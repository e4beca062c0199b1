"""Training loop for NerrfNet: the port of ``nerrf_tpu/train/loop.py``'s
single-device paths.

Objective = masked, class-rebalanced BCE on edge logits (the GNN's
edge-anomaly task) + node BCE (aux) + sequence BCE (the LSTM task), as the
reference's ``make_loss_fn``.  The optimizer is the reference's ``make_tx``,
written out in PyTorch:

* ``optax.warmup_cosine_decay_schedule(0, lr, warmup, max(num_steps,
  warmup + 1))`` as a plain function of the update count
  (:func:`lr_schedule`): the first update runs at learning rate 0;
* ``optax.clip_by_global_norm(1.0)`` by hand (:func:`clip_by_global_norm_`):
  ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, optax does not;
* AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) and weight decay
  on every parameter (``torch.optim.AdamW`` computes the same update).

Dropout masks come from one ``torch.Generator`` on the model's device, seeded
from ``TrainConfig.seed``.  Batches follow :func:`make_idx_schedule`, the
reference's draw.  The step flavors:

* :func:`make_train_step`: a batch of tensors on the device, copied from the
  host by the caller (the streamed path);
* :func:`make_train_step_resident`, :func:`make_train_step_scheduled` and
  :func:`make_train_superstep`: the dataset on the card (uploaded once by
  :func:`device_put_chunked`), each step's batch taken there with
  ``torch.index_select``; the scheduled step reads its row of the index
  schedule from a table on the card, the superstep runs K of them with no
  host sync between.  :func:`train_nerrfnet` takes the scheduled path
  whenever the dataset fits (:func:`_fits_resident`), as the reference does;
* :func:`train_sharded_stream`: a disk corpus (``train/corpus.py``) rotated
  shard by shard through the card, the next shard uploading on a side
  stream while the current one trains.

``TrainConfig.telemetry`` adds the in-step health scalars
(``trainwatch/telemetry.py``) to each step's ``aux``; a
``trainwatch.TrainHealthMonitor`` passed as ``monitor`` watches the logged
steps and halts a diverged run.  At the end of a run
:func:`train_nerrfnet` sets the device-time plane's gauges
(``device_mfu{program="train_step"}``, the roofline intensity) from the
step's analytic cost (`devtime.costmodel.train_step_cost`) and the
measured steps/s.  The streamed flavor carries the chaos plane's
``train.nonfinite_grad`` fault point.  Left out: the compile cache (with
CUDA graphs, ROADMAP B.D1).  A mesh experiment trains
on the one card, as the reference's does on one device; data parallelism
over several cards is ROADMAP A.7.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerrf_tpu_torch import chaos, tracing
from nerrf_tpu_torch.device import resolve_device
from nerrf_tpu_torch.models.joint import JointConfig, NerrfNet, build_nerrfnet
from nerrf_tpu_torch.observability import DEFAULT_REGISTRY
from nerrf_tpu_torch.ops import active_impls
from nerrf_tpu_torch.pipeline import make_eval_fn
from nerrf_tpu_torch.tracing import span
from nerrf_tpu_torch.train.data import WindowDataset, padding_waste_fractions
from nerrf_tpu_torch.train.metrics import best_f1, roc_auc


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: JointConfig = JointConfig()
    batch_size: int = 8
    num_steps: int = 500
    learning_rate: float = 2e-3
    warmup_steps: int = 50
    weight_decay: float = 1e-4
    edge_loss_weight: float = 1.0
    node_loss_weight: float = 0.3
    seq_loss_weight: float = 1.0
    pos_weight: float = 8.0  # attack classes are rare
    seed: int = 0
    eval_every: int = 100
    # in-step health telemetry (trainwatch): grad/param/update norms and
    # per-component nonfinite flags computed on the card inside the step
    # and returned with the loss under aux["telemetry"]
    telemetry: bool = False


@dataclasses.dataclass
class TrainState:
    """The model (its params), the optimizer (its moments) and the number of
    updates taken: what the reference's ``TrainState`` carries."""

    model: NerrfNet
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    metrics: Dict[str, float]
    steps_per_sec: float
    history: list
    # what the sharded trainer saw of its shard pipeline (shards trained,
    # seconds waiting on the reader, upload bytes and device seconds)
    info: Dict = dataclasses.field(default_factory=dict)


_MODEL_INPUTS = (
    "node_feat", "node_type", "node_aux", "node_mask", "edge_src", "edge_dst",
    "edge_feat", "edge_mask", "seq_feat", "seq_mask", "seq_node_idx",
)


def model_inputs(batch: Dict[str, torch.Tensor]) -> tuple:
    return tuple(batch[k] for k in _MODEL_INPUTS)


def _weighted_bce(logit, label, mask, pos_weight):
    """Masked BCE-with-logits, positives upweighted."""
    loss = -(pos_weight * label * F.logsigmoid(logit)
             + (1.0 - label) * F.logsigmoid(-logit))
    return (loss * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def make_loss_fn(model: NerrfNet, cfg: TrainConfig):
    """``loss_fn(batch, dropout_gen) -> (total, {"edge_loss", "node_loss",
    "seq_loss"})`` over a batch of tensors on the model's device; dropout
    runs when ``dropout_gen`` is given."""

    def loss_fn(batch, dropout_gen=None):
        out = model(*model_inputs(batch), dropout_gen=dropout_gen)
        e_mask = batch["edge_mask"].float()
        n_mask = batch["node_mask"].float()
        s_mask = batch["seq_valid"].float()
        edge_loss = _weighted_bce(out["edge_logit"], batch["edge_label"],
                                  e_mask, cfg.pos_weight)
        node_loss = _weighted_bce(out["node_logit"], batch["node_label"],
                                  n_mask, cfg.pos_weight)
        seq_loss = _weighted_bce(out["seq_logit"], batch["seq_label"],
                                 s_mask, cfg.pos_weight)
        total = (cfg.edge_loss_weight * edge_loss
                 + cfg.node_loss_weight * node_loss
                 + cfg.seq_loss_weight * seq_loss)
        return total, {"edge_loss": edge_loss, "node_loss": node_loss,
                       "seq_loss": seq_loss}

    return loss_fn


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(num_steps,
    warmup + 1))``: the learning rate of the update taken after ``count``
    earlier ones (linear from 0 to ``lr`` over the warmup, then a cosine
    down to 0 at the decay end, and 0 past it)."""
    peak, warmup = cfg.learning_rate, cfg.warmup_steps
    decay = max(cfg.num_steps, warmup + 1) - warmup

    def schedule(count: int) -> float:
        if warmup > 0 and count < warmup:
            return peak * count / warmup
        t = min(count - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: when the global norm
    ``sqrt(Σ g²)`` is at least ``max_norm``, every gradient becomes
    ``g / (norm / max_norm)`` (no epsilon added to the norm; for
    ``max_norm`` 1 exactly optax's ``g / norm * 1``).  Returns the norm (a
    tensor: no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(norm >= max_norm, norm / max_norm, one))
    return norm


def make_tx(model: NerrfNet, cfg: TrainConfig) -> torch.optim.AdamW:
    """The reference's AdamW (optax defaults) over every parameter; the
    learning rate is set before each update from :func:`lr_schedule`."""
    return torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.weight_decay)


def init_state(cfg: TrainConfig, device=None) -> TrainState:
    """A fresh model drawn from ``cfg.seed`` (flax's initializer kinds) in
    training mode on ``device`` (the card unless ``device='cpu'``), and its
    optimizer."""
    model = build_nerrfnet(cfg.model, seed=cfg.seed, device=device).train()
    return TrainState(model=model, optimizer=make_tx(model, cfg))


def make_train_step(model: NerrfNet, cfg: TrainConfig):
    """``train_step(state, batch, dropout_gen) -> (state, loss, aux)``: one
    forward and backward through ``model`` (``state.model``), the global-norm
    clip, and one AdamW update at the schedule's learning rate.  ``loss`` and
    ``aux`` are detached tensors on the device (reading them syncs).  With
    ``cfg.telemetry`` the step keeps the raw gradients and the pre-update
    params (one copy of each) and adds ``step_telemetry`` under
    ``aux["telemetry"]``."""
    loss_fn = make_loss_fn(model, cfg)
    schedule = lr_schedule(cfg)
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state: TrainState, batch, dropout_gen=None):
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(batch, dropout_gen)
        loss.backward()
        grads = []
        for p in params:
            if p.grad is None:  # optax updates (and decays) every param
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if cfg.telemetry:
            raw = [g.detach().clone() for g in grads]
            old = [p.detach().clone() for p in params]
        clip_by_global_norm_(grads, 1.0)
        lr = schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        aux = {k: v.detach() for k, v in aux.items()}
        if cfg.telemetry:
            from nerrf_tpu_torch.trainwatch.telemetry import step_telemetry

            aux["telemetry"] = step_telemetry(old, params, raw, loss.detach(), aux)
        return state, loss.detach(), aux

    return train_step


# --- the dataset on the card -------------------------------------------------------

class Upload:
    """Tensors copied to the device by :func:`device_put_chunked`, with the
    event (None on the CPU) that fires when the copies have landed.  The
    consumer calls :meth:`wait` before it first reads ``arrays``."""

    def __init__(self, arrays: Dict[str, torch.Tensor], event=None, start=None,
                 nbytes: int = 0) -> None:
        self.arrays, self.event, self.start, self.nbytes = arrays, event, start, nbytes
        self._waited: set = set()

    def wait(self) -> None:
        """Order the current stream after the copies (no host sync), and
        mark the tensors as used by it: the caching allocator then keeps
        their memory until that stream's work on them is done, though they
        were allocated on the side stream."""
        if self.event is None:
            return
        stream = torch.cuda.current_stream()
        if stream.cuda_stream in self._waited:
            return
        stream.wait_event(self.event)
        for t in self.arrays.values():
            t.record_stream(stream)
        self._waited.add(stream.cuda_stream)

    def seconds(self) -> Optional[float]:
        """Device seconds from the side stream's start to the last copy's
        end (syncs on the copies; None on the CPU)."""
        if self.event is None:
            return None
        self.event.synchronize()
        return self.start.elapsed_time(self.event) / 1e3

    def stats(self) -> "Upload":
        """The same upload without its tensors (its size and events)."""
        return Upload({}, self.event, self.start, self.nbytes)


_UPLOAD_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _upload_stream(dev: torch.device) -> "torch.cuda.Stream":
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = _UPLOAD_STREAMS.get(index)
    if stream is None:
        stream = _UPLOAD_STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


def device_put_chunked(arrays, max_bytes: int = 64 << 20, block: bool = False,
                       log=None, device=None) -> Upload:
    """Copy a dict of host arrays to ``device`` (the card unless
    ``device='cpu'``), at most ``max_bytes`` at a time.

    On the card the bytes go through two pinned host buffers of
    ``max_bytes`` each and are copied on a side CUDA stream, so the upload
    overlaps whatever the current stream is running; the chunking bounds the
    pinned memory (the reference chunks because one large transfer wedged a
    TPU host relay).  The device tensors are allocated on the side stream:
    its memory pool gives them only blocks whose earlier copies it has
    ordered, and :meth:`Upload.wait` records the consumer's stream on them
    so that a block is not handed out again while the consumer still reads
    it.  The returned :class:`Upload` carries the event the consumer waits
    on before the first read.  ``block=True`` synchronizes and, with
    ``log``, reports the rate.  On the CPU it is a plain copy.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    total = sum(int(v.nbytes) for v in arrays.values())
    if dev.type != "cuda":
        return Upload({k: torch.from_numpy(v.copy()) for k, v in arrays.items()},
                      nbytes=total)
    chunk = max(1, min(max_bytes, max((int(v.nbytes) for v in arrays.values()),
                                      default=1)))
    staging = [torch.empty(chunk, dtype=torch.uint8, pin_memory=True)
               for _ in range(2)]
    landed: List[Optional[torch.cuda.Event]] = [None, None]
    start = torch.cuda.Event(enable_timing=True)
    event = torch.cuda.Event(enable_timing=True)
    side = _upload_stream(dev)
    j = 0
    with torch.cuda.stream(side):
        out = {k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype, device=dev)
               for k, v in arrays.items()}
        start.record(side)
        for k, v in arrays.items():
            src = v.reshape(-1).view(np.uint8)
            dst = out[k].view(-1).view(torch.uint8)
            for off in range(0, src.size, chunk):
                n = min(chunk, src.size - off)
                if landed[j] is not None:
                    landed[j].synchronize()  # the buffer's last copy is done
                staging[j].numpy()[:n] = src[off:off + n]
                dst[off:off + n].copy_(staging[j][:n], non_blocking=True)
                landed[j] = torch.cuda.Event()
                landed[j].record(side)
                j ^= 1
        event.record(side)
    up = Upload(out, event, start, total)
    if block:
        event.synchronize()
        if log:
            dt = time.perf_counter() - t0
            log(f"upload: {total / 1e9:.2f} GB in {dt:.1f}s "
                f"({total / 1e9 / max(dt, 1e-9):.2f} GB/s)")
    return up


def _gather(data: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Rows ``idx`` of every array, on the device (the reference's
    ``jnp.take(v, idx, axis=0)``; f16 storage is cast to f32 after the
    gather, so compute sees f32)."""
    batch = {k: torch.index_select(v, 0, idx) for k, v in data.items()}
    return {k: v.float() if v.dtype == torch.float16 else v
            for k, v in batch.items()}


def make_train_step_resident(model: NerrfNet, cfg: TrainConfig, arrays):
    """Train step over a dataset on the card: ``arrays`` is uploaded once
    (:func:`device_put_chunked`) and each step takes its batch there, so a
    step's only host→device copy is its [batch] index vector.
    ``step(state, idx, dropout_gen) -> (state, loss, aux)``."""
    step, _, _ = _make_resident_steps(model, cfg, arrays)
    return step


def make_train_step_scheduled(model: NerrfNet, cfg: TrainConfig, arrays,
                              idx_table: np.ndarray):
    """Device-driven training: the dataset and the whole batch-index schedule
    (``idx_table``, [num_steps, batch]) live on the card, and each step reads
    its row as ``table[state.step % len(table)]``, a view with no copy from
    the host.  ``step(state, dropout_gen) -> (state, loss, aux)``."""
    _, make_scheduled, _ = _make_resident_steps(model, cfg, arrays)
    return make_scheduled(idx_table)


def make_train_superstep(model: NerrfNet, cfg: TrainConfig, arrays,
                         idx_table: np.ndarray, steps_per_call: int):
    """K scheduled steps a call, with no host sync between them:
    ``step(state, dropout_gen) -> (state, losses)``, ``losses`` one [K]
    tensor on the device."""
    _, _, make_super = _make_resident_steps(model, cfg, arrays)
    return make_super(idx_table, steps_per_call)


def _make_resident_steps(model: NerrfNet, cfg: TrainConfig, arrays):
    """One factory for the resident flavors, sharing the upload, the gather
    and the step body."""
    dev = next(model.parameters()).device
    upload = device_put_chunked(arrays, device=dev)
    train_step = make_train_step(model, cfg)

    def gathered_step(state, idx, dropout_gen):
        upload.wait()
        return train_step(state, _gather(upload.arrays, idx), dropout_gen)

    def resident(state, idx, dropout_gen=None):
        idx = torch.as_tensor(np.asarray(idx, np.int64)).to(dev)
        return gathered_step(state, idx, dropout_gen)

    def make_scheduled(idx_table):
        table = torch.as_tensor(np.asarray(idx_table, np.int64)).to(dev)

        def scheduled(state, dropout_gen=None):
            return gathered_step(state, table[state.step % table.shape[0]],
                                 dropout_gen)

        return scheduled

    def make_super(idx_table, steps_per_call):
        scheduled = make_scheduled(idx_table)

        def superstep(state, dropout_gen=None):
            losses = []
            for _ in range(steps_per_call):
                state, loss, _aux = scheduled(state, dropout_gen)
                losses.append(loss)
            return state, torch.stack(losses)

        return superstep

    return resident, make_scheduled, make_super


def make_idx_schedule(n: int, cfg: TrainConfig) -> np.ndarray:
    """The deterministic batch schedule train_nerrfnet follows: row `step` is
    the same draw the reference's streaming loop makes at that step."""
    order = np.random.default_rng(cfg.seed)
    size = min(cfg.batch_size, n)
    return np.stack([
        order.choice(n, size=size, replace=False)
        for _ in range(cfg.num_steps)
    ])


def _step_seed(seed: int, step: int) -> int:
    """The dropout seed of step ``step`` of a run seeded ``seed``: a fixed
    function of the pair (the counterpart of the reference's
    ``jax.random.fold_in(PRNGKey(seed), step)``), so a resumed run draws the
    same masks as an uninterrupted one."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])


# Datasets larger than this stream batches from the host instead of living
# in device memory (override: NERRF_RESIDENT_MAX_BYTES).
RESIDENT_MAX_BYTES = 2 << 30

# Bounded in-memory loss history: a long run logging every eval_every steps
# must not grow a list for the life of the run.  Callers that need the
# whole trajectory pass ``full_history=True``; everyone else gets the newest
# HISTORY_LIMIT entries (TrainResult.history stays a plain list).
HISTORY_LIMIT = 512


def _history(full_history: bool) -> deque:
    return deque(maxlen=None if full_history else HISTORY_LIMIT)


def _history_entry(step: int, loss, aux) -> dict:
    """One logged step's history entry: floats the loss (the loop's one
    host sync) and, when the step carries telemetry, its headline scalars
    in the same sync."""
    entry = {"step": step, "loss": float(loss)}
    tel = aux.get("telemetry") if isinstance(aux, dict) else None
    if tel is not None:
        entry["grad_norm"] = float(tel["grad_norm"])
        entry["update_ratio"] = float(tel["update_ratio"])
    return entry


def _loss_components(aux) -> Dict[str, float]:
    return {k: float(v) for k, v in aux.items() if k != "telemetry"}


def _telemetry_floats(aux) -> Optional[dict]:
    tel = aux.get("telemetry") if isinstance(aux, dict) else None
    if tel is None:
        return None
    return {
        "grad_norm": float(tel["grad_norm"]),
        "param_norm": float(tel["param_norm"]),
        "update_norm": float(tel["update_norm"]),
        "update_ratio": float(tel["update_ratio"]),
        "nonfinite": {k: float(v) for k, v in tel["nonfinite"].items()},
    }


def _dataset_bytes(arrays) -> int:
    return sum(int(v.nbytes) for v in arrays.values())


def _fits_resident(arrays) -> bool:
    limit = int(os.environ.get("NERRF_RESIDENT_MAX_BYTES", RESIDENT_MAX_BYTES))
    return _dataset_bytes(arrays) <= limit


def batch_to_device(arrays: Dict[str, np.ndarray], idx,
                    device) -> Dict[str, torch.Tensor]:
    """Rows ``idx`` of every array, as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(device)
            for k, v in arrays.items()}


def evaluate(eval_fn, ds: WindowDataset, batch_size: int = 8) -> Dict[str, float]:
    """Masked metrics over a dataset, batches sliced on the host and scored
    by ``eval_fn`` (:func:`nerrf_tpu_torch.pipeline.make_eval_fn`)."""
    a = ds.arrays
    scores = {"edge": [], "node": [], "seq": []}
    labels = {"edge": [], "node": [], "seq": []}
    masks = {"edge": "edge_mask", "node": "node_mask", "seq": "seq_valid"}
    with span("eval", device=True, samples=len(ds)):
        for i in range(0, len(ds), batch_size):
            idx = np.arange(i, min(i + batch_size, len(ds)))
            out = eval_fn({k: a[k][idx] for k in _MODEL_INPUTS})
            for j, row in enumerate(idx):
                for kind, mkey in masks.items():
                    m = a[mkey][row]
                    scores[kind].append(out[f"{kind}_logit"][j][m])
                    labels[kind].append(a[f"{kind}_label"][row][m])
    s = {k: np.concatenate(v) for k, v in scores.items()}
    lab = {k: np.concatenate(v) for k, v in labels.items()}
    seq_f1, seq_t = best_f1(lab["seq"], s["seq"])
    node_f1, _ = best_f1(lab["node"], s["node"])
    return {
        "edge_auc": roc_auc(lab["edge"], s["edge"]),
        "node_auc": roc_auc(lab["node"], s["node"]),
        "seq_auc": roc_auc(lab["seq"], s["seq"]),
        "seq_f1": seq_f1,
        "seq_f1_threshold": seq_t,
        "node_f1": node_f1,
        "num_edges_eval": float(len(lab["edge"])),
        "num_seqs_eval": float(len(lab["seq"])),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _observe(monitor, step, entry, aux, data_wait_s, log) -> Optional[tuple]:
    """Feed one logged step to ``monitor``; the latched divergence when the
    monitor says to halt, else None."""
    monitor.observe_step(step, entry["loss"], telemetry=_telemetry_floats(aux),
                         data_wait_s=data_wait_s,
                         components=_loss_components(aux))
    if not monitor.should_halt:
        return None
    if log:
        log(f"trainwatch: halting at step {step} — {monitor.diverged[1]}")
    return monitor.diverged


def _set_run(monitor, cfg: TrainConfig) -> None:
    from nerrf_tpu_torch.flight.journal import fingerprint

    monitor.set_run(config_fingerprint=fingerprint(cfg),
                    model_fingerprint=fingerprint(cfg.model),
                    steps=cfg.num_steps, seed=cfg.seed)


def train_nerrfnet(
    train_ds: WindowDataset,
    eval_ds: Optional[WindowDataset] = None,
    cfg: Optional[TrainConfig] = None,
    log=None,
    device=None,
    monitor=None,
    full_history: bool = False,
) -> TrainResult:
    """Train a fresh ``NerrfNet`` on ``train_ds`` for ``cfg.num_steps`` steps
    on ``device`` (the card unless ``device='cpu'``), logging the loss every
    ``cfg.eval_every`` steps and at the last, then evaluate on ``eval_ds``
    (``train_ds`` when None).  ``steps_per_sec`` counts the steps after step
    0 (which pays the one-time set-up), as the reference does.

    When the dataset fits (:func:`_fits_resident`) it lives on the card and
    the steps are scheduled there (:func:`make_train_step_scheduled`); else
    each step's batch is copied from the host.  Both follow the same
    schedule rows and draw dropout from one generator in the same order, so
    on the card they give the same bits.

    ``monitor`` (a ``trainwatch.TrainHealthMonitor``) observes every logged
    step (loss, telemetry floats, data wait) at the loop's existing host
    sync, and halts the loop once a divergence latches; a halted run skips
    the evaluation and returns empty metrics.  ``full_history`` keeps every
    logged entry (else the newest HISTORY_LIMIT)."""
    cfg = cfg or TrainConfig()
    dev = resolve_device(device)
    from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL, fingerprint

    DEFAULT_JOURNAL.record(
        "train_start", config_fingerprint=fingerprint(cfg),
        model_fingerprint=fingerprint(cfg.model),
        steps=cfg.num_steps, batch_size=cfg.batch_size,
        windows=len(train_ds), seed=cfg.seed)
    if monitor is not None:
        _set_run(monitor, cfg)
    with span("train_setup", device=True):
        state = init_state(cfg, dev)
        dropout_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    n = len(train_ds)
    if log:
        nodes = train_ds.arrays["node_feat"].shape[1]
        log(f"gnn aggregation={cfg.model.gnn.resolved_aggregation(nodes)} "
            f"kernel_path={active_impls(dev)}")
    schedule = make_idx_schedule(n, cfg)
    resident = _fits_resident(train_ds.arrays)
    with span("train_setup", device=True, phase="step_fns"):
        if resident:
            train_step = make_train_step_scheduled(state.model, cfg,
                                                   train_ds.arrays, schedule)
        else:
            train_step = make_train_step(state.model, cfg)
    history = _history(full_history)
    trace_steps = tracing.enabled()
    bucket = (f"{train_ds.arrays['node_feat'].shape[1]}n/"
              f"{train_ds.arrays['edge_src'].shape[1]}e")
    for kind, frac in padding_waste_fractions(train_ds.arrays).items():
        DEFAULT_REGISTRY.gauge_set(
            "train_padding_waste_fraction", frac,
            labels={"kind": kind, "bucket": bucket},
            help="fraction of padded capacity carrying no real data")
    blocked_s = data_wait_s = 0.0
    dw_accum = 0.0  # data wait since the monitor's last observation
    steps_done = 0
    halted = None
    t_start = None
    with span("train_loop", steps=cfg.num_steps, resident=resident, bucket=bucket):
        for step in range(cfg.num_steps):
            if resident:
                args = (state, dropout_gen)
            else:
                dw_cm = (span("data_wait", step=step) if trace_steps
                         else contextlib.nullcontext())
                t_dw = time.perf_counter()
                with dw_cm as dw:
                    batch = batch_to_device(train_ds.arrays, schedule[step], dev)
                # step 0 excluded: the fractions measure steady state, as
                # steps/s does
                if step > 0:
                    dw_accum += time.perf_counter() - t_dw
                    if dw is not None:
                        data_wait_s += dw.dur
                # chaos fault point (disarmed = one global None read):
                # poison this step's input with NaN — the non-finite
                # value propagates through loss and gradients, so the
                # in-step nonfinite telemetry must fire and the monitor
                # must dump exactly one train_divergence bundle.  Same
                # shapes, same kernels
                if chaos.check("train.nonfinite_grad", key=str(step),
                               step=step) is not None:
                    batch = dict(batch,
                                 node_feat=batch["node_feat"] * float("nan"))
                args = (state, batch, dropout_gen)
            if trace_steps:
                # the span lasts until the loss is on the host, so its
                # duration less the dispatch is the host-blocked time
                with span("device_step", device=True, step=step) as sp:
                    t_d = time.perf_counter()
                    state, loss, aux = train_step(*args)
                    dispatch_s = time.perf_counter() - t_d
                    loss.item()
                    sp.args["dispatch_s"] = round(dispatch_s, 6)
                if step > 0:
                    blocked_s += max(sp.dur - dispatch_s, 0.0)
            else:
                state, loss, aux = train_step(*args)
            if step == 0:
                _sync(dev)  # step 0 pays the set-up: excluded from steps/s
                t_start = time.perf_counter()
            steps_done = step + 1
            if step % cfg.eval_every == 0 or step == cfg.num_steps - 1:
                entry = _history_entry(step, loss, aux)
                history.append(entry)
                DEFAULT_REGISTRY.gauge_set("train_step", step,
                                           help="last completed train step")
                DEFAULT_REGISTRY.gauge_set(
                    "train_loss", entry["loss"],
                    help="joint loss at last logged step")
                if log:
                    log(f"step {step}: loss={entry['loss']:.4f} "
                        + " ".join(f"{k}={v:.4f}"
                                   for k, v in _loss_components(aux).items()))
                if monitor is not None:
                    halted = _observe(monitor, step, entry, aux, dw_accum, log)
                    dw_accum = 0.0
                    if halted is not None:
                        break
        _sync(dev)
    if monitor is not None:
        # stepping is over: the evaluation must not read as a stall
        monitor.finish()
    elapsed = time.perf_counter() - (t_start or time.perf_counter())
    steps_per_sec = ((steps_done - 1) / elapsed
                     if elapsed > 0 and steps_done > 1 else 0.0)
    if trace_steps and elapsed > 0 and cfg.num_steps > 1:
        DEFAULT_REGISTRY.gauge_set(
            "train_host_blocked_fraction", blocked_s / elapsed,
            help="fraction of steady-state train wall spent blocked on "
                 "device results (synced device_step spans)")
        DEFAULT_REGISTRY.gauge_set(
            "train_data_wait_fraction", data_wait_s / elapsed,
            help="fraction of steady-state train wall spent assembling or "
                 "waiting for input batches")
    # device-efficiency plane: analytic step FLOPs x measured steps/s →
    # device_mfu{program="train_step"} + roofline intensity.  A meta trace
    # (no launch), memoized per architecture and shapes, best-effort by
    # contract; the MFU gauge stays absent off the card (null-not-fake).
    # Spanned, so the trace's host seconds are attributed
    with span("devtime_cost", program="train_step"):
        from nerrf_tpu_torch.devtime import train_efficiency_gauges

        eff = train_efficiency_gauges(state.model, cfg, train_ds.arrays,
                                      steps_per_sec)
    if eff and log:
        log(f"device efficiency: {eff}")
    if halted is not None:
        # diverged weights: evaluating them would only fabricate metrics
        metrics = {}
    else:
        metrics = evaluate(make_eval_fn(state.model),
                           eval_ds if eval_ds is not None else train_ds,
                           cfg.batch_size)
    DEFAULT_JOURNAL.record(
        "train_done", config_fingerprint=fingerprint(cfg),
        steps_per_sec=round(steps_per_sec, 3),
        steps_done=steps_done,
        **({"halted": halted[1]} if halted is not None else {}),
        metrics={k: round(float(v), 4) for k, v in metrics.items()})
    return TrainResult(state=state, metrics=metrics,
                       steps_per_sec=steps_per_sec, history=list(history))


def train_sharded_stream(
    corpus,
    cfg: Optional[TrainConfig] = None,
    eval_ds: Optional[WindowDataset] = None,
    log=None,
    passes_per_shard: int = 2,
    ckpt_dir=None,
    save_every: int = 0,
    upload_chunk_bytes: int = 64 << 20,
    compile_cache=None,
    monitor=None,
    full_history: bool = False,
    device=None,
) -> TrainResult:
    """Train from a disk corpus (a ``train.corpus.ShardedCorpus``), rotating
    its shards through the card, double-buffered.

    A reader thread loads shard i+1 from disk into a queue of one while the
    card trains on shard i; the trainer starts its upload
    (:func:`device_put_chunked`, a side stream) as soon as it starts on
    shard i, so the copy hides behind ``passes_per_shard`` epochs of shard
    i's batches, and the card holds two shards.  Batch indices come from
    ``default_rng((seed, steps_done))``; the shard order reshuffles every
    corpus epoch (``iter_train_shards(seed + epoch)``).  A failure in the
    reader re-raises here.

    ``ckpt_dir``/``save_every`` write full-state checkpoints
    (``train/elastic.py``) and resume from the newest: params, optimizer
    state and step come back exactly; the batch draws and the dropout
    generator restart from the restored step's seeds, so the shard rotation
    is not replayed bit for bit across a restart (a data-order
    perturbation, as in the reference).  A halted run saves nothing.
    ``compile_cache`` is refused: it becomes a capture cache of CUDA graphs
    (ROADMAP B.D1).

    ``TrainResult.info`` holds the pipeline's numbers: ``shards`` trained,
    ``data_wait_s`` (the trainer waiting on the reader), ``upload_bytes``
    and ``upload_device_s`` (the side stream's copies)."""
    import queue as queue_mod
    import threading

    if compile_cache is not None:
        raise NotImplementedError(
            "train_sharded_stream(compile_cache=...): the compile cache is not "
            "ported; it becomes a capture cache of CUDA graphs (ROADMAP B.D1)")
    cfg = cfg or TrainConfig()
    dev = resolve_device(device)

    def put_chunked(arrays, block=False):
        # the first shard blocks (it gates the init anyway) and logs its
        # rate; the next shards' uploads overlap the current shard's steps
        return device_put_chunked(arrays, max_bytes=upload_chunk_bytes,
                                  block=block, log=log, device=dev)

    # -- shard pipeline: disk → host queue → side-stream upload ----------------
    host_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=1)
    stop = threading.Event()

    def reader():
        try:
            epoch = 0
            while not stop.is_set():
                for arrays in corpus.iter_train_shards(epoch_seed=cfg.seed + epoch):
                    while not stop.is_set():
                        try:
                            host_q.put(arrays, timeout=0.5)
                            break
                        except queue_mod.Full:
                            continue
                    if stop.is_set():
                        return
                epoch += 1
        except BaseException as e:  # re-raised by the trainer, never a hang
            host_q.put(e)

    thread = threading.Thread(target=reader, daemon=True,
                              name="nerrf-train-reader")
    thread.start()
    waited = [0.0, 0.0]  # data wait since the monitor's last look, and in all

    def next_host_shard():
        t_dw = time.perf_counter()
        try:
            with span("data_wait", source="shard_queue"):
                while True:
                    try:
                        item = host_q.get(timeout=5.0)
                    except queue_mod.Empty:
                        if not thread.is_alive():
                            raise RuntimeError(
                                "corpus reader thread died without reporting")
                        continue
                    if isinstance(item, BaseException):
                        raise RuntimeError("corpus shard read failed") from item
                    return item
        finally:
            dt = time.perf_counter() - t_dw
            waited[0] += dt
            waited[1] += dt

    uploads: List[Upload] = []  # their events and sizes, not their arrays
    history = _history(full_history)
    steps_done = 0
    halted = None
    t_start = None
    timed_from = 0
    try:
        shard = put_chunked(next_host_shard(), block=True)
        uploads.append(shard.stats())
        with span("train_setup", device=True):
            state = init_state(cfg, dev)
            train_step = make_train_step(state.model, cfg)
        if monitor is not None:
            _set_run(monitor, cfg)
        if ckpt_dir is not None and save_every > 0:
            from nerrf_tpu_torch.train.elastic import _restore_full, latest_step

            resumed = latest_step(ckpt_dir)
            if resumed is not None:
                state = _restore_full(Path(ckpt_dir), resumed, state)
                steps_done = resumed
                if log:
                    log(f"resumed from step {resumed}")
        order = np.random.default_rng((cfg.seed, steps_done))
        dropout_gen = torch.Generator(device=dev).manual_seed(
            _step_seed(cfg.seed, steps_done))
        timed_from = steps_done
        with span("train_loop", steps=cfg.num_steps, sharded=True):
            while steps_done < cfg.num_steps and halted is None:
                # stage the next shard: its upload overlaps this shard's steps
                per_shard = _shard_steps(shard.arrays, cfg, passes_per_shard)
                nxt = (put_chunked(next_host_shard())
                       if steps_done + per_shard < cfg.num_steps else None)
                if nxt is not None:
                    uploads.append(nxt.stats())
                n = int(shard.arrays["node_feat"].shape[0])
                shard.wait()
                for _ in range(min(per_shard, cfg.num_steps - steps_done)):
                    idx = torch.from_numpy(order.choice(
                        n, size=min(cfg.batch_size, n), replace=False)).to(dev)
                    state, loss, aux = train_step(state, _gather(shard.arrays, idx),
                                                  dropout_gen)
                    if t_start is None:
                        _sync(dev)  # the first step pays the set-up
                        t_start = time.perf_counter()
                        timed_from = steps_done
                    if cfg.eval_every and steps_done % cfg.eval_every == 0:
                        entry = _history_entry(steps_done, loss, aux)
                        history.append(entry)
                        if log:
                            log(f"step {steps_done}: loss={entry['loss']:.4f} "
                                + " ".join(f"{k}={v:.4f}" for k, v in
                                           _loss_components(aux).items()))
                        if monitor is not None:
                            halted = _observe(monitor, steps_done, entry, aux,
                                              waited[0], log)
                            waited[0] = 0.0
                            if halted is not None:
                                break
                    steps_done += 1
                    if (ckpt_dir is not None and save_every > 0
                            and steps_done % save_every == 0):
                        from nerrf_tpu_torch.train.elastic import _save_full

                        _save_full(Path(ckpt_dir), steps_done, state)
                        if monitor is not None:
                            monitor.note_checkpoint(
                                Path(ckpt_dir) / f"step_{steps_done:08d}",
                                steps_done)
                if nxt is not None:
                    shard = nxt
            _sync(dev)
    finally:
        stop.set()
        try:  # release a blocked put so the reader can exit
            while True:
                host_q.get_nowait()
        except queue_mod.Empty:
            pass
        thread.join(timeout=10)

    if monitor is not None:
        monitor.finish()  # the evaluation must not read as a stall
    if ckpt_dir is not None and save_every > 0 and halted is None:
        # a diverged run must not overwrite the last good checkpoint
        from nerrf_tpu_torch.train.elastic import _save_full

        _save_full(Path(ckpt_dir), steps_done, state)
    elapsed = time.perf_counter() - (t_start or time.perf_counter())
    timed = max(steps_done - timed_from - 1, 1)
    steps_per_sec = timed / elapsed if elapsed > 0 else 0.0
    upload_s = [u.seconds() for u in uploads]
    info = {
        "shards": len(uploads),
        "data_wait_s": waited[1],
        "upload_bytes": sum(u.nbytes for u in uploads),
        "upload_device_s": (None if dev.type != "cuda" else sum(upload_s)),
    }
    metrics = (
        evaluate(make_eval_fn(state.model), eval_ds, cfg.batch_size)
        if eval_ds is not None and halted is None else {}
    )
    return TrainResult(state=state, metrics=metrics, steps_per_sec=steps_per_sec,
                       history=list(history), info=info)


def _shard_steps(shard, cfg: TrainConfig, passes: int) -> int:
    n = int(shard["node_feat"].shape[0])
    return max(1, passes * n // cfg.batch_size)
