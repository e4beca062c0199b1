"""Training loop for NerrfNet: the port of ``nerrf_tpu/train/loop.py``'s
single-device path (``train_nerrfnet`` streaming batches from the host).

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
reference's draw.  Left for later slices: the resident, scheduled and
superstep step variants, the compile cache, the journal and registry gauges,
chaos, trainwatch (``TrainConfig.telemetry`` is refused), devtime and
the sharded trainer.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerrf_tpu_torch.device import resolve_device
from nerrf_tpu_torch.models.joint import JointConfig, NerrfNet, build_nerrfnet
from nerrf_tpu_torch.ops import active_impls
from nerrf_tpu_torch.pipeline import make_eval_fn
from nerrf_tpu_torch.tracing import span
from nerrf_tpu_torch.train.data import WindowDataset
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
    # the reference's in-step health telemetry (trainwatch), carried so that
    # every reference config parses; trainwatch is not ported (ROADMAP
    # A.3), so train_nerrfnet refuses True
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
    ``aux`` are detached tensors on the device (reading them syncs)."""
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
        clip_by_global_norm_(grads, 1.0)
        lr = schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return state, loss.detach(), {k: v.detach() for k, v in aux.items()}

    return train_step


def make_idx_schedule(n: int, cfg: TrainConfig) -> np.ndarray:
    """The deterministic batch schedule train_nerrfnet follows: row `step` is
    the same draw the reference's streaming loop makes at that step."""
    order = np.random.default_rng(cfg.seed)
    size = min(cfg.batch_size, n)
    return np.stack([
        order.choice(n, size=size, replace=False)
        for _ in range(cfg.num_steps)
    ])


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


def train_nerrfnet(
    train_ds: WindowDataset,
    eval_ds: Optional[WindowDataset] = None,
    cfg: Optional[TrainConfig] = None,
    log=None,
    device=None,
) -> TrainResult:
    """Train a fresh ``NerrfNet`` on ``train_ds`` for ``cfg.num_steps`` steps
    on ``device`` (the card unless ``device='cpu'``), logging the loss every
    ``cfg.eval_every`` steps and at the last, then evaluate on ``eval_ds``
    (``train_ds`` when None).  ``steps_per_sec`` counts the steps after step
    0 (which pays the one-time set-up), as the reference does."""
    cfg = cfg or TrainConfig()
    if cfg.telemetry:
        raise NotImplementedError(
            "TrainConfig.telemetry: the in-step health telemetry (trainwatch) "
            "is not ported (ROADMAP A.3)")
    dev = resolve_device(device)
    with span("train_setup", device=True):
        state = init_state(cfg, dev)
        train_step = make_train_step(state.model, cfg)
        dropout_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    n = len(train_ds)
    if log:
        nodes = train_ds.arrays["node_feat"].shape[1]
        log(f"gnn aggregation={cfg.model.gnn.resolved_aggregation(nodes)} "
            f"kernel_path={active_impls(dev)}")
    schedule = make_idx_schedule(n, cfg)
    history = []
    bucket = (f"{train_ds.arrays['node_feat'].shape[1]}n/"
              f"{train_ds.arrays['edge_src'].shape[1]}e")
    t_start = None
    with span("train_loop", steps=cfg.num_steps, bucket=bucket):
        for step in range(cfg.num_steps):
            batch = batch_to_device(train_ds.arrays, schedule[step], dev)
            state, loss, aux = train_step(state, batch, dropout_gen)
            if step == 0:
                _sync(dev)  # step 0 pays the set-up: excluded from steps/s
                t_start = time.perf_counter()
            if step % cfg.eval_every == 0 or step == cfg.num_steps - 1:
                entry = {"step": step, "loss": float(loss)}
                history.append(entry)
                if log:
                    log(f"step {step}: loss={entry['loss']:.4f} "
                        + " ".join(f"{k}={float(v):.4f}" for k, v in aux.items()))
        _sync(dev)
    elapsed = time.perf_counter() - (t_start or time.perf_counter())
    steps_per_sec = ((cfg.num_steps - 1) / elapsed
                     if elapsed > 0 and cfg.num_steps > 1 else 0.0)
    metrics = evaluate(make_eval_fn(state.model),
                       eval_ds if eval_ds is not None else train_ds,
                       cfg.batch_size)
    return TrainResult(state=state, metrics=metrics,
                       steps_per_sec=steps_per_sec, history=history)
