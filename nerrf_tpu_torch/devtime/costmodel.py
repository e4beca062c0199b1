"""Unified per-program cost model: FLOPs / bytes / HBM floor per program.

The port of ``nerrf_tpu/devtime/costmodel.py``.  `program_costs()`
resolves an analytic cost for every serve bucket program (at the exact
shapes `serve.service.warmup_batches` warms — the admission-reachable
set) and for the train step.  The FLOP numerator of record is the
analytic count (`bench.flops`): FlopCounterMode over one call on ``meta``
tensors, a meta copy of the model (`meta_model`) and meta copies of the
inputs (`bench.flops.shaped`).  Nothing runs on a device and no kernel
launches; the ops take their plain versions' shape logic on meta.

* the serve program is `pipeline.make_eval_fn`'s forward (`serve_forward`:
  ``inference_mode``, the model's outputs in float32) at a bucket's
  shape-donor batch;
* the train step is `train.loop.make_loss_fn`'s forward, its backward and
  the global-norm clip at ``min(batch_size, n)`` windows of the dataset's
  shapes (`train_step`).  The AdamW update issues no matmul; its state is
  in the byte floor.

Costs are memoized in the process by (program, architecture, argument
shapes): the trace of a full-width program takes seconds of host.

Bytes are an analytic floor, not a measurement: what the program reads
once and writes once.  Serve: the model's state dict (parameters and
buffers: everything the forward reads) + the whole donor batch + the
float32 outputs.  Train: the state dict, the two AdamW moments a
parameter and the batch in; the parameters, the moments, the loss and
its three parts out.  Intermediates and re-reads are invisible to a
shape-level trace, so the derived arithmetic intensity is an UPPER bound.

Two counts differ from the reference's at equal shapes, each for a
reason the port keeps (the tests pin both):

* the train step issues one recurrent product fewer a BiLSTM layer: the
  reference's scan transpose takes the carry's cotangent through all T
  steps, into the zero initial state too, while autograd stops at the
  initial state, which needs no gradient (one ``[2, R, 4H] × [2, 4H, H]``
  product a layer);
* the byte floor reads each LSTM cell's ``bias_ih``, a zero buffer that
  keeps PyTorch's LSTM layout (the reference has no input-side bias).

The reference's XLA ``cost_analysis`` cross-check becomes one real call
on the card under ``torch.profiler(with_flops=True)`` (`bench.flops.
profiler_flops`): opt-in (``cross_check=True``), None off the card,
recorded in ``profiler_flops``/``profiler_device_sec``, never the MFU
numerator.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from nerrf_tpu_torch.bench.flops import profiler_flops, shaped, traced


@dataclasses.dataclass(frozen=True)
class ProgramCost:
    """One program's analytic cost at one call signature."""

    program: str                 # "serve_eval[<bucket>]" / "train_step"
    flops: float                 # analytic matmul/conv FLOPs per call
    bytes_accessed: float        # analytic floor: read once + written once
    peak_hbm_bytes: float        # residency floor: the same bytes
    batch_slots: Optional[int] = None   # padded windows per call (serve)
    # the profiler cross-check (None unless cross_check=True ran on the
    # card): PyTorch's FLOP count of one real call and that call's kernel
    # seconds — recorded, never the MFU numerator
    profiler_flops: Optional[float] = None
    profiler_device_sec: Optional[float] = None

    @property
    def intensity_flops_per_byte(self) -> Optional[float]:
        """Ceiling arithmetic intensity (analytic flops over the byte
        floor) — compare against `ChipPeaks.ridge_flops_per_byte`."""
        if self.bytes_accessed <= 0:
            return None
        return self.flops / self.bytes_accessed

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        i = self.intensity_flops_per_byte
        d["intensity_flops_per_byte"] = round(i, 2) if i else None
        return d


def tree_bytes(tree) -> float:
    """Bytes of the arrays and tensors of a (dict/list/tuple) tree; a
    module counts its state dict (parameters and buffers)."""
    if isinstance(tree, nn.Module):
        return tree_bytes(list(tree.state_dict().values()))
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return float(tree.numel() * tree.element_size())
    if isinstance(tree, np.ndarray):
        return float(tree.size * tree.itemsize)
    return 0.0


def meta_model(model: nn.Module) -> nn.Module:
    """``model``'s architecture on ``meta``, in its train/eval mode: a new
    module built from ``model.cfg`` (no weight is copied, whatever device
    ``model`` lies on), or ``model`` itself when it is already on meta."""
    if all(p.device.type == "meta" for p in model.parameters()):
        return model
    meta = type(model)(model.cfg).to("meta")
    return meta.train(model.training)


def _on_device(tree, device):
    """Arrays of a tree as tensors on ``device`` (for a real call)."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def program_cost(fn, *args, program: str,
                 batch_slots: Optional[int] = None) -> Optional[ProgramCost]:
    """Cost one call of ``fn`` at these argument shapes (shape-level
    trace): modules become `meta_model` copies, arrays and tensors meta
    tensors.  Returns None when the counter sees no matmul or the trace
    fails — null, never a fabricated number."""
    try:
        meta_args = tuple(meta_model(a) if isinstance(a, nn.Module)
                          else shaped(a) for a in args)
        flops, out = traced(fn, *meta_args)
    except Exception:  # noqa: BLE001 — a cost model must degrade to null
        return None
    if not flops:
        return None
    byts = tree_bytes(meta_args) + tree_bytes(out)
    return ProgramCost(
        program=program, flops=flops, bytes_accessed=byts,
        peak_hbm_bytes=byts, batch_slots=batch_slots)


def serve_forward(model: nn.Module, batch: Dict[str, torch.Tensor]):
    """The serve program: `pipeline.make_eval_fn`'s forward on tensors
    (its copies to and from the host left out)."""
    from nerrf_tpu_torch.pipeline import MODEL_INPUTS

    with torch.inference_mode():
        out = model(*(batch[k] for k in MODEL_INPUTS))
        return {k: v.float() for k, v in out.items()}


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


# memoized analytic costs by (program, architecture, argument shapes): a
# cost depends on nothing else, and the meta trace of a full-width program
# takes seconds of host (serve's cost thread, ``profile costs`` and every
# ``train_nerrfnet`` call would repeat it).  The cross-check is never kept
_COSTS: Dict[tuple, ProgramCost] = {}
_COSTS_LOCK = threading.Lock()


def _shapes(tree) -> tuple:
    return tuple((k, tuple(v.shape), str(v.dtype)) for k, v in sorted(tree.items()))


def _memoized(key: tuple, compute) -> Optional[ProgramCost]:
    with _COSTS_LOCK:
        hit = _COSTS.get(key)
    if hit is not None:
        return hit
    cost = compute()
    if cost is not None:
        with _COSTS_LOCK:
            if len(_COSTS) >= 256:
                _COSTS.clear()
            _COSTS[key] = cost
    return cost


def _checked(cost: Optional[ProgramCost], fn, run_args) -> Optional[ProgramCost]:
    """``cost`` with the profiler cross-check of one real call of
    ``fn(*run_args)`` (no check when ``run_args`` is None)."""
    if cost is None or run_args is None:
        return cost
    pf, pd = profiler_flops(fn, *run_args)
    return dataclasses.replace(cost, profiler_flops=pf, profiler_device_sec=pd)


def serve_cost(model: nn.Module, batch: Dict[str, np.ndarray], tag: str,
               run_args: Optional[tuple] = None) -> Optional[ProgramCost]:
    """The serve program's cost at one bucket's padded ``batch`` (memoized;
    ``model`` may lie anywhere, its meta copy is built only to trace)."""
    slots = int(next(iter(batch.values())).shape[0])
    cost = _memoized(
        ("serve_eval", repr(model.cfg), _shapes(batch)),
        lambda: program_cost(serve_forward, meta_model(model).eval(), batch,
                             program=f"serve_eval[{tag}]", batch_slots=slots))
    return _checked(cost, serve_forward, run_args)


def serve_program_costs(model: nn.Module, cfg,
                        cross_check: bool = False) -> Dict[str, ProgramCost]:
    """``bucket tag → ProgramCost`` for every warmed serve program, at the
    exact shape-donor batches `warmup_batches` yields — the same shapes
    admission can ever produce.  The cross-check runs ``model`` itself when
    it lies on the card."""
    from nerrf_tpu_torch.serve.service import warmup_batches

    dev = _device_of(model)
    out: Dict[str, ProgramCost] = {}
    for _bucket, tag, batch in warmup_batches(cfg):
        run_args = ((model, _on_device(batch, dev))
                    if cross_check and dev.type == "cuda" else None)
        cost = serve_cost(model, batch, tag, run_args=run_args)
        if cost is not None:
            out[tag] = cost
    return out


def train_step(train_cfg):
    """The train program over ``(model, moments, batch)``: `make_loss_fn`'s
    forward, the backward and the global-norm clip; returns what the step
    writes (parameters, AdamW moments, the loss and its parts)."""
    from nerrf_tpu_torch.train.loop import clip_by_global_norm_, make_loss_fn

    def step(model, moments, batch):
        with torch.inference_mode(False), torch.enable_grad():
            loss, aux = make_loss_fn(model, train_cfg)(batch)
            loss.backward()
        params = [p for p in model.parameters() if p.requires_grad]
        clip_by_global_norm_([p.grad if p.grad is not None
                              else torch.zeros_like(p) for p in params], 1.0)
        return (params, moments, loss.detach(),
                {k: v.detach() for k, v in aux.items()})

    return step


def train_step_cost(model: nn.Module, train_cfg, arrays,
                    cross_check: bool = False) -> Optional[ProgramCost]:
    """Analytic cost of ONE train step at these dataset shapes (memoized):
    the first ``min(batch_size, n)`` windows of ``arrays`` (shapes only), on
    a meta copy of ``model`` in training mode (dropout off: it issues no
    matmul).  The cross-check runs one real step of a fresh model on
    ``model``'s card, its optimizer state zeros."""
    try:
        n = int(next(iter(arrays.values())).shape[0])
        b = min(train_cfg.batch_size, n)
        batch = shaped({k: v[:b] for k, v in arrays.items()})

        def compute():
            meta = meta_model(model).train()
            moments = [torch.empty_like(p) for p in meta.parameters()
                       if p.requires_grad for _ in range(2)]
            return program_cost(train_step(train_cfg), meta, moments, batch,
                                program="train_step", batch_slots=b)

        cost = _memoized(("train_step", repr(model.cfg), _shapes(batch)), compute)
        run_args = None
        dev = _device_of(model)
        if cost is not None and cross_check and dev.type == "cuda":
            real = type(model)(model.cfg).to(dev).train()
            real_moments = [torch.zeros_like(p) for p in real.parameters()
                            if p.requires_grad for _ in range(2)]
            real_batch = _on_device({k: v[:b] for k, v in arrays.items()},
                                    dev)
            run_args = (real, real_moments, real_batch)
        return _checked(cost, train_step(train_cfg), run_args)
    except Exception:  # noqa: BLE001 — a cost model must degrade to null
        return None


def program_costs(model: nn.Module, serve_cfg, train_cfg=None, arrays=None,
                  cross_check: bool = False) -> Dict[str, ProgramCost]:
    """The unified cost surface: ``program name → ProgramCost`` for every
    serve bucket program plus (when the training pieces are given) the
    train step."""
    out = {c.program: c for c in serve_program_costs(
        model, serve_cfg, cross_check=cross_check).values()}
    if train_cfg is not None and arrays is not None:
        tc = train_step_cost(model, train_cfg, arrays,
                             cross_check=cross_check)
        if tc is not None:
            out[tc.program] = tc
    return out
