"""Model FLOPs of one call, counted at logical shapes, for MFU of record.

The port of ``nerrf_tpu/bench/flops.py``.  The reference walks the jaxpr
and counts every ``dot_general``/``conv_general_dilated`` at its logical
shape (2·M·N·K per dot), scan bodies times their trip count.  The port
runs the call once under ``torch.utils.flop_counter.FlopCounterMode`` on
``meta`` tensors: the same convention (matmuls and convolutions at logical
shapes, elementwise work ignored, every product the program issues
counted, the LSTM's time loop once a step), with no device work and no
kernel launch — a meta tensor holds no data, and the ops take their plain
versions' shape logic on it (``ops.segment``).

The port's hand-written kernels count 0: their work is sums and copies
(segment sums, gathers, the SAGE aggregation), not matmuls.  The
reference's Pallas segment sum is a one-hot ``dot_general`` inside the
kernel body (``pallas_segment.py``), so a count of the reference with its
Pallas route registered holds matmuls the port does not issue: compare
against the reference's plain route only.

`profiler_flops` is the recorded cross-check (the counterpart of the
reference's XLA ``cost_analysis``): one real call on the card under
``torch.profiler(with_flops=True)``, never the MFU numerator.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode


def traced(fn, *args, **kwargs) -> Tuple[float, Any]:
    """``(FLOPs, outputs)`` of one call of ``fn`` under FlopCounterMode.
    Raises what the call raises."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return float(counter.get_total_flops()), out


def analytic_flops(fn, *args, **kwargs) -> Optional[float]:
    """Matmul/conv FLOPs of one call of ``fn`` on these (meta) arguments,
    or None when the count is 0 or the call fails."""
    try:
        flops, _ = traced(fn, *args, **kwargs)
    except Exception:  # noqa: BLE001 — a count must degrade to null
        return None
    return flops or None


def _meta_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, dtype=x.dtype)).dtype


def shaped(tree: Any):
    """Map the arrays and tensors of a (dict/list/tuple) tree to ``meta``
    tensors of the same shapes and dtypes: host-cheap tracing arguments.
    Anything else passes through."""
    if isinstance(tree, dict):
        return {k: shaped(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shaped(v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return torch.empty(tuple(tree.shape), dtype=_meta_dtype(tree),
                           device="meta")
    return tree


def profiler_flops(fn, *args, **kwargs
                   ) -> Tuple[Optional[float], Optional[float]]:
    """``(FLOPs, device seconds)`` of one real call of ``fn`` on the card,
    from ``torch.profiler(with_flops=True)``: PyTorch's own count of its
    matmul ops, and the call's kernel time summed.  ``(None, None)``
    without CUDA, or when the profiler records nothing: the cross-check is
    optional evidence, never a reason to fail a cost."""
    if not torch.cuda.is_available():
        return None, None
    try:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            fn(*args, **kwargs)
            torch.cuda.synchronize()
        events = prof.key_averages()
        flops = float(sum(e.flops or 0 for e in events)) or None
        device_us = float(sum(
            getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0)) or 0
            for e in events))
        return flops, (device_us * 1e-6 if device_us > 0 else None)
    except Exception:  # noqa: BLE001 — cross-check is best-effort
        return None, None
