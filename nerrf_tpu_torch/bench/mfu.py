"""Card peaks for MFU.

The port of ``nerrf_tpu/bench/mfu.py``.  The MFU numerator of record is
the analytic count (`bench.flops.analytic_flops`, FlopCounterMode over
meta tensors); the counterpart of the reference's ``flops_per_step`` (its
XLA cross-check) is `bench.flops.profiler_flops`, PyTorch's profiler count
of one real call on the card.  `chip_peak_tflops` comes from the one peak
table (`devtime.peaks`).
"""

from __future__ import annotations

from typing import Optional

from nerrf_tpu_torch.devtime.peaks import chip_peak_tflops  # noqa: F401  (re-export)


def mfu(flops: Optional[float], steps_per_sec: float,
        device) -> tuple[Optional[float], Optional[float]]:
    """(achieved_tflops, mfu_pct) — None when flops or peak are unknown."""
    if not flops:
        return None, None
    achieved = flops * steps_per_sec / 1e12
    peak = chip_peak_tflops(device)
    return achieved, (100.0 * achieved / peak if peak else None)
