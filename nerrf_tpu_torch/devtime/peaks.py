"""Per-card peaks: the one table every card-relative number reads.

The port of ``nerrf_tpu/devtime/peaks.py``.  The MFU gauges, ``profile
costs`` and ``chip_smoke.py``'s roofline bounds all divide by this table,
so a kernel's bound and the program's MFU share one peak.  Resolution is
the reference's: **exact match first** on the lowercased name
``torch.cuda.get_device_name()`` returns, then the longest table key
contained in the name (a decorated name still lands on its row, never on
a shorter one), with bandwidth beside compute so the roofline gauge has a
ridge point.

The rows are NVIDIA's public data sheet for the H100 Tensor Core GPU
(dense rates, without sparsity; the bf16 rate is half the sheet's sparse
figure): the SXM5 part (80 GB HBM3), the PCIe part and the NVL part.  The
reference's TPU rows are not copied: the port states no figure for a TPU.
The rates assume the card's full power limit; a card set below it runs
slower under load, which is why every measured number stands beside the
limit ``nvidia-smi`` reports.

Null-not-fake: anything unrecognized (the CPU, ``meta``, a card without a
row) resolves to ``None``, never a guessed peak.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    """Public per-card peaks (bf16 matmul compute + HBM bandwidth)."""

    kind: str                # canonical table key, lowercase
    tflops_bf16: float       # peak dense bf16 TFLOP/s (tensor cores)
    hbm_gbps: float          # peak HBM bandwidth, GB/s
    # peak float32 TFLOP/s outside the tensor cores: the bound of a kernel
    # whose operations are f32 sums on the CUDA cores
    tflops_f32: Optional[float] = None

    @property
    def ridge_flops_per_byte(self) -> float:
        """Roofline ridge point: programs below this arithmetic intensity
        are bandwidth-bound at peak, above it compute-bound."""
        return self.tflops_bf16 * 1e12 / (self.hbm_gbps * 1e9)


# Exact names as torch.cuda.get_device_name() returns them (lowercased for
# lookup).  Source: NVIDIA H100 Tensor Core GPU data sheet.
CHIP_TABLE = {
    "nvidia h100 80gb hbm3": ChipPeaks("nvidia h100 80gb hbm3", 989.4,
                                       3350.0, 67.0),
    "nvidia h100 pcie": ChipPeaks("nvidia h100 pcie", 756.0, 2000.0, 51.0),
    "nvidia h100 nvl": ChipPeaks("nvidia h100 nvl", 835.0, 3900.0, 60.0),
}


def resolve_kind(device_kind: str) -> Optional[ChipPeaks]:
    """Exact-match-first resolution of a card's name.

    1. exact match on the lowercased name;
    2. else the LONGEST table key contained in the name, regardless of
       dict order.
    """
    kind = (device_kind or "").strip().lower()
    if not kind:
        return None
    hit = CHIP_TABLE.get(kind)
    if hit is not None:
        return hit
    best = None
    for key, peaks in CHIP_TABLE.items():
        if key in kind and (best is None or len(key) > len(best[0])):
            best = (key, peaks)
    return best[1] if best else None


def chip_peaks(device) -> Optional[ChipPeaks]:
    """Peaks for a ``torch.device`` (or a card's name).  ``None`` for the
    CPU, ``meta`` and any card without a row: callers treat that as "no
    card-relative number", never substitute a default.  A CUDA device's
    name is read only when CUDA is available."""
    if isinstance(device, str):
        if device in ("cpu", "meta") or device.startswith("cuda"):
            device = _torch_device(device)
        else:
            return resolve_kind(device)
    if getattr(device, "type", None) != "cuda":
        return None
    import torch

    if not torch.cuda.is_available():
        return None
    return resolve_kind(torch.cuda.get_device_name(device))


def _torch_device(spec: str):
    import torch

    return torch.device(spec)


def chip_peak_tflops(device) -> Optional[float]:
    """bf16 peak for a device (or a card's name), or None when unknown."""
    peaks = chip_peaks(device)
    return peaks.tflops_bf16 if peaks else None
