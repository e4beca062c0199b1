"""Device-efficiency plane: the port of ``nerrf_tpu/devtime``.

Continuous device-time truth for every program the port runs: a unified
analytic cost model (`costmodel.program_costs` — FLOPs/bytes/HBM floor
per serve bucket program and the train step, counted on ``meta`` tensors,
torch.profiler's count recorded only as cross-check), live MFU /
utilization / useful-FLOPs accounting on the scorer's device boundary
(`accounting`), a capacity headroom predictor over the observed arrival
mix (`headroom`), and a fail-open torch.profiler capture plane
(`capture`) the flight recorder and ``profile`` drive.  Card-relative
numbers are null-not-fake: no published peak, no MFU.

Exports resolve lazily (PEP 562): `peaks`, `headroom` and `capture`
import no torch, and eager package imports would drag `costmodel` →
torch into every consumer — the offline ``doctor`` imports
`devtime.capture.trace_summary` and must stay light on a host where
touching the device stack is unwanted.
"""

_EXPORTS = {
    "CHIP_TABLE": "peaks",
    "ChipPeaks": "peaks",
    "chip_peak_tflops": "peaks",
    "chip_peaks": "peaks",
    "resolve_kind": "peaks",
    "HeadroomEstimate": "headroom",
    "HeadroomTracker": "headroom",
    "predict_headroom": "headroom",
    "capture_trace": "capture",
    "profiled": "capture",
    "trace_summary": "capture",
    "ProgramCost": "costmodel",
    "program_cost": "costmodel",
    "program_costs": "costmodel",
    "serve_program_costs": "costmodel",
    "train_step_cost": "costmodel",
    "DeviceTimeAccountant": "accounting",
    "default_peaks": "accounting",
    "train_efficiency_gauges": "accounting",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'nerrf_tpu_torch.devtime' has no attribute {name!r}")
    import importlib

    return getattr(
        importlib.import_module(f"nerrf_tpu_torch.devtime.{module}"), name)


def __dir__():
    return __all__
