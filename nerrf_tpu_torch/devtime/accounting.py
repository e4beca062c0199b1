"""Live device-efficiency accounting: MFU, utilization, useful-FLOPs.

The port of ``nerrf_tpu/devtime/accounting.py``, the same but for
`default_peaks` (the current CUDA device's row) and the model that
`train_efficiency_gauges` takes (a ``NerrfNet``, whose weights do not
matter: the cost is a shape trace).

`DeviceTimeAccountant` sits on the serve scorer's device boundary (the
same ``t_device → t_scored`` span the SLO plane stamps) and combines the
measured per-batch device seconds with the analytic cost model
(`devtime.costmodel`) into the operator-facing efficiency gauges:

  * ``nerrf_device_mfu{program}`` — trailing achieved FLOP/s over the
    chip's bf16 peak, as a 0–1 fraction.  The numerator is the analytic
    per-call FLOP count × calls in the trailing window; the denominator
    is wall device-seconds × `ChipPeaks.tflops_bf16`.  Chip-relative, so
    it is ABSENT (never fabricated) when the platform has no published
    peak — a CPU rig exports no MFU at all;
  * ``nerrf_device_util_fraction`` — fraction of trailing wall time the
    device spent inside scoring calls (platform-independent: pure
    measured seconds);
  * ``nerrf_device_useful_flops_fraction{bucket}`` — how much of the
    padded compute carried real data: batch-slot occupancy × real-node
    density (static shapes make a padded slot cost exactly a real one,
    so this is the padding-discount joining the training loop's
    ``train_padding_waste_fraction`` gauges);
  * ``nerrf_device_roofline_intensity{program}`` — the program's ceiling
    arithmetic intensity (FLOPs per byte floor, static per program) next
    to ``nerrf_device_roofline_ridge`` (chip peak FLOPs/byte, only when
    peaks are known): intensity below the ridge reads bandwidth-bound;
  * ``nerrf_capacity_headroom_streams`` — the `devtime.headroom`
    prediction over the observed arrival mix, recomputed on a cadence,
    with a ``capacity_saturation`` journal record the first time the
    prediction drops under the margin — evidence BEFORE the batcher
    starts shedding.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from nerrf_tpu_torch.devtime.costmodel import ProgramCost
from nerrf_tpu_torch.devtime.headroom import HeadroomEstimate, HeadroomTracker
from nerrf_tpu_torch.devtime.peaks import ChipPeaks, chip_peaks


def default_peaks() -> Optional[ChipPeaks]:
    """Peaks of the current CUDA device — None without CUDA or for a card
    with no row (every chip-relative gauge then stays absent)."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        return chip_peaks(torch.device("cuda", torch.cuda.current_device()))
    except Exception:  # noqa: BLE001 — no device → no chip numbers
        return None


class DeviceTimeAccountant:
    """Trailing-window device-efficiency accounting + registry export."""

    def __init__(self, registry=None, journal=None,
                 peaks: Optional[ChipPeaks] = "auto",
                 window_sec: float = 60.0,
                 headroom_update_sec: float = 2.0,
                 saturation_margin_streams: float = 1.0,
                 saturation_cooldown_sec: float = 60.0) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        if journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            journal = DEFAULT_JOURNAL
        self._reg = registry
        self._journal = journal
        self.peaks = default_peaks() if peaks == "auto" else peaks
        self.window_sec = max(float(window_sec), 1e-3)
        self._lock = threading.Lock()
        # per-program trailing (t, device_sec) + static costs
        self._calls: Dict[str, deque] = {}
        self._costs: Dict[str, ProgramCost] = {}
        # when accounting started: the utilization denominator is wall
        # time (clamped to the window), not the retained entries' extent
        # — a single fresh call must not read util=1.0
        self._t_first: Optional[float] = None
        # per-bucket trailing useful-fraction samples (t, fraction)
        self._useful: Dict[str, deque] = {}
        self.headroom = HeadroomTracker(window_sec=self.window_sec)
        self._headroom_update_sec = headroom_update_sec
        self._saturation_margin = saturation_margin_streams
        self._saturation_cooldown = saturation_cooldown_sec
        self._last_headroom_t = 0.0
        self._last_saturation_t: Optional[float] = None
        self.last_estimate: Optional[HeadroomEstimate] = None
        if self.peaks is not None:
            self._reg.gauge_set(
                "device_roofline_ridge", self.peaks.ridge_flops_per_byte,
                help="chip roofline ridge point (peak FLOPs per peak HBM "
                     "byte): program intensity below it reads "
                     "bandwidth-bound")

    # -- cost registration ----------------------------------------------------

    def register_cost(self, program: str, cost: ProgramCost) -> None:
        """Bind a program's analytic cost (from `devtime.costmodel`); the
        roofline intensity gauge is static per program, so it exports
        here, once."""
        with self._lock:
            self._costs[program] = cost
        intensity = cost.intensity_flops_per_byte
        if intensity:
            self._reg.gauge_set(
                "device_roofline_intensity", intensity,
                labels={"program": program},
                help="ceiling arithmetic intensity (analytic FLOPs over "
                     "the params+inputs+outputs byte floor) per program")

    # -- hot-path intake ------------------------------------------------------

    def observe_admit(self, stream: str, tag: str) -> None:
        self.headroom.observe_admit(stream, tag)

    def observe_batch(self, program: str, tag: str, device_sec: float,
                      occupancy: int, slots: int,
                      real_density: Optional[float] = None) -> None:
        """One device scoring call: measured seconds + what filled it.
        ``real_density`` is the mean real-node fraction over the batch's
        OCCUPIED slots (None when the caller didn't measure it)."""
        now = time.monotonic()
        device_sec = max(float(device_sec), 0.0)
        with self._lock:
            if self._t_first is None:
                self._t_first = now
            dq = self._calls.setdefault(program, deque())
            dq.append((now, device_sec))
            self._evict(dq, now)
            window = list(dq)
            cost = self._costs.get(program)
            useful = None
            if slots > 0:
                useful = (occupancy / slots) * (
                    real_density if real_density is not None else 1.0)
                uq = self._useful.setdefault(tag, deque())
                uq.append((now, useful))
                self._evict(uq, now)
                useful = sum(u for _, u in uq) / len(uq)
            util = self._util_locked(now)
        self.headroom.observe_batch(tag, device_sec, occupancy)
        self._reg.gauge_set(
            "device_util_fraction", util,
            help="fraction of trailing wall time the device spent inside "
                 "scoring/step calls (measured seconds, platform-free)")
        if useful is not None:
            self._reg.gauge_set(
                "device_useful_flops_fraction", useful,
                labels={"bucket": tag},
                help="fraction of the padded batch compute carrying real "
                     "data (slot occupancy x real-node density) — the "
                     "padding discount on every FLOP spent at this bucket")
        if self.peaks is not None and cost is not None and window:
            busy = sum(d for _, d in window)
            if busy > 0:
                achieved = cost.flops * len(window) / busy  # FLOP/s
                self._reg.gauge_set(
                    "device_mfu", achieved / (self.peaks.tflops_bf16 * 1e12),
                    labels={"program": program},
                    help="trailing model-FLOPs utilization (analytic "
                         "FLOPs/s over the chip bf16 peak, 0-1); absent "
                         "on platforms with no published peak")
        self._maybe_update_headroom(now)

    def _evict(self, dq: deque, now: float) -> None:
        lo = now - self.window_sec
        while dq and dq[0][0] < lo:
            dq.popleft()

    def _util_locked(self, now: float) -> float:
        # evict EVERY program's aged entries first: a program that simply
        # stopped being scored must not keep its stale busy-seconds in
        # the sum forever (the per-observe eviction only touches the
        # program being observed — after a traffic shift or lull the
        # others would otherwise overstate utilization indefinitely)
        busy = 0.0
        for dq in self._calls.values():
            self._evict(dq, now)
            busy += sum(d for _t, d in dq)
        if self._t_first is None:
            return 0.0
        # denominator: wall time since accounting started, clamped to the
        # trailing window — NOT the retained entries' extent (one fresh
        # instantaneous call would divide by ~0 and read 1.0)
        span = min(max(now - self._t_first, 1e-3), self.window_sec)
        return min(busy / span, 1.0)

    # -- headroom export ------------------------------------------------------

    def _maybe_update_headroom(self, now: float) -> None:
        with self._lock:
            if now - self._last_headroom_t < self._headroom_update_sec:
                return
            self._last_headroom_t = now
        est = self.headroom.estimate(now)
        self.last_estimate = est
        if est is None:
            return  # degenerate traffic: the gauge keeps its last value
        self._reg.gauge_set(
            "capacity_headroom_streams", est.headroom_streams,
            help="predicted additional average streams this device absorbs "
                 "before saturating (observed arrival mix x measured "
                 "per-bucket device cost; docs/device-efficiency.md)")
        if est.headroom_streams < self._saturation_margin:
            with self._lock:
                last = self._last_saturation_t
                if last is not None and \
                        now - last < self._saturation_cooldown:
                    return
                self._last_saturation_t = now
            self._journal.record(
                "capacity_saturation",
                **est.to_dict(),
                margin_streams=self._saturation_margin)

    # -- reading --------------------------------------------------------------

    def snapshot(self) -> dict:
        """Per-program trailing efficiency — the serve bench's ``devtime``
        artifact block.  Chip-relative fields are None off-chip."""
        now = time.monotonic()
        with self._lock:
            programs = {}
            for program, dq in self._calls.items():
                window = [(t, d) for t, d in dq if t >= now - self.window_sec]
                busy = sum(d for _, d in window)
                cost = self._costs.get(program)
                mfu = None
                if self.peaks is not None and cost is not None and busy > 0:
                    mfu = (cost.flops * len(window) / busy
                           / (self.peaks.tflops_bf16 * 1e12))
                programs[program] = {
                    "calls": len(window),
                    "device_seconds": round(busy, 4),
                    "flops_per_call": cost.flops if cost else None,
                    "intensity_flops_per_byte":
                        (round(cost.intensity_flops_per_byte, 2)
                         if cost and cost.intensity_flops_per_byte
                         else None),
                    "mfu": round(mfu, 6) if mfu is not None else None,
                }
            useful = {}
            for tag, uq in self._useful.items():
                # same trailing filter the programs block applies: a
                # bucket last scored an hour ago reports nothing, not its
                # long-dead samples
                vals = [u for t, u in uq if t >= now - self.window_sec]
                if vals:
                    useful[tag] = round(sum(vals) / len(vals), 4)
            util = self._util_locked(now)
        return {
            "platform_peaks": ({
                "kind": self.peaks.kind,
                "tflops_bf16": self.peaks.tflops_bf16,
                "hbm_gbps": self.peaks.hbm_gbps,
                "ridge_flops_per_byte":
                    round(self.peaks.ridge_flops_per_byte, 1),
            } if self.peaks is not None else None),
            "util_fraction": round(util, 4),
            "programs": programs,
            "useful_flops_fraction": useful,
            "headroom": (self.last_estimate.to_dict()
                         if self.last_estimate is not None else None),
        }


def train_efficiency_gauges(model, train_cfg, arrays, steps_per_sec: float,
                            registry=None) -> Optional[dict]:
    """Train-loop face of the plane: analytic step cost × measured
    steps/s → MFU + roofline gauges for ``program="train_step"``.
    Chip-relative gauges stay absent off-chip (returns what it set, for
    logging).  Best-effort by contract — a cost-model failure must never
    cost a training run."""
    if registry is None:
        from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

        registry = DEFAULT_REGISTRY
    try:
        from nerrf_tpu_torch.devtime.costmodel import train_step_cost

        cost = train_step_cost(model, train_cfg, arrays)
        if cost is None or steps_per_sec <= 0:
            return None
        out = {"flops_per_step": cost.flops}
        intensity = cost.intensity_flops_per_byte
        if intensity:
            registry.gauge_set(
                "device_roofline_intensity", intensity,
                labels={"program": "train_step"},
                help="ceiling arithmetic intensity (analytic FLOPs over "
                     "the params+inputs+outputs byte floor) per program")
            out["intensity_flops_per_byte"] = round(intensity, 2)
        peaks = default_peaks()
        if peaks is not None:
            mfu = cost.flops * steps_per_sec / (peaks.tflops_bf16 * 1e12)
            registry.gauge_set(
                "device_mfu", mfu, labels={"program": "train_step"},
                help="trailing model-FLOPs utilization (analytic FLOPs/s "
                     "over the chip bf16 peak, 0-1); absent on platforms "
                     "with no published peak")
            out["mfu"] = round(mfu, 6)
        return out
    except Exception:  # noqa: BLE001 — advisory gauges only
        return None
