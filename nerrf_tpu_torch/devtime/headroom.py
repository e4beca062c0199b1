"""Capacity headroom: how many more streams fit before the device saturates.

A host copy of ``nerrf_tpu/devtime/headroom.py``, kept identical.

The admission plane already sheds load when it must (drop-oldest,
quarantine, deadline close); this module answers the question operators
need BEFORE that happens: at the observed per-stream arrival rates and
the measured per-bucket device cost, how many more average streams does
this device absorb?  Exported as ``nerrf_capacity_headroom_streams`` and
journaled as a ``capacity_saturation`` record when the prediction says
the next stream would not fit — evidence *ahead* of the first drop burst.

The math is deliberately first-order queue-free utilization accounting:

    util               = Σ_streams  rate_s · Σ_buckets mix_s[b] · cost[b]
    mean_demand        = util / num_streams          (device-sec per sec,
                                                      per average stream)
    headroom_streams   = (1 − util) / mean_demand
    saturation_streams = num_streams + headroom      (= 1/mean_demand for
                                                      a homogeneous mix)

Per-window cost is MEASURED under the live occupancy (total device-busy
seconds / windows scored, per bucket), so batching efficiency is already
inside ``cost[b]`` — the prediction extrapolates the current operating
point, it does not model the occupancy curve.  That makes it honest near
the current load and a band estimate far from it, which is exactly what
the serve bench's ramp leg gates (prediction within a band of measured
saturation).

Degenerate cases return ``None`` — zero traffic, unknown buckets, no
measured cost — never a fabricated number (same null-not-fake contract
as the MFU plane).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class HeadroomEstimate:
    """One headroom prediction at one instant."""

    streams: int                      # streams observed arriving
    util: float                       # predicted device-busy fraction
    mean_stream_demand: float         # device-sec/sec per average stream
    headroom_streams: float           # additional average streams that fit
    saturation_streams: float         # streams + headroom
    per_bucket_util: Dict[str, float]

    def to_dict(self) -> dict:
        return {
            "streams": self.streams,
            "util": round(self.util, 4),
            "mean_stream_demand": round(self.mean_stream_demand, 6),
            "headroom_streams": round(self.headroom_streams, 2),
            "saturation_streams": round(self.saturation_streams, 2),
            "per_bucket_util": {k: round(v, 4)
                                for k, v in sorted(self.per_bucket_util
                                                   .items())},
        }


def predict_headroom(
        stream_rates: Dict[str, float],
        stream_mix: Dict[str, Dict[str, float]],
        cost_per_window: Dict[str, float]) -> Optional[HeadroomEstimate]:
    """Pure headroom math (the unit-testable core).

    ``stream_rates``: stream → windows/sec arriving.
    ``stream_mix``:   stream → {bucket tag → fraction of its windows}.
    ``cost_per_window``: bucket tag → measured device-seconds per window.

    Returns None (never a fake number) when there is no traffic, when a
    stream's windows land in a bucket with no measured cost (unknown
    bucket), or when any input is degenerate.
    """
    streams = [s for s, r in stream_rates.items() if r > 0]
    if not streams:
        return None
    util = 0.0
    per_bucket: Dict[str, float] = {}
    for s in streams:
        mix = stream_mix.get(s)
        if not mix:
            return None
        for tag, frac in mix.items():
            if frac <= 0:
                continue
            cost = cost_per_window.get(tag)
            if cost is None or cost <= 0:
                return None  # unknown bucket: no honest prediction
            u = stream_rates[s] * frac * cost
            util += u
            per_bucket[tag] = per_bucket.get(tag, 0.0) + u
    if util <= 0:
        return None
    mean_demand = util / len(streams)
    headroom = (1.0 - util) / mean_demand
    return HeadroomEstimate(
        streams=len(streams), util=util, mean_stream_demand=mean_demand,
        headroom_streams=headroom,
        saturation_streams=len(streams) + headroom,
        per_bucket_util=per_bucket)


class HeadroomTracker:
    """Windowed arrival/cost observer feeding `predict_headroom`.

    Fed from the serve hot path (an admit record per window, a device
    record per batch) and read on a cadence; all state is trailing
    (``window_sec``), so the estimate follows the live traffic mix, not
    the pod's whole history."""

    def __init__(self, window_sec: float = 60.0) -> None:
        self.window_sec = max(float(window_sec), 1e-3)
        self._lock = threading.Lock()
        self._admits: deque = deque()     # (t, stream, tag)
        self._batches: deque = deque()    # (t, tag, device_sec, windows)

    def observe_admit(self, stream: str, tag: str,
                      t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else t
        with self._lock:
            self._admits.append((t, stream, tag))
            self._evict(t)

    def observe_batch(self, tag: str, device_sec: float, windows: int,
                      t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else t
        with self._lock:
            self._batches.append((t, tag, float(device_sec), int(windows)))
            self._evict(t)

    def _evict(self, now: float) -> None:
        lo = now - self.window_sec
        while self._admits and self._admits[0][0] < lo:
            self._admits.popleft()
        while self._batches and self._batches[0][0] < lo:
            self._batches.popleft()

    def estimate(self, now: Optional[float] = None
                 ) -> Optional[HeadroomEstimate]:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._evict(now)
            admits = list(self._admits)
            batches = list(self._batches)
        if not admits or not batches:
            return None
        # the observation span: clamp to the data actually seen so a
        # freshly started tracker doesn't divide a second of traffic by
        # the full window and under-read every rate
        t0 = min(admits[0][0], batches[0][0])
        span = max(now - t0, 1e-3)
        counts: Dict[str, Dict[str, int]] = {}
        for _t, stream, tag in admits:
            per = counts.setdefault(stream, {})
            per[tag] = per.get(tag, 0) + 1
        rates = {s: sum(tags.values()) / span for s, tags in counts.items()}
        mix = {s: {tag: n / sum(tags.values())
                   for tag, n in tags.items()}
               for s, tags in counts.items()}
        busy: Dict[str, float] = {}
        scored: Dict[str, int] = {}
        for _t, tag, dev, win in batches:
            busy[tag] = busy.get(tag, 0.0) + dev
            scored[tag] = scored.get(tag, 0) + win
        cost = {tag: busy[tag] / scored[tag]
                for tag in busy if scored.get(tag, 0) > 0}
        return predict_headroom(rates, mix, cost)
