"""End-to-end SLO accounting for the serve path.

A host copy of ``nerrf_tpu/flight/slo.py``, kept identical.

Every scored window already carries its event time through the pipeline
(`WindowRequest.t_admit` → assembled `t_packed` → scorer pickup `t_device`
→ demux).  `SLOTracker.observe` turns those stamps into the operator-facing
SLO plane:

  * ``nerrf_slo_e2e_seconds{stream=...}`` — per-stream admit→demux latency
    histograms (the per-stream refinement of the un-labelled
    ``serve_window_latency_seconds``);
  * ``nerrf_slo_stage_seconds{stage=...}`` — where inside the budget the
    time went: ``queue`` (admit→batch close), ``pack`` (close→scorer
    pickup), ``device`` (the program + fetch), ``demux`` (fan-back);
  * ``nerrf_slo_budget_burn_ratio{stream,stage}`` — TRAILING mean stage
    cost as a fraction of the window deadline, so a dashboard shows WHICH
    stage is eating the budget before p99 breaches (trailing, not
    all-time: a regression must move the gauge within one trailing
    window, not fight a day of healthy history);
  * ``nerrf_slo_breaches_total{stream}`` — windows that blew the deadline;
  * exemplars — the slowest window in each stream's trailing set, by trace
    ID, so a slow alert links back to its exact batch's span tree and
    journal records (``slo_breach`` journal records carry the same ID).
    Trailing by construction: an exemplar ages out with its window, so it
    always points at evidence the span/journal rings can still hold.

Cardinality is bounded: the tracker keeps at most ``max_streams`` streams
(LRU on observation).  A resident serve pod's reconnect sessions mint new
stream IDs forever (``name#<n>``); when a stream ages out, its in-memory
state AND its per-stream registry series are retired
(`MetricsRegistry.remove_series`), so neither host memory nor the
/metrics exposition grows with session churn.

Percentiles: the registry histograms are fixed-bucket (Prometheus-side
quantiles); `snapshot()` additionally reports *exact* trailing p50/p99 per
stream from the in-memory window, which is what the serve bench's artifact
and the flight recorder's p99 trigger consume.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

# e2e ladder: sub-deadline through multi-second stalls (the serve path's
# LATENCY_BUCKETS, extended down for sub-close-deadline fast paths)
SLO_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0)
STAGES = ("queue", "pack", "device", "demux")


def percentile(sorted_vals, p: float) -> Optional[float]:
    """Nearest-rank percentile over an ascending list (None when empty).
    The ONE definition both the SLO plane and the flight recorder's p99
    trigger use — they must never disagree about the same data."""
    if not sorted_vals:
        return None
    return sorted_vals[min(int(p * len(sorted_vals)), len(sorted_vals) - 1)]


class _StreamWindow:
    """One stream's trailing accounting: (e2e, trace_id, stages) entries
    plus running trailing stage sums (evictions subtract, so the burn
    gauge is O(1) per observation)."""

    __slots__ = ("window", "stage_sums", "count", "breaches")

    def __init__(self) -> None:
        self.window: deque = deque()  # (e2e, trace_id, {stage: sec})
        self.stage_sums: Dict[str, float] = {s: 0.0 for s in STAGES}
        self.count = 0
        self.breaches = 0

    def worst(self):
        if not self.window:
            return None, None
        e2e, trace_id, _ = max(self.window, key=lambda t: t[0])
        return trace_id, e2e


class SLOTracker:
    """Per-stream trailing SLO accounting + registry export."""

    def __init__(self, deadline_sec: float, registry=None, journal=None,
                 trailing: int = 256, max_streams: int = 256) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        if journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            journal = DEFAULT_JOURNAL
        self.deadline_sec = max(float(deadline_sec), 1e-9)
        self._reg = registry
        self._journal = journal
        self._trailing = max(trailing, 1)
        self._max_streams = max(max_streams, 1)
        self._lock = threading.Lock()
        # insertion order IS the LRU order: observe() re-inserts its
        # stream at the end, so the first key is the coldest
        self._streams: Dict[str, _StreamWindow] = {}

    def observe(self, stream: str, trace_id: Optional[str],
                window_id: Optional[int], stages: Dict[str, float],
                e2e_sec: float) -> None:
        """One scored window's stamps.  ``stages`` maps stage name →
        seconds (missing/negative stages are clamped to 0 — clock reads
        from different threads can jitter a µs below zero)."""
        e2e_sec = max(float(e2e_sec), 0.0)
        clamped = {s: max(float(stages.get(s, 0.0)), 0.0) for s in STAGES}
        breach = e2e_sec > self.deadline_sec
        with self._lock:
            w = self._streams.pop(stream, None) or _StreamWindow()
            self._streams[stream] = w  # re-insert: newest at the end
            w.window.append((e2e_sec, trace_id, clamped))
            for s in STAGES:
                w.stage_sums[s] += clamped[s]
            if len(w.window) > self._trailing:
                _, _, old = w.window.popleft()
                for s in STAGES:
                    w.stage_sums[s] = max(w.stage_sums[s] - old[s], 0.0)
            w.count += 1
            if breach:
                w.breaches += 1
            n = len(w.window)
            burns = {s: (w.stage_sums[s] / n) / self.deadline_sec
                     for s in STAGES}
            evicted = None
            if len(self._streams) > self._max_streams:
                evicted = next(iter(self._streams))
                del self._streams[evicted]
        if evicted is not None:
            self._retire_series(evicted)
        self._reg.histogram_observe(
            "slo_e2e_seconds", e2e_sec, buckets=SLO_BUCKETS,
            labels={"stream": stream},
            help="per-stream end-to-end window latency, admit through demux")
        for stage in STAGES:
            self._reg.histogram_observe(
                "slo_stage_seconds", clamped[stage],
                buckets=SLO_BUCKETS, labels={"stage": stage},
                help="per-stage share of the window's end-to-end latency")
            self._reg.gauge_set(
                "slo_budget_burn_ratio", burns[stage],
                labels={"stream": stream, "stage": stage},
                help="trailing mean stage latency as a fraction of the "
                     "per-window deadline budget")
        if breach:
            self._reg.counter_inc(
                "slo_breaches_total", labels={"stream": stream},
                help="windows whose end-to-end latency blew the deadline")
            self._journal.record(
                "slo_breach", stream=stream, window_id=window_id,
                trace_id=trace_id, e2e_sec=round(e2e_sec, 6),
                deadline_sec=self.deadline_sec,
                stages={k: round(clamped[k], 6) for k in STAGES})

    def _retire_series(self, stream: str) -> None:
        """Drop an aged-out stream's per-stream registry series — the
        cardinality bound for long-lived pods with reconnect-session IDs."""
        self._reg.remove_series("slo_e2e_seconds", {"stream": stream})
        self._reg.remove_series("slo_breaches_total", {"stream": stream})
        for stage in STAGES:
            self._reg.remove_series(
                "slo_budget_burn_ratio", {"stream": stream, "stage": stage})

    # -- reading -------------------------------------------------------------

    def exemplar(self, stream: str):
        """(trace_id, e2e_seconds) of the worst window in ``stream``'s
        TRAILING set — ages out with its window, so the ID always joins to
        evidence the span/journal rings can still hold."""
        with self._lock:
            w = self._streams.get(stream)
            return (None, None) if w is None else w.worst()

    def trailing_p99(self, stream: str) -> Optional[float]:
        with self._lock:
            w = self._streams.get(stream)
            vals = sorted(e for e, _, _ in w.window) if w is not None else []
        return percentile(vals, 0.99)

    def snapshot(self) -> dict:
        """Per-stream exact trailing stats — the bench artifact's ``slo``
        block and the flight bundle's manifest both embed this."""
        with self._lock:
            streams = {
                s: (sorted(e for e, _, _ in w.window), w.count, w.breaches,
                    *w.worst(), dict(w.stage_sums), len(w.window))
                for s, w in self._streams.items()}
        out = {}
        for s, (vals, count, breaches, worst_trace, worst_e2e,
                sums, n) in sorted(streams.items()):
            out[s] = {
                "count": count,
                "breaches": breaches,
                "p50_ms": _ms(percentile(vals, 0.50)),
                "p99_ms": _ms(percentile(vals, 0.99)),
                "max_ms": _ms(vals[-1] if vals else None),
                "exemplar_trace_id": worst_trace,
                "exemplar_ms": _ms(worst_e2e if worst_trace else None),
                "budget_burn": {k: round((v / n) / self.deadline_sec, 4)
                                for k, v in sorted(sums.items())} if n
                               else {},
            }
        return {"deadline_sec": self.deadline_sec, "per_stream": out}


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1e3, 1)
