"""Alert fan-out for the online detection service.

A host copy of ``nerrf_tpu/serve/alerts.py``, without the chaos plane's
fault point in ``drain``.

Two granularities leave the demux stage:

  * `WindowAlert` — per scored window, emitted the moment any node
    probability crosses the operating threshold: the low-latency signal a
    responder or auto-planner watches.  Delivery is a *bounded* queue with
    drop-on-full (counted as ``nerrf_serve_demux_overflows_total``): a slow
    alert consumer can lose alerts, never stall the scoring plane.
  * per-stream `DetectionResult` at stream leave — the exact offline
    artifact (`pipeline.model_detect` parity), ready for
    `pipeline.build_undo_domain` → the MCTS planner.  Subclass or wrap
    `AlertSink.on_detection` to hand off automatically.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class WindowAlert:
    """One hot window.  ``hot`` carries (node_kind, host_key, prob) —
    host keys are inodes for files and pids for processes; consumers
    resolve paths against the stream's trace (the mapping is only final at
    stream end, when renames have settled)."""

    stream: str
    window_idx: int
    lo_ns: int
    hi_ns: int
    max_prob: float
    hot: List[Tuple[str, int, float]]
    t_admit: float
    t_scored: float
    late: bool
    # registry model version that scored the window (None when the service
    # runs without a model manager)
    model_version: Optional[int] = None
    # the window's flight/span join key (flight.journal.make_trace_id):
    # an alert is joinable to its batch's span tree and journal records
    trace_id: str = ""
    # calibrated severity in [0, 1]: how far max_prob sits above the
    # operating threshold, normalized by the remaining headroom
    # ((max_prob - thr) / (1 - thr)).  Computed ONCE at the demux boundary
    # (service._on_scored) so every consumer of the sink reads the same
    # number instead of re-deriving severity from the raw score with
    # threshold assumptions of its own.
    severity: float = 0.0


def calibrated_severity(max_prob: float, threshold: float) -> float:
    """The one severity formula (WindowAlert.severity): fraction of the
    headroom above the operating threshold the score consumed, clamped to
    [0, 1].  A window exactly at threshold is severity 0; a saturated score
    is 1 regardless of where the threshold sits — comparable across
    deployments with different operating points."""
    thr = min(max(float(threshold), 0.0), 1.0)
    head = max(1.0 - thr, 1e-9)
    return min(max((float(max_prob) - thr) / head, 0.0), 1.0)


class AlertSink:
    """Bounded, never-blocking alert queue + per-stream detection capture."""

    def __init__(self, slots: int = 256, registry=None,
                 journal=None) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        if journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            journal = DEFAULT_JOURNAL
        self._reg = registry
        self._journal = journal
        self._lock = threading.Lock()
        self._alerts: deque = deque(maxlen=max(slots, 1))
        self.detections: Dict[str, object] = {}

    def emit(self, alert: WindowAlert) -> bool:
        """Enqueue; False (and a counted overflow) when a stale alert was
        evicted to make room — the deque keeps the *newest* alerts, the
        same newest-evidence-wins policy as admission drop-oldest."""
        # every emission counts BEFORE queueing outcomes (drops alone only
        # ever measure the consumer).  BASE stream name: a resident
        # stream's reconnect sessions (name#N) must not mint a label
        # series per session
        self._reg.counter_inc(
            "serve_alerts_emitted_total",
            labels={"stream": alert.stream.split("#", 1)[0]},
            help="window alerts emitted at the demux boundary, by stream "
                 "(pre-queue: the alert-rate numerator, independent of "
                 "sink drops)")
        with self._lock:
            overflow = len(self._alerts) == self._alerts.maxlen
            evicted = self._alerts[0] if overflow else None
            self._alerts.append(alert)
        if overflow:
            self._reg.counter_inc(
                "serve_demux_overflows_total",
                help="window alerts evicted because the alert sink was full "
                     "(slow consumer); scoring is unaffected")
            # journal the EVICTED alert (the one the operator lost), not
            # the incoming one
            self._journal.record(
                "demux_drop", stream=evicted.stream,
                window_id=evicted.window_idx, trace_id=evicted.trace_id,
                reason="sink_full", max_prob=round(evicted.max_prob, 4))
        return not overflow

    def on_detection(self, stream: str, detection) -> None:
        """Stream-leave hook: receives the final DetectionResult.  The
        default keeps it for collection; override to chain it into a
        planner for automatic response."""
        with self._lock:
            self.detections[stream] = detection

    def drain(self, max_n: Optional[int] = None) -> List[WindowAlert]:
        out: List[WindowAlert] = []
        with self._lock:
            while self._alerts and (max_n is None or len(out) < max_n):
                out.append(self._alerts.popleft())
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._alerts)
