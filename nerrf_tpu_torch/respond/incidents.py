"""Incidents and the bounded incident queue.

The port of ``nerrf_tpu/respond/incidents.py``; domains are built with the
port's ``pipeline.build_undo_domain``.

An `Incident` is one unit of response work: the planning domain distilled
from a detection, plus the identity (trace ID, stream, window) and the
graph-snapshot handle (`VerifyContext`) the verification stage replays
against.  Incidents enter from two boundaries:

  * the serve demux — every `WindowAlert` above the severity gate
    (`Incident.from_alert`); hot-list host keys are inodes/pids, so these
    incidents carry pseudo-paths and verify only when a snapshot context
    resolves them;
  * detection results — the offline artifact (`Incident.from_detection`),
    with real paths and manifest-backed losses, the path the scenario
    corpus and the respond bench drive.

The queue is a bounded deque with drop-oldest on overflow (the same
newest-evidence-wins policy as serve admission), every admission journaled
as ``incident_enqueued`` and every eviction as a counted, journaled drop —
a planner stall sheds load, never wedges the demux thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import List, Optional

from nerrf_tpu_torch.planner.domain import UndoDomain
from nerrf_tpu_torch.respond.verify import VerifyContext


@dataclasses.dataclass
class Incident:
    """One planning work item (see module docstring for provenance)."""

    trace_id: str
    stream: str
    window_idx: int
    severity: float
    domain: UndoDomain
    # graph snapshot handle: what the verifier replays the plan against.
    # None = no snapshot is bound for this stream; the plan can still be
    # produced but will be quarantined (fail closed), never surfaced.
    context: Optional[VerifyContext] = None
    t_enqueued: float = 0.0

    @classmethod
    def from_alert(cls, alert, *, max_files: int = 128, max_procs: int = 16,
                   context: Optional[VerifyContext] = None) -> "Incident":
        """WindowAlert → Incident.  The hot list carries (kind, host_key,
        prob) with inode/pid host keys — paths are only final at stream
        end — so the domain is built over ``ino:<key>``/``pid:<key>``
        pseudo-targets with a nominal loss estimate.  Good enough to rank
        and plan; verification requires a context whose manifest can
        ground the targets (otherwise the verifier rejects, by design)."""
        files = [(f"ino:{key}", prob) for kind, key, prob in alert.hot
                 if kind == "file"][:max_files]
        procs = [(f"{key}:alert", prob) for kind, key, prob in alert.hot
                 if kind == "proc"][:max_procs]
        if not files:  # a proc-only alert still needs a non-empty file axis
            files = [("ino:none", 0.0)]
        import numpy as np

        domain = UndoDomain(
            file_paths=[p for p, _ in files],
            file_scores=np.asarray([s for _, s in files], np.float32),
            file_loss_mb=np.ones(len(files), np.float32),
            proc_names=[p for p, _ in procs],
            proc_scores=np.asarray([s for _, s in procs], np.float32),
        )
        return cls(trace_id=alert.trace_id, stream=alert.stream,
                   window_idx=alert.window_idx,
                   severity=float(alert.severity), domain=domain,
                   context=context)

    @classmethod
    def from_detection(cls, stream: str, detection, *,
                       context: Optional[VerifyContext] = None,
                       severity: float = 1.0, trace_id: str = "",
                       max_files: int = 128,
                       max_procs: int = 16) -> "Incident":
        """DetectionResult → Incident through the same domain constructor
        the offline CLI uses (pipeline.build_undo_domain), with manifest-
        backed loss estimates when a context is bound — plan targets are
        real paths, so these incidents are verifiable end to end."""
        from nerrf_tpu_torch.pipeline import build_undo_domain

        manifest = context.manifest if context is not None else None
        root = str(context.victim_root) if context is not None else ""
        domain = build_undo_domain(detection, manifest, root=root,
                                   max_files=max_files, max_procs=max_procs)
        return cls(trace_id=trace_id, stream=stream, window_idx=-1,
                   severity=float(severity), domain=domain, context=context)


class IncidentQueue:
    """Bounded, never-blocking incident intake (see module docstring)."""

    def __init__(self, slots: int = 64, registry=None, journal=None) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        if journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            journal = DEFAULT_JOURNAL
        self._reg = registry
        self._journal = journal
        self._lock = threading.Lock()
        self._q: deque = deque(maxlen=max(int(slots), 1))
        self._not_empty = threading.Condition(self._lock)

    def put(self, incident: Incident) -> bool:
        """Admit; False when the oldest incident was evicted to make room
        (counted + journaled — an unplanned incident is lost evidence)."""
        incident.t_enqueued = time.monotonic()
        self._reg.counter_inc(
            "respond_incidents_total", labels={"outcome": "admitted"},
            help="incidents entering the respond queue, by outcome "
                 "(admitted / evicted when the bounded queue overflowed)")
        self._journal.record(
            "incident_enqueued", stream=incident.stream,
            window_id=incident.window_idx, trace_id=incident.trace_id,
            severity=round(incident.severity, 4),
            files=incident.domain.F, procs=incident.domain.P)
        with self._lock:
            overflow = len(self._q) == self._q.maxlen
            evicted = self._q[0] if overflow else None
            self._q.append(incident)
            self._not_empty.notify()
        if overflow:
            self._reg.counter_inc(
                "respond_incidents_total", labels={"outcome": "evicted"},
                help="incidents entering the respond queue, by outcome "
                     "(admitted / evicted when the bounded queue "
                     "overflowed)")
            self._journal.record(
                "incident_enqueued", stream=evicted.stream,
                window_id=evicted.window_idx, trace_id=evicted.trace_id,
                dropped=True, reason="queue_full")
        self._reg.gauge_set("respond_queue_depth", float(len(self)),
                            help="incidents waiting for the planner")
        return not overflow

    def take(self, max_n: int, close_sec: float = 0.0) -> List[Incident]:
        """Drain up to ``max_n`` incidents; with ``close_sec`` > 0, block
        that long for the FIRST incident (micro-batch close window), then
        return whatever is waiting without further blocking."""
        deadline = time.monotonic() + max(close_sec, 0.0)
        out: List[Incident] = []
        with self._lock:
            while not self._q:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return out
                self._not_empty.wait(remaining)
            while self._q and len(out) < max_n:
                out.append(self._q.popleft())
        self._reg.gauge_set("respond_queue_depth", float(len(self)),
                            help="incidents waiting for the planner")
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)
