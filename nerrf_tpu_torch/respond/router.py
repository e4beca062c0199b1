"""ResponseRouter: the respond tier's resident loop.

The port of ``nerrf_tpu/respond/router.py`` over the port's
`BatchedDeviceMCTS` (the ``mcts_search`` kernel, one launch a chunk for a
whole wave, on the card unless ``device="cpu"``).  The reference's
``cache`` argument and its ``value_apply``/``value_params`` pair become
``value`` (a `ValueNet` or None), as in the port's planner; the compile
cache comes with ROADMAP A.7.

Wires the pieces into one daemon-shaped object the serve plane can hang
off its demux (`service.attach_respond`):

  admission   — a `WindowAlert` becomes an `Incident` iff its calibrated
                severity (the demux-boundary number alert consumers also
                read) clears ``cfg.severity_min``;
  queueing    — bounded `IncidentQueue`, drop-oldest, journaled;
  batching    — a worker thread drains the queue in micro-batches (close
                window ``batch_close_sec``, cap = the largest batch slot)
                and drives the batched `BatchedDeviceMCTS`;
  verification— every emitted plan replays through `PlanVerifier` before
                it reaches ``results``; rejects are quarantined there too,
                flagged, with the journaled reason.

Thread discipline mirrors the serve sinks: one non-daemon worker, stop
flag + condition + join in ``stop()``, and nothing user-visible happens
under a lock (plans/verification run outside, results append under a
short lock).  The demux thread only ever pays a deque append.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from nerrf_tpu_torch.respond.config import RespondConfig
from nerrf_tpu_torch.respond.incidents import Incident, IncidentQueue
from nerrf_tpu_torch.respond.planner import BatchedDeviceMCTS
from nerrf_tpu_torch.respond.verify import PlanVerifier, VerifiedPlan, VerifyContext


class ResponseRouter:
    """Live incident → verified undo plan, batched (see module docstring)."""

    def __init__(self, cfg: Optional[RespondConfig] = None,
                 registry=None, journal=None, value=None,
                 device=None) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        if journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            journal = DEFAULT_JOURNAL
        self.cfg = cfg or RespondConfig()
        self._reg = registry
        self._journal = journal
        self.queue = IncidentQueue(self.cfg.queue_slots, registry=registry,
                                   journal=journal)
        self.planner = BatchedDeviceMCTS(
            self.cfg.mcts_config(), batch_slots=self.cfg.batch_slots,
            value=value, registry=registry, device=device)
        self.verifier = PlanVerifier(registry=registry, journal=journal)
        # per-stream snapshot handles (base stream label, serve convention)
        self._contexts: Dict[str, VerifyContext] = {}
        self._results: deque = deque(maxlen=256)
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._batches = 0
        self._planned = 0
        self.warmup_seconds = 0.0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ResponseRouter":
        """Warm every (bucket, batch-slot) wave, then start the worker.
        Warmup BEFORE serving is the zero-recompile contract's other half —
        after this, no live incident runs outside the warmed set."""
        self.warmup_seconds = self.planner.warmup_for(
            self.cfg.max_files, self.cfg.max_procs)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="respond-router")
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None

    # -- intake ------------------------------------------------------------

    def bind_context(self, stream: str, context: VerifyContext) -> None:
        """Attach a snapshot handle to a stream (base label); incidents
        from that stream become verifiable."""
        with self._lock:
            self._contexts[stream.split("#", 1)[0]] = context

    def offer_alert(self, alert) -> bool:
        """Severity-gated admission from the serve demux.  Never blocks,
        never raises into the demux thread beyond the queue's own
        counters."""
        if float(getattr(alert, "severity", 0.0)) < self.cfg.severity_min:
            self._reg.counter_inc(
                "respond_incidents_total", labels={"outcome": "below_min"},
                help="incidents entering the respond queue, by outcome "
                     "(admitted / evicted when the bounded queue "
                     "overflowed)")
            return False
        with self._lock:
            ctx = self._contexts.get(alert.stream.split("#", 1)[0])
        inc = Incident.from_alert(alert, max_files=self.cfg.max_files,
                                  max_procs=self.cfg.max_procs, context=ctx)
        return self._admit(inc)

    def submit_detection(self, stream: str, detection, *,
                         context: Optional[VerifyContext] = None,
                         severity: float = 1.0, trace_id: str = "") -> bool:
        """Detection-artifact intake (scenario corpus, CLI, bench)."""
        if context is None:
            with self._lock:
                context = self._contexts.get(stream.split("#", 1)[0])
        inc = Incident.from_detection(
            stream, detection, context=context, severity=severity,
            trace_id=trace_id, max_files=self.cfg.max_files,
            max_procs=self.cfg.max_procs)
        return self._admit(inc)

    def _admit(self, inc: Incident) -> bool:
        with self._lock:
            self._inflight += 1
        ok = self.queue.put(inc)
        if not ok:
            # the eviction already decremented nothing — the evicted
            # incident was in-flight too; account for it here
            with self._lock:
                self._inflight -= 1
                self._idle.notify_all()
        return ok

    # -- worker ------------------------------------------------------------

    def _run(self) -> None:
        top = self.cfg.batch_slots[-1]
        while not self._stop.is_set():
            batch = self.queue.take(top, close_sec=self.cfg.batch_close_sec)
            if not batch:
                continue
            try:
                self._plan_and_verify(batch)
            except Exception as e:  # noqa: BLE001 — the loop must survive
                self._journal.record(
                    "exception", where="respond.router",
                    what=f"{type(e).__name__}: {e}")
                with self._lock:
                    self._inflight -= len(batch)
                    self._idle.notify_all()
        # drain what arrived before stop so callers' flushes terminate
        tail = self.queue.take(self.cfg.queue_slots)
        while tail:
            try:
                self._plan_and_verify(tail)
            except Exception:  # noqa: BLE001
                with self._lock:
                    self._inflight -= len(tail)
                    self._idle.notify_all()
            tail = self.queue.take(self.cfg.queue_slots)

    def _plan_and_verify(self, batch: List[Incident]) -> None:
        t0 = time.perf_counter()
        plans = self.planner.plan_batch([i.domain for i in batch])
        plan_sec = time.perf_counter() - t0
        self._reg.histogram_observe(
            "respond_plan_seconds", plan_sec,
            help="wall seconds per batched planning call")
        out: List[VerifiedPlan] = []
        for inc, plan in zip(batch, plans):
            self._reg.counter_inc(
                "respond_plans_total", labels={"outcome": "emitted"},
                help="undo plans leaving the respond planner, by outcome "
                     "(emitted pre-verification, then verified or "
                     "rejected)")
            self._journal.record(
                "plan_emitted", stream=inc.stream, window_id=inc.window_idx,
                trace_id=inc.trace_id, actions=len(plan.actions),
                expected_reward=round(float(plan.expected_reward), 4),
                rollouts=plan.rollouts, batch=len(batch),
                plan_seconds=round(plan_sec, 4))
            if self.cfg.verify:
                out.append(self.verifier.verify(inc, plan))
            else:
                out.append(VerifiedPlan(
                    incident=inc, plan=plan, verified=False,
                    reason="verification disabled (cfg.verify=False) — "
                           "plan is UNVERIFIED"))
        with self._lock:
            self._results.extend(out)
            self._batches += 1
            self._planned += len(batch)
            self._inflight -= len(batch)
            self._idle.notify_all()

    # -- observation -------------------------------------------------------

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until every admitted incident has a result (or timeout)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
        return True

    def results(self, clear: bool = False) -> List[VerifiedPlan]:
        with self._lock:
            out = list(self._results)
            if clear:
                self._results.clear()
        return out

    def stats(self) -> Dict:
        with self._lock:
            results = list(self._results)
            batches, planned = self._batches, self._planned
        return {
            "batches": batches,
            "planned": planned,
            "verified": sum(1 for r in results if r.verified),
            "rejected": sum(1 for r in results if not r.verified),
            "queue_depth": len(self.queue),
            "recompiles": self.planner.recompiles,
            "warmup_seconds": round(self.warmup_seconds, 3),
        }
