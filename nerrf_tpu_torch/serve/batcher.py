"""Continuous cross-stream micro-batcher: many streams, one scorer.

The port of ``nerrf_tpu/serve/batcher.py``, model-free as the reference's
is.  The Podracer/Sebulba shape
(arXiv:2104.06272) applied to detection: any number of independent stream
actors funnel window requests into per-bucket pending queues, and a central
scheduler packs same-bucket windows — from *different* streams — into one
shared padded batch for the NerrfNet forward.  Throughput is won by batch
occupancy, not per-call latency, so the scheduler's batch-close policy
trades a bounded deadline for occupancy:

    close bucket B's batch when  live(B) >= occupancy target
                            or   age(oldest pending in B) >= batch_close_sec
    (whichever first), subject to per-bucket in-flight limits.

Isolation properties (tested in tests/test_torch_serve.py):
  * buckets are independent — a stalled stream starves only its own
    partial windows, never another bucket's batch close;
  * demux never blocks — scored windows are handed to a callback that the
    service keeps non-blocking (bounded alert queue, drop counted);
  * a request can be marked dropped while queued (stream backpressure or
    leave) and the scheduler skips it at assembly, so drop-oldest costs
    O(1) and never fences the device.

Spans: ``serve_batch_close`` (assembly), ``serve_device_score`` (the
forward, its copies in and out included), ``serve_demux`` (per-window
fan-back).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from nerrf_tpu_torch import chaos
from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL
from nerrf_tpu_torch.pipeline import pad_batch
from nerrf_tpu_torch.serve.config import Bucket, ServeConfig, bucket_tag
from nerrf_tpu_torch.tracing import span as trace_span

# windows-per-batch occupancy ladder (batch sizes are small powers of two)
OCCUPANCY_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)
# admit→demux latency ladder: sub-close-deadline up to multi-second stalls
LATENCY_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0)


@dataclasses.dataclass
class WindowRequest:
    """One lowered window waiting for a device slot."""

    stream: str
    window_idx: int
    lo_ns: int
    hi_ns: int
    bucket: Bucket
    sample: Optional[Dict[str, np.ndarray]]
    t_admit: float
    deadline: float
    dropped: bool = False
    # set (under the batcher lock) when assembled into a closing batch:
    # an in-flight request can no longer be dropped, only awaited
    inflight: bool = False
    # set by the batcher before on_failed when the failure is PROVEN
    # window-specific: bisection pinned it to this single window while a
    # sibling from the same original batch scored.  An all-fail batch
    # (device-wide fault) or an unbisected cohort never sets it — only
    # poison-proven windows strike their stream toward quarantine
    poison: bool = False
    # the window's journal/span join key, plus the per-stage time stamps
    # (admit → packed → scorer pickup) the SLO plane reads
    trace_id: str = ""
    t_packed: float = 0.0
    t_device: float = 0.0
    # the admission-side MEASURED window structure (pre-truncation
    # node/edge/file counts), carried so demux never re-measures
    nodes: int = 0
    edges: int = 0
    files: int = 0


@dataclasses.dataclass
class ScoredWindow:
    """One window's demuxed result.  Holds only the node-level arrays the
    detection aggregation needs — the full padded sample (dominated by the
    [max_seqs, seq_len, F] sequence block) is released at scoring time so
    queued-but-unscored windows are the only ones paying full-sample RAM."""

    stream: str
    window_idx: int
    lo_ns: int
    hi_ns: int
    bucket: Bucket
    probs: np.ndarray       # float [max_nodes] node probabilities
    node_type: np.ndarray
    node_key: np.ndarray
    node_mask: np.ndarray
    t_admit: float
    t_scored: float
    late: bool
    # which model version scored this window (None until a swap names
    # one): the per-window stamp that flips at exactly one batch boundary
    model_version: Optional[int] = None
    # mirrors WindowRequest: join key + stage stamps
    trace_id: str = ""
    t_packed: float = 0.0
    t_device: float = 0.0
    # mirrors WindowRequest: measured window structure
    nodes: int = 0
    edges: int = 0
    files: int = 0


class MicroBatcher:
    """Per-bucket pending queues + closer/scorer threads (one device).

    ``score_fn(batch_dict) -> np.ndarray [batch_size, max_nodes]`` is the
    forward's wrapper (the service's eval function + sigmoid); the batcher
    itself is model-free, so the packing/backpressure logic is testable
    without a model.
    """

    def __init__(
        self,
        score_fn: Callable[[Dict[str, np.ndarray]], np.ndarray],
        cfg: ServeConfig,
        registry=None,
        on_scored: Optional[Callable[[List[ScoredWindow]], None]] = None,
        on_failed: Optional[Callable[[List[WindowRequest], BaseException], None]] = None,
        journal=None,
    ) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        self._score_fn = score_fn
        self._cfg = cfg
        self._reg = registry
        self._journal = journal if journal is not None else DEFAULT_JOURNAL
        self._on_scored = on_scored or (lambda scored: None)
        self._on_failed = on_failed or (lambda reqs, exc: None)
        self._lock = threading.Lock()
        self._kick = threading.Event()
        self._pending: Dict[Bucket, deque] = {}
        self._live: Dict[Bucket, int] = {}
        self._inflight: Dict[Bucket, int] = {}
        self._warmed: set = set()
        self._ready: "queue.Queue" = queue.Queue()
        self._running = False
        self._threads: List[threading.Thread] = []
        # scorer watchdog state (all under _lock): when one device call
        # has been stuck past cfg.scorer_wedge_sec the batcher is WEDGED —
        # readiness fails and leave() stops waiting, instead of every
        # stream hanging on a dead scorer thread.  Cleared the moment the
        # stuck call returns (journaled both ways).
        self._scoring_since: Optional[float] = None
        self._scoring_bucket: Optional[str] = None
        self._wedged = False

    # -- submission (stream threads) -----------------------------------------

    def submit(self, req: WindowRequest) -> None:
        with self._lock:
            self._pending.setdefault(req.bucket, deque()).append(req)
            self._live[req.bucket] = self._live.get(req.bucket, 0) + 1
            depth = self._live[req.bucket]
        self._reg.gauge_set(
            "serve_queue_depth", depth,
            labels={"bucket": bucket_tag(req.bucket)},
            help="windows pending per capacity bucket")
        self._kick.set()

    def mark_dropped(self, req: WindowRequest) -> bool:
        """Drop a queued request in place (drop-oldest backpressure, stream
        leave).  O(1): the scheduler skips dropped entries at assembly.
        Returns False when the request is already dropped or already
        assembled into an in-flight batch (then it must be awaited)."""
        with self._lock:
            if req.dropped or req.inflight:
                return False
            req.dropped = True
            req.sample = None
            self._live[req.bucket] = max(self._live.get(req.bucket, 1) - 1, 0)
            return True

    def mark_warm(self, bucket: Bucket) -> None:
        """Register a bucket whose forward ran at warmup; scoring any other
        bucket after start counts into serve_recompiles_total."""
        with self._lock:
            self._warmed.add(tuple(bucket))

    def queue_depth(self, bucket: Bucket) -> int:
        with self._lock:
            return self._live.get(bucket, 0)

    @property
    def running(self) -> bool:
        return self._running

    @property
    def wedged(self) -> bool:
        with self._lock:
            return self._wedged

    @property
    def healthy(self) -> bool:
        """Running and not wedged — what readiness and leave() key off."""
        return self._running and not self.wedged

    # -- batch close ----------------------------------------------------------

    def _collect_ready(self, now: float, force: bool = False
                       ) -> List[Tuple[Bucket, List[WindowRequest], str]]:
        out = []
        with self._lock:
            for bucket, dq in self._pending.items():
                while dq and dq[0].dropped:
                    dq.popleft()
                if not dq:
                    continue
                if not force and \
                        self._inflight.get(bucket, 0) >= self._cfg.max_inflight_batches:
                    continue
                live = self._live.get(bucket, 0)
                age = now - dq[0].t_admit
                if not (force or live >= self._cfg.occupancy
                        or age >= self._cfg.batch_close_sec):
                    continue
                reqs: List[WindowRequest] = []
                while dq and len(reqs) < self._cfg.batch_size:
                    r = dq.popleft()
                    if not r.dropped:
                        r.inflight = True
                        r.t_packed = now  # stage stamp: queue ends here
                        reqs.append(r)
                if not reqs:
                    continue
                self._live[bucket] = max(live - len(reqs), 0)
                self._inflight[bucket] = self._inflight.get(bucket, 0) + 1
                cause = ("flush" if force else
                         "occupancy" if len(reqs) >= self._cfg.occupancy
                         else "deadline")
                out.append((bucket, reqs, cause))
        return out

    def _emit_batch(self, bucket: Bucket, reqs: List[WindowRequest],
                    cause: str) -> None:
        tag = bucket_tag(bucket)
        with self._lock:
            # stream threads mutate _live concurrently; the post-close
            # depth must be a locked read, not a racy .get
            depth = self._live.get(bucket, 0)
        with trace_span("serve_batch_close", bucket=tag, cause=cause,
                        windows=len(reqs)) as sp:
            self._reg.counter_inc(
                "serve_batches_total", labels={"bucket": tag, "cause": cause},
                help="shared device batches closed, by bucket and close cause")
            self._reg.histogram_observe(
                "serve_batch_occupancy", float(len(reqs)),
                buckets=OCCUPANCY_BUCKETS, labels={"bucket": tag},
                help="real windows packed per shared device batch")
            self._reg.gauge_set(
                "serve_queue_depth", depth,
                labels={"bucket": tag},
                help="windows pending per capacity bucket")
            # the batch-close record: bucket, close cause, occupancy vs
            # padded slots, post-close depth, and every packed window's
            # trace ID (span join keys)
            rec = self._journal.record(
                "batch_close", bucket=tag, cause=cause,
                occupancy=len(reqs),
                padding=self._cfg.batch_size - len(reqs),
                depth_after=depth,
                streams=sorted({r.stream for r in reqs}),
                trace_ids=[r.trace_id for r in reqs if r.trace_id])
            sp.args["journal_seq"] = rec.seq
        self._ready.put((bucket, reqs, cause))

    # -- scoring --------------------------------------------------------------

    def _stack(self, reqs: List[WindowRequest]) -> Dict[str, np.ndarray]:
        """Exactly model_detect's fixed-shape batching (the shared
        `pipeline.pad_batch`): stack the window samples and zero-pad the
        tail so every forward shares one shape."""
        return pad_batch([r.sample for r in reqs], self._cfg.batch_size)

    def _score_batch(self, bucket: Bucket, reqs: List[WindowRequest]) -> None:
        tag = bucket_tag(bucket)
        with self._lock:
            warmed = tuple(bucket) in self._warmed
        if not warmed:
            self._reg.counter_inc(
                "serve_recompiles_total", labels={"bucket": tag},
                help="device batches scored at a bucket shape not warmed "
                     "at start (steady state must stay at 0)")
            self.mark_warm(bucket)
        failures: List[Tuple[List[WindowRequest], BaseException]] = []
        scored_n = self._score_cohort(bucket, tag, reqs, 0, failures)
        for f_reqs, exc in failures:
            # poison evidence needs ALL of: pinned to a single window,
            # a sibling from the same original batch scored (an all-fail
            # batch, or a lone occupancy-1 deadline batch, indicts the
            # device and strikes nobody), AND the window fails a CONFIRM
            # re-run — one failed retry on an intermittently-failing
            # device proves nothing about the window's stream
            if scored_n > 0 and len(f_reqs) == 1 \
                    and self._cfg.bisect_failed_batches:
                confirm: List[Tuple[List[WindowRequest],
                                    BaseException]] = []
                if self._score_cohort(bucket, tag, f_reqs, 0, confirm):
                    scored_n += 1  # intermittent fault: window delivered
                    continue
                for c_reqs, c_exc in confirm:
                    for r in c_reqs:
                        r.poison = True  # failed twice, siblings scored
                    self._on_failed(c_reqs, c_exc)
                continue
            self._on_failed(f_reqs, exc)

    def _score_cohort(self, bucket: Bucket, tag: str,
                      reqs: List[WindowRequest], depth: int,
                      failures: List[Tuple[List[WindowRequest],
                                           BaseException]]) -> int:
        """Score one cohort; on failure, bisect to isolate the poison.
        Returns how many windows SCORED; terminal failures are appended
        to ``failures`` (delivered by `_score_batch` once the whole
        original batch's outcome — the poison evidence — is known).

        A shared batch means one poisoned window (one that makes the
        forward raise, or a device fault its data provokes) would cost
        every cohabiting stream's windows in the batch.  Instead: split the
        failed cohort in half and retry each half — retried cohorts re-pad
        to the same ``batch_size`` shape, so retries reuse the warmed
        shape — until the failure is pinned to single windows.  Every
        window that did NOT provoke the fault scores normally.  Cost is
        logarithmic: isolating one poison window in a batch of B re-runs
        the forward ~2·log2(B) times, only while failing."""
        batch = self._stack(reqs)
        t_device = time.perf_counter()
        for r in reqs:
            r.t_device = t_device  # stage stamp: scorer pickup
        # watchdog window: ONE device call (this cohort's), not the whole
        # bisection recursion — each retry re-stamps, so a slow-but-
        # progressing isolation can never be mistaken for a wedge
        with self._lock:
            self._scoring_since = t_device
            self._scoring_bucket = tag
        try:
            with trace_span("serve_device_score", device=True, bucket=tag,
                            windows=len(reqs)):
                # chaos fault points (no-ops disarmed): a whole-batch
                # device fault / latency spike, and the per-window poison
                # (keyed by trace ID so bisection retries fire the same
                # way the first score did — that is what lets the split
                # isolate exactly the injected window)
                chaos.inject("serve.device_latency", bucket=tag,
                             windows=len(reqs))
                chaos.inject("serve.device_error", bucket=tag,
                             windows=len(reqs))
                for r in reqs:
                    chaos.inject("serve.poison_window", key=r.trace_id,
                                 stream=r.stream, window_idx=r.window_idx,
                                 bucket=tag)
                out = self._score_fn(batch)
                # a version-stamping score_fn (the service's) returns
                # (probs, model_version); plain score_fns return the bare
                # array
                probs, version = out if isinstance(out, tuple) \
                    else (out, None)
                probs = np.asarray(probs)
        except Exception as exc:  # noqa: BLE001 — one bad batch must not
            # kill the scorer thread and wedge every stream behind it
            self._reg.counter_inc(
                "serve_batch_failures_total", labels={"bucket": tag},
                help="device batches whose scoring raised")
            self._journal.record(
                "batch_failed", bucket=tag, windows=len(reqs), depth=depth,
                error=f"{type(exc).__name__}: {exc}",
                trace_ids=[r.trace_id for r in reqs if r.trace_id])
            if len(reqs) > 1 and self._cfg.bisect_failed_batches:
                self._reg.counter_inc(
                    "serve_poison_bisections_total", labels={"bucket": tag},
                    help="failed shared batches split-and-retried to "
                         "isolate the poisoning window")
                self._journal.record(
                    "batch_bisect", bucket=tag, windows=len(reqs),
                    depth=depth,
                    trace_ids=[r.trace_id for r in reqs if r.trace_id])
                mid = len(reqs) // 2
                return (self._score_cohort(bucket, tag, reqs[:mid],
                                           depth + 1, failures)
                        + self._score_cohort(bucket, tag, reqs[mid:],
                                             depth + 1, failures))
            failures.append((list(reqs), exc))
            return 0
        finally:
            with self._lock:
                self._scoring_since = None
        now = time.perf_counter()
        scored: List[ScoredWindow] = []
        with trace_span("serve_demux", bucket=tag, windows=len(reqs)):
            for j, r in enumerate(reqs):
                late = now > r.deadline
                if late:
                    self._reg.counter_inc(
                        "serve_late_windows_total",
                        help="windows scored after their admit→alert "
                             "deadline (served, but SLO-late)")
                self._reg.histogram_observe(
                    "serve_window_latency_seconds", now - r.t_admit,
                    buckets=LATENCY_BUCKETS,
                    help="window admit→demux latency")
                s = r.sample
                scored.append(ScoredWindow(
                    stream=r.stream, window_idx=r.window_idx,
                    lo_ns=r.lo_ns, hi_ns=r.hi_ns, bucket=bucket,
                    probs=probs[j], node_type=s["node_type"],
                    node_key=s["node_key"], node_mask=s["node_mask"],
                    t_admit=r.t_admit, t_scored=now, late=late,
                    model_version=version, trace_id=r.trace_id,
                    t_packed=r.t_packed, t_device=r.t_device,
                    nodes=r.nodes, edges=r.edges, files=r.files))
                r.sample = None  # release the padded sample's memory
            self._reg.counter_inc(
                "serve_windows_scored_total", len(reqs),
                help="windows scored through shared device batches")
            self._on_scored(scored)
        return len(reqs)

    # -- threads --------------------------------------------------------------

    def _close_loop(self) -> None:
        tick = max(self._cfg.batch_close_sec / 4.0, 0.002)
        while self._running:
            self._kick.wait(timeout=tick)
            self._kick.clear()
            now = time.perf_counter()
            self._check_watchdog(now)
            for bucket, reqs, cause in self._collect_ready(now):
                self._emit_batch(bucket, reqs, cause)

    def _check_watchdog(self, now: float) -> None:
        """The closer thread doubles as the scorer's watchdog (it ticks on
        its own clock even when no batches close): one device call stuck
        past ``scorer_wedge_sec`` flips the batcher WEDGED — readiness
        fails (a probe can restart the pod) and `leave()` stops waiting —
        and the flip back is journaled the moment the call returns."""
        limit = self._cfg.scorer_wedge_sec
        if not limit:
            return
        with self._lock:
            since, bucket = self._scoring_since, self._scoring_bucket
            stuck = since is not None and now - since > limit
            flipped = None
            if stuck and not self._wedged:
                self._wedged = True
                flipped = ("scorer_wedged",
                           {"bucket": bucket,
                            "stuck_seconds": round(now - since, 2),
                            "limit_seconds": limit})
            elif self._wedged and not stuck:
                self._wedged = False
                flipped = ("scorer_recovered", {"bucket": bucket})
        if flipped is not None:
            kind, data = flipped
            self._reg.gauge_set(
                "serve_scorer_wedged", 1.0 if kind == "scorer_wedged"
                else 0.0,
                help="1 while a device call has been stuck past the "
                     "watchdog limit (readiness fails while set)")
            self._journal.record(kind, **data)

    def _score_loop(self) -> None:
        while True:
            item = self._ready.get()
            if item is None:
                return
            bucket, reqs, _cause = item
            try:
                self._score_batch(bucket, reqs)
            finally:
                with self._lock:
                    self._inflight[bucket] = max(
                        self._inflight.get(bucket, 1) - 1, 0)
                self._kick.set()  # an inflight slot freed: re-check closes

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        # the wedge gauge must EXIST on a healthy pod — an alert on
        # serve_scorer_wedged == 1 has to read 0, not "no data"
        self._reg.gauge_set(
            "serve_scorer_wedged", 0.0,
            help="1 while a device call has been stuck past the "
                 "watchdog limit (readiness fails while set)")
        self._threads = [
            threading.Thread(target=self._close_loop,
                             name="nerrf-serve-closer", daemon=True),
            threading.Thread(target=self._score_loop,
                             name="nerrf-serve-scorer", daemon=True),
        ]
        for t in self._threads:
            t.start()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        if not self._running:
            return
        self._running = False
        self._kick.set()
        self._threads[0].join(timeout=timeout)
        if drain:
            # repeat until empty: one pass closes at most batch_size per
            # bucket, and a deep queue abandoned here would be an
            # UNCOUNTED drop (every other loss path has a counter)
            while True:
                batches = self._collect_ready(time.perf_counter(),
                                              force=True)
                if not batches:
                    break
                for bucket, reqs, cause in batches:
                    self._emit_batch(bucket, reqs, cause)
        self._ready.put(None)
        self._threads[1].join(timeout=timeout)
        self._threads = []

    def drain_once(self, force: bool = False) -> int:
        """Synchronous single-threaded operation (tests, shutdown): close
        every due batch — all non-empty buckets when ``force`` — and score
        them inline.  Returns the number of batches scored."""
        batches = self._collect_ready(time.perf_counter(), force=force)
        for bucket, reqs, cause in batches:
            self._emit_batch(bucket, reqs, cause)
            item = self._ready.get()
            try:
                self._score_batch(item[0], item[1])
            finally:
                with self._lock:
                    self._inflight[item[0]] = max(
                        self._inflight.get(item[0], 1) - 1, 0)
        return len(batches)
