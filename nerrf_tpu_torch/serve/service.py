"""The online detection service: N event streams → one scorer on the card.

The port of ``nerrf_tpu/serve/service.py``.  Per-stream feeder threads
window and lower their own events on the host (`serve.windower` + the
shared `train.data.window_sample`), and a central `serve.batcher.MicroBatcher`
packs same-capacity-bucket windows from *different* streams into shared
padded batches for one NerrfNet forward per batch, on the scorer thread.
Every bucket of the ladder runs one forward at `start()` (warmup, the
counterpart of the reference's compile at start); a window outside the
ladder is rejected at admission (counted), never scored at a new shape.

Bit-parity contract: replaying one stream through ``join → feed… → leave``
yields a `DetectionResult` bit-identical to `pipeline.model_detect` on the
accumulated trace at the same bucket's `DatasetConfig` — both paths share
the per-window lowering, the fixed-shape batch padding, the eval function
(`pipeline.make_eval_fn`), the host-side sigmoid and the aggregation tail
(`pipeline.accumulate_node_scores` / `finalize_detection`).  A window's
probabilities depend neither on which windows share its batch nor on its
slot in it: the forward is per-window math on the fixed ``batch_size``
shape.

Degradation: per-stream bounded admission (drop-OLDEST, counted), a
bounded alert sink (drop-on-full, counted), deadline-based batch close,
per-bucket in-flight limits, poison bisection and stream quarantine, a
scorer watchdog, and clean stream join/leave while batches are in flight.

Not ported yet: ``connect`` (the wire ingest), shadow scoring, the compile
cache, and the device-time, quality, archive, learning, response, flight
and SLO planes; without the device-time plane there is no SLO-aware
shedding, as in the reference.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from nerrf_tpu_torch.data.loaders import Trace
from nerrf_tpu_torch.device import resolve_device
from nerrf_tpu_torch.flight.journal import (DEFAULT_JOURNAL, fingerprint,
                                            make_trace_id)
from nerrf_tpu_torch.graph.builder import NODE_TYPE_FILE, measure_window
from nerrf_tpu_torch.models.joint import JointConfig, NerrfNet, build_nerrfnet
from nerrf_tpu_torch.pipeline import (
    DetectionResult,
    _inode_to_path,
    _pid_to_comm,
    accumulate_node_scores,
    finalize_detection,
    make_eval_fn,
    warmup_trace,
)
from nerrf_tpu_torch.schema import EventArrays, StringTable
from nerrf_tpu_torch.serve.alerts import (AlertSink, WindowAlert,
                                          calibrated_severity)
from nerrf_tpu_torch.serve.batcher import (MicroBatcher, ScoredWindow,
                                           WindowRequest)
from nerrf_tpu_torch.serve.config import (ServeConfig, bucket_tag,
                                          select_bucket)
from nerrf_tpu_torch.serve.windower import StreamWindower
from nerrf_tpu_torch.tracing import span as trace_span
from nerrf_tpu_torch.train.data import window_sample, windows_of_trace


class StreamHandle:
    """One admitted stream: its windower, live-request ledger, and scored
    windows.  ``cond`` guards the ledger; `leave` waits on it."""

    def __init__(self, stream_id: str, cfg: ServeConfig) -> None:
        self.id = stream_id
        self.windower = StreamWindower(window_sec=cfg.window_sec,
                                       stride_sec=cfg.stride_sec)
        self.cond = threading.Condition()
        self.live: "OrderedDict[int, WindowRequest]" = OrderedDict()
        self.scored: List[ScoredWindow] = []
        self.admitted = 0
        self.dropped = 0
        self.failed = 0
        self.skipped = 0
        self.rejected = 0
        self.closing = False


class OnlineDetectionService:
    """``model`` must lie on ``device`` (the card unless ``device='cpu'``),
    as for `pipeline.model_detect`."""

    def __init__(
        self,
        model: NerrfNet,
        cfg: Optional[ServeConfig] = None,
        registry=None,
        alert_sink: Optional[AlertSink] = None,
        window_log: Optional[list] = None,
        journal=None,
        device=None,
    ) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        self.device = resolve_device(device)
        param_dev = next(model.parameters()).device
        if param_dev.type != self.device.type:
            raise ValueError(f"OnlineDetectionService on {self.device}: the "
                             f"model lies on {param_dev}; move it first")
        self.cfg = cfg or ServeConfig()
        # the live model and its eval function, swapped together under
        # _swap_lock at a batch boundary (swap_params)
        self._model = model
        self._eval_fn = make_eval_fn(model)
        self._reg = registry
        self._journal = journal if journal is not None else DEFAULT_JOURNAL
        self.sink = alert_sink or AlertSink(self.cfg.alert_queue_slots,
                                            registry=registry,
                                            journal=self._journal)
        self._batcher = MicroBatcher(
            score_fn=self._score_fn, cfg=self.cfg, registry=registry,
            on_scored=self._on_scored, on_failed=self._on_failed,
            journal=self._journal)
        self._lock = threading.Lock()
        self._streams: Dict[str, StreamHandle] = {}
        # poison accounting (under _lock): per-stream strike counters fed
        # by PROVEN batch-poison windows (bisection isolated the window
        # while a sibling scored), and stream → quarantined-at monotonic
        # stamp for streams past cfg.quarantine_strikes — admission drops
        # a quarantined stream's windows (until quarantine_release_sec
        # passes) so it cannot keep burning device retries for every
        # cohabiting stream
        self._strikes: Dict[str, int] = {}
        self._quarantined: Dict[str, float] = {}
        self._warm = False
        self._admission_open = False
        self.warmup_seconds: Dict[str, float] = {}
        self._swap_lock = threading.Lock()
        self._live_version: Optional[int] = None
        # the operating point the service booted with: a swap to an
        # UNCALIBRATED version restores this instead of leaking the
        # outgoing version's calibrated cut
        self._boot_threshold = self.cfg.threshold
        # optional per-window log: every scored window appends
        # (stream, window_idx, latency_sec, late, model_version) — exact
        # admit→demux percentiles and per-window version stamps
        self._window_log = window_log

    # -- scoring --------------------------------------------------------------

    def _score_fn(self, batch: Dict[str, np.ndarray]):
        """One padded batch → host node probabilities: the live model's
        eval function and the same host-side sigmoid as model_detect (the
        parity path).

        The live model is read ONCE per batch (under the swap lock), so
        every window of a batch is scored by exactly one model version and
        a concurrent hot swap lands at a batch boundary; the captured eval
        function keeps the outgoing model alive until this batch returns.
        Returns ``(probs, model_version)``; the batcher stamps the version
        into every demuxed window."""
        with self._swap_lock:
            eval_fn = self._eval_fn
            version = self._live_version
        out = self._run_eval(eval_fn, batch)
        probs = 1.0 / (1.0 + np.exp(-out["node_logit"]))
        return probs, version

    def _run_eval(self, eval_fn, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
        """One forward: one call of the live model's eval function, which
        runs under ``torch.inference_mode`` on the calling thread's current
        stream and returns host arrays."""
        return eval_fn(batch)

    # -- model lifecycle ------------------------------------------------------

    @property
    def live_version(self) -> Optional[int]:
        return self._live_version

    def swap_params(self, state_dict: Mapping[str, torch.Tensor],
                    version: Optional[int] = None,
                    threshold: Optional[float] = None) -> None:
        """Zero-downtime hot swap: check ``state_dict`` against the live
        model's (keys, shapes, dtypes), load it into a second `NerrfNet` on
        the device, outside the lock, then repoint the live model and its
        eval function under the lock, so the swap lands between two
        batches.  Nothing queued is touched and no new shape is met.
        ``threshold`` moves the alerting operating point with the weights;
        ``None`` restores the boot-time operating point."""
        _check_swap_compatible(self._model.state_dict(), state_dict)
        with torch.device(self.device):
            staged = NerrfNet(self._model.cfg)
        staged.load_state_dict(state_dict, strict=True)
        staged.eval()
        eval_fn = make_eval_fn(staged)
        if self.device.type == "cuda":
            # the weights' copy lands OUTSIDE the lock
            torch.cuda.synchronize(self.device)
        want_thr = threshold if threshold is not None else self._boot_threshold
        with self._swap_lock:
            previous = self._live_version
            self._model = staged
            self._eval_fn = eval_fn
            self._live_version = version
            if want_thr != self.cfg.threshold:
                self.cfg = dataclasses.replace(self.cfg, threshold=want_thr)
        self._journal.record("registry_swap", version=version,
                             previous=previous, threshold=want_thr)

    def _warmup(self, log=None) -> None:
        """One forward per configured bucket the donor trace can fill,
        through the serve path's own shape authority, before admission
        opens: it builds the kernel libraries on this thread and sets up
        each bucket shape's library state, so no live window waits on
        either.  Readiness (`ready`) gates on completion."""
        for bucket, tag, batch in warmup_batches(self.cfg):
            t0 = time.perf_counter()
            self._score_fn(batch)
            self.warmup_seconds[tag] = round(time.perf_counter() - t0, 2)
            self._reg.gauge_set(
                "serve_warmup_seconds", self.warmup_seconds[tag],
                labels={"bucket": tag},
                help="seconds to ready one bucket at boot (one forward of "
                     "its shape-donor batch)")
            self._batcher.mark_warm(bucket)
            if log:
                log(f"serve bucket {tag} warm ({self.warmup_seconds[tag]}s)")

    # -- lifecycle ------------------------------------------------------------

    def start(self, log=None) -> "OnlineDetectionService":
        # config + model fingerprints up front: the journal tail identifies
        # exactly what was serving
        self._journal.record(
            "config", config_fingerprint=fingerprint(self.cfg),
            buckets=[bucket_tag(b) for b in self.cfg.buckets],
            batch_size=self.cfg.batch_size,
            batch_close_sec=self.cfg.batch_close_sec,
            window_deadline_sec=self.cfg.window_deadline_sec,
            threshold=self.cfg.threshold,
            model_fingerprint=fingerprint(self._model.cfg))
        if self.cfg.warmup_on_start:
            self._warmup(log=log)
        self._warm = True
        self._batcher.start()
        self._admission_open = True
        self._journal.record("readiness", ready=True,
                             warmup_seconds=dict(self.warmup_seconds))
        return self

    def ready(self):
        """Readiness: warmed AND admitting.  The third element is extra
        payload for a probe body: the live model version."""
        extra = {"model_version": (f"v{self._live_version}"
                                   if self._live_version is not None
                                   else None)}
        if not self._warm:
            return False, "warmup in progress", extra
        if not self._admission_open:
            return False, "admission closed", extra
        if self._batcher.wedged:
            # the scorer watchdog tripped: a forward has been stuck past
            # cfg.scorer_wedge_sec
            return False, "scorer wedged (device call stuck)", extra
        return True, "ok", extra

    def stop(self, drain: bool = True) -> None:
        if self._admission_open:
            self._journal.record("readiness", ready=False, reason="stopping")
        self._admission_open = False
        self._batcher.stop(drain=drain)

    # -- stream membership ----------------------------------------------------

    def join(self, stream_id: str) -> StreamHandle:
        if not self._admission_open:
            raise RuntimeError("service is not admitting streams "
                               "(call start(), or it is stopping)")
        with self._lock:
            if stream_id in self._streams:
                raise ValueError(f"stream {stream_id!r} already joined")
            handle = StreamHandle(stream_id, self.cfg)
            self._streams[stream_id] = handle
            self._reg.gauge_set(
                "serve_streams_active", len(self._streams),
                help="tracker streams currently admitted")
        return handle

    def feed(self, stream_id: str, events: EventArrays,
             strings: StringTable) -> int:
        """One decoded block in; returns the number of windows it closed
        (each admitted to the micro-batcher)."""
        handle = self._handle(stream_id)
        if handle.closing:
            raise RuntimeError(f"stream {stream_id!r} is leaving")
        closed = handle.windower.feed(events, strings)
        for idx, lo, hi in closed:
            self._admit(handle, idx, lo, hi)
        return len(closed)

    def leave(self, stream_id: str, flush: bool = True,
              timeout: float = 60.0) -> DetectionResult:
        """Flush the stream's partial windows, wait for its in-flight
        windows to score, and return the final DetectionResult.  Safe
        mid-batch: still-queued windows are dropped in place; windows
        already assembled into a batch are awaited (bounded), and the
        batcher's deadline close guarantees they fire without this stream
        feeding more."""
        handle = self._handle(stream_id)
        handle.closing = True
        if flush:
            for idx, lo, hi in handle.windower.flush():
                self._admit(handle, idx, lo, hi)
        deadline = time.monotonic() + timeout
        with handle.cond:
            # a stopped OR WEDGED batcher scores nothing more (re-checked
            # each 0.25 s wait slice)
            while handle.live and self._batcher.healthy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                handle.cond.wait(timeout=min(remaining, 0.25))
            # still-queued leftovers (never assembled): drop cleanly
            leave_drops = []
            for idx in [i for i, r in handle.live.items()
                        if self._batcher.mark_dropped(r)]:
                req = handle.live.pop(idx)
                handle.dropped += 1
                self._reg.counter_inc(
                    "serve_admission_dropped_total",
                    labels={"reason": "leave"},
                    help="windows dropped at the serve admission boundary")
                leave_drops.append((idx, req.trace_id))
        # journal OUTSIDE handle.cond (a listener must never run while the
        # cond is held: the scorer's demux needs it)
        for idx, tid in leave_drops:
            self._journal.record(
                "admission_drop", stream=handle.id, window_id=idx,
                trace_id=tid, reason="leave")
        det = self._finalize(handle)
        with self._lock:
            self._streams.pop(stream_id, None)
            self._reg.gauge_set(
                "serve_streams_active", len(self._streams),
                help="tracker streams currently admitted")
        self.sink.on_detection(stream_id, det)
        return det

    # -- admission ------------------------------------------------------------

    def _handle(self, stream_id: str) -> StreamHandle:
        with self._lock:
            try:
                return self._streams[stream_id]
            except KeyError:
                raise KeyError(f"stream {stream_id!r} not joined") from None

    def _drop(self, handle: StreamHandle, idx: int, trace_id: str,
              reason: str, **data) -> None:
        """Count and journal one window dropped at admission (the caller
        charges it to the stream's ledger)."""
        self._reg.counter_inc(
            "serve_admission_dropped_total", labels={"reason": reason},
            help="windows dropped at the serve admission boundary")
        self._journal.record("admission_drop", stream=handle.id,
                             window_id=idx, trace_id=trace_id, reason=reason,
                             **data)

    def _admit(self, handle: StreamHandle, idx: int, lo: int, hi: int) -> None:
        trace_id = make_trace_id(handle.id, idx, lo)
        with trace_span("serve_admit", stream=handle.id, window=idx,
                        trace_id=trace_id) as sp:
            if not self._admission_open:
                # the batcher is stopped/stopping: a window admitted now
                # would queue forever and wedge this stream's leave()
                handle.dropped += 1
                self._drop(handle, idx, trace_id, "closed")
                return
            released = False
            base = _base_stream(handle.id)
            with self._lock:
                q_at = self._quarantined.get(base)
                if q_at is not None and self.cfg.quarantine_release_sec \
                        and time.monotonic() - q_at \
                        >= self.cfg.quarantine_release_sec:
                    # timed release: the stream gets a clean slate (and
                    # earns quarantine again if it is still poisonous)
                    del self._quarantined[base]
                    self._strikes[base] = 0
                    q_at = None
                    released = True
            if released:
                self._journal.record("stream_released", stream=base,
                                     after_sec=self.cfg
                                     .quarantine_release_sec)
                self._reg.gauge_set(
                    "serve_stream_strikes", 0.0, labels={"stream": base},
                    help="proven poison windows charged against a "
                         "stream (quarantined at quarantine_strikes)")
            if q_at is not None:
                # the stream earned cfg.quarantine_strikes proven poison
                # windows: its traffic is shed at admission
                handle.dropped += 1
                self._drop(handle, idx, trace_id, "quarantined")
                return
            # measure/lower from the window's slice of the stream, not the
            # whole accumulated history (bit-identical: the same events are
            # selected either way)
            ev = handle.windower.window_view(lo, hi)
            n, e = measure_window(ev, lo, hi)
            sel = ev.valid & (ev.ts_ns >= lo) & (ev.ts_ns < hi)
            files = len(np.unique(ev.inode[sel & (ev.inode > 0)]))
            sp.args.update(nodes=n, edges=e, files=files)
            bucket = select_bucket(n, e, files, self.cfg.buckets)
            if bucket is None:
                handle.rejected += 1
                self._drop(handle, idx, trace_id, "oversize", nodes=int(n),
                           edges=int(e), files=int(files))
                return
            sp.args["bucket"] = bucket_tag(bucket)
            sample, _stats = window_sample(
                Trace(events=ev, strings=handle.windower.strings,
                      ground_truth=None, labels=None, name=handle.id),
                lo, hi, self.cfg.dataset_config(bucket))
            if sample is None:
                handle.skipped += 1
                self._reg.counter_inc(
                    "serve_windows_skipped_total",
                    help="windows below min_events (no signal, not scored)")
                return
            now = time.perf_counter()
            req = WindowRequest(
                stream=handle.id, window_idx=idx, lo_ns=lo, hi_ns=hi,
                bucket=bucket, sample=sample, t_admit=now,
                deadline=now + self.cfg.window_deadline_sec,
                trace_id=trace_id,
                nodes=int(n), edges=int(e), files=int(files))
            dropped_old = None
            with handle.cond:
                if len(handle.live) >= self.cfg.stream_queue_slots:
                    # drop-OLDEST: under sustained overload the newest
                    # evidence wins; only still-queued requests are droppable
                    for old_idx, old in handle.live.items():
                        if self._batcher.mark_dropped(old):
                            del handle.live[old_idx]
                            handle.dropped += 1
                            dropped_old = (old_idx, old.trace_id)
                            break
                handle.live[idx] = req
                handle.admitted += 1
            if dropped_old is not None:
                # journal OUTSIDE handle.cond (see leave)
                self._drop(handle, dropped_old[0], dropped_old[1],
                           "backpressure")
            self._reg.counter_inc(
                "serve_windows_admitted_total",
                help="windows admitted into the micro-batcher")
            self._batcher.submit(req)

    # -- demux ----------------------------------------------------------------

    def _on_scored(self, scored: List[ScoredWindow]) -> None:
        alert_thr = (self.cfg.threshold if self.cfg.threshold is not None
                     else 0.5)
        for s in scored:
            if self._window_log is not None:
                self._window_log.append(
                    (s.stream, s.window_idx, s.t_scored - s.t_admit, s.late,
                     s.model_version))
            # alerting: hot windows only, never blocking (bounded sink).
            # Fail-open per window: a raising sink loses at most this
            # window's alert, never the ledger resolution below — an
            # unresolved window wedges leave()
            try:
                mask = s.node_mask.astype(bool)
                hot_slots = (np.nonzero(mask & (s.probs >= alert_thr))[0]
                             if mask.any() else np.empty(0, np.int64))
                if len(hot_slots):
                    order = np.argsort(-s.probs[hot_slots], kind="stable")
                    hot = [("file" if s.node_type[i] == NODE_TYPE_FILE
                            else "proc",
                            int(s.node_key[i]), float(s.probs[i]))
                           for i in hot_slots[order][:16]]
                    max_prob = float(s.probs[mask].max())
                    self.sink.emit(WindowAlert(
                        stream=s.stream, window_idx=s.window_idx,
                        lo_ns=s.lo_ns, hi_ns=s.hi_ns,
                        max_prob=max_prob, hot=hot,
                        t_admit=s.t_admit, t_scored=s.t_scored,
                        late=s.late, model_version=s.model_version,
                        trace_id=s.trace_id,
                        # computed ONCE here, at the demux boundary
                        severity=calibrated_severity(max_prob, alert_thr)))
            except Exception as e:  # noqa: BLE001 — demux must resolve
                self._journal.record(
                    "demux_drop", stream=s.stream, window_id=s.window_idx,
                    trace_id=s.trace_id, reason="emit_error",
                    error=f"{type(e).__name__}: {e}")
            # ledger resolution LAST: the cond notify releases leave()
            # waiters, so the alert must be emitted BEFORE it fires
            with self._lock:
                handle = self._streams.get(s.stream)
            if handle is not None:
                with handle.cond:
                    handle.live.pop(s.window_idx, None)
                    handle.scored.append(s)
                    handle.cond.notify_all()

    def _on_failed(self, reqs: List[WindowRequest], exc: BaseException) -> None:
        """Terminal failure for a cohort the batcher could not score.  Each
        window is journaled as ``device_batch_failed`` with its trace ID.
        Windows the batcher marked ``poison`` (bisection pinned the failure
        to the window while a sibling scored) strike their stream toward
        quarantine; an all-fail batch or an unbisected cohort indicts the
        device and blames no stream."""
        reason = type(exc).__name__
        for r in reqs:
            with self._lock:
                handle = self._streams.get(r.stream)
            if handle is not None:
                with handle.cond:
                    handle.live.pop(r.window_idx, None)
                    handle.failed += 1
                    handle.cond.notify_all()
            # strike/metric key: the BASE stream name (a resident stream
            # renames per session, s0, s0#1, …)
            base = _base_stream(r.stream)
            self._reg.counter_inc(
                "serve_windows_failed_total",
                labels={"reason": reason, "stream": base},
                help="windows lost to a failed device batch, by failure "
                     "type and stream")
            strikes = None
            newly_quarantined = False
            if r.poison and self.cfg.quarantine_strikes:
                with self._lock:
                    strikes = self._strikes.get(base, 0) + 1
                    self._strikes[base] = strikes
                    if strikes >= self.cfg.quarantine_strikes \
                            and base not in self._quarantined:
                        self._quarantined[base] = time.monotonic()
                        newly_quarantined = True
                self._reg.counter_inc(
                    "serve_windows_quarantined_total",
                    labels={"stream": base},
                    help="windows isolated as batch poison by bisection "
                         "and dropped (cohabiting windows scored)")
                self._reg.gauge_set(
                    "serve_stream_strikes", float(strikes),
                    labels={"stream": base},
                    help="proven poison windows charged against a "
                         "stream (quarantined at quarantine_strikes)")
            # journal OUTSIDE handle.cond/self._lock; the record keeps the
            # SESSION id, the strike ledger is base-keyed
            self._journal.record(
                "device_batch_failed", stream=r.stream,
                window_id=r.window_idx, trace_id=r.trace_id,
                reason=f"{reason}: {exc}", poison=r.poison,
                **({"strikes": strikes} if strikes is not None else {}))
            if newly_quarantined:
                self._journal.record(
                    "stream_quarantined", stream=base,
                    strikes=strikes,
                    limit=self.cfg.quarantine_strikes,
                    release_sec=self.cfg.quarantine_release_sec)

    # -- finalize -------------------------------------------------------------

    def _finalize(self, handle: StreamHandle) -> DetectionResult:
        # stamp the scoring model: one version for the whole stream →
        # "serve[agg]@vN"; mixed (scored across a hot swap) or unversioned
        # → the plain tag
        versions = {s.model_version for s in handle.scored}
        detector = f"serve[{self.cfg.agg}]"
        if len(versions) == 1 and None not in versions:
            detector += f"@v{versions.pop()}"
        if handle.windower.strings is None:  # stream never produced events
            return DetectionResult({}, {}, {}, detector=detector)
        trace = handle.windower.trace(name=handle.id)
        ino_path = _inode_to_path(trace)
        pid_comm = _pid_to_comm(trace)
        window_scores: Dict[str, list] = {}
        proc_scores: Dict[str, float] = {}
        # window order, exactly like model_detect's batch loop — keeps the
        # per-path window-score lists bit-identical
        for s in sorted(handle.scored, key=lambda sw: sw.window_idx):
            accumulate_node_scores(s.probs, s.node_type, s.node_key,
                                   s.node_mask, ino_path, pid_comm,
                                   window_scores, proc_scores)
        return finalize_detection(trace, window_scores, proc_scores,
                                  agg=self.cfg.agg,
                                  threshold=self.cfg.threshold,
                                  detector=detector,
                                  ino_path=ino_path)


def _base_stream(stream_id: str) -> str:
    """The stable stream name under session renames (<name>, <name>#1, …):
    strike ledgers, quarantine state and per-stream metric labels key on
    it."""
    return stream_id.split("#", 1)[0]


def warmup_batches(cfg: ServeConfig):
    """Yield ``(bucket, tag, shape-donor batch)`` for every configured
    bucket the warmup donor trace can fill: the set `_warmup` runs."""
    tiny = warmup_trace("serve-warmup")
    for bucket in cfg.buckets:
        samples = windows_of_trace(tiny, cfg.dataset_config(bucket))
        if not samples:
            continue
        batch = {k: np.broadcast_to(
            v, (cfg.batch_size,) + v.shape).copy()
            for k, v in samples[0].items()}
        yield bucket, bucket_tag(bucket), batch


def batch_signature(batch: Dict[str, np.ndarray]) -> tuple:
    """A padded batch's (name, shape, dtype) set: what tells one bucket's
    forward shape from another's."""
    return tuple(sorted(
        (k, tuple(v.shape), str(getattr(v, "dtype", type(v).__name__)))
        for k, v in batch.items()))


def _check_swap_compatible(current: Mapping[str, torch.Tensor],
                           incoming: Mapping[str, torch.Tensor]) -> None:
    """The swap gate: the incoming state dict must hold the live one's keys,
    and each tensor its shape and dtype, so the swap meets no new shape.
    Raises ValueError naming the first mismatch."""
    missing = [k for k in current if k not in incoming]
    extra = [k for k in incoming if k not in current]
    if missing or extra:
        first = (f"missing {missing[0]!r}" if missing
                 else f"unexpected {extra[0]!r}")
        raise ValueError(f"cannot hot-swap: the state dict's keys differ "
                         f"from the live model's ({first})")
    for k, cur in current.items():
        new = incoming[k]
        c_sig = (tuple(cur.shape), cur.dtype)
        n_sig = (tuple(new.shape), new.dtype)
        if c_sig != n_sig:
            raise ValueError(
                f"cannot hot-swap: {k} is {n_sig}, the live model's is "
                f"{c_sig}: the checkpoint was trained at a different "
                f"architecture")


def init_untrained_model(cfg: JointConfig = JointConfig(),
                         serve_cfg: Optional[ServeConfig] = None,
                         seed: int = 0, device=None) -> NerrfNet:
    """A randomly initialized `NerrfNet` (`build_nerrfnet`) on ``device``,
    for load testing and smoke runs without a trained checkpoint.  As the
    reference's ``init_untrained_params``, it requires the service's
    smallest bucket to lower a window of the donor trace."""
    serve_cfg = serve_cfg or ServeConfig()
    ds_cfg = serve_cfg.dataset_config(sorted(serve_cfg.buckets)[0])
    if not windows_of_trace(warmup_trace("init"), ds_cfg):
        raise RuntimeError("could not synthesize an init sample")
    return build_nerrfnet(cfg, seed=seed, device=device)
