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

``connect`` drains a Tracker endpoint (the gRPC wire of `ingest.service`)
as one stream, and ``attach_respond`` hands every alert to the respond
tier's `ResponseRouter`.

Model lifecycle (`registry/`): ``attach_manager`` binds a `ModelManager`,
which hot-swaps promoted versions (`swap_params`) and stages candidates
(`start_shadow`): a staged candidate is a second `NerrfNet` on the device
that scores every live batch after the live forward, and only the paired
comparison reaches the manager's guardrails.  The quality plane
(`quality/`) compares the scored windows against the live version's
reference profile, and ``attach_archive`` spools the telemetry to a
durable archive (`archive/`).

The flight and learn planes: every scored window's stage stamps feed the
SLO tracker (``slo``, `flight/slo.py`: per-stream e2e histograms, budget
burn, exemplar trace IDs), ``attach_flight`` feeds a `FlightRecorder`'s
p99 trigger, and ``attach_learn`` tees admitted windows into a
`learn.ReplayWriter` (the payload at admission, the scores at demux, a
failed window discarded).  Each observer is fail-open where the reference's
is.

The device-time plane (`devtime/`): every scored batch's synced scoring
call is timed on the host clock and fed, after warmup, to a
`DeviceTimeAccountant` (``devtime``: per-program MFU against the card's
peak, utilization, useful-FLOPs and the capacity-headroom predictor),
whose per-bucket analytic costs a background thread traces on ``meta``
tensors after warmup (no launch, no device work).  Under predicted
pressure (headroom below ``shed_headroom_margin``) an overflowing stream's
queue sheds the worst device-stage SLO budget burner's oldest window
instead of its own (SLO-aware shedding, ``fleet_shed``).  Not ported yet:
the compile cache (ROADMAP A.7).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from nerrf_tpu_torch.data.loaders import Trace
from nerrf_tpu_torch.device import resolve_device
from nerrf_tpu_torch.devtime.accounting import DeviceTimeAccountant
from nerrf_tpu_torch.flight.journal import (DEFAULT_JOURNAL, fingerprint,
                                            make_trace_id)
from nerrf_tpu_torch.flight.slo import SLOTracker
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
from nerrf_tpu_torch.quality import QualityMonitor
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


@dataclasses.dataclass
class StreamRun:
    """A `connect`-spawned drain: result or error lands when the wire
    stream ends and the stream has left."""

    stream: str
    thread: threading.Thread
    done: threading.Event
    result: Optional[DetectionResult] = None
    error: Optional[BaseException] = None


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
        quality_monitor=None,
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
        # the SLO plane: per-stream e2e histograms + per-stage budget burn
        # from the stage stamps every window carries (flight/slo.py)
        self._slo = SLOTracker(self.cfg.window_deadline_sec,
                               registry=registry, journal=self._journal)
        # optional FlightRecorder (flight/recorder.py, attach_flight): fed
        # per-window e2e latencies for the p99-breach trigger; journal
        # records reach it through its own subscription
        self._flight = None
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
        # a staged shadow candidate (its eval function and version), read
        # with the live model under _swap_lock, and the ModelManager that
        # judges it (attach_manager)
        self._shadow: Optional[Tuple[object, int]] = None
        self._manager = None
        # the operating point the service booted with: a swap to an
        # UNCALIBRATED version restores this instead of leaking the
        # outgoing version's calibrated cut
        self._boot_threshold = self.cfg.threshold
        # optional per-window log: every scored window appends
        # (stream, window_idx, latency_sec, late, model_version) — exact
        # admit→demux percentiles and per-window version stamps
        self._window_log = window_log
        # optional respond.ResponseRouter (attach_respond)
        self._respond = None
        # detection-quality plane: trailing score/feature drift sketches vs
        # the live version's reference profile, fed at the demux boundary.
        # Inactive (one None check per window) until set_quality_profile
        # binds a reference.  ``quality_monitor`` brings one of the caller's
        # own (its QualityConfig: evidence gates and cadences)
        self._quality = (quality_monitor if quality_monitor is not None
                         else (QualityMonitor(registry=registry,
                                              journal=self._journal)
                               if self.cfg.quality_monitoring else None))
        # telemetry archive plane: when attached, the demux boundary feeds
        # each scored window's measured structure and stage stamps into the
        # writer's workload sketches (journal records reach it through its
        # own subscription)
        self._archive = None
        # optional learn.ReplayWriter (attach_learn)
        self._learn = None
        # device-efficiency plane (devtime/): per-program MFU / utilization
        # / useful-FLOPs gauges from the scorer's measured seconds + the
        # analytic cost model registered after warmup, and the capacity-
        # headroom predictor over the admit stream.  Card-relative gauges
        # stay absent on the CPU (null-not-fake)
        self._devtime = (DeviceTimeAccountant(
                             registry=registry, journal=self._journal,
                             window_sec=self.cfg.devtime_window_sec)
                         if self.cfg.devtime_accounting else None)
        # the background cost-registration thread (start()) and its stop
        # flag: stop() waits it out, so no trace outlives the service
        self._devtime_thread: Optional[threading.Thread] = None
        self._devtime_stop = threading.Event()

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
            shadow = self._shadow
        # the host clock around the synced call (the eval function returns
        # host arrays, so its copy out waits for the card), as the
        # reference times its device_get
        t_dev = time.perf_counter()
        out = self._run_eval(eval_fn, batch)
        device_sec = time.perf_counter() - t_dev
        probs = 1.0 / (1.0 + np.exp(-out["node_logit"]))
        if self._devtime is not None and self._warm:
            # steady state only: the warmup call's seconds include the
            # kernel libraries' build and load
            self._observe_devtime(batch, device_sec)
        if shadow is not None:
            self._shadow_score(shadow, batch, probs)
        return probs, version

    def _observe_devtime(self, batch: Dict[str, np.ndarray],
                         device_sec: float) -> None:
        """Feed one scoring call to the efficiency accountant: the bucket
        tag comes from the padded shapes (exactly how the program is
        keyed), occupancy from which slots carry real nodes, and the
        padding discount from the occupied slots' node-mask density."""
        n = batch["node_feat"].shape[1]
        e = batch["edge_src"].shape[1]
        s = batch["seq_feat"].shape[1]
        tag = f"{n}n/{e}e/{s}s"
        mask = np.asarray(batch["node_mask"])
        occupied = mask.any(axis=1)
        occ = int(occupied.sum())
        density = float(mask[occupied].mean()) if occ else None
        self._devtime.observe_batch(
            f"serve_eval[{tag}]", tag, device_sec,
            occupancy=occ, slots=int(mask.shape[0]), real_density=density)

    def _run_eval(self, eval_fn, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
        """One forward: one call of the live model's eval function, which
        runs under ``torch.inference_mode`` on the calling thread's current
        stream and returns host arrays."""
        return eval_fn(batch)

    def _shadow_score(self, shadow, batch, live_probs) -> None:
        """Score the staged candidate on the same padded batch the live
        model just scored (same shapes, only the weights differ) and feed
        the paired comparison to the manager.  Best-effort: a shadow failure
        is counted and never costs a live window."""
        s_eval_fn, s_version = shadow
        try:
            with trace_span("registry_shadow_score", device=True,
                            version=s_version,
                            windows=int(live_probs.shape[0])):
                s_out = self._run_eval(s_eval_fn, batch)
            s_probs = 1.0 / (1.0 + np.exp(-s_out["node_logit"]))
            if self._manager is None:
                return
            mask = np.asarray(batch["node_mask"]).astype(bool)
            for j in range(live_probs.shape[0]):
                if mask[j].any():  # skip the batch's zero-padded tail slots
                    self._manager.observe_shadow(
                        live_probs[j], s_probs[j], mask[j], s_version)
        except Exception as e:  # noqa: BLE001 — shadow is advisory
            self._reg.counter_inc(
                "registry_shadow_failures_total",
                help="shadow-scoring attempts that raised (live scoring "
                     "unaffected)")
            if self._manager is not None:
                self._manager._log(
                    f"shadow score failed: {type(e).__name__}: {e}")

    # -- model lifecycle ------------------------------------------------------

    @property
    def model_config(self):
        """The architecture the warmed bucket forwards run."""
        return self._model.cfg

    @property
    def live_version(self) -> Optional[int]:
        return self._live_version

    def attach_manager(self, manager) -> None:
        self._manager = manager

    def attach_flight(self, recorder) -> None:
        """Bind a FlightRecorder: per-window e2e latencies feed its
        p99-breach trigger (journal-record triggers need no binding — the
        recorder subscribes to the journal itself)."""
        self._flight = recorder

    def attach_archive(self, writer) -> None:
        """Bind a telemetry `archive.ArchiveWriter`: scored windows feed
        its workload sketches at the demux boundary, rejected windows its
        rejected-demand sketches (journal records reach it through its own
        subscription)."""
        self._archive = writer

    def attach_learn(self, writer) -> None:
        """Bind a learn.ReplayWriter: admission tees each window's event
        payload (per-stream reservoir decides acceptance), the demux
        boundary joins the scores, and the writer's own thread owns the
        disk."""
        self._learn = writer

    @property
    def slo(self) -> SLOTracker:
        return self._slo

    def flight_info(self) -> dict:
        """Live identity for a flight bundle's manifest: which model is
        serving, what the ladder/threshold are — captured at dump time."""
        info = {
            "model_version": (f"v{self._live_version}"
                              if self._live_version is not None else None),
            "threshold": self.cfg.threshold,
            "buckets": [bucket_tag(b) for b in self.cfg.buckets],
            "config_fingerprint": fingerprint(self.cfg),
        }
        if self._manager is not None:
            info["lineage"] = self._manager.lineage
            if self._manager.shadow_version is not None:
                info["shadow_version"] = f"v{self._manager.shadow_version}"
        return info

    @property
    def devtime(self) -> Optional[DeviceTimeAccountant]:
        """The device-efficiency accountant (None when disabled): its
        snapshot() is the serve leg's devtime block."""
        return self._devtime

    @property
    def quality(self) -> Optional[QualityMonitor]:
        """The drift monitor (None when disabled by config)."""
        return self._quality

    def set_quality_profile(self, profile, version=None) -> None:
        """Bind the live version's reference quality profile (dict or
        QualityProfile; None clears, so a version published without a
        profile exports no quality series rather than comparing against a
        stale reference).  Called by the ModelManager on attach and swap,
        and by the serve CLI at boot.  No-op when the plane is off."""
        if self._quality is not None:
            self._quality.set_reference(profile, version=version)

    def quality_snapshot(self) -> Optional[dict]:
        """Live sketches and the reference; None when the plane is off or
        no reference is bound."""
        return (self._quality.snapshot()
                if self._quality is not None else None)

    def _stage(self, state_dict: Mapping[str, torch.Tensor]):
        """Check ``state_dict`` against the live model's (keys, shapes,
        dtypes), load it into a second `NerrfNet` on the device and return
        its eval function; the weights' copy has landed on return.  Takes no
        lock: the caller repoints under ``_swap_lock`` afterwards."""
        _check_swap_compatible(self._model.state_dict(), state_dict)
        with torch.device(self.device):
            staged = NerrfNet(self._model.cfg)
        staged.load_state_dict(state_dict, strict=True)
        staged.eval()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return staged, make_eval_fn(staged)

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
        staged, eval_fn = self._stage(state_dict)  # OUTSIDE the lock
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

    def start_shadow(self, state_dict: Mapping[str, torch.Tensor],
                     version: int) -> None:
        """Stage a candidate: from the next batch on, every live batch is
        also scored by a second `NerrfNet` holding ``state_dict`` (staged as
        `swap_params` stages, outside the lock, at the live shapes).  Its
        results never reach alerts or streams, only the paired guardrail
        statistics."""
        _staged, eval_fn = self._stage(state_dict)
        with self._swap_lock:
            self._shadow = (eval_fn, int(version))

    def stop_shadow(self) -> None:
        with self._swap_lock:
            self._shadow = None

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

    def _register_devtime_costs(self) -> None:
        """Resolve the analytic cost of every warmup bucket program and
        bind it to the accountant (background; see start()): a meta copy
        of the live architecture traced per bucket (memoized by
        architecture and shapes), no launch, no device work.  Best-effort
        throughout: a failed trace leaves that program's MFU gauge absent,
        never blocks or raises into the serving plane."""
        from nerrf_tpu_torch.devtime.costmodel import serve_cost

        try:
            for _bucket, tag, batch in warmup_batches(self.cfg):
                if self._devtime_stop.is_set():
                    return  # stopping: remaining costs don't matter
                cost = serve_cost(self._model, batch, tag)
                if cost is not None:
                    self._devtime.register_cost(f"serve_eval[{tag}]", cost)
        except Exception:  # noqa: BLE001 — advisory gauges only
            pass

    def attach_respond(self, router) -> None:
        """Bind a respond.ResponseRouter: every WindowAlert leaving the
        demux boundary is also offered to the incident queue (the router
        applies its own severity admission)."""
        self._respond = router

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
        if self._devtime is not None:
            # cost-model registration OFF the boot path: readiness never
            # waits on it, and until a program's cost lands its MFU gauge
            # is simply absent (the seconds/util gauges flow from the first
            # scored batch either way).  Non-daemon, with a stop flag that
            # stop() sets and a join: no trace outlives the service.  The
            # counter's first use imports torch._dynamo, as a profiler's
            # start does: imported here, so that the cost thread and a
            # capture thread never both import it (their module locks can
            # deadlock)
            import torch._dynamo  # noqa: F401

            self._devtime_stop.clear()
            self._devtime_thread = threading.Thread(
                target=self._register_devtime_costs, daemon=False,
                name="nerrf-devtime-costs")
            self._devtime_thread.start()
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
        if self._manager is not None:
            extra["lineage"] = self._manager.lineage
            if self._manager.shadow_version is not None:
                extra["shadow_version"] = f"v{self._manager.shadow_version}"
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
        if self._devtime_thread is not None:
            # the stop flag skips the remaining buckets; the trace in
            # progress is O(seconds)
            self._devtime_stop.set()
            self._devtime_thread.join(timeout=30.0)
            self._devtime_thread = None

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

    def connect(self, stream_id: str, target: str,
                max_events: Optional[int] = None,
                timeout: float = 30.0,
                follow: bool = False,
                reconnect_sec: float = 2.0,
                reconnect_max_sec: float = 30.0) -> StreamRun:
        """Drain a live Tracker endpoint as one stream (join → feed per
        decoded block → leave at end-of-stream), on its own actor thread.
        Each block is decoded by the client's `IngestBridge` (the native
        decoder when ``libnerrf_ingest.so`` builds).

        ``follow`` makes the actor RESIDENT (the serve pod's mode, same
        contract as `nerrf ingest --follow`): when the wire stream ends —
        clean end-of-replay or a gRPC deadline — the session finalizes
        (DetectionResult in ``run.result``) and the actor reconnects as
        ``<stream_id>#<n>``, forever, until the service stops admitting.
        Without it a 'resident' deployment would exit at the first stream
        end and crash-loop through the warmup sweep.

        Reconnect pacing is capped exponential backoff with jitter from
        ``reconnect_sec`` up to ``reconnect_max_sec``: a session that
        never produced a block doubles the delay (a dead endpoint is not
        hammered, and the jitter de-synchronizes a fleet reconnecting to
        one recovered tracker), while a session that fed at least one
        block resets to the base (a live-but-flaky wire reconnects
        promptly).  Every reconnect is journaled and counted into
        ``nerrf_serve_reconnects_total{stream}``."""
        import random

        from nerrf_tpu_torch.ingest.service import TrackerClient

        done = threading.Event()
        run = StreamRun(stream=stream_id, thread=None, done=done)

        def drain() -> None:
            session = 0
            backoff = max(reconnect_sec, 0.001)
            try:
                while True:
                    sid = stream_id if session == 0 \
                        else f"{stream_id}#{session}"
                    joined = False
                    blocks = 0
                    try:
                        self.join(sid)
                        joined = True
                        client = TrackerClient(target)
                        for events, strings in client.iter_blocks(
                                max_events=max_events, timeout=timeout,
                                stream=sid):
                            self.feed(sid, events, strings)
                            blocks += 1
                        run.result = self.leave(sid)
                        run.error = None
                    except BaseException as e:  # noqa: BLE001 — via run.error
                        run.error = e
                        # only tear down a stream THIS drain joined — when
                        # join() itself failed (duplicate id), the live
                        # stream under that id belongs to another actor
                        if joined:
                            try:
                                run.result = self.leave(sid, timeout=5.0)
                            except Exception:  # noqa: BLE001
                                pass
                    if not (follow and self._admission_open):
                        return
                    session += 1
                    # healthy = the wire produced data this session: reset
                    # to the base; a dead endpoint (0 blocks) backs off
                    if blocks > 0:
                        backoff = max(reconnect_sec, 0.001)
                    delay = backoff * (0.5 + random.random() / 2.0)
                    if blocks == 0:
                        backoff = min(backoff * 2.0, reconnect_max_sec)
                    self._reg.counter_inc(
                        "serve_reconnects_total",
                        labels={"stream": stream_id},
                        help="resident-stream wire reconnects (the "
                             "follow-mode session restarts)")
                    self._journal.record(
                        "reconnect", stream=stream_id, session=session,
                        healthy=blocks > 0, delay_sec=round(delay, 3),
                        error=(f"{type(run.error).__name__}: {run.error}"
                               if run.error is not None else None))
                    # interruptible sleep: a stopping service must not
                    # hold the actor for a full capped backoff
                    deadline = time.monotonic() + delay
                    while self._admission_open:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        time.sleep(min(0.25, left))
                    if not self._admission_open:
                        # stopped mid-backoff: exit WITHOUT attempting
                        # another join — it would raise "not admitting"
                        # and overwrite run.error on a session that
                        # finalized cleanly
                        return
            finally:
                done.set()

        t = threading.Thread(target=drain, daemon=True,
                             name=f"nerrf-serve-{stream_id}")
        run.thread = t
        t.start()
        return run

    # -- admission ------------------------------------------------------------

    def _handle(self, stream_id: str) -> StreamHandle:
        with self._lock:
            try:
                return self._streams[stream_id]
            except KeyError:
                raise KeyError(f"stream {stream_id!r} not joined") from None

    # -- SLO-aware shedding -----------------------------------------------------

    def _shed_pressure(self) -> bool:
        """True when the capacity-headroom predictor says the whole
        service is under pressure (predicted headroom below the shed
        margin) — the gate that turns a per-stream queue overflow into
        a fleet-ranked shed instead of a private drop-oldest."""
        if not self.cfg.slo_aware_shedding or self._devtime is None:
            return False
        est = self._devtime.last_estimate
        return est is not None and \
            est.headroom_streams < self.cfg.shed_headroom_margin

    def _select_shed_victim(self, base: str):
        """The stream that loses evidence under pressure: worst trailing
        DEVICE-stage SLO budget burn (flight/slo stage accounting) among
        non-quarantined streams burning MORE than the admitting one —
        healthy streams keep bit-parity, and when the admitting stream
        is itself the worst burner the answer is None (its own
        drop-oldest bound already sheds the right victim).  Returns
        ``(handle, burn_ratio, ranking)`` or None.

        Device stage, NOT the summed total: on a saturated shared FIFO
        every cohabitant's total burn converges to the deadline — their
        latency is set by the queue they all share, so the total cannot
        separate the stream CAUSING the pressure from the streams
        suffering it.  The device stage is the occupancy a stream's own
        windows impose on the fleet, and it separates cause from victim
        by construction."""
        snap = self._slo.snapshot()
        burns: Dict[str, float] = {}
        for s, ent in (snap.get("per_stream") or {}).items():
            burn = (ent.get("budget_burn") or {}).get("device", 0.0)
            b = _base_stream(s)
            burns[b] = max(burns.get(b, 0.0), burn)
        own = burns.get(base, 0.0)
        with self._lock:
            quarantined = set(self._quarantined)
            by_base: Dict[str, List[StreamHandle]] = {}
            for h in self._streams.values():
                by_base.setdefault(_base_stream(h.id), []).append(h)
        ranking = sorted(((b, round(r, 4)) for b, r in burns.items()
                          if r > 0), key=lambda kv: kv[1], reverse=True)
        for b, r in ranking:
            if r <= own:
                break  # sorted: nobody below burns more than us
            if b == base or b in quarantined:
                continue
            for h in by_base.get(b, ()):
                if h.live:  # racy hint; _shed_one rechecks under cond
                    return h, r, ranking
        return None

    def _shed_one(self, base: str) -> Optional[dict]:
        """Drop the worst budget-burner's OLDEST queued window (the
        intra-stream bound survives inside the victim) and return the
        evidence for the fleet_shed record, or None when no ranked
        victim exists.  The victim's cond is taken and released here —
        never nested with the admitting stream's."""
        picked = self._select_shed_victim(base)
        if picked is None:
            return None
        vhandle, burn, ranking = picked
        with vhandle.cond:
            for old_idx, old in vhandle.live.items():
                if self._batcher.mark_dropped(old):
                    del vhandle.live[old_idx]
                    vhandle.dropped += 1
                    self._reg.counter_inc(
                        "serve_admission_dropped_total",
                        labels={"reason": "shed"},
                        help="windows dropped at the serve admission "
                             "boundary")
                    self._reg.counter_inc(
                        "fleet_shed_total",
                        labels={"stream": _base_stream(vhandle.id),
                                "reason": "budget_burn"},
                        help="windows shed from SLO-budget-burning "
                             "streams under capacity pressure")
                    return {"victim": vhandle.id, "window_id": old_idx,
                            "trace_id": old.trace_id,
                            "burn_ratio": burn, "ranking": ranking}
        return None

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
                try:
                    if self._archive is not None:
                        # rejected-demand sketches: the oversize window's
                        # structure, not just a count.  Fail-open: telemetry
                        # loss must never become an admission fault
                        self._archive.observe_rejected(
                            nodes=int(n), edges=int(e), files=int(files))
                except Exception:  # noqa: BLE001
                    pass
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
            try:
                if self._learn is not None:
                    # replay-buffer tee: the event payload must be
                    # captured HERE (the windower's buffer behind `ev`
                    # is reused); the writer's per-stream reservoir
                    # decides acceptance before serializing.  Fail-open
                    # like every observer at this seam — experience
                    # collection must never become an admission fault
                    self._learn.observe_admit(
                        trace_id, base, idx, lo, hi, ev,
                        handle.windower.strings)
            except Exception:  # noqa: BLE001
                pass
            shed = None
            if len(handle.live) >= self.cfg.stream_queue_slots \
                    and self._shed_pressure():
                # SLO-aware shed: under fleet-wide pressure the victim is
                # the worst budget-burner's oldest window, not this
                # stream's — shed BEFORE handle.cond is taken so the two
                # streams' conds are never nested
                shed = self._shed_one(base)
            # when another stream paid, this stream's queue may stretch to
            # 2x slots before its own drop-oldest bound applies — still
            # hard-bounded memory, but a healthy stream is not robbed to
            # admit its own next window while burners queue
            allowed = self.cfg.stream_queue_slots * (2 if shed else 1)
            dropped_old = None
            with handle.cond:
                if len(handle.live) >= allowed:
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
            if shed is not None:
                # journal OUTSIDE every cond; admission_drop keeps the drop
                # inventory uniform, the fleet_shed record carries the
                # ranking evidence
                self._journal.record(
                    "admission_drop", stream=shed["victim"],
                    window_id=shed["window_id"],
                    trace_id=shed["trace_id"], reason="shed")
                self._journal.record(
                    "fleet_shed", stream=shed["victim"],
                    window_id=shed["window_id"],
                    trace_id=shed["trace_id"], reason="budget_burn",
                    burn_ratio=shed["burn_ratio"],
                    ranking=shed["ranking"], admitting=handle.id)
            if dropped_old is not None:
                # journal OUTSIDE handle.cond (see leave)
                self._drop(handle, dropped_old[0], dropped_old[1],
                           "backpressure")
            self._reg.counter_inc(
                "serve_windows_admitted_total",
                help="windows admitted into the micro-batcher")
            if self._devtime is not None:
                # capacity headroom: the arrival side of the model (BASE
                # stream name — reconnect sessions are the same demand)
                self._devtime.observe_admit(base, bucket_tag(bucket))
            self._batcher.submit(req)

    # -- demux ----------------------------------------------------------------

    def _on_scored(self, scored: List[ScoredWindow]) -> None:
        alert_thr = (self.cfg.threshold if self.cfg.threshold is not None
                     else 0.5)
        t_demux = time.perf_counter()
        for s in scored:
            if self._window_log is not None:
                self._window_log.append(
                    (s.stream, s.window_idx, s.t_scored - s.t_admit, s.late,
                     s.model_version))
            # SLO accounting from the stage stamps the window carried:
            # admit → packed (queue) → scorer pickup (pack) → scored
            # (device) → here (demux); e2e runs admit → demux
            e2e = t_demux - s.t_admit
            stages = {"queue": s.t_packed - s.t_admit,
                      "pack": s.t_device - s.t_packed,
                      "device": s.t_scored - s.t_device,
                      "demux": t_demux - s.t_scored}
            self._slo.observe(
                s.stream, s.trace_id, s.window_idx,
                stages=stages, e2e_sec=e2e)
            if self._flight is not None:
                self._flight.observe_window(s.stream, s.trace_id, e2e)
            # alerting: hot windows only, never blocking (bounded sink).
            # Fail-open per window: a raising sink, router, quality,
            # archive or learn observer loses at most this window's alert,
            # never the ledger resolution below — an unresolved window
            # wedges leave()
            try:
                if self._archive is not None:
                    # workload sketches for the durable archive: the
                    # window's admission-measured structure and the same
                    # stage stamps the SLO plane just consumed; O(bins),
                    # no IO
                    self._archive.observe_window(
                        bucket_tag(s.bucket), nodes=s.nodes,
                        edges=s.edges, files=s.files, stages=stages,
                        e2e_sec=e2e)
                if self._learn is not None:
                    # replay-buffer join: marry the scores to the
                    # admit-time payload by trace_id (the writer's
                    # thread owns the disk; this is dict ops only)
                    self._learn.observe_scored(s)
                mask = s.node_mask.astype(bool)
                hot_slots = (np.nonzero(mask & (s.probs >= alert_thr))[0]
                             if mask.any() else np.empty(0, np.int64))
                if self._quality is not None:
                    # drift sketches at the demux boundary (base stream
                    # name: a resident stream's reconnect sessions are the
                    # same traffic population)
                    self._quality.observe_window(
                        _base_stream(s.stream), bucket_tag(s.bucket),
                        s.probs, mask, s.node_type,
                        nodes=s.nodes, edges=s.edges, files=s.files,
                        alerted=bool(len(hot_slots)))
                if len(hot_slots):
                    order = np.argsort(-s.probs[hot_slots], kind="stable")
                    hot = [("file" if s.node_type[i] == NODE_TYPE_FILE
                            else "proc",
                            int(s.node_key[i]), float(s.probs[i]))
                           for i in hot_slots[order][:16]]
                    max_prob = float(s.probs[mask].max())
                    alert = WindowAlert(
                        stream=s.stream, window_idx=s.window_idx,
                        lo_ns=s.lo_ns, hi_ns=s.hi_ns,
                        max_prob=max_prob, hot=hot,
                        t_admit=s.t_admit, t_scored=s.t_scored,
                        late=s.late, model_version=s.model_version,
                        trace_id=s.trace_id,
                        # computed ONCE here, at the demux boundary: the
                        # sink's consumers and the respond tier's
                        # admission gate read the same number
                        severity=calibrated_severity(max_prob, alert_thr))
                    self.sink.emit(alert)
                    if self._respond is not None:
                        # the router applies its own severity admission
                        # and bounded queue; inside the fail-open block,
                        # so planning never wedges the ledger resolution
                        self._respond.offer_alert(alert)
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
            try:
                if self._learn is not None:
                    # a window the device failed never becomes training
                    # data: drop its parked replay payload
                    self._learn.discard(r.trace_id)
            except Exception:  # noqa: BLE001
                pass
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
