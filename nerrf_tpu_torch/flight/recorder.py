"""Anomaly-triggered flight recorder: dump the evidence while it exists.

The port of ``nerrf_tpu/flight/recorder.py``: a copy but in two places.
`env_fingerprint` reports PyTorch, its CUDA and the card instead of jax;
and the p99 bundle's profiler capture
(``profile_on_p99_sec > 0``) is a torch.profiler trace under
``torch_trace/``, taken on a capture thread of its own: the p99 trigger
fires on the scorer's thread (demux), and a capture taken there would
watch a scorer it blocks.

The journal ring and the span ring both wrap — by the time an operator
logs in, the 2am incident's records are gone.  `FlightRecorder` watches
the live signals and, the moment a declarative trigger fires, atomically
writes a self-contained **bundle** directory:

    bundle-<utc>-<trigger>/
      manifest.json   trigger, reason, context, SLO snapshot, model
                      lineage, environment fingerprint, journal seq range
      journal.jsonl   the journal tail (newest last)
      trace.json      Chrome-trace export of the span ring (Perfetto/
                      chrome://tracing loadable, `nerrf trace` readable)
      metrics.prom    full Prometheus text-exposition snapshot

Triggers (all evaluated in-process, no scrape loop):

  * ``p99_breach``   — trailing-window p99 of e2e window latency crosses
    the threshold (default: the window deadline), min-count gated;
  * ``drop_burst``   — ≥ N ``admission_drop``/``demux_drop`` journal
    records within a sliding T seconds;
  * ``shadow_disagreement`` — a ``registry_shadow_stats`` journal record
    reports a disagreement rate above the spike threshold;
  * ``guardrail_veto``     — any ``registry_veto`` journal record;
  * ``quality_drift``      — SUSTAINED distribution drift: the quality
    monitor's cadenced ``quality_stats`` records report a score- or
    feature-PSI above the breach threshold for N consecutive records
    (min-window gated; one breaching record is noise, a streak is a
    shift).  The bundle embeds the live sketches + reference profile
    (``quality.json``) so the drift is analyzable offline;
  * ``exception``    — uncaught exception on any thread, via the
    `install_crash_handlers` sys/threading excepthook wrappers
    (+ `faulthandler` into the bundle directory for hard crashes);
  * ``train_divergence`` / ``train_starvation`` / ``train_stall`` — the
    training-health monitor (`nerrf_tpu_torch/trainwatch/`) fires these
    through `trigger()` directly; the bundle context embeds the loss/
    grad history tail, run fingerprints, and the last-good-checkpoint
    restart pointer, and `nerrf doctor`'s training-health section reads
    them offline (docs/training-health.md).  Construct the recorder with
    ``info=monitor.flight_info`` so the manifest lineage carries the run
    identity at dump time.

Every trigger is rate-limited (one bundle per ``min_interval_sec`` per
trigger) and the bundle directory is bounded (oldest deleted beyond
``max_bundles``) — an alert storm can never fill the disk.  Bundles are
written to a temp dir and `os.replace`d into place, so a reader never
sees a torn bundle.  `nerrf doctor <bundle>` reconstructs the incident
timeline offline (`flight.doctor`).
"""

from __future__ import annotations

import dataclasses
import faulthandler
import json
import os
import platform
import shutil
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, Optional

from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL, JournalRecord
from nerrf_tpu_torch.flight.slo import percentile

# the loss-record kinds the drop-burst trigger counts: admission drops,
# demuxed-alert evictions, AND device-batch failures — a persistent
# device fault sheds windows exactly like overload does, and must leave
# a bundle behind the same way
DROP_KINDS = ("admission_drop", "demux_drop", "device_batch_failed")


@dataclasses.dataclass(frozen=True)
class FlightConfig:
    """Trigger thresholds + bundle retention knobs."""

    out_dir: str = "flight-bundles"
    # rate limit: at most one bundle per trigger name per interval —
    # a sustained breach produces ONE bundle, not a bundle storm
    min_interval_sec: float = 60.0
    # disk bound: oldest bundle-* dirs deleted beyond this many
    max_bundles: int = 8
    # journal records embedded per bundle (newest last)
    journal_tail: int = 512
    # p99_breach: trailing window of e2e latencies, min sample gate, and
    # the breach threshold (None → the serve deadline passed at wiring)
    p99_window: int = 64
    p99_min_count: int = 16
    p99_breach_sec: Optional[float] = None
    # drop_burst: this many drop records inside the sliding window
    drop_burst_n: int = 10
    drop_burst_sec: float = 5.0
    # shadow_disagreement: spike threshold on the reported rate, gated on
    # a minimum paired-window count — the first shadow-scored window's
    # rate is single-batch noise, not an incident
    disagreement_spike: float = 0.35
    disagreement_min_windows: int = 8
    # quality_drift: fires when quality_stats journal records report a
    # worst score- OR feature-PSI at/above the breach value for
    # quality_breach_records CONSECUTIVE records (the monitor cuts one
    # per journal_every windows, so the streak is the "sustained" gate),
    # each record carrying at least quality_min_windows observed windows.
    # 0.25 is the conventional "major shift" PSI reading
    quality_psi_breach: float = 0.25
    quality_min_windows: int = 64
    quality_breach_records: int = 3
    # OPT-IN p99-breach profiler capture (devtime/capture.py): when > 0, a
    # p99_breach bundle additionally embeds this many seconds of live
    # torch.profiler trace under <bundle>/torch_trace/ — the scorer keeps
    # scoring while the profiler watches, so the trace shows the card
    # during exactly the overload that fired the trigger.  The bundle is
    # written by a capture thread once the capture ends (close() waits for
    # it).  Fail-open: a profiler that cannot start journals
    # profile_failed and the bundle ships without the trace.  The capture
    # holds the dump lock for its duration, so keep it SMALL (≤2 s).
    # 0 (default) disables
    profile_on_p99_sec: float = 0.0


class FlightRecorder:
    """Watches journal records + per-window latencies; dumps bundles."""

    def __init__(self, cfg: FlightConfig, registry=None, journal=None,
                 tracer=None, slo=None, info=None, quality=None,
                 archive=None, log=None) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        if tracer is None:
            from nerrf_tpu_torch.tracing import DEFAULT_TRACER

            tracer = DEFAULT_TRACER
        self.cfg = cfg
        self._reg = registry
        self._journal = journal if journal is not None else DEFAULT_JOURNAL
        self._tracer = tracer
        self._slo = slo
        # info(): live model lineage / service identity for the manifest —
        # callable so the bundle captures the state AT dump time
        self._info = info or (lambda: {})
        # quality(): the quality monitor's snapshot (live sketches +
        # reference profile) — embedded as quality.json in every bundle
        # when it returns one, so a drift bundle is self-contained and
        # ANY bundle can answer "was the model drifting at the time"
        self._quality = quality
        # archive: the telemetry ArchiveWriter (or any position()-bearing
        # object).  Every bundle's manifest then carries the active
        # archive segment + journal seq range AT DUMP TIME, so `nerrf
        # doctor` can point from a bundle (one ring's worth of tail) to
        # the surrounding archived context (the whole run)
        self._archive = archive
        self._quality_streak = 0
        self._log = log or (lambda msg: None)
        self._lock = threading.Lock()
        # dumps are serialized: concurrent triggers writing + the .tmp
        # sweep in retention must never see each other's half-written dirs
        self._dump_lock = threading.Lock()
        self._last_fire: Dict[str, float] = {}
        self._bundle_n = 0  # monotonic: bundle names sort chronologically
        self._e2e: deque = deque(maxlen=max(cfg.p99_window, 1))
        self._drops: deque = deque()
        # the capture threads of p99 bundles with a profiler trace (joined
        # by close()); the profiler is imported here, not first on one
        self._captures: list = []
        if cfg.profile_on_p99_sec > 0:
            from nerrf_tpu_torch.observability import load_profiler

            load_profiler()
        self._journal.subscribe(self._on_record)

    def close(self) -> None:
        self._journal.unsubscribe(self._on_record)
        with self._lock:
            captures, self._captures = self._captures, []
        for t in captures:
            t.join(timeout=self.cfg.profile_on_p99_sec + 60.0)

    # -- signal intake --------------------------------------------------------

    def observe_window(self, stream: str, trace_id: Optional[str],
                       e2e_sec: float) -> None:
        """Per-scored-window latency feed (the p99_breach trigger's
        signal).  Cheap: deque append + an occasional sorted() of a small
        trailing window."""
        threshold = self.cfg.p99_breach_sec
        if threshold is None:
            return
        with self._lock:
            self._e2e.append((float(e2e_sec), stream, trace_id))
            if len(self._e2e) < self.cfg.p99_min_count:
                return
            vals = sorted(e for e, _, _ in self._e2e)
            p99 = percentile(vals, 0.99)
            # worst of the TRAILING window (the breaching set), so the
            # bundle's exemplar trace ID always joins to evidence still in
            # the span/journal rings — never an ancient evicted spike
            worst = max(self._e2e, key=lambda t: t[0])
        if p99 > threshold:
            self.trigger(
                "p99_breach",
                f"trailing p99 {p99 * 1e3:.1f}ms > "
                f"{threshold * 1e3:.1f}ms over last {len(vals)} windows",
                context={"p99_ms": round(p99 * 1e3, 1),
                         "threshold_ms": round(threshold * 1e3, 1),
                         "windows": len(vals),
                         "worst_ms": round(worst[0] * 1e3, 1),
                         "stream": worst[1], "trace_id": worst[2]})

    def _on_record(self, rec: JournalRecord) -> None:
        """Journal listener: the declarative record-kind triggers."""
        if rec.kind == "bundle":
            return  # our own breadcrumb — never self-trigger
        if rec.kind in DROP_KINDS:
            now = rec.t_perf
            with self._lock:
                self._drops.append(now)
                lo = now - self.cfg.drop_burst_sec
                while self._drops and self._drops[0] < lo:
                    self._drops.popleft()
                burst = len(self._drops)
            if burst >= self.cfg.drop_burst_n:
                self.trigger(
                    "drop_burst",
                    f"{burst} windows dropped in the last "
                    f"{self.cfg.drop_burst_sec:g}s "
                    f"(latest: {rec.data.get('reason', rec.kind)})",
                    context={"drops": burst,
                             "window_sec": self.cfg.drop_burst_sec,
                             "stream": rec.stream,
                             "trace_id": rec.trace_id})
        elif rec.kind == "registry_veto":
            self.trigger(
                "guardrail_veto",
                f"shadow v{rec.data.get('version')} vetoed: "
                f"{rec.data.get('reason', 'unknown')}",
                context=dict(rec.data))
        elif rec.kind == "registry_shadow_stats":
            rate = float(rec.data.get("disagreement_rate", 0.0))
            windows = int(rec.data.get("windows", 0))
            if (rate >= self.cfg.disagreement_spike
                    and windows >= self.cfg.disagreement_min_windows):
                self.trigger(
                    "shadow_disagreement",
                    f"shadow disagreement rate {rate:.3f} >= "
                    f"{self.cfg.disagreement_spike:g}",
                    context=dict(rec.data))
        elif rec.kind == "quality_stats":
            worst = max((v for v in (rec.data.get("worst_score_psi"),
                                     rec.data.get("worst_feature_psi"))
                         if v is not None), default=None)
            windows = int(rec.data.get("windows", 0))
            breach = (worst is not None
                      and worst >= self.cfg.quality_psi_breach
                      and windows >= self.cfg.quality_min_windows)
            with self._lock:
                # a streak of consecutive breaching records IS the
                # "sustained" gate: one hot record between cadence points
                # resets — drift persists, noise does not
                self._quality_streak = self._quality_streak + 1 if breach \
                    else 0
                fire = self._quality_streak >= self.cfg.quality_breach_records
                if fire:
                    self._quality_streak = 0
            if fire:
                self.trigger(
                    "quality_drift",
                    f"PSI {worst:.3f} >= {self.cfg.quality_psi_breach:g} "
                    f"sustained over {self.cfg.quality_breach_records} "
                    f"consecutive quality_stats records "
                    f"({windows} windows observed)",
                    context=dict(rec.data))
        elif rec.kind == "exception":
            self.trigger(
                "exception",
                f"{rec.data.get('type')}: {rec.data.get('message')}",
                context=dict(rec.data, stream=rec.stream))

    # -- firing ---------------------------------------------------------------

    def trigger(self, name: str, reason: str,
                context: Optional[dict] = None) -> Optional[str]:
        """Fire a trigger: rate-limit, then dump.  Returns the bundle path
        (None when suppressed or the dump failed — the recorder must never
        take the serving plane down with it — and for a p99 bundle with a
        profiler capture, which a capture thread writes)."""
        now = time.monotonic()
        with self._lock:
            last = self._last_fire.get(name)
            if last is not None and now - last < self.cfg.min_interval_sec:
                suppressed = True
            else:
                self._last_fire[name] = now
                suppressed = False
        if suppressed:
            self._reg.counter_inc(
                "flight_triggers_suppressed_total", labels={"trigger": name},
                help="trigger firings suppressed by the per-trigger rate "
                     "limit (a bundle for this incident already exists)")
            return None
        if name == "p99_breach" and self.cfg.profile_on_p99_sec > 0:
            # the trigger fires on the scorer's thread: the bundle and its
            # capture go to a thread of their own, so the profiler watches
            # a scorer that keeps scoring.  Non-daemon and joined by close()
            t = threading.Thread(
                target=self._fire, args=(name, reason, context, now, last),
                name="nerrf-flight-capture", daemon=False)
            with self._lock:
                self._captures = [c for c in self._captures
                                  if c.is_alive()] + [t]
            t.start()
            return None
        return self._fire(name, reason, context, now, last)

    def _fire(self, name: str, reason: str, context: Optional[dict],
              now: float, last: Optional[float]) -> Optional[str]:
        """Dump one bundle for a trigger that passed its rate limit (stamped
        ``now``, the previous stamp ``last``)."""
        try:
            path = self.dump(name, reason, context or {})
        except Exception as e:  # noqa: BLE001 — evidence capture is
            # best-effort; a full disk must not crash the scorer thread
            with self._lock:
                # a failed dump must not consume the interval: with zero
                # bundles on disk the next firing should retry, not be
                # suppressed for min_interval_sec while the rings wrap
                # (unless a concurrent fire already succeeded after us)
                if self._last_fire.get(name) == now:
                    if last is None:
                        # nerrflint: ok[atomicity-violation] split on purpose: this rollback re-validates under the lock (stamp still ours, the .get above) before undoing, so a concurrent successful fire is never clobbered
                        self._last_fire.pop(name, None)
                    else:
                        self._last_fire[name] = last
            self._log(f"flight: bundle dump failed ({type(e).__name__}: {e})")
            return None
        self._log(f"flight: {name} → {path} ({reason})")
        return path

    def dump(self, trigger: str, reason: str, context: dict) -> str:
        """Atomically write one bundle and enforce the disk bound."""
        with self._dump_lock:
            return self._dump_locked(trigger, reason, context)

    def _dump_locked(self, trigger: str, reason: str, context: dict) -> str:
        from nerrf_tpu_torch import chaos

        # chaos fault point (no-op disarmed): the bundle volume filling up
        # mid-dump — the caller's fail-open (trigger() rolls back the
        # rate-limit stamp, no .tmp orphan) is what survives
        chaos.inject("flight.disk_full", trigger=trigger)
        out_root = os.fspath(self.cfg.out_dir)
        # nerrflint: ok[blocking-under-lock] serializing bundle IO is the dump lock's entire purpose: concurrent triggers and the retention sweep must never interleave half-written dirs; only other dumps wait here
        os.makedirs(out_root, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        with self._lock:
            self._bundle_n += 1
            n = self._bundle_n
        # the in-process counter keeps same-second names distinct AND
        # lexicographically chronological — retention sorts by name, so
        # "oldest" must never be a naming accident
        name = f"bundle-{stamp}-{n:03d}-{trigger}"
        final = os.path.join(out_root, name)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        try:
            os.makedirs(tmp)
            profile = None
            if trigger == "p99_breach" and self.cfg.profile_on_p99_sec > 0:
                # capture FIRST (the overload is happening now; the
                # journal tail written below then includes the capture's
                # own profile_capture/profile_failed record), into the
                # tmp dir so the os.replace below keeps bundles atomic
                from nerrf_tpu_torch.devtime.capture import (
                    capture_trace,
                    trace_summary,
                )

                pdir = os.path.join(tmp, "torch_trace")
                got = capture_trace(pdir,
                                    seconds=self.cfg.profile_on_p99_sec,
                                    journal=self._journal)
                summary = trace_summary(pdir) if got else None
                profile = ({"dir": "torch_trace",
                            "seconds": self.cfg.profile_on_p99_sec,
                            **summary} if summary else
                           {"dir": None,
                            "error": "profiler capture failed (fail-open; "
                                     "see profile_failed journal record)"})
            quality = _safe(self._quality) if self._quality is not None \
                else None
            if quality:
                # the drift evidence: live trailing sketches + the full
                # reference profile — mergeable counts, so offline
                # analysis (and cross-host aggregation) recompute any
                # divergence without the pod
                with open(os.path.join(tmp, "quality.json"), "w") as f:
                    json.dump(quality, f)
            records = self._journal.tail(self.cfg.journal_tail)
            with open(os.path.join(tmp, "journal.jsonl"), "w") as f:
                for r in records:
                    f.write(json.dumps(r.to_dict()) + "\n")
            with open(os.path.join(tmp, "trace.json"), "w") as f:
                json.dump(self._tracer.chrome_trace(), f)
            with open(os.path.join(tmp, "metrics.prom"), "w") as f:
                f.write(self._reg.render())
            manifest = {
                "schema": 1,
                "trigger": trigger,
                "reason": reason,
                "context": context,
                "created_unix": time.time(),
                "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                             time.gmtime()),
                "journal_seq": {"lo": records[0].seq if records else None,
                                "hi": records[-1].seq if records else None,
                                "records": len(records)},
                "slo": self._slo.snapshot() if self._slo is not None
                       else None,
                "profile": profile,
                "quality": "quality.json" if quality else None,
                "archive": (_safe(self._archive.position)
                            if self._archive is not None else None),
                "lineage": _safe(self._info),
                "env": env_fingerprint(),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=2)
            os.replace(tmp, final)  # readers never see a torn bundle
        except BaseException:
            # a failed dump (ENOSPC mid-write) must not strand its partial
            # .tmp — each dump mints a fresh name, so an orphan would
            # evade retention forever and erode the disk bound
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._reg.counter_inc(
            "flight_bundles_total", labels={"trigger": trigger},
            help="flight-recorder diagnostic bundles written, by trigger")
        self._reg.gauge_set(
            "flight_last_bundle_unix_seconds", manifest["created_unix"],
            help="when the most recent flight bundle was written")
        self._journal.record("bundle", trigger=trigger, path=final,
                             reason=reason)
        self._enforce_retention(out_root)
        return final

    def _enforce_retention(self, out_root: str) -> None:
        # nerrflint: ok[blocking-under-lock] retention runs under the dump lock BY DESIGN — deleting bundle dirs must never race a concurrent dump's os.replace; only other dumps wait
        entries = [e for e in os.listdir(out_root) if e.startswith("bundle-")]
        # sweep stale .tmp dirs from a crash mid-dump in an EARLIER process
        # (a failed dump in this one already cleaned up after itself)
        for tmp in entries:
            if tmp.endswith(".tmp") and not os.path.exists(
                    os.path.join(out_root, tmp[:-4])):
                shutil.rmtree(os.path.join(out_root, tmp),
                              ignore_errors=True)
        bundles = sorted(e for e in entries if not e.endswith(".tmp"))
        for stale in bundles[:-self.cfg.max_bundles] \
                if len(bundles) > self.cfg.max_bundles else []:
            shutil.rmtree(os.path.join(out_root, stale), ignore_errors=True)


def _safe(fn) -> Optional[dict]:
    try:
        return fn() or None
    except Exception:  # noqa: BLE001 — manifest extras are best-effort
        return None


def env_fingerprint() -> dict:
    """Process identity for the manifest: enough to answer "what exactly
    was running" without the pod.  The PyTorch and numpy versions only
    when already imported, PyTorch's CUDA version, and the card's name
    only when CUDA is already initialised ("cpu" when it is not) — the
    recorder must never force a device's initialisation."""
    out = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "hostname": platform.node(),
        "pid": os.getpid(),
        "argv": sys.argv,
    }
    for mod in ("torch", "numpy"):
        m = sys.modules.get(mod)
        v = getattr(m, "__version__", None) if m is not None else None
        if v is not None:
            out[f"{mod}_version"] = str(v)
    torch = sys.modules.get("torch")
    if torch is not None:
        out["torch_cuda_version"] = torch.version.cuda
        try:
            out["device"] = (torch.cuda.get_device_name()
                             if torch.cuda.is_initialized() else "cpu")
        except Exception:  # noqa: BLE001 — the device may be mid-init
            pass
    return out


def journal_exception(journal, exc_type, exc, tb,
                      thread_name: str = "main") -> None:
    """Journal one uncaught exception (the subscribed recorder's listener
    turns the record into an ``exception`` bundle).  Shared by the
    installed hooks AND callers whose own try/finally would otherwise
    uninstall the hooks before the exception ever reaches them (the serve
    CLI's main-thread path)."""
    journal.record(
        "exception", stream=thread_name,
        type=getattr(exc_type, "__name__", str(exc_type)),
        message=str(exc),
        traceback="".join(
            traceback.format_exception(exc_type, exc, tb))[-4000:])


def install_crash_handlers(recorder: FlightRecorder,
                           journal=None):
    """Wire ``sys.excepthook`` + ``threading.excepthook`` to journal the
    exception and dump an ``exception`` bundle before the previous hooks
    run, and enable `faulthandler` into ``<out_dir>/faulthandler.log``
    (hard crashes — SIGSEGV in a native lib — leave tracebacks next to the
    bundles).  Returns an ``uninstall()`` callable (tests).  The journal
    defaults to the RECORDER'S journal — the only one whose listeners
    include this recorder; an embedder wiring an isolated journal would
    otherwise get crash records it is not subscribed to (and no bundle)."""
    journal = journal if journal is not None else recorder._journal
    os.makedirs(recorder.cfg.out_dir, exist_ok=True)
    fh_file = open(  # noqa: SIM115 — must outlive this frame
        os.path.join(recorder.cfg.out_dir, "faulthandler.log"), "a")
    faulthandler.enable(file=fh_file)

    def capture(exc_type, exc, tb, thread_name: str) -> None:
        journal_exception(journal, exc_type, exc, tb, thread_name)
        # the journal listener fires the `exception` trigger; nothing more
        # to do here — capture must stay exception-free itself

    prev_sys = sys.excepthook
    prev_threading = threading.excepthook

    def sys_hook(exc_type, exc, tb):
        try:
            capture(exc_type, exc, tb, "main")
        finally:
            prev_sys(exc_type, exc, tb)

    def threading_hook(args):
        try:
            capture(args.exc_type, args.exc_value, args.exc_traceback,
                    getattr(args.thread, "name", "thread"))
        finally:
            prev_threading(args)

    sys.excepthook = sys_hook
    threading.excepthook = threading_hook

    def uninstall() -> None:
        sys.excepthook = prev_sys
        threading.excepthook = prev_threading
        faulthandler.disable()
        fh_file.close()

    return uninstall
