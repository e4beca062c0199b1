"""TrainHealthMonitor: the training run's live health plane.

A host copy of the reference's ``nerrf_tpu/trainwatch/monitor.py`` (stdlib
only), kept identical but for the registry and journal it reports into
(the port's ``observability.DEFAULT_REGISTRY`` and
``flight.journal.DEFAULT_JOURNAL``).  The loop feeds it one observation per
*logged* step (the cadence at which the loss is already fetched to the
host, so the monitor adds no device sync); it exports gauges, cuts cadenced
``train_health`` journal records, and fires train-side triggers through an
attached flight recorder:

  * ``train_divergence``: any non-finite telemetry flag (loss component,
    total, or gradient elements), a non-finite loss even without
    telemetry, or a loss >= ``spike_factor`` x the trailing median for
    ``spike_streak`` consecutive observations.  Latches: readiness fails
    and, with ``halt_on_divergence``, the loop stops;
  * ``train_starvation``: the trailing data-wait fraction (host time spent
    assembling or waiting for input) crosses ``starved_fraction``;
  * ``train_stall``: the watcher thread (``nerrf-trainwatch``, non-daemon,
    bounded join in `stop`) sees no completed step for ``stall_after_sec``
    while the run is mid-flight.

``trainwatch.training_health`` attaches a `flight.FlightRecorder` when
given a flight directory; with none attached, a trigger logs its reason and
dumps no bundle, as the reference does.

Gauges: ``nerrf_train_grad_norm``, ``nerrf_train_update_ratio``,
``nerrf_train_nonfinite_total{component}``,
``nerrf_train_throughput_steps``, ``nerrf_train_data_starved_fraction``.

Lock discipline: state and gauge exports under the one lock (registry calls
never re-enter), journal records and trigger firing strictly outside it.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

_HELP = {
    "train_grad_norm":
        "global L2 norm of the step's raw gradients (pre-clip), from the "
        "in-step telemetry at the last logged step",
    "train_update_ratio":
        "global ||param update|| / ||params|| at the last logged step — "
        "the effective-learning-rate reading",
    "train_nonfinite_total":
        "non-finite telemetry observations by component (loss components, "
        "total loss, gradient elements) — any increment is an incident",
    "train_throughput_steps":
        "trailing training throughput in steps/s over the monitor's "
        "observation window",
    "train_data_starved_fraction":
        "trailing fraction of train wall spent waiting for input data "
        "(the train_starvation trigger's signal)",
}


@dataclasses.dataclass(frozen=True)
class TrainHealthConfig:
    """Trigger thresholds + cadences of the training-health monitor."""

    # trailing observation window: loss median for the spike test,
    # throughput and data-wait fractions
    trailing_steps: int = 64
    # divergence: loss >= spike_factor * trailing median for spike_streak
    # CONSECUTIVE observations (a one-step spike is a hard batch, a streak
    # is a run leaving its basin); judged only past min_history
    spike_factor: float = 10.0
    spike_streak: int = 3
    min_history: int = 8
    # starvation: trailing data-wait fraction at/above this, once at least
    # starved_min_steps observations carry wall time
    starved_fraction: float = 0.5
    starved_min_steps: int = 16
    # one cadenced train_health journal record per this many observations
    journal_every: int = 16
    # stall: the watcher thread fires when no step completes for this long
    # while the run is mid-flight; poll_sec bounds the thread's wake cadence
    stall_after_sec: float = 120.0
    poll_sec: float = 5.0
    # a diverged run halts at the next logged step (should_halt) — NaN
    # weights cannot recover, so further steps only burn chip time
    halt_on_divergence: bool = True
    # history entries embedded in a trigger's bundle context
    history_tail: int = 32


class TrainHealthMonitor:
    """Per-run training health: gauges, journal cadence, flight triggers."""

    def __init__(self, cfg: Optional[TrainHealthConfig] = None,
                 registry=None, journal=None, log=None) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        if journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            journal = DEFAULT_JOURNAL
        self.cfg = cfg or TrainHealthConfig()
        self._reg = registry
        self._journal = journal
        self._log = log or (lambda msg: None)
        self._recorder = None
        self._lock = threading.Lock()
        self._run_info: Dict = {}
        self._ckpt: Optional[Tuple[str, int]] = None
        self._observed = 0
        self._last_step: Optional[int] = None
        self._last_t: Optional[float] = None
        # (t_perf, step) per observation — trailing throughput
        self._times: deque = deque(maxlen=max(self.cfg.trailing_steps, 2))
        # (wall_s, wait_s) per observation — trailing data-wait fraction
        self._waits: deque = deque(maxlen=max(self.cfg.trailing_steps, 2))
        self._losses: deque = deque(maxlen=max(self.cfg.trailing_steps, 2))
        self._tail: deque = deque(maxlen=max(self.cfg.history_tail, 1))
        self._spike_run = 0
        self._diverged: Optional[Tuple[int, str]] = None
        self._starved_latched = False
        self._stall_latched = False
        self._finished = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- wiring ---------------------------------------------------------------

    def attach_flight(self, recorder) -> None:
        """Bind a FlightRecorder: train triggers dump bundles through it.
        Construct the recorder with ``info=monitor.flight_info`` so the
        bundle manifest carries the run identity at dump time."""
        self._recorder = recorder

    def set_run(self, **info) -> None:
        """Run identity for bundles/readiness (config_fingerprint,
        model_fingerprint, experiment/steps...) — the loop stamps this
        right after it journals ``train_start``."""
        with self._lock:
            self._run_info.update(
                {k: v for k, v in info.items() if v is not None})

    def finish(self) -> None:
        """The loop is done STEPPING (post-training eval/calibration may
        run for minutes) — disarm stall detection.  Without this the
        watcher reads the quiet after the last step as a stall and dumps
        a spurious bundle (observed live: a 2-minute calibration sweep
        fired train_stall after a clean 40-step run)."""
        with self._lock:
            self._finished = True

    def note_checkpoint(self, path, step: int) -> None:
        """Record the last durable checkpoint — a divergence bundle points
        the operator at exactly where to restart from."""
        with self._lock:
            self._ckpt = (str(path), int(step))

    def flight_info(self) -> dict:
        """Bundle-manifest identity (the recorder's ``info()`` callable)."""
        with self._lock:
            info = dict(self._run_info)
            info["role"] = "train"
            info["last_step"] = self._last_step
            if self._ckpt is not None:
                info["last_good_checkpoint"] = self._ckpt[0]
                info["last_good_checkpoint_step"] = self._ckpt[1]
            if self._diverged is not None:
                info["diverged_at_step"] = self._diverged[0]
        return info

    # -- lifecycle (the stall watcher thread) ---------------------------------

    def start(self) -> "TrainHealthMonitor":
        """Start the stall watcher.  NON-daemon on purpose (thread-
        lifecycle lint): a daemon thread alive at interpreter teardown is
        the historical segfault class; the stop flag + bounded join in
        `stop()` bound its life instead.  The target touches no device —
        it only reads monitor state and fires triggers."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch, daemon=False,
                                        name="nerrf-trainwatch")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "TrainHealthMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _watch(self) -> None:
        """Stall detection: no completed step for stall_after_sec while
        the run is mid-flight.  Cheap state reads under the lock; the
        trigger fires outside it."""
        while not self._stop.wait(self.cfg.poll_sec):
            fire = None
            with self._lock:
                if (self._last_t is not None and self._diverged is None
                        and not self._stall_latched
                        and not self._finished):
                    idle = time.perf_counter() - self._last_t
                    if idle >= self.cfg.stall_after_sec:
                        self._stall_latched = True
                        fire = (
                            f"no train step completed for {idle:.0f}s "
                            f"(threshold {self.cfg.stall_after_sec:g}s, "
                            f"last step {self._last_step})",
                            {"step": self._last_step,
                             "idle_sec": round(idle, 1),
                             **self._context_locked()})
            if fire is not None:
                self._trigger("train_stall", *fire)

    # -- observation (the training loop's thread) -----------------------------

    def observe_step(self, step: int, loss: float,
                     telemetry: Optional[dict] = None,
                     data_wait_s: float = 0.0,
                     components: Optional[Dict[str, float]] = None) -> None:
        """One logged step.  ``loss`` and ``telemetry`` are HOST floats —
        the caller fetched them at its existing sync point; the monitor
        never touches device values.  ``data_wait_s`` is the host time
        spent waiting for/assembling input since the previous observation."""
        now = time.perf_counter()
        fires: List[Tuple[str, str, dict]] = []
        record = None
        with self._lock:
            wall = (now - self._last_t) if self._last_t is not None else 0.0
            self._last_t = now
            self._last_step = step
            self._observed += 1
            self._times.append((now, step))
            if wall > 0.0:
                self._waits.append((wall, max(float(data_wait_s), 0.0)))
            prior = list(self._losses)
            self._losses.append(float(loss))
            entry = {"step": step, "loss": round(float(loss), 6)}
            if telemetry:
                entry["grad_norm"] = round(float(telemetry["grad_norm"]), 6)
                entry["update_ratio"] = round(
                    float(telemetry["update_ratio"]), 8)
            self._tail.append(entry)
            # a recovered stall stops being latched the moment steps flow
            self._stall_latched = False

            sps = self._throughput_locked()
            starved = self._starved_locked()
            # gauges under the lock (registry calls never re-enter the
            # monitor); literal names for the metrics-contract lint
            if telemetry:
                self._reg.gauge_set("train_grad_norm",
                                    float(telemetry["grad_norm"]),
                                    help=_HELP["train_grad_norm"])
                self._reg.gauge_set("train_update_ratio",
                                    float(telemetry["update_ratio"]),
                                    help=_HELP["train_update_ratio"])
            if sps is not None:
                self._reg.gauge_set("train_throughput_steps", sps,
                                    help=_HELP["train_throughput_steps"])
            if starved is not None:
                self._reg.gauge_set("train_data_starved_fraction", starved,
                                    help=_HELP[
                                        "train_data_starved_fraction"])

            # -- divergence: non-finite beats everything ----------------------
            bad = self._nonfinite_components(loss, telemetry)
            for comp, count in bad:
                self._reg.counter_inc(
                    "train_nonfinite_total", count,
                    labels={"component": comp},
                    help=_HELP["train_nonfinite_total"])
            if bad and self._diverged is None:
                detail = ", ".join(f"{c}×{n:g}" for c, n in bad)
                self._diverged = (step, f"non-finite {detail}")
                fires.append(("train_divergence",
                              f"non-finite telemetry at step {step}: "
                              f"{detail}",
                              {"step": step, "loss": float(loss),
                               "nonfinite": dict(bad),
                               **self._context_locked()}))
            elif self._diverged is None and len(prior) >= self.cfg.min_history:
                med = sorted(prior)[len(prior) // 2]
                if (math.isfinite(med)
                        and float(loss) >= self.cfg.spike_factor
                        * max(med, 1e-12)):
                    self._spike_run += 1
                else:
                    self._spike_run = 0
                if self._spike_run >= self.cfg.spike_streak:
                    self._diverged = (
                        step, f"loss {float(loss):.4g} >= "
                              f"{self.cfg.spike_factor:g}× trailing median "
                              f"{med:.4g} for {self._spike_run} steps")
                    fires.append(("train_divergence",
                                  f"sustained loss spike at step {step}: "
                                  f"{self._diverged[1]}",
                                  {"step": step, "loss": float(loss),
                                   "trailing_median": med,
                                   **self._context_locked()}))

            # -- starvation edge ---------------------------------------------
            if starved is not None and len(self._waits) \
                    >= self.cfg.starved_min_steps:
                if starved >= self.cfg.starved_fraction \
                        and not self._starved_latched:
                    self._starved_latched = True
                    fires.append((
                        "train_starvation",
                        f"data-wait fraction {starved:.2f} >= "
                        f"{self.cfg.starved_fraction:g} over the last "
                        f"{len(self._waits)} observations at step {step}",
                        {"step": step,
                         "data_starved_fraction": round(starved, 4),
                         **self._context_locked()}))
                elif starved < self.cfg.starved_fraction:
                    self._starved_latched = False

            if self._observed % self.cfg.journal_every == 0 or bad:
                record = {
                    "step": step, "loss": round(float(loss), 6),
                    "steps_per_sec": (round(sps, 3)
                                      if sps is not None else None),
                    "data_wait_fraction": (round(starved, 4)
                                           if starved is not None else None),
                    **({"grad_norm": entry.get("grad_norm"),
                        "update_ratio": entry.get("update_ratio")}
                       if telemetry else {}),
                    **({"nonfinite": dict(bad)} if bad else {}),
                    **({"components": {k: round(float(v), 6)
                                       for k, v in components.items()}}
                       if components else {}),
                }
        # journal + triggers OUTSIDE the lock: the journal fans out to the
        # flight recorder, whose dump does file IO and calls flight_info
        if record is not None:
            self._journal.record("train_health", **record)
        for name, reason, context in fires:
            self._trigger(name, reason, context)

    # -- readiness (MetricsServer ready_check in the train role) --------------

    def ready(self):
        """/readyz for a training pod: not ready before the first observed
        step, ready while stepping, 503 once the run has diverged (the
        halt state — a supervisor should reschedule, not keep routing)."""
        with self._lock:
            extra = {"role": "train", "step": self._last_step}
            if self._diverged is not None:
                return (False,
                        f"training diverged at step {self._diverged[0]}: "
                        f"{self._diverged[1]}", extra)
            if self._last_step is None:
                return False, "no training step completed yet", extra
            return True, "ok", extra

    # -- reading --------------------------------------------------------------

    @property
    def diverged(self) -> Optional[Tuple[int, str]]:
        with self._lock:
            return self._diverged

    @property
    def should_halt(self) -> bool:
        """True once a divergence has latched and the config says to stop
        the loop (NaN weights cannot recover)."""
        with self._lock:
            return self._diverged is not None and self.cfg.halt_on_divergence

    def snapshot(self) -> dict:
        with self._lock:
            sps = self._throughput_locked()
            starved = self._starved_locked()
            return {
                "observed": self._observed,
                "last_step": self._last_step,
                "steps_per_sec": round(sps, 3) if sps is not None else None,
                "data_starved_fraction": (round(starved, 4)
                                          if starved is not None else None),
                "diverged": ({"step": self._diverged[0],
                              "reason": self._diverged[1]}
                             if self._diverged is not None else None),
                "loss_tail": list(self._tail),
            }

    # -- internals ------------------------------------------------------------

    def _nonfinite_components(self, loss: float,
                              telemetry: Optional[dict]) -> List[tuple]:
        bad = []
        if telemetry:
            for comp, v in (telemetry.get("nonfinite") or {}).items():
                if float(v) > 0:
                    bad.append((comp, float(v)))
        elif not math.isfinite(float(loss)):
            bad.append(("total", 1.0))
        return bad

    def _throughput_locked(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        (t0, s0), (t1, s1) = self._times[0], self._times[-1]
        return (s1 - s0) / (t1 - t0) if t1 > t0 and s1 > s0 else None

    def _starved_locked(self) -> Optional[float]:
        wall = sum(w for w, _ in self._waits)
        if wall <= 0.0:
            return None
        return min(sum(d for _, d in self._waits) / wall, 1.0)

    def _context_locked(self) -> dict:
        """The bundle-context payload shared by every train trigger: the
        history tail + run identity + restart pointer (caller holds the
        lock; the dict is fired outside it)."""
        ctx = {"loss_tail": list(self._tail)}
        ctx.update({k: v for k, v in self._run_info.items()
                    if isinstance(v, (str, int, float, bool))})
        ctx["last_good_checkpoint"] = (self._ckpt[0]
                                       if self._ckpt is not None else None)
        return ctx

    def _trigger(self, name: str, reason: str, context: dict) -> None:
        if self._recorder is None:
            self._log(f"trainwatch: {name} ({reason}) — no flight "
                      f"recorder attached, no bundle")
            return
        try:
            self._recorder.trigger(name, reason, context=context)
        except Exception as e:  # noqa: BLE001 — evidence capture must
            # never take the training loop down with it
            self._log(f"trainwatch: {name} trigger failed "
                      f"({type(e).__name__}: {e})")
