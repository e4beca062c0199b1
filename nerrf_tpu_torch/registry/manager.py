"""The in-process model lifecycle manager: registry poll → shadow →
guarded promotion → zero-downtime hot-swap.

The port of ``nerrf_tpu/registry/manager.py``, kept identical but for two
points.  A version's weights are a state dict, which the service loads into
a second `NerrfNet` on its device (`swap_params`, `start_shadow`).  And the
architecture gate compares the fields a checkpoint's sidecar records
(`train.checkpoint.architecture`), since a loaded config carries the
default dtype, not the serving model's.

`ModelManager` runs inside the serve process (Podracer split, arXiv:
2104.06272: learners publish versioned weights, resident actors swap them
in-place).  Because the serve plane's bucket ladder fixes every pytree
shape, applying a new version is a `device_put` plus a pointer swap under
the service's swap lock — the compiled per-bucket eval programs are keyed
on shapes, so a swap never recompiles and never drops a window.

Lifecycle, as the poll loop sees it:

  * **LIVE moved** (promote or rollback, from any process) → load, gate
    (pytree + architecture compatibility), stage to device, swap.
  * **a newer version exists but LIVE did not move** → stage it as the
    SHADOW candidate: every live batch is also scored by the candidate
    (``registry_shadow_score`` spans), the paired disagreement/drift
    statistics export as ``nerrf_registry_*`` metrics, and when the
    guardrails pass (`guardrails.evaluate`) the manager auto-promotes —
    repoints LIVE in the registry, then swaps in-process.  A guardrail
    veto stops the shadow and remembers the version so it is never
    re-staged.

Every decision is also available synchronously: `poll()` is reentrant-safe
and is what `nerrf models`-poked deployments call.
"""

from __future__ import annotations

import threading
from typing import Optional

from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL
from nerrf_tpu_torch.registry.config import RegistryConfig
from nerrf_tpu_torch.registry.guardrails import (
    PROMOTE,
    VETO,
    evaluate,
    make_stats,
)
from nerrf_tpu_torch.registry.store import ModelRegistry
from nerrf_tpu_torch.tracing import span as trace_span
from nerrf_tpu_torch.train.checkpoint import architecture


class ModelManager:
    def __init__(self, store: ModelRegistry, lineage: str,
                 cfg: Optional[RegistryConfig] = None,
                 registry=None, log=None, journal=None) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        self.store = store
        self.lineage = lineage
        self.cfg = cfg or RegistryConfig()
        self._reg = registry
        self._log = log or (lambda msg: None)
        self._journal = journal if journal is not None else DEFAULT_JOURNAL
        self._shadow_obs = 0  # journal cadence for shadow-stat records
        self._service = None
        self._version: Optional[int] = None
        self._shadow_version: Optional[int] = None
        self._stats = None
        self._vetoed: set = set()
        self._poll_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- boot -----------------------------------------------------------------

    def boot(self):
        """Load the lineage's LIVE checkpoint for service construction.
        → (params, JointConfig, calibration, version)."""
        params, model_cfg, calibration, version = self.store.load(
            self.lineage)
        # _version is otherwise only moved under the poll lock; boot
        # usually runs before polling starts, but a CLI-poked manager can
        # already be polling, so the write takes the same lock
        with self._poll_lock:
            self._version = version
        return params, model_cfg, calibration, version

    def attach(self, service) -> "ModelManager":
        """Bind to a started `OnlineDetectionService` (the service calls
        back into `observe_shadow` from its scorer thread)."""
        self._service = service
        service.attach_manager(self)
        # same discipline as boot(): _version moves only under the poll
        # lock (a concurrent poll would race the stamp otherwise).  The
        # nested swap-lock take matches the _apply→swap_params order, so
        # the acquisition-order graph stays acyclic.
        with self._poll_lock:
            if self._version is None:
                self._version = service.live_version
            elif service.live_version is None:
                # the service was constructed from boot()'s params before
                # any swap: stamp the booted version so results carry it
                # from the first scored window
                with service._swap_lock:
                    service._live_version = self._version
            version = self._version
        self._stamp_info(version)
        self._push_quality_profile(version)
        return self

    @property
    def live_version(self) -> Optional[int]:
        return self._version

    @property
    def shadow_version(self) -> Optional[int]:
        return self._shadow_version

    def _push_quality_profile(self, version: Optional[int]) -> None:
        """Bind the version's reference quality profile to the service's
        drift monitor — the serve plane must always compare live traffic
        against the distribution of the version actually serving.  Best-
        effort and tolerant of profile-less versions (the monitor then
        exports nothing) and of skeleton services without the setter."""
        setter = getattr(self._service, "set_quality_profile", None)
        if setter is None:
            return
        try:
            profile = (self.store.quality_profile(self.lineage, version)
                       if version is not None else None)
            setter(profile, version=version)
        except Exception as e:  # noqa: BLE001 — drift plane is advisory
            self._log(f"registry: quality profile bind for v{version} "
                      f"failed: {type(e).__name__}: {e}")

    # -- metrics --------------------------------------------------------------

    def _stamp_info(self, version: Optional[int],
                    previous: Optional[int] = None) -> None:
        """`nerrf_build_info`-style identity gauge: exactly one series per
        lineage is 1 (the serving version); a swapped-out version's series
        drops to 0 so dashboards see the flip, not two live models."""
        if previous is not None and previous != version:
            self._reg.gauge_set(
                "model_info", 0.0,
                labels={"lineage": self.lineage, "version": f"v{previous}"},
                help="1 for the model version currently serving "
                     "this lineage")
        if version is not None:
            self._reg.gauge_set(
                "model_info", 1.0,
                labels={"lineage": self.lineage, "version": f"v{version}"},
                help="1 for the model version currently serving "
                     "this lineage")

    # -- shadow observation (scorer thread) -----------------------------------

    def observe_shadow(self, live_probs, shadow_probs, node_mask,
                       version: int) -> None:
        stats = self._stats
        if stats is None or version != self._shadow_version:
            return  # a batch scored against an already-retired shadow
        stats.observe(live_probs, shadow_probs, node_mask)
        self._reg.counter_inc(
            "registry_shadow_windows_total",
            labels={"lineage": self.lineage},
            help="windows scored by a shadow candidate alongside the "
                 "live model")
        snap = stats.snapshot()
        self._reg.gauge_set(
            "registry_shadow_disagreement_rate", snap["disagreement_rate"],
            labels={"lineage": self.lineage},
            help="fraction of real-node decisions the shadow candidate "
                 "flips vs live (paired, same batches)")
        self._reg.gauge_set(
            "registry_shadow_score_drift", snap["score_drift"],
            labels={"lineage": self.lineage},
            help="mean |p_shadow - p_live| over real nodes (score-"
                 "distribution drift)")
        # journal the paired stats on a cadence (not per window — the ring
        # is bounded and batch closes must survive a long shadow run); the
        # flight recorder's shadow_disagreement trigger keys off this kind.
        # The counter is scorer-thread-only in steady state; a racy reset
        # from _start_shadow merely shifts the journal cadence by a window
        # nerrflint: ok[lock-discipline] cadence counter: a torn read shifts journaling by one window, never corrupts state
        self._shadow_obs += 1
        # nerrflint: ok[lock-discipline] same cadence counter as the line above
        if self._shadow_obs % 32 == 1:
            self._journal.record(
                "registry_shadow_stats", lineage=self.lineage,
                version=version,
                windows=self._shadow_obs,
                disagreement_rate=round(snap["disagreement_rate"], 4),
                score_drift=round(snap["score_drift"], 4),
                # score-distribution quantiles from the shared sketch
                # primitive (quality/sketch): the record shows a tail
                # walking toward the cut, not just the paired means
                live_score_quantiles=snap["live_score_quantiles"],
                shadow_score_quantiles=snap["shadow_score_quantiles"])

    # -- the poll step --------------------------------------------------------

    def poll(self) -> dict:
        """One lifecycle step; called by the poll thread, a CLI poke, or a
        test.  Returns a record of what (if anything) happened."""
        with self._poll_lock:
            return self._poll_locked()

    def _poll_locked(self) -> dict:
        out = {"live": self._version, "shadow": self._shadow_version,
               "action": "none"}
        try:
            live_rec = self.store.live(self.lineage)
        except (OSError, ValueError) as e:
            out.update(action="error", error=f"{type(e).__name__}: {e}")
            return out
        target = int(live_rec["version"]) if live_rec else None
        # 1) the pointer moved (promote/rollback from anywhere): follow it
        if target is not None and target != self._version:
            return self._apply(target, out)
        # 2) a newer published version: stage it as the shadow candidate.
        # The floor is the newest version that has EVER been LIVE (the
        # pointer records its predecessor), not just the current one —
        # after a rollback v2→v1 the floor stays 2, so the version the
        # operator just rolled back from is never re-staged and silently
        # re-promoted, even by a freshly restarted pod whose in-memory
        # veto set is empty
        floor = max(target or 0,
                    int((live_rec or {}).get("previous") or 0))
        # veto entries at/below the floor are dead — the staging filter
        # below only ever considers v > floor — so drop them here, or a
        # long-lived manager's veto set grows by one per rejected
        # candidate for the lineage's lifetime
        if any(v <= floor for v in self._vetoed):
            self._vetoed = {v for v in self._vetoed if v > floor}
        newest = max(
            (v for v in self.store.versions(self.lineage)
             if v > floor and v not in self._vetoed),
            default=None)
        if newest is not None and newest != self._shadow_version:
            return self._start_shadow(newest, out)
        # 3) judge the running shadow
        if self._shadow_version is not None and self._stats is not None:
            verdict, reason = evaluate(self._stats, self.cfg)
            out.update(verdict=verdict, reason=reason)
            if verdict == PROMOTE and self.cfg.auto_promote:
                try:
                    self.store.promote(self.lineage, self._shadow_version,
                                       kind="auto")
                except OSError as e:
                    # an unwritable registry (read-only mount, transient
                    # volume error) must not wedge the poll loop with the
                    # shadow double-scoring forever on a promotion that
                    # can never land: veto locally and surface the error
                    # nerrflint: ok[callback-under-lock] _log is a one-line CLI/print logger by contract; only the poll thread and CLI pokes take _poll_lock — the scorer thread never does
                    self._log(f"registry: auto-promotion of "
                              f"v{self._shadow_version} cannot write the "
                              f"registry ({e}); unstaging the candidate — "
                              f"promote it with `nerrf models promote` "
                              f"from a host with write access")
                    self._vetoed.add(self._shadow_version)
                    out.update(action="error",
                               error=f"promote v{self._shadow_version}: {e}")
                    self._retire_shadow()
                    return out
                self._reg.counter_inc(
                    "registry_promotions_total",
                    labels={"lineage": self.lineage, "kind": "auto"},
                    help="candidate versions promoted to LIVE")
                self._journal.record(
                    "registry_promote", lineage=self.lineage,
                    version=self._shadow_version, promotion="auto",
                    reason=reason)
                return self._apply(self._shadow_version, out,
                                   action="auto_promote")
            if verdict == VETO:
                self._vetoed.add(self._shadow_version)
                self._reg.counter_inc(
                    "registry_shadow_vetoes_total",
                    labels={"lineage": self.lineage},
                    help="shadow candidates rejected by a promotion "
                         "guardrail")
                self._journal.record(
                    "registry_veto", lineage=self.lineage,
                    version=self._shadow_version, reason=reason)
                self._log(f"registry: shadow v{self._shadow_version} "
                          f"vetoed — {reason}")
                out.update(action="veto", vetoed=self._shadow_version)
                self._retire_shadow()
        return out

    def _apply(self, version: int, out: dict, action: str = "swap") -> dict:
        """Load → gate → stage → atomic swap under the service lock."""
        try:
            params, model_cfg, calibration, _ = self.store.load(
                self.lineage, version)
        except (OSError, ValueError) as e:
            out.update(action="error",
                       error=f"load v{version}: {type(e).__name__}: {e}")
            return out
        svc = self._service
        if svc is not None:
            if svc.model_config is not None and \
                    architecture(model_cfg) != architecture(svc.model_config):
                # architecture drift the pytree check might not catch
                # (e.g. fuse mode): refuse — the compiled programs encode
                # the live architecture.  (model-free services — test
                # stubs — skip this and rely on the pytree gate.)
                self._vetoed.add(version)
                out.update(action="error",
                           error=f"v{version} architecture {model_cfg} != "
                                 f"serving {svc.model_config}; not swapped")
                return out
            try:
                with trace_span("registry_swap", lineage=self.lineage,
                                version=version):
                    svc.swap_params(
                        params, version,
                        threshold=calibration.get("node_threshold"))
                # stage the version's AOT sidecar (if published with one):
                # the running ladder needs no recompile — the swap reuses
                # the compiled programs by the pytree contract — but any
                # FUTURE compile (restart, ladder change) now seeds from
                # the freshest published executables
                stage = getattr(svc, "stage_executables", None)
                if stage is not None:
                    stage(self.store.executables_dir(self.lineage, version))
            except ValueError as e:
                # pytree-signature mismatch: the checkpoint cannot serve on
                # the compiled programs — veto so the poll loop does not
                # reload + re-stage it to device every poll_sec forever
                self._vetoed.add(version)
                # nerrflint: ok[callback-under-lock] same one-line-logger contract as _poll_locked; swap cadence tolerates a log line
                self._log(f"registry: cannot swap to v{version}: {e}")
                out.update(action="error", error=f"swap v{version}: {e}")
                return out
        previous, self._version = self._version, version
        direction = "rollback" if (previous is not None
                                   and version < previous) else "forward"
        if direction == "rollback" and previous is not None:
            # never re-stage the version the operator just rolled back
            # from (the candidate floor in _poll_locked enforces the same
            # across restarts; this covers the running process)
            self._vetoed.add(previous)
        self._reg.counter_inc(
            "registry_swaps_total",
            labels={"lineage": self.lineage, "direction": direction},
            help="live param hot-swaps applied in-process (zero-recompile "
                 "pointer swaps under the batch lock)")
        self._stamp_info(version, previous=previous)
        # the drift baseline moves WITH the model: from the next scored
        # batch the monitor compares against the incoming version's
        # reference (or goes silent for a profile-less version)
        self._push_quality_profile(version)
        self._journal.record(
            "registry_swap", lineage=self.lineage, version=version,
            previous=previous, direction=direction, action=action)
        if self._shadow_version is not None and self._shadow_version <= version:
            self._retire_shadow()
        self._log(f"registry: live model -> v{version} "
                  f"(was v{previous}, {direction})")
        out.update(action=action, live=version, previous=previous,
                   direction=direction)
        return out

    def _start_shadow(self, version: int, out: dict) -> dict:
        try:
            params, model_cfg, calibration, _ = self.store.load(
                self.lineage, version)
        except (OSError, ValueError) as e:
            out.update(action="error",
                       error=f"load v{version}: {type(e).__name__}: {e}")
            return out
        svc = self._service
        if svc is not None:
            if svc.model_config is not None and \
                    architecture(model_cfg) != architecture(svc.model_config):
                self._vetoed.add(version)
                out.update(action="error",
                           error=f"shadow v{version} architecture mismatch; "
                                 f"not staged")
                return out
            try:
                svc.start_shadow(params, version)
            except ValueError as e:
                # same pytree gate as the swap path: veto, don't retry
                self._vetoed.add(version)
                # nerrflint: ok[callback-under-lock] same one-line-logger contract as _poll_locked; shadow staging cadence tolerates a log line
                self._log(f"registry: cannot stage shadow v{version}: {e}")
                out.update(action="error", error=f"shadow v{version}: {e}")
                return out
            thr = svc.cfg.threshold
        else:
            thr = None
        self._stats = make_stats(self.cfg, threshold=thr)
        self._shadow_version = version
        self._shadow_obs = 0
        self._journal.record(
            "registry_shadow", lineage=self.lineage, version=version,
            live=self._version)
        self._log(f"registry: shadow candidate v{version} staged "
                  f"(live v{self._version})")
        out.update(action="shadow_start", shadow=version)
        return out

    def _retire_shadow(self) -> None:
        self._shadow_version = None
        self._stats = None
        if self._service is not None:
            self._service.stop_shadow()

    def shadow_report(self) -> Optional[dict]:
        stats, version = self._stats, self._shadow_version
        if stats is None or version is None:
            return None
        verdict, reason = evaluate(stats, self.cfg)
        return {"shadow": version, "verdict": verdict, "reason": reason,
                **stats.snapshot()}

    # -- poll thread ----------------------------------------------------------

    def start_polling(self) -> "ModelManager":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(timeout=self.cfg.poll_sec):
                try:
                    self.poll()
                except Exception as e:  # noqa: BLE001 — a poll failure
                    # must never kill the lifecycle thread (the next poll
                    # may find a repaired registry)
                    self._log(f"registry poll failed: {type(e).__name__}: {e}")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="nerrf-registry-poll")
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
