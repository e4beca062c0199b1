"""Fault points: the imperative half of the chaos plane.

A **fault point** is one named line in a real code path where a failure
the production system claims to survive can be injected on demand:

    from nerrf_tpu_torch import chaos
    ...
    chaos.inject("ingest.wire_error", stream=stream_id)   # hot path

Disarmed (the default, and the only state outside an explicit game day /
chaos bench), ``inject``/``check``/``mangle`` are a single module-global
``None`` test — no plan parsing, no locks, no allocation — so the points
stay threaded through the hot paths permanently at zero cost (the serve
bench's p99 gate holds with every point disarmed).

Armed (`arm(plan)` / `arm_from_env()` reading ``NERRF_CHAOS_PLAN``), every
check consults the plan's specs for that site; a firing spec is journaled
as a typed ``fault_injected`` record carrying the site plus whatever
stream/window/trace IDs the call site passed — so every injection is
joinable to its observed effect (the quarantine record, the reconnect,
the fail-open compile) by trace ID, exactly like any other journal
evidence.  ``nerrf_chaos_faults_injected_total{site}`` counts firings.

Arming is process-global on purpose: the points live deep inside scorer
threads, gRPC drains, and cache reads that no config object reaches, and
a game day wants ONE switch.  `arm` returns the controller (tests and the
soak bench read its ``fired`` ledger); `disarm()` restores the no-op
state.  Arming while armed replaces the plan.

The port's copy of ``nerrf_tpu/chaos/points.py`` over the port's
``observability`` and ``flight.journal``, with one difference: the port
has no compile cache yet (ROADMAP A.7), so ``compilecache.corrupt_payload``
stays in the catalog (``chaos sites`` lists what the reference lists) but
a plan that names it is refused at validation, in one line naming A.7 —
armed, it could never fire, the phantom fault ``SITE_MODES`` forbids.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

from nerrf_tpu_torch.chaos.plan import (
    ChaosFault,
    FaultPlan,
    FaultSpec,
    corrupt_payload,
    hash01,
    load_plan,
)

# The fault-point catalog: every site threaded through the codebase, with
# the failure it simulates and the survival contract it exercises.  `nerrf
# chaos sites` prints this; plan validation rejects unknown names so a
# typo'd schedule fails at load, not by silently injecting nothing.
SITES: Dict[str, str] = {
    "ingest.wire_error":
        "TrackerClient.iter_blocks raises mid-stream (gRPC reset) — "
        "exercises resident reconnect with backoff+jitter",
    "ingest.wire_stall":
        "TrackerClient.iter_blocks stalls delay_sec before a frame — "
        "exercises deadline-based batch close under a slow producer",
    "serve.device_error":
        "the scorer's device program raises for a whole batch — "
        "exercises batch-failure accounting and stream isolation",
    "serve.device_latency":
        "the scorer's device program stalls delay_sec — exercises SLO "
        "degradation bounds and the scorer watchdog threshold",
    "serve.poison_window":
        "one window's presence makes its shared batch raise — exercises "
        "poison-batch bisection, per-stream strikes, quarantine",
    "registry.store_io":
        "ModelRegistry.publish raises OSError (volume I/O) — exercises "
        "publish fail-closed: no partial version, tmp cleaned up",
    "registry.corrupt_sidecar":
        "the published copy's model_config.json is mangled — exercises "
        "the one-line corrupt-sidecar load error, not a deep traceback",
    "compilecache.corrupt_payload":
        "a cache entry's executable bytes are mangled at read — "
        "exercises fail-open: evict, live compile, repair on put",
    "flight.disk_full":
        "the flight recorder's bundle dump raises ENOSPC — exercises "
        "dump fail-open + rate-limit retry (no .tmp orphans)",
    "alerts.slow_consumer":
        "AlertSink.drain stalls delay_sec (slow operator console) — "
        "exercises bounded drop-on-full demux, scoring unaffected",
    "train.nonfinite_grad":
        "one streaming train step's input batch is scaled by NaN (the "
        "non-finite value propagates through loss and gradients) — "
        "exercises the in-step nonfinite telemetry → train_divergence "
        "flight bundle → divergence halt, with zero recompiles",
}

# The mode(s) each point can actually EXECUTE: `inject` sites raise
# (error) or sleep (stall), `mangle` sites corrupt bytes.  Validation
# rejects a spec whose mode its site cannot execute — such a spec would
# fire, journal, and count while injecting nothing: a phantom fault no
# recovery record can ever match, which the game-day runbook would
# misread as a real unrecovered incident.
SITE_MODES: Dict[str, Tuple[str, ...]] = {
    "ingest.wire_error": ("error",),
    "ingest.wire_stall": ("stall",),
    "serve.device_error": ("error",),
    "serve.device_latency": ("stall",),
    "serve.poison_window": ("error",),
    "registry.store_io": ("error",),
    "registry.corrupt_sidecar": ("corrupt",),
    "compilecache.corrupt_payload": ("corrupt",),
    "flight.disk_full": ("error",),
    "alerts.slow_consumer": ("stall",),
    # the point corrupts DATA (a NaN-scaled batch), not bytes: the call
    # site uses chaos.check() and applies the poison itself, so "corrupt"
    # is the honest mode — error would claim a raise that never happens
    "train.nonfinite_grad": ("corrupt",),
}


# sites whose retry semantics REQUIRE the same verdict on every check of
# the same key: the scorer's bisection retries a poisoned window and can
# only converge if the fault replays on the same window each time.
# Counter triggers (at/every, or keyless prob) advance on every check —
# including retries — so the fault would hop to a DIFFERENT window per
# retry and bisection would quarantine windows that were never targeted.
KEY_STABLE_SITES = ("serve.poison_window",)

# sites of the catalog that no code path of the port reaches yet, each with
# why: a plan naming one is refused, since its spec could never fire
UNWIRED_SITES: Dict[str, str] = {
    "compilecache.corrupt_payload":
        "the port has no compile cache yet (ROADMAP A.7), so this point "
        "can never fire",
}


def validate_plan(plan: FaultPlan) -> FaultPlan:
    """Full plan validation: site names, trigger shapes, per-site mode
    executability, and key-stability where retries depend on it.  The
    one validator the CLI and arming share."""
    plan.validate(tuple(SITES))
    for spec in plan.faults:
        if spec.site in UNWIRED_SITES:
            raise ValueError(
                f"spec for {spec.site!r}: {UNWIRED_SITES[spec.site]}")
        allowed = SITE_MODES[spec.site]
        if spec.mode not in allowed:
            raise ValueError(
                f"spec for {spec.site!r}: mode {spec.mode!r} cannot "
                f"execute at this point (allowed: "
                f"{'/'.join(allowed)}) — it would journal a phantom "
                f"injection with no effect and no recovery")
        if spec.site in KEY_STABLE_SITES and (
                spec.at is not None or spec.every is not None):
            raise ValueError(
                f"spec for {spec.site!r}: at/every triggers are "
                f"counter-based and advance on bisection retries — the "
                f"fault would hop windows between retries and isolation "
                f"would converge on the wrong window; use prob (keyed "
                f"by trace ID) and/or match instead")
    return plan


class ChaosController:
    """The armed state: plan + per-spec hit/fire counters + the journal
    and metrics sinks.  One lock, held only for counter bookkeeping —
    never across a journal append or a sleep."""

    def __init__(self, plan: FaultPlan, registry=None, journal=None) -> None:
        validate_plan(plan)
        self.plan = plan
        self._registry = registry
        self._journal = journal
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._hits = [0] * len(plan.faults)
        self._fires = [0] * len(plan.faults)
        # the injection ledger: (site, key, ctx) per firing — the soak
        # bench joins this against recovery records, tests assert on it.
        # Bounded: a pod armed for a long game day with a high-rate spec
        # must not grow this for the life of the plan (the journal +
        # chaos_faults_injected_total are the unbounded-horizon records)
        self.fired: deque = deque(maxlen=8192)

    def _reg(self):
        if self._registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            self._registry = DEFAULT_REGISTRY
        return self._registry

    def _jrn(self):
        if self._journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            self._journal = DEFAULT_JOURNAL
        return self._journal

    def check(self, site: str, key: Optional[str],
              ctx: dict) -> Optional[FaultSpec]:
        """Evaluate every spec armed at ``site``; fire at most one (first
        match wins, in plan order).  Fired specs are journaled + counted
        here so call sites stay one-liners."""
        now = time.monotonic() - self._t0
        fired: Optional[FaultSpec] = None
        for i, spec in enumerate(self.plan.faults):
            if spec.site != site:
                continue
            if spec.match is not None and any(
                    ctx.get(k) != v for k, v in spec.match.items()):
                continue
            if now < spec.after_sec or (
                    spec.for_sec is not None
                    and now > spec.after_sec + spec.for_sec):
                continue
            with self._lock:
                if spec.max_fires is not None \
                        and self._fires[i] >= spec.max_fires:
                    continue
                self._hits[i] += 1
                hits = self._hits[i]
                ok = True
                if spec.at is not None and hits != spec.at:
                    ok = False
                if ok and spec.every is not None and hits % spec.every != 0:
                    ok = False
                if ok and spec.prob is not None:
                    draw_key = key if key is not None else str(hits)
                    ok = hash01(self.plan.seed, site, draw_key) < spec.prob
                if not ok:
                    continue
                self._fires[i] += 1
                self.fired.append((site, key, dict(ctx)))
            fired = spec
            break
        if fired is None:
            return None
        self._reg().counter_inc(
            "chaos_faults_injected_total", labels={"site": site},
            help="chaos-plane faults fired at armed fault points, by site")
        self._jrn().record(
            "fault_injected", stream=ctx.get("stream"),
            window_id=ctx.get("window_idx"),
            trace_id=ctx.get("trace_id") or key,
            site=site, mode=fired.mode,
            **{k: v for k, v in ctx.items()
               if k not in ("stream", "window_idx", "trace_id")})
        return fired


# the one global switch — None is the production state
_CONTROLLER: Optional[ChaosController] = None

PLAN_ENV = "NERRF_CHAOS_PLAN"


def armed() -> bool:
    return _CONTROLLER is not None


def controller() -> Optional[ChaosController]:
    return _CONTROLLER


def arm(plan: FaultPlan, registry=None, journal=None) -> ChaosController:
    """Arm a plan process-wide; returns the controller (its ``fired``
    ledger is the injection record of truth for benches/tests)."""
    global _CONTROLLER
    ctl = ChaosController(plan, registry=registry, journal=journal)
    _CONTROLLER = ctl
    ctl._jrn().record("chaos_armed", seed=plan.seed,
                      faults=[s.to_dict() for s in plan.faults])
    return ctl


def disarm() -> None:
    global _CONTROLLER
    if _CONTROLLER is not None:
        _CONTROLLER._jrn().record("chaos_disarmed")
    _CONTROLLER = None


def arm_from_env(registry=None, journal=None,
                 log=None) -> Optional[ChaosController]:
    """Arm from ``$NERRF_CHAOS_PLAN`` (a plan file path) when set — the
    serve CLI calls this at boot so a game day is one env var on the pod,
    no image or flag change.  Unset → stays disarmed, returns None."""
    import os

    path = os.environ.get(PLAN_ENV)
    if not path:
        return None
    ctl = arm(load_plan(path), registry=registry, journal=journal)
    if log:
        log(f"chaos: armed {len(ctl.plan.faults)} fault spec(s) from "
            f"{path} (seed {ctl.plan.seed})")
    return ctl


# -- the call-site API (hot-path safe: one global read when disarmed) ---------

def check(site: str, key: Optional[str] = None, **ctx) -> Optional[FaultSpec]:
    """Would a fault fire here?  Returns the firing spec (journaled and
    counted) or None.  The raw primitive — `inject`/`mangle` wrap it."""
    ctl = _CONTROLLER
    if ctl is None:
        return None
    return ctl.check(site, key, ctx)


def inject(site: str, key: Optional[str] = None, **ctx) -> None:
    """The standard hot-path point: raise `ChaosFault` (mode=error) or
    sleep ``delay_sec`` (mode=stall) when a spec fires; no-op otherwise."""
    ctl = _CONTROLLER
    if ctl is None:
        return
    spec = ctl.check(site, key, ctx)
    if spec is None:
        return
    if spec.mode == "error":
        raise ChaosFault(spec.message
                         or f"injected fault at {site} ({ctx or key})")
    if spec.mode == "stall":
        time.sleep(spec.delay_sec)


def mangle(site: str, payload: bytes, key: Optional[str] = None,
           **ctx) -> bytes:
    """Byte-payload point: returns the payload, corrupted when a
    corrupt-mode spec fires (seeded, deterministic per plan)."""
    ctl = _CONTROLLER
    if ctl is None:
        return payload
    spec = ctl.check(site, key, ctx)
    if spec is None or spec.mode != "corrupt":
        return payload
    return corrupt_payload(payload, ctl.plan.seed, site,
                           flip_bytes=spec.flip_bytes)
