"""Fleet controller: headroom-driven autoscaling + deterministic stream
placement over a set of serve replicas (docs/fleet.md).

The port of ``nerrf_tpu/fleet/controller.py``: the same decisions, journal
records and ``nerrf_fleet_*`` metrics, line for line; the daemon (`main`)
adds ``--device`` (passed to every replica) and refuses ``--compile-cache``
until the port has a compile cache (ROADMAP A.7).

The controller is a poll loop over each replica's ``/metrics`` +
``/readyz``: it reads the capacity plane's predicted headroom gauge
(``nerrf_capacity_headroom_streams``, devtime/headroom.py) per replica
and actuates three decisions, each journaled with the evidence snapshot
that justified it and exported as ``nerrf_fleet_*`` metrics:

  * ``fleet_scale`` (direction=out) — the worst replica's predicted
    headroom has sat below ``scale_out_below`` for ``scale_out_sustain``
    consecutive polls: add a replica BEFORE the saturation point the
    capacity ramp measures (the prediction leads the delivery-ratio
    collapse by construction — that is what the headroom model is for).
  * ``fleet_scale`` (direction=in) — every replica's headroom has sat
    above ``scale_in_above`` for ``scale_in_sustain`` polls: retire one,
    preferring a replica the slot map left empty.  A replica hosting no
    streams reads as pure slack regardless of its gauge — an emptied
    replica's last exported headroom is frozen at its busy-era value
    (no traffic, nothing updates the estimator), and trusting it would
    wedge scale-in forever.  The band between the two thresholds is the
    hysteresis dead zone — a headroom trajectory oscillating inside it
    never flaps the fleet.
  * ``fleet_rebalance`` — stream→replica slots recomputed through the
    deterministic `slot_map` (stable hash of the BASE stream name, the
    same key quarantine and the SLO/quality ledgers use — so a moved
    stream's ledgers follow it by construction, nothing is migrated).

The controller owns no device state and runs host-side everywhere.  Its
poll thread is NON-daemon with a stop event and a bounded join (the
repo's thread-lifecycle discipline): `stop()` always returns.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional


def _base_stream(stream_id: str) -> str:
    """`s#3` → `s`: reconnect sessions are the same placement demand
    (the serve plane's quarantine/SLO ledgers key the same way)."""
    return stream_id.split("#", 1)[0]


def stable_slot(stream_id: str, n: int) -> int:
    """Deterministic slot of a stream among ``n`` replicas: stable hash
    (sha1 — NOT the interpreter's randomized `hash`) of the BASE stream
    name.  Every controller replica, restart, and offline replay computes
    the same placement from the same inputs."""
    digest = hashlib.sha1(_base_stream(stream_id).encode()).digest()
    return int.from_bytes(digest[:8], "big") % max(n, 1)


def slot_map(streams, replicas) -> Dict[str, str]:
    """stream → replica-name placement over the SORTED replica list.
    Pure and deterministic: the same (streams, replicas) always yields
    the same map, so a rebalance is a diff of two calls, never a
    stateful migration."""
    reps = sorted(replicas)
    if not reps:
        return {}
    return {s: reps[stable_slot(s, len(reps))] for s in streams}


def parse_gauge(text: Optional[str], name: str,
                labels: Optional[Dict[str, str]] = None) -> Optional[float]:
    """First sample of one gauge out of a /metrics text exposition.
    Tolerant by design — a half-written scrape yields None, never an
    exception into the poll loop."""
    if not text:
        return None
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        try:
            key, val = line.rsplit(" ", 1)
        except ValueError:
            continue
        if key.split("{", 1)[0] != name:
            continue
        if labels and not all(f'{k}="{v}"' in key
                              for k, v in labels.items()):
            continue
        try:
            return float(val)
        except ValueError:
            continue
    return None


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Controller knobs.  The two headroom thresholds form the
    hysteresis band: ``scale_out_below`` strictly under
    ``scale_in_above``, with sustain counters on both edges and a
    cooldown after any actuation, so a noisy headroom trajectory inside
    the band never flaps the replica count."""

    poll_sec: float = 2.0
    # scale OUT when the worst replica's predicted headroom is below
    # this many streams...
    scale_out_below: float = 1.5
    # ...and back IN only when EVERY replica's headroom exceeds this
    # (the band between the two is the dead zone)
    scale_in_above: float = 4.0
    # consecutive polls the signal must hold before actuating
    scale_out_sustain: int = 2
    scale_in_sustain: int = 5
    # no scale decision within this long of the previous one
    cooldown_sec: float = 10.0
    min_replicas: int = 1
    max_replicas: int = 4
    # the gauge scraped from each replica (rendered name — replicas
    # export through their own registries, prefix included)
    headroom_metric: str = "nerrf_capacity_headroom_streams"

    def __post_init__(self) -> None:
        if self.scale_out_below >= self.scale_in_above:
            raise ValueError(
                "hysteresis band inverted: scale_out_below "
                f"({self.scale_out_below}) must be strictly below "
                f"scale_in_above ({self.scale_in_above})")


class FleetController:
    """Poll → decide → actuate over a replica pool.

    The pool is any object with the `ReplicaSet` surface
    (fleet/replica.py): ``replicas()`` → {name: handle} where each
    handle has ``scrape()`` (raw /metrics text or None) and ``ready()``;
    ``streams()`` → the base-stream universe; ``scale_out()`` →
    new-replica name or None; ``scale_in(name)``; ``apply_slots(map,
    moved)``.  A fake pool with those five methods is the paced unit
    harness for the hysteresis tests."""

    def __init__(self, pool, cfg: Optional[FleetConfig] = None,
                 registry=None, journal=None, archive_dirs=None,
                 log=lambda *a: None) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        if journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            journal = DEFAULT_JOURNAL
        self.pool = pool
        self.cfg = cfg or FleetConfig()
        self._reg = registry
        self._journal = journal
        self._log = log
        # optional cross-host evidence: `archive merge`d telemetry dirs
        # whose capacity trajectory is stamped into scale decisions
        self._archive_dirs = list(archive_dirs or [])
        self._slots: Dict[str, str] = {}
        self._low_ticks = 0
        self._slack_ticks = 0
        self._last_scale_t: Optional[float] = None
        # recent decision tail for stats/tests; the journal is the
        # durable record
        self.decisions: deque = deque(maxlen=64)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "FleetController":
        if self._thread is not None:
            raise RuntimeError("controller already started")
        self._stop.clear()
        # NON-daemon + stop event + bounded join in stop(): the repo's
        # thread-lifecycle rule (a daemon thread caught inside teardown
        # is the historical segfault class; this one is device-free but the
        # discipline is uniform)
        self._thread = threading.Thread(target=self._run, daemon=False,
                                        name="nerrf-fleet-controller")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the loop must live
                self._log(f"[fleet] poll error: {type(e).__name__}: {e}")
            self._stop.wait(self.cfg.poll_sec)

    # -- one poll step (the unit-testable body) -------------------------------

    def poll_once(self, now: Optional[float] = None) -> Optional[dict]:
        """Scrape every replica, update gauges, apply the hysteresis
        bands, actuate at most one scale decision, then reconcile the
        slot map.  Returns the decision record (or None)."""
        cfg = self.cfg
        now = time.monotonic() if now is None else now
        reps = self.pool.replicas()
        per: Dict[str, Optional[float]] = {}
        ready: List[str] = []
        for name in sorted(reps):
            handle = reps[name]
            try:
                text = handle.scrape()
                is_ready = bool(handle.ready())
            except Exception:  # noqa: BLE001 — a dying replica is data
                text, is_ready = None, False
            h = parse_gauge(text, cfg.headroom_metric)
            per[name] = h
            if is_ready:
                ready.append(name)
            if h is not None:
                self._reg.gauge_set(
                    "fleet_headroom_streams", h,
                    labels={"replica": name},
                    help="per-replica predicted capacity headroom as "
                         "scraped by the fleet controller (streams)")
        decision = None
        # a replica the slot map assigns NO streams has a stale gauge by
        # construction (no traffic → the headroom estimator has nothing
        # to update): its true state is total slack, so it must neither
        # block scale-in with a frozen low reading nor trigger scale-out.
        # Guarded on a non-empty slot map: before any stream is placed,
        # gauges are trusted as-is
        hosted = set(self._slots.values())
        idle = sorted(name for name in per
                      if self._slots and name not in hosted)
        known = [h for name, h in per.items()
                 if h is not None and name not in idle]
        if not known and idle:
            # every replica is empty but streams exist (transient during
            # placement) — pure slack fleet-wide
            known = [float("inf")]
        if known:
            worst = min(known)
            if worst < cfg.scale_out_below:
                self._low_ticks += 1
                self._slack_ticks = 0
            elif worst > cfg.scale_in_above:
                self._slack_ticks += 1
                self._low_ticks = 0
            else:
                # inside the hysteresis band: decay both edges — the
                # dead zone is where nothing happens
                self._low_ticks = 0
                self._slack_ticks = 0
            cool = (self._last_scale_t is None
                    or now - self._last_scale_t >= cfg.cooldown_sec)
            if (self._low_ticks >= cfg.scale_out_sustain and cool
                    and len(reps) < cfg.max_replicas):
                decision = self._scale("out", worst, per, now)
            elif (self._slack_ticks >= cfg.scale_in_sustain and cool
                  and len(reps) > cfg.min_replicas):
                decision = self._scale("in", worst, per, now)

        # gauge AFTER any actuation: the exported count is what the
        # fleet looks like leaving this poll, not entering it
        self._reg.gauge_set(
            "fleet_replicas", float(len(self.pool.replicas())),
            help="serve replicas currently managed by the fleet "
                 "controller")
        if decision is None:
            self._rebalance(ready if ready else sorted(reps))
        else:
            # membership just changed: reconcile against the live set
            self._rebalance(sorted(self.pool.replicas()))
        return decision

    def _scale(self, direction: str, worst: float,
               per: Dict[str, Optional[float]],
               now: float) -> Optional[dict]:
        reps_before = len(self.pool.replicas())
        hosted = set(self._slots.values())
        if direction == "out":
            name = self.pool.scale_out()
            if name is None:
                return None
        else:
            # retire an EMPTY replica when one exists (it hosts nothing:
            # zero streams move), else the LAST in sort order — either
            # way the same replica every controller instance would pick,
            # so an HA pair of controllers cannot retire two
            cands = sorted(self.pool.replicas())
            empty = [r for r in cands if r not in hosted]
            name = (empty or cands)[-1]
            self.pool.scale_in(name)
        self._last_scale_t = now
        self._low_ticks = 0
        self._slack_ticks = 0
        evidence = {
            "worst_headroom_streams": (
                None if worst == float("inf") else round(worst, 3)),
            "per_replica": {k: (None if v is None else round(v, 3))
                            for k, v in per.items()},
            # empty replicas whose (stale) gauges were read as pure slack
            "idle_replicas": sorted(r for r in per
                                    if self._slots and r not in hosted),
            "scale_out_below": self.cfg.scale_out_below,
            "scale_in_above": self.cfg.scale_in_above,
        }
        archive_ev = self._archive_evidence()
        if archive_ev is not None:
            evidence["archive"] = archive_ev
        record = {
            "direction": direction, "replica": name,
            "replicas_before": reps_before,
            "replicas_after": len(self.pool.replicas()),
            "reason": ("headroom_low" if direction == "out"
                       else "sustained_slack"),
            "evidence": evidence,
        }
        self._journal.record("fleet_scale", **record)
        self.decisions.append({"kind": "fleet_scale", **record})
        self._log(f"[fleet] scale {direction}: {name} "
                  f"(worst headroom {worst:.2f})")
        return record

    def _rebalance(self, replica_names: List[str]) -> None:
        desired = slot_map(self.pool.streams(), replica_names)
        if desired == self._slots:
            return
        moved = sorted(s for s, r in desired.items()
                       if s in self._slots and self._slots[s] != r)
        self.pool.apply_slots(desired, moved)
        if moved:
            self._reg.counter_inc(
                "fleet_rebalances_total",
                help="stream slot-map rebalances actuated by the fleet "
                     "controller")
            record = {"slots": dict(desired), "moved": moved,
                      "replicas": sorted(replica_names)}
            self._journal.record("fleet_rebalance", **record)
            self.decisions.append({"kind": "fleet_rebalance", **record})
            self._log(f"[fleet] rebalance: moved {moved}")
        self._slots = desired

    def _archive_evidence(self) -> Optional[dict]:
        """Cross-host capacity trajectory from `archive merge`d dirs —
        stamped into scale decisions only (never per poll: reading an
        archive is file I/O, decisions are rare)."""
        if not self._archive_dirs:
            return None
        try:
            from nerrf_tpu_torch.archive import build_report

            cap = build_report(self._archive_dirs)["capacity"]
            return {"dirs": [str(d) for d in self._archive_dirs],
                    "headroom_streams_min": cap["headroom_streams_min"],
                    "saturation_events": cap["saturation_events"]}
        except Exception:  # noqa: BLE001 — evidence, not a dependency
            return None


def main(argv=None) -> int:
    """Fleet controller daemon (deploy/manifests/nerrf-fleet.yaml runs
    exactly this): a `FleetController` over a `ReplicaSet` of locally
    spawned serve replicas (fleet/replica.py), with the controller's
    ``nerrf_fleet_*`` gauges and /healthz on ``--metrics-port``.  The
    same loop the bench drives (benchmarks/run_fleet_bench.py part B),
    resident: register the offered streams, one reconciliation poll to
    place them, then the hysteresis loop until interrupted.  Every
    replica runs on ``--device`` (the card by default: without CUDA the
    daemon raises before it spawns one); ``--compile-cache`` exits 2."""
    import argparse
    import sys

    from nerrf_tpu_torch.device import resolve_device
    from nerrf_tpu_torch.fleet.replica import (
        COMPILE_CACHE_REFUSAL,
        ReplicaProcess,
        ReplicaSet,
        replica_args,
    )
    from nerrf_tpu_torch.observability import DEFAULT_REGISTRY, MetricsServer

    p = argparse.ArgumentParser(
        description="headroom-driven fleet controller over spawned "
                    "serve replicas")
    p.add_argument("--poll-sec", type=float, default=2.0)
    p.add_argument("--scale-out-below", type=float, default=1.5)
    p.add_argument("--scale-in-above", type=float, default=4.0)
    p.add_argument("--scale-out-sustain", type=int, default=2)
    p.add_argument("--scale-in-sustain", type=int, default=5)
    p.add_argument("--cooldown-sec", type=float, default=10.0)
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=4)
    p.add_argument("--metrics-port", type=int, default=0)
    p.add_argument("--stream", action="append", default=[],
                   metavar="NAME=RATE_HZ",
                   help="offered stream, repeatable (rate defaults 1.0)")
    p.add_argument("--duration-sec", type=float, default=0.0,
                   help="exit after this long; 0 = until interrupted")
    # replica spec passthrough (kept next to replica_args so the two
    # cannot drift)
    p.add_argument("--buckets", default="256x512x64")
    p.add_argument("--synthetic-cost", type=float, default=0.0)
    p.add_argument("--devtime-window-sec", type=float, default=60.0)
    p.add_argument("--compile-cache", default=None,
                   help="not ported yet (ROADMAP A.7), exits 2")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where every replica's tensors live (default: the "
                        "card; without CUDA the default raises)")
    p.add_argument("--archive-dir", action="append", default=[],
                   help="archived telemetry dir(s) stamped into scale "
                        "decisions as cross-host evidence (repeatable)")
    args = p.parse_args(argv)

    def log(*a) -> None:
        print(*a, file=sys.stderr, flush=True)

    if args.compile_cache is not None:
        log(COMPILE_CACHE_REFUSAL)
        return 2
    resolve_device(args.device)

    def spawn(name: str) -> ReplicaProcess:
        return ReplicaProcess(name, args=replica_args(
            buckets=args.buckets, synthetic_cost=args.synthetic_cost,
            devtime_window_sec=args.devtime_window_sec,
            device=args.device), log=log)

    rs = ReplicaSet(spawn, max_replicas=args.max_replicas, log=log)
    metrics = MetricsServer(registry=DEFAULT_REGISTRY, host="0.0.0.0",
                            port=args.metrics_port)
    ctl = FleetController(
        rs,
        FleetConfig(poll_sec=args.poll_sec,
                    scale_out_below=args.scale_out_below,
                    scale_in_above=args.scale_in_above,
                    scale_out_sustain=args.scale_out_sustain,
                    scale_in_sustain=args.scale_in_sustain,
                    cooldown_sec=args.cooldown_sec,
                    min_replicas=args.min_replicas,
                    max_replicas=args.max_replicas),
        archive_dirs=args.archive_dir, log=log)
    rc = 0
    try:
        rs.scale_out()  # the steady-state first replica
        for spec in args.stream:
            name, _, rate = spec.partition("=")
            rs.add_stream(name, float(rate or 1.0))
        ctl.poll_once()  # reconciliation: place streams before the loop
        ctl.start()
        log(f"[fleet] controller up: metrics :{metrics.port}, "
            f"{len(args.stream)} stream(s)")
        stop = threading.Event()
        stop.wait(args.duration_sec if args.duration_sec > 0 else None)
    except KeyboardInterrupt:
        pass
    except Exception as e:  # noqa: BLE001 — exit with the evidence
        log(f"[fleet] fatal: {type(e).__name__}: {e}")
        rc = 1
    finally:
        ctl.stop()
        rs.stop_all()
        metrics.close()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
