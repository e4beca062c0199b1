"""Plan verification: replay before surfacing.

The port of ``nerrf_tpu/respond/verify.py`` over the port's host copies of
the rollback sandbox gate and snapshot store.

Every `UndoPlan` the batched planner emits is rehearsed through the
rollback sandbox gate (`rollback.sandbox.SandboxGate`: clone the victim
tree, optionally replay the captured trace for determinism, execute the
plan against the clone, diff against the pre-attack manifest) BEFORE it is
surfaced to any consumer.  A plan that cannot be verified — no snapshot
context bound, replay divergence, residual diff, failed restores, even an
empty plan — is quarantined with a journaled ``plan_rejected`` reason and
never surfaced.  Fail closed: an unverifiable plan executed against a live
host is exactly the blast radius this tier exists to prevent.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple

from nerrf_tpu_torch.planner.domain import UndoPlan
from nerrf_tpu_torch.rollback.sandbox import GateResult, SandboxGate
from nerrf_tpu_torch.rollback.store import Manifest, SnapshotStore


@dataclasses.dataclass
class VerifyContext:
    """The graph-snapshot handle an incident carries: everything the gate
    needs to rehearse a plan for that incident's stream.

    ``leaves_behind`` is the per-scenario residue policy — attack
    artifacts the plan intentionally does not remove (ransom notes,
    staging blobs, dropped cron entries).  File *names*, matched against
    the diff's extra entries exactly like the gate's default ransom-note
    policy."""

    store: SnapshotStore
    manifest: Manifest
    victim_root: Path
    trace: Optional[object] = None
    ransom_ext: str = ".lockbit3"
    leaves_behind: Tuple[str, ...] = ("README_LOCKBIT.txt",)


@dataclasses.dataclass
class VerifiedPlan:
    """The verifier's output for one incident: surfaced iff verified."""

    incident: object
    plan: UndoPlan
    verified: bool
    reason: str
    gate: Optional[GateResult] = None

    def to_dict(self) -> Dict:
        return {
            "stream": self.incident.stream,
            "trace_id": self.incident.trace_id,
            "verified": self.verified,
            "reason": self.reason,
            "actions": len(self.plan.actions),
            "expected_reward": self.plan.expected_reward,
        }


class PlanVerifier:
    """Replays plans through the sandbox gate and journals both verdicts."""

    def __init__(self, registry=None, journal=None) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        if journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            journal = DEFAULT_JOURNAL
        self._reg = registry
        self._journal = journal

    def _reject(self, incident, plan: UndoPlan, reason: str,
                gate: Optional[GateResult] = None) -> VerifiedPlan:
        self._reg.counter_inc(
            "respond_plans_total", labels={"outcome": "rejected"},
            help="undo plans leaving the respond planner, by outcome "
                 "(emitted pre-verification, then verified or rejected)")
        # the journaled reason IS the quarantine record: every rejected
        # plan must be explainable offline (doctor's respond section)
        self._journal.record(
            "plan_rejected", stream=incident.stream,
            window_id=incident.window_idx, trace_id=incident.trace_id,
            reason=reason, actions=len(plan.actions))
        return VerifiedPlan(incident=incident, plan=plan, verified=False,
                            reason=reason, gate=gate)

    def verify(self, incident, plan: UndoPlan) -> VerifiedPlan:
        ctx: Optional[VerifyContext] = incident.context
        if ctx is None:
            return self._reject(
                incident, plan,
                "no snapshot context bound for this stream — cannot replay")
        if not plan.actions:
            return self._reject(incident, plan, "planner emitted no actions")
        try:
            gate = SandboxGate(ctx.store, ctx.manifest,
                               ransom_ext=ctx.ransom_ext).rehearse(
                plan, ctx.victim_root, trace=ctx.trace,
                ignore_extra=tuple(ctx.leaves_behind))
        except Exception as e:  # noqa: BLE001 — a raising gate is a rejection
            return self._reject(
                incident, plan, f"gate raised {type(e).__name__}: {e}")
        if not gate.approved:
            return self._reject(incident, plan, gate.reason, gate=gate)
        self._reg.counter_inc(
            "respond_plans_total", labels={"outcome": "verified"},
            help="undo plans leaving the respond planner, by outcome "
                 "(emitted pre-verification, then verified or rejected)")
        self._journal.record(
            "plan_verified", stream=incident.stream,
            window_id=incident.window_idx, trace_id=incident.trace_id,
            actions=len(plan.actions),
            files_restored=gate.rehearsal.files_restored,
            replay_ops=gate.replay_ops)
        return VerifiedPlan(incident=incident, plan=plan, verified=True,
                            reason=gate.reason, gate=gate)
