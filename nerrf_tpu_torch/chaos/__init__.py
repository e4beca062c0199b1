"""Chaos plane: deterministic, seedable fault injection for the paths
whose failure handling the stack stakes SLO claims on.

The port of ``nerrf_tpu/chaos``: `FaultPlan`/`FaultSpec` (the JSON schema),
`hash01` (the keyed coin) and `corrupt_payload` in ``plan.py``; the fault
points (``points.py``: the site catalog, arm/disarm, the controller) threaded
through the port's serve, alerts, ingest, training, registry and flight
paths.  A plan is armed by ``serve-detect --chaos-plan`` or
``$NERRF_CHAOS_PLAN``; every firing is journaled as a ``fault_injected``
record joinable to its observed effect by trace ID.  Disarmed points are a
single global ``None`` check.
"""

from nerrf_tpu_torch.chaos.plan import (
    MODES,
    ChaosFault,
    FaultPlan,
    FaultSpec,
    corrupt_payload,
    hash01,
    load_plan,
)
from nerrf_tpu_torch.chaos.points import (
    PLAN_ENV,
    SITE_MODES,
    SITES,
    ChaosController,
    arm,
    arm_from_env,
    armed,
    check,
    controller,
    disarm,
    inject,
    mangle,
    validate_plan,
)

__all__ = [
    "MODES",
    "PLAN_ENV",
    "SITES",
    "SITE_MODES",
    "ChaosController",
    "ChaosFault",
    "FaultPlan",
    "FaultSpec",
    "arm",
    "arm_from_env",
    "armed",
    "check",
    "controller",
    "corrupt_payload",
    "disarm",
    "hash01",
    "inject",
    "load_plan",
    "mangle",
    "validate_plan",
]
