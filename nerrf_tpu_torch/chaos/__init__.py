"""The chaos plane's fault plans: `FaultPlan`/`FaultSpec` (the JSON schema),
`hash01` (the keyed coin) and `corrupt_payload`.  The port of
``nerrf_tpu/chaos/plan.py``; the fault points themselves (``points.py``:
the site catalog, arm/disarm, the controller) and their wiring into serve,
ingest and training come with ROADMAP A.6."""

from nerrf_tpu_torch.chaos.plan import (
    MODES,
    ChaosFault,
    FaultPlan,
    FaultSpec,
    corrupt_payload,
    hash01,
    load_plan,
)

__all__ = [
    "MODES",
    "ChaosFault",
    "FaultPlan",
    "FaultSpec",
    "corrupt_payload",
    "hash01",
    "load_plan",
]
