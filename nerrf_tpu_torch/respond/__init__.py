"""Online incident-response tier: live detections → batched MCTS planning
→ sandbox-verified undo plans.  The port of ``nerrf_tpu/respond/``.

The serve plane detects; this package answers.  Alerts crossing the
demux's calibrated-severity gate become incidents in a bounded queue, a
micro-batcher packs them into padded root-state buckets for one
``mcts_search`` launch a chunk per wave (every (bucket, slot) wave warmed
at start), and every emitted plan is replayed through the rollback sandbox
gate before anything is surfaced.  Unverifiable plans are quarantined with
a journaled reason, never surfaced.  The reference's
``respond_program_key`` (the compile-cache key of a search program) comes
with the port's compile cache, ROADMAP A.7.
"""

from nerrf_tpu_torch.respond.config import RespondConfig
from nerrf_tpu_torch.respond.incidents import Incident, IncidentQueue
from nerrf_tpu_torch.respond.planner import BatchedDeviceMCTS
from nerrf_tpu_torch.respond.router import ResponseRouter
from nerrf_tpu_torch.respond.scenarios import (FAMILIES, ScheduledIncident,
                                               StagedIncident, schedule,
                                               sim_config, stage_incident)
from nerrf_tpu_torch.respond.verify import (PlanVerifier, VerifiedPlan,
                                            VerifyContext)

__all__ = [
    "RespondConfig",
    "Incident",
    "IncidentQueue",
    "BatchedDeviceMCTS",
    "ResponseRouter",
    "FAMILIES",
    "ScheduledIncident",
    "StagedIncident",
    "schedule",
    "sim_config",
    "stage_incident",
    "PlanVerifier",
    "VerifiedPlan",
    "VerifyContext",
]
