"""The online incident-response tier's planner: batched MCTS over incident
roots.  The port of ``nerrf_tpu/respond/``'s `BatchedDeviceMCTS`; the
router, incident queue, plan verifier, scenario corpus and config are not
carried yet."""

from nerrf_tpu_torch.respond.planner import BatchedDeviceMCTS

__all__ = ["BatchedDeviceMCTS"]
