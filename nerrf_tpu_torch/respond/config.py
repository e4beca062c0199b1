"""Respond tier configuration.

The port of ``nerrf_tpu/respond/config.py``, the same dataclass.
One frozen dataclass, mirroring the serve plane's config discipline: every
knob that shapes a compiled program (simulation budget, shape clamps,
batch-slot ladder) lives here so the warmup pass and the live path cannot
disagree about which (bucket, slot) waves were warmed.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from nerrf_tpu_torch.planner.mcts import MCTSConfig


@dataclasses.dataclass(frozen=True)
class RespondConfig:
    """Knobs for the online incident-response tier (docs/response.md)."""

    # Admission: a WindowAlert below this calibrated severity
    # (alerts.calibrated_severity — the demux boundary's number, not a
    # re-derived one) never becomes an incident.
    severity_min: float = 0.5
    # Bounded incident queue; overflow evicts the OLDEST incident
    # (newest-evidence-wins, the admission/sink drop policy) and journals
    # the eviction.
    queue_slots: int = 64
    # Batch-slot ladder for the vmapped planner: incidents are packed into
    # the smallest slot ≥ the waiting count, so exactly len(batch_slots)
    # search executables exist per shape bucket — all warmed at start.
    batch_slots: Tuple[int, ...] = (1, 2, 4, 8)
    # How long the micro-batcher holds an incomplete batch open waiting
    # for co-riders before planning what it has.
    batch_close_sec: float = 0.05
    # Planner budget per batch (MCTSConfig.num_simulations /
    # timeout_seconds). Smaller than the offline default: the online tier
    # trades plan polish for MTTR, and the offline planner remains the
    # deep-audit path.
    num_simulations: int = 96
    timeout_seconds: float = 30.0
    # Shape clamps fed to build_undo_domain: keep every incident inside
    # ONE (file, proc) compile bucket so the zero-recompile contract is a
    # property of admission, not of traffic.
    max_files: int = 128
    max_procs: int = 16
    # Verification: replay every emitted plan through the sandbox gate
    # before surfacing. Disabling this surfaces UNVERIFIED plans and
    # exists only for throughput benchmarking.
    verify: bool = True

    def mcts_config(self) -> MCTSConfig:
        return MCTSConfig(num_simulations=self.num_simulations,
                          timeout_seconds=self.timeout_seconds)

    def fingerprint(self) -> dict:
        """The knobs a compiled search program depends on — CompileCache
        ``extra`` material (respond_program_key)."""
        return {
            "sims": self.num_simulations,
            "max_files": self.max_files,
            "max_procs": self.max_procs,
            "slots": list(self.batch_slots),
        }
