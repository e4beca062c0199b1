"""Model lifecycle registry: versioned checkpoints, zero-downtime
hot-swap, shadow scoring, and guarded promotion.  See
docs/model-lifecycle.md for the publish → shadow → promote → rollback
walkthrough."""

from nerrf_tpu_torch.registry.config import RegistryConfig
from nerrf_tpu_torch.registry.guardrails import (
    PROMOTE,
    VETO,
    WAIT,
    ShadowStats,
    evaluate,
    make_stats,
)
from nerrf_tpu_torch.registry.manager import ModelManager
from nerrf_tpu_torch.registry.store import ModelRegistry, validate_checkpoint_dir

__all__ = [
    "PROMOTE",
    "VETO",
    "WAIT",
    "ModelManager",
    "ModelRegistry",
    "RegistryConfig",
    "ShadowStats",
    "evaluate",
    "make_stats",
    "validate_checkpoint_dir",
]
