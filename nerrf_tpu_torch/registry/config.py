"""Model-lifecycle configuration: polling cadence and the promotion
guardrails.

A host copy of ``nerrf_tpu/registry/config.py``, kept identical.

Every knob here bounds what an *unattended* promotion may do: a candidate
checkpoint published into a lineage first runs in shadow (scored against
the same packed batches as the live model, results discarded except for
the comparison), and auto-promotes only when the disagreement and drift
guardrails pass.  See docs/model-lifecycle.md for the measured guidance.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RegistryConfig:
    """Knobs of the in-process `ModelManager` (shadow scoring + guarded
    promotion); the file layout itself is knob-free."""

    # how often the manager re-reads the registry for a new LIVE pointer or
    # a fresh candidate version (the CLI can also poke a poll explicitly)
    poll_sec: float = 10.0
    # windows both models must have scored before the guardrails judge —
    # verdicts off a handful of windows would promote/veto on noise
    shadow_min_windows: int = 64
    # fraction of real-node *decisions* (probability vs the operating
    # threshold) allowed to flip between live and shadow
    max_disagreement_rate: float = 0.02
    # mean |p_shadow − p_live| over real nodes (score-distribution drift;
    # decisions can agree while the distribution quietly walks away)
    max_score_drift: float = 0.05
    # trailing per-window canary: the last N windows must EACH stay under
    # canary_max_disagreement — a candidate that is fine on average but
    # diverges on the most recent traffic is not promotable
    canary_windows: int = 16
    canary_max_disagreement: float = 0.10
    # promote automatically when every guardrail passes; off = shadow
    # metrics only, promotion stays a human decision (`nerrf models
    # promote`)
    auto_promote: bool = True
    # node decision cut used for the disagreement guardrail; None = the
    # live model's operating threshold (falling back to 0.5)
    decision_threshold: Optional[float] = None
