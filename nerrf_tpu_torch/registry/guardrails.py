"""Promotion guardrails: shadow-vs-live comparison math and the verdict.

A host copy of ``nerrf_tpu/registry/guardrails.py``, kept identical.

A shadow candidate scores the SAME packed batches as the live model (same
windows, same padding, same program — only the param pytree differs), so
every comparison here is paired and exact: no sampling error between the
two sides, only the models' actual difference.

Two signals, because they fail differently:

  * **disagreement rate** — the fraction of real-node *decisions*
    (probability vs the operating threshold) that flip.  This is what a
    responder experiences: every flip is an alert appearing or vanishing.
  * **score drift** — mean |p_shadow − p_live| over real nodes.  Decisions
    can agree at the cut while the distribution quietly walks toward it;
    drift catches the regression before it becomes flips.

Plus a trailing per-window **canary**: the last N windows must each stay
under a (looser) disagreement cut, so a candidate that is fine on average
but diverging on the newest traffic cannot promote.

Both sides' score DISTRIBUTIONS are additionally sketched on the quality
plane's mergeable fixed-bin primitive (`nerrf_tpu_torch.quality.sketch` — the
same maths the serve-side drift monitor runs), so the cadenced
``registry_shadow_stats`` journal records carry score quantiles, not just
means: a candidate whose mean drift is tiny while its tail walks toward
the cut is visible in the record, and offline analysis can PSI the two
sketches without replaying a single batch.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Optional

import numpy as np

from nerrf_tpu_torch.quality.sketch import SCORE_EDGES, Sketch
from nerrf_tpu_torch.registry.config import RegistryConfig

# verdicts
WAIT = "wait"          # not enough evidence yet
PROMOTE = "promote"    # every guardrail passes
VETO = "veto"          # a guardrail failed decisively


@dataclasses.dataclass
class ShadowStats:
    """Paired live/shadow comparison accumulator (thread-safe: the scorer
    thread observes, the manager's poll thread judges)."""

    threshold: float = 0.5
    windows: int = 0
    nodes: int = 0
    disagreements: int = 0
    drift_sum: float = 0.0
    recent: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=64))
    # score-distribution sketches over the paired real-node scores (the
    # quality plane's mergeable primitive — one drift maths repo-wide)
    live_sketch: Sketch = dataclasses.field(
        default_factory=lambda: Sketch.empty(SCORE_EDGES))
    shadow_sketch: Sketch = dataclasses.field(
        default_factory=lambda: Sketch.empty(SCORE_EDGES))
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    def observe(self, live_probs: np.ndarray, shadow_probs: np.ndarray,
                node_mask: np.ndarray) -> None:
        """One window's paired scores (padded arrays + real-node mask)."""
        mask = np.asarray(node_mask).astype(bool)
        n = int(mask.sum())
        lp = np.asarray(live_probs)[mask]
        sp = np.asarray(shadow_probs)[mask]
        flips = int(((lp >= self.threshold) != (sp >= self.threshold)).sum())
        drift = float(np.abs(sp - lp).sum())
        with self._lock:
            self.windows += 1
            self.nodes += n
            self.disagreements += flips
            self.drift_sum += drift
            self.recent.append(flips / n if n else 0.0)
            self.live_sketch.observe(lp)
            self.shadow_sketch.observe(sp)

    @property
    def disagreement_rate(self) -> float:
        with self._lock:
            return self.disagreements / self.nodes if self.nodes else 0.0

    @property
    def score_drift(self) -> float:
        with self._lock:
            return self.drift_sum / self.nodes if self.nodes else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            nodes = self.nodes
            return {
                "windows": self.windows,
                "nodes": nodes,
                "disagreement_rate":
                    self.disagreements / nodes if nodes else 0.0,
                "score_drift": self.drift_sum / nodes if nodes else 0.0,
                "recent_window_rates": [round(r, 6) for r in self.recent],
                # bin-resolution quantiles of both score distributions —
                # a tail walking toward the cut shows here while the
                # mean drift still reads healthy
                "live_score_quantiles": self.live_sketch.quantiles(),
                "shadow_score_quantiles": self.shadow_sketch.quantiles(),
            }


def make_stats(cfg: RegistryConfig,
               threshold: Optional[float] = None) -> ShadowStats:
    s = ShadowStats(threshold=(cfg.decision_threshold
                               if cfg.decision_threshold is not None
                               else (threshold if threshold is not None
                                     else 0.5)))
    s.recent = deque(maxlen=max(cfg.canary_windows, 1))
    return s


def evaluate(stats: ShadowStats, cfg: RegistryConfig) -> tuple:
    """→ (verdict, reason).  PROMOTE only when: enough windows, aggregate
    disagreement and drift under their ceilings, and every canary window
    individually under the canary ceiling."""
    snap = stats.snapshot()
    if snap["windows"] < cfg.shadow_min_windows:
        return WAIT, (f"shadow has {snap['windows']}/"
                      f"{cfg.shadow_min_windows} windows")
    if snap["disagreement_rate"] > cfg.max_disagreement_rate:
        return VETO, (f"disagreement rate {snap['disagreement_rate']:.4f} "
                      f"exceeds {cfg.max_disagreement_rate}")
    if snap["score_drift"] > cfg.max_score_drift:
        return VETO, (f"score drift {snap['score_drift']:.4f} exceeds "
                      f"{cfg.max_score_drift}")
    recent = snap["recent_window_rates"]
    if len(recent) < min(cfg.canary_windows, cfg.shadow_min_windows):
        return WAIT, (f"canary has {len(recent)}/{cfg.canary_windows} "
                      f"windows")
    worst = max(recent) if recent else 0.0
    if worst > cfg.canary_max_disagreement:
        return VETO, (f"canary window disagreement {worst:.4f} exceeds "
                      f"{cfg.canary_max_disagreement}")
    return PROMOTE, (f"{snap['windows']} shadow windows, disagreement "
                     f"{snap['disagreement_rate']:.4f}, drift "
                     f"{snap['score_drift']:.4f}, canary worst {worst:.4f}")
