"""Mergeable fixed-bin distribution sketches + population-stability math.

A host copy of ``nerrf_tpu/quality/sketch.py``, kept identical.

One primitive for every drift comparison in the repo: a histogram over a
FIXED bin ladder.  Fixed bins make the sketch

  * **mergeable by construction** — merging is elementwise count
    addition, associative and commutative, so per-window increments,
    per-stream trailing windows, per-host aggregates and the
    calibration-time reference all compose without coordination (the
    pod-scale serving item can sum sketches across hosts exactly);
  * **exactly subtractable** — a trailing window evicts a window by
    subtracting its increment, so "the last N windows" is O(bins) per
    eviction, never a re-scan;
  * **comparable** — PSI between two sketches over the same ladder is a
    closed-form sum, no re-binning.

Quantiles are bin-resolution approximations (right edge of the bin the
rank lands in) — good enough for dashboards and journal records; exact
values stay with the exact paths (calibration, guardrails means).

PSI (population stability index), the standard drift score:

    PSI = Σ_i (p_i − q_i) · ln(p_i / q_i)

with ε-floored bin proportions so an empty bin cannot blow it up.
Conventional reading: < 0.1 stable, 0.1–0.25 moderate shift, > 0.25
major shift (the default trigger threshold in flight.FlightConfig).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# Node-probability ladder: 20 uniform bins over [0, 1].
SCORE_EDGES = tuple(round(i * 0.05, 2) for i in range(1, 20))
# Count ladder (nodes/edges/files per window): powers of two — matches
# how the bucket ladder quantizes capacity, so a one-rung shift in the
# window population is a one-bin shift here.
COUNT_EDGES = tuple(float(1 << i) for i in range(13))  # 1 .. 4096
# Fraction ladder (event-type mix): 10 uniform bins over [0, 1].
FRACTION_EDGES = tuple(round(i * 0.1, 1) for i in range(1, 10))


@dataclasses.dataclass
class Sketch:
    """Counts over ``len(edges) + 1`` bins; bin i holds values in
    ``(edges[i-1], edges[i]]`` (first bin: ``<= edges[0]``, last bin:
    ``> edges[-1]``)."""

    edges: tuple
    counts: np.ndarray  # int64 [len(edges) + 1]

    @classmethod
    def empty(cls, edges: Sequence[float]) -> "Sketch":
        edges = tuple(float(e) for e in edges)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"sketch edges must be strictly ascending: "
                             f"{edges}")
        return cls(edges=edges, counts=np.zeros(len(edges) + 1, np.int64))

    # -- building -------------------------------------------------------------

    def bin_counts(self, values) -> np.ndarray:
        """The increment one batch of values contributes (does NOT mutate
        this sketch) — the unit a trailing window appends and later
        subtracts."""
        idx = np.searchsorted(np.asarray(self.edges),
                              np.asarray(values, np.float64), side="left")
        return np.bincount(idx, minlength=len(self.edges) + 1) \
            .astype(np.int64)

    def observe(self, values) -> np.ndarray:
        """Add a batch of values; returns the increment (for trailing
        callers that must subtract it later)."""
        inc = self.bin_counts(values)
        self.counts += inc
        return inc

    def add_counts(self, inc: np.ndarray) -> None:
        self.counts += np.asarray(inc, np.int64)

    def sub_counts(self, inc: np.ndarray) -> None:
        self.counts = np.maximum(self.counts - np.asarray(inc, np.int64), 0)

    def merge(self, other: "Sketch") -> "Sketch":
        """Elementwise count addition — associative and commutative, the
        property pod-scale aggregation and profile merging rely on.
        Refuses mismatched ladders (re-binning would fabricate data)."""
        if self.edges != other.edges:
            raise ValueError(
                f"cannot merge sketches over different bin ladders "
                f"({len(self.edges)} vs {len(other.edges)} edges)")
        return Sketch(edges=self.edges, counts=self.counts + other.counts)

    # -- reading --------------------------------------------------------------

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def proportions(self, alpha: float = 0.5) -> np.ndarray:
        """Laplace-smoothed bin proportions — the PSI operand.

        Add-α smoothing rather than an ε floor: with an ε floor, every
        reference bin a SMALL live sample happens to miss contributes
        ``p·ln(p/ε)`` (large), so trailing windows still filling up read
        as major drift — measured 0.75 PSI on identical distributions at
        30 windows.  α = 0.5 (Jeffreys) shrinks empty-bin contributions
        toward the sample's actual resolution instead."""
        total = float(self.counts.sum())
        return (self.counts + alpha) / (total + alpha * len(self.counts))

    def quantile(self, q: float) -> Optional[float]:
        """Bin-resolution quantile: the right edge of the bin the rank
        lands in (the last bin reports its left edge — it is unbounded).
        None when empty."""
        total = self.counts.sum()
        if total == 0:
            return None
        rank = q * total
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank, side="left"))
        i = min(i, len(self.counts) - 1)
        if i < len(self.edges):
            return float(self.edges[i])
        return float(self.edges[-1])

    def quantiles(self, qs=(0.5, 0.9, 0.99)) -> Dict[str, Optional[float]]:
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}

    # -- roundtrip ------------------------------------------------------------

    def to_dict(self) -> dict:
        return {"edges": list(self.edges),
                "counts": [int(c) for c in self.counts]}

    @classmethod
    def from_dict(cls, d: dict) -> "Sketch":
        edges = tuple(float(e) for e in d["edges"])
        counts = np.asarray(d["counts"], np.int64)
        if len(counts) != len(edges) + 1:
            raise ValueError(
                f"corrupt sketch: {len(counts)} counts for {len(edges)} "
                f"edges (want {len(edges) + 1})")
        return cls(edges=edges, counts=counts)


def psi(reference: Sketch, live: Sketch, alpha: float = 0.5) -> float:
    """Population stability index of ``live`` against ``reference``
    (same ladder).  Symmetric in spirit but conventionally reported
    live-vs-reference; Laplace-smoothed so empty bins stay finite AND
    small live samples are not biased toward "drift" (see
    `Sketch.proportions`)."""
    if reference.edges != live.edges:
        raise ValueError("PSI requires both sketches on the same bin ladder")
    p = reference.proportions(alpha)
    q = live.proportions(alpha)
    return float(np.sum((q - p) * np.log(q / p)))


def top_drifting(reference: Dict[str, Sketch], live: Dict[str, Sketch],
                 alpha: float = 0.5) -> List[tuple]:
    """``[(feature, psi), ...]`` sorted worst-first, over the features
    both sides carry — the `nerrf quality` table and the doctor's drift
    section."""
    out = []
    for name in sorted(set(reference) & set(live)):
        try:
            out.append((name, psi(reference[name], live[name], alpha)))
        except ValueError:
            continue  # ladder drift between schema versions: skip, not crash
    out.sort(key=lambda t: -t[1])
    return out
