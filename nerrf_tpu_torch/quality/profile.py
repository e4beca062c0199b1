"""Reference quality profile: the distribution a published model expects.

The port of ``nerrf_tpu/quality/profile.py``: the numpy parts kept
identical, and `build_reference_profile` scoring a `NerrfNet` through
the port's `pipeline.make_eval_fn` where the reference applies a Flax
param tree.

Computed at calibration time over a held-out corpus scored through the
REAL eval path (same per-window lowering, same padded batching, same
sigmoid as `pipeline.model_detect` and the serve scorer — a profile built
through any other path would measure the path, not the model), and
stamped into the checkpoint as a ``quality_profile.json`` sidecar so the
registry publishes it with the weights.  Contents (all schema-versioned):

  * ``score``      — node-probability sketch over every real node;
  * ``features``   — per-window structural sketches: ``nodes`` / ``edges``
    / ``files`` (measured counts, the admission-side measure) and
    ``file_node_frac`` (event-type mix: file nodes over real nodes);
  * ``margin_mass`` — fraction of real-node scores within ``margin_eps``
    of the calibrated threshold: the calibration-health baseline (mass
    drifting INTO the margin means the operating point is eroding before
    a single decision flips);
  * ``alert_rate`` — fraction of windows with any node past the cut (the
    alert-rate z-score's reference numerator).

Profiles over the same ladders MERGE (count addition — associative), so
shard-built profiles and multi-host aggregates compose exactly.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from nerrf_tpu_torch.quality.sketch import (
    COUNT_EDGES,
    FRACTION_EDGES,
    SCORE_EDGES,
    Sketch,
)

PROFILE_SCHEMA = 1
PROFILE_FILENAME = "quality_profile.json"

# the per-window structural features and their ladders — the ONE place
# the feature set is defined (builder, monitor and docs all key off it)
FEATURE_EDGES = {
    "nodes": COUNT_EDGES,
    "edges": COUNT_EDGES,
    "files": COUNT_EDGES,
    "file_node_frac": FRACTION_EDGES,
}


def window_features(node_mask, node_type, nodes: int, edges: int,
                    files: int) -> Dict[str, float]:
    """One window's feature values.  ``nodes``/``edges``/``files`` are the
    admission-side MEASURED counts (pre-truncation — what the window
    actually contained); the mix fraction comes from the lowered arrays."""
    from nerrf_tpu_torch.graph.builder import NODE_TYPE_FILE

    mask = np.asarray(node_mask).astype(bool)
    real = int(mask.sum())
    file_frac = (float((np.asarray(node_type)[mask]
                        == NODE_TYPE_FILE).mean()) if real else 0.0)
    return {"nodes": float(nodes), "edges": float(edges),
            "files": float(files), "file_node_frac": file_frac}


@dataclasses.dataclass
class QualityProfile:
    """The reference distribution a version was calibrated against."""

    schema: int
    threshold: float
    margin_eps: float
    windows: int
    node_scores: int
    margin_hits: int        # real-node scores with |p - threshold| <= eps
    alert_windows: int      # windows with any real node >= threshold
    score: Sketch
    features: Dict[str, Sketch]

    @property
    def margin_mass(self) -> float:
        return self.margin_hits / self.node_scores if self.node_scores else 0.0

    @property
    def alert_rate(self) -> float:
        return self.alert_windows / self.windows if self.windows else 0.0

    def to_dict(self) -> dict:
        return {
            "schema": self.schema,
            "threshold": self.threshold,
            "margin_eps": self.margin_eps,
            "windows": self.windows,
            "node_scores": self.node_scores,
            "margin_hits": self.margin_hits,
            "alert_windows": self.alert_windows,
            "margin_mass": round(self.margin_mass, 6),
            "alert_rate": round(self.alert_rate, 6),
            "score": self.score.to_dict(),
            "features": {k: v.to_dict()
                         for k, v in sorted(self.features.items())},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "QualityProfile":
        schema = int(d.get("schema", 0))
        if schema > PROFILE_SCHEMA:
            raise ValueError(
                f"quality profile carries schema v{schema}, this code "
                f"reads v{PROFILE_SCHEMA} — written by a newer version")
        return cls(
            schema=schema,
            threshold=float(d["threshold"]),
            margin_eps=float(d["margin_eps"]),
            windows=int(d["windows"]),
            node_scores=int(d["node_scores"]),
            margin_hits=int(d["margin_hits"]),
            alert_windows=int(d["alert_windows"]),
            score=Sketch.from_dict(d["score"]),
            features={k: Sketch.from_dict(v)
                      for k, v in (d.get("features") or {}).items()},
        )

    def summary(self) -> dict:
        """The compact face (journal records, CLI tables, manifests)."""
        return {
            "schema": self.schema,
            "threshold": self.threshold,
            "windows": self.windows,
            "node_scores": self.node_scores,
            "score_quantiles": self.score.quantiles(),
            "margin_eps": self.margin_eps,
            "margin_mass": round(self.margin_mass, 4),
            "alert_rate": round(self.alert_rate, 4),
            "features": sorted(self.features),
        }


def merge_profiles(a: QualityProfile, b: QualityProfile) -> QualityProfile:
    """Count addition over every sketch and tally — associative and
    commutative, so shard-built profiles compose in any order.  Refuses
    mismatched operating points (merging distributions calibrated at
    different cuts would average two different questions)."""
    if (a.threshold, a.margin_eps) != (b.threshold, b.margin_eps):
        raise ValueError(
            f"cannot merge profiles at different operating points "
            f"(threshold/eps {a.threshold}/{a.margin_eps} vs "
            f"{b.threshold}/{b.margin_eps})")
    if set(a.features) != set(b.features):
        raise ValueError(
            f"cannot merge profiles with different feature sets "
            f"({sorted(a.features)} vs {sorted(b.features)})")
    return QualityProfile(
        schema=max(a.schema, b.schema),
        threshold=a.threshold, margin_eps=a.margin_eps,
        windows=a.windows + b.windows,
        node_scores=a.node_scores + b.node_scores,
        margin_hits=a.margin_hits + b.margin_hits,
        alert_windows=a.alert_windows + b.alert_windows,
        score=a.score.merge(b.score),
        features={k: a.features[k].merge(b.features[k])
                  for k in a.features},
    )


class ProfileBuilder:
    """Accumulates scored windows into a QualityProfile.  Pure host-side
    numpy — usable from the calibration path, a bench, or a test."""

    def __init__(self, threshold: float, margin_eps: float = 0.05) -> None:
        self.threshold = float(threshold)
        self.margin_eps = float(margin_eps)
        self._score = Sketch.empty(SCORE_EDGES)
        self._features = {k: Sketch.empty(e)
                          for k, e in FEATURE_EDGES.items()}
        self._windows = 0
        self._scores = 0
        self._margin = 0
        self._alerts = 0

    def observe_window(self, probs, node_mask, node_type,
                       nodes: int, edges: int, files: int) -> None:
        mask = np.asarray(node_mask).astype(bool)
        p = np.asarray(probs, np.float64)[mask]
        self._score.observe(p)
        feats = window_features(node_mask, node_type, nodes, edges, files)
        for k, v in feats.items():
            self._features[k].observe([v])
        self._windows += 1
        self._scores += int(p.size)
        self._margin += int((np.abs(p - self.threshold)
                             <= self.margin_eps).sum())
        self._alerts += int(bool(p.size and (p >= self.threshold).any()))

    def finish(self) -> QualityProfile:
        return QualityProfile(
            schema=PROFILE_SCHEMA,
            threshold=self.threshold, margin_eps=self.margin_eps,
            windows=self._windows, node_scores=self._scores,
            margin_hits=self._margin, alert_windows=self._alerts,
            score=self._score, features=dict(self._features))


def build_reference_profile(model, traces: List,
                            ds_cfg=None, threshold: Optional[float] = None,
                            margin_eps: float = 0.05, batch_size: int = 8,
                            log=None) -> QualityProfile:
    """Score ``traces`` through the real eval path and sketch the result.

    Mirrors the serve admission pipeline exactly: `snapshot_windows` →
    `measure_window` (the feature counts) → the shared
    `train.data.window_sample` lowering → `pipeline.pad_batch` → the
    eval function of ``model`` (a `NerrfNet`, on the device its params lie
    on) → host sigmoid.  What the profile describes is therefore the
    distribution the serve monitor will actually observe."""
    from nerrf_tpu_torch.data.loaders import Trace
    from nerrf_tpu_torch.graph.builder import measure_window, snapshot_windows
    from nerrf_tpu_torch.pipeline import make_eval_fn, pad_batch
    from nerrf_tpu_torch.train.data import DatasetConfig, window_sample

    ds_cfg = ds_cfg or DatasetConfig()
    thr = threshold if threshold is not None else 0.5
    builder = ProfileBuilder(thr, margin_eps=margin_eps)
    eval_fn = make_eval_fn(model)
    pending: list = []  # (sample, nodes, edges, files)

    def flush() -> None:
        if not pending:
            return
        batch = pad_batch([p[0] for p in pending], batch_size)
        out = eval_fn(batch)
        probs = 1.0 / (1.0 + np.exp(-out["node_logit"]))
        for j, (s, n, e, f) in enumerate(pending):
            builder.observe_window(probs[j], s["node_mask"], s["node_type"],
                                   nodes=n, edges=e, files=f)
        pending.clear()

    for trace in traces:
        ev = trace.events
        if ev.num_valid == 0:
            continue
        unlabelled = Trace(events=ev, strings=trace.strings,
                           ground_truth=None, labels=None, name=trace.name)
        valid_ts = ev.ts_ns[ev.valid]
        for lo, hi in snapshot_windows(int(valid_ts.min()),
                                       int(valid_ts.max()), ds_cfg.graph):
            n, e = measure_window(ev, lo, hi)
            sel = ev.valid & (ev.ts_ns >= lo) & (ev.ts_ns < hi)
            files = len(np.unique(ev.inode[sel & (ev.inode > 0)]))
            sample, _stats = window_sample(unlabelled, lo, hi, ds_cfg)
            if sample is None:
                continue
            pending.append((sample, int(n), int(e), int(files)))
            if len(pending) >= batch_size:
                flush()
    flush()
    profile = builder.finish()
    if log:
        log(f"quality profile: {profile.windows} windows, "
            f"{profile.node_scores} node scores, margin mass "
            f"{profile.margin_mass:.4f}, alert rate {profile.alert_rate:.4f}")
    return profile


def load_profile(path) -> Optional[QualityProfile]:
    """Read a profile from a checkpoint dir (its ``quality_profile.json``
    sidecar) or a bare profile JSON file.  None when the checkpoint
    predates profiles (the null-not-fake contract starts here); corrupt
    JSON raises the one-line error the sidecar loaders use."""
    p = Path(path)
    if p.is_dir():
        p = p / PROFILE_FILENAME
        if not p.is_file():
            return None
    elif not p.is_file():
        return None
    try:
        return QualityProfile.from_dict(json.loads(p.read_text()))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(
            f"corrupt quality profile {p}: not valid JSON ({e})") from None
    except (KeyError, TypeError) as e:
        raise ValueError(
            f"corrupt quality profile {p}: missing or malformed field "
            f"({e!r})") from None
