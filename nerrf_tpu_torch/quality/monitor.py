"""Serve-side quality monitor: live trailing sketches vs the reference.

A host copy of ``nerrf_tpu/quality/monitor.py``, kept identical.

`QualityMonitor` hangs off the scorer's demux boundary (the same seam as
the devtime accountant): every scored window contributes its real-node
probabilities, structural features and alert bit to trailing fixed-bin
sketches, compared continuously against the live version's reference
profile:

  * ``nerrf_quality_score_psi{stream}``      — PSI of the stream's
    trailing node-score distribution vs the reference sketch;
  * ``nerrf_quality_feature_psi{feature}``   — PSI of each trailing
    window-feature distribution (nodes/edges/files/event-type mix);
  * ``nerrf_quality_alert_rate_z{stream}``   — z-score of the stream's
    trailing alert rate against the reference alert rate;
  * ``nerrf_quality_calibration_margin_mass`` — trailing fraction of
    real-node scores within ``margin_eps`` of the calibrated cut (mass
    drifting INTO the margin is the operating point eroding before a
    single decision flips).

**Null-not-fake**: with no reference profile (the live version predates
profiles) `observe_window` is a no-op — no gauges exist, no journal
records are cut; a dashboard shows "no data", never a fabricated zero.
Per-stream gauges additionally stay absent until the stream clears the
``min_windows``/``min_scores`` evidence gates (PSI over a handful of
windows is noise, not drift).

Every ``journal_every`` windows the monitor cuts a ``quality_stats``
journal record (worst stream PSI, per-feature PSI, margin mass, window
count) — the flight recorder's ``quality_drift`` trigger consumes these,
and the continuous-learning retrain loop will consume the same records.

Cardinality is bounded exactly like the SLO tracker: at most
``max_streams`` live streams (LRU on observation), an evicted stream's
registry series retired via `MetricsRegistry.remove_series`.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque
from typing import Dict, Optional

import numpy as np

from nerrf_tpu_torch.quality.profile import QualityProfile, window_features
from nerrf_tpu_torch.quality.sketch import Sketch, psi

_HELP = {
    "quality_score_psi":
        "PSI of the stream's trailing node-score distribution vs the "
        "live version's reference profile (>0.25 = major shift)",
    "quality_feature_psi":
        "PSI of a trailing window-feature distribution vs the reference "
        "(nodes/edges/files/file_node_frac)",
    "quality_alert_rate_z":
        "z-score of the stream's trailing alert rate against the "
        "reference alert rate",
    "quality_calibration_margin_mass":
        "trailing fraction of real-node scores within margin_eps of the "
        "calibrated threshold (reference value in the quality profile)",
}


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """Evidence gates + cadences of the serve-side monitor."""

    # per-stream trailing window count (score sketches subtract evicted
    # windows' bin increments, so trailing is exact)
    trailing_windows: int = 256
    # global trailing window count for the feature sketches
    feature_trailing_windows: int = 512
    # a stream's PSI/z gauges stay ABSENT until it has this many trailing
    # windows and this many real-node scores (noise gate)
    min_windows: int = 32
    min_scores: int = 256
    # one quality_stats journal record per this many observed windows
    journal_every: int = 16
    # LRU stream cap — reconnect-session churn cannot grow memory/scrape
    max_streams: int = 256
    # Laplace smoothing for PSI bin proportions (sketch.proportions)
    psi_alpha: float = 0.5


class _StreamState:
    __slots__ = ("window", "score", "scores", "margin", "alerts", "count")

    def __init__(self, edges) -> None:
        # (score_inc, n_scores, margin_hits, alerted) per trailing window
        self.window: deque = deque()
        self.score = Sketch.empty(edges)
        self.scores = 0
        self.margin = 0
        self.alerts = 0
        self.count = 0  # all-time observed windows (gate + reporting)


class QualityMonitor:
    """Trailing live sketches + divergence export against one reference."""

    def __init__(self, cfg: Optional[QualityConfig] = None,
                 registry=None, journal=None) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        if journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            journal = DEFAULT_JOURNAL
        self.cfg = cfg or QualityConfig()
        self._reg = registry
        self._journal = journal
        self._lock = threading.Lock()
        self._ref: Optional[QualityProfile] = None
        self._version: Optional[int] = None
        # live state, all reset when the reference moves (a new version's
        # drift must be measured against ITS reference from zero)
        self._streams: Dict[str, _StreamState] = {}  # insertion order = LRU
        self._feat_window: deque = deque()           # {feature: inc} dicts
        self._features: Dict[str, Sketch] = {}
        self._observed = 0
        # reference generation: bumped by every set_reference, checked by
        # in-flight observers before they journal — a quality_stats record
        # computed against a retired reference must not be cut
        self._gen = 0

    # -- reference lifecycle --------------------------------------------------

    @property
    def reference(self) -> Optional[QualityProfile]:
        return self._ref

    def set_reference(self, profile: Optional[QualityProfile],
                      version: Optional[int] = None) -> None:
        """Bind (or clear) the reference the live traffic is compared to.
        Resets every trailing sketch — divergence is a property of (live
        version, its reference), not of the pod's uptime — and retires
        the previous state's gauges so a profile-less version exports
        NOTHING (null-not-fake, not stale)."""
        if profile is not None and not isinstance(profile, QualityProfile):
            profile = QualityProfile.from_dict(profile)
        with self._lock:
            stale = list(self._streams)
            stale_feats = list(self._features)
            had_state = bool(self._streams or self._features
                             or self._ref is not None)
            self._ref = profile
            self._version = version
            self._gen += 1
            self._streams = {}
            self._feat_window = deque()
            self._features = ({k: Sketch.empty(v.edges)
                               for k, v in profile.features.items()}
                              if profile is not None else {})
            self._observed = 0
            # retire UNDER the lock: observers export their gauges under
            # the same lock, so a concurrent demux thread can never
            # resurrect a just-retired series with a stale value (the
            # null-not-fake contract would otherwise freeze a dead PSI
            # on dashboards when the incoming version is profile-less)
            if had_state:
                for stream in stale:
                    self._retire_stream(stream)
                self._reg.remove_series("quality_calibration_margin_mass")
                for feat in stale_feats:
                    self._reg.remove_series("quality_feature_psi",
                                            {"feature": feat})
        # the journal stays OUTSIDE the lock: its listeners include the
        # flight recorder, whose bundle dump calls back into snapshot()
        self._journal.record(
            "quality_reference",
            version=(f"v{version}" if version is not None else None),
            profile=profile.summary() if profile is not None else None)

    def _retire_stream(self, stream: str) -> None:
        self._reg.remove_series("quality_score_psi", {"stream": stream})
        self._reg.remove_series("quality_alert_rate_z", {"stream": stream})

    # -- observation (scorer/demux thread) ------------------------------------

    def observe_window(self, stream: str, bucket: str, probs, node_mask,
                       node_type, nodes: int, edges: int, files: int,
                       alerted: bool) -> None:
        """One demuxed window.  ``stream`` is the BASE stream name (the
        caller strips reconnect-session suffixes); ``nodes``/``edges``/
        ``files`` are the admission-side measured counts the request
        carried through the batcher.  No-op without a reference — the hot
        path pays one None check, exactly the chaos plane's disarmed
        discipline."""
        with self._lock:
            ref = self._ref
            if ref is None:
                return
            cfg = self.cfg
            st = self._streams.pop(stream, None)
            if st is None:
                st = _StreamState(ref.score.edges)
            self._streams[stream] = st  # re-insert: newest last (LRU)
            evicted = None
            if len(self._streams) > cfg.max_streams:
                evicted = next(iter(self._streams))
                del self._streams[evicted]

            mask = np.asarray(node_mask).astype(bool)
            p = np.asarray(probs, np.float64)[mask]
            inc = st.score.observe(p)
            margin = int((np.abs(p - ref.threshold)
                          <= ref.margin_eps).sum())
            st.window.append((inc, int(p.size), margin, bool(alerted)))
            st.scores += int(p.size)
            st.margin += margin
            st.alerts += int(bool(alerted))
            st.count += 1
            if len(st.window) > cfg.trailing_windows:
                old_inc, old_n, old_m, old_a = st.window.popleft()
                st.score.sub_counts(old_inc)
                st.scores -= old_n
                st.margin -= old_m
                st.alerts -= int(old_a)

            feats = window_features(node_mask, node_type, nodes, edges,
                                    files)
            feat_inc = {}
            for name, sk in self._features.items():
                v = feats.get(name)
                if v is None:
                    continue
                feat_inc[name] = sk.observe([v])
            self._feat_window.append(feat_inc)
            if len(self._feat_window) > cfg.feature_trailing_windows:
                for name, old in self._feat_window.popleft().items():
                    if name in self._features:
                        self._features[name].sub_counts(old)

            self._observed += 1
            out, record = self._compute_locked(stream, st)
            gen = self._gen
            if evicted is not None:
                self._retire_stream(evicted)
            # gauges UNDER the lock (registry calls never re-enter the
            # monitor): set_reference retires series under this same
            # lock, so a reference move can never interleave retirement
            # with a stale re-export.  Literal-name calls — the
            # metrics-contract lint resolves names at the call site
            if out["score_psi"] is not None:
                self._reg.gauge_set(
                    "quality_score_psi", out["score_psi"],
                    labels={"stream": stream},
                    help=_HELP["quality_score_psi"])
            if out["alert_z"] is not None:
                self._reg.gauge_set(
                    "quality_alert_rate_z", out["alert_z"],
                    labels={"stream": stream},
                    help=_HELP["quality_alert_rate_z"])
            if out["margin_mass"] is not None:
                self._reg.gauge_set(
                    "quality_calibration_margin_mass", out["margin_mass"],
                    help=_HELP["quality_calibration_margin_mass"])
            for feat, v in out["feature_psi"].items():
                self._reg.gauge_set(
                    "quality_feature_psi", v, labels={"feature": feat},
                    help=_HELP["quality_feature_psi"])
        if record is not None:
            # the journal OUTSIDE the lock (its listeners include the
            # flight recorder, whose dump calls back into snapshot());
            # generation-checked so a record computed against a retired
            # reference is dropped, not fired as a stale drift signal
            with self._lock:
                stale = self._gen != gen
            if not stale:
                self._journal.record("quality_stats", **record)

    def _compute_locked(self, stream: str, st: _StreamState):
        """Gauge values + the cadenced journal record (computed under
        the lock, emitted outside it)."""
        cfg, ref = self.cfg, self._ref
        score_psi = (psi(ref.score, st.score, cfg.psi_alpha)
                     if self._stream_ready(st) else None)
        alert_z = self._alert_z(st) if self._stream_ready(st) else None
        # margin mass + feature PSI are population-level: gate on the
        # global trailing evidence
        tot_scores = sum(s.scores for s in self._streams.values())
        tot_margin = sum(s.margin for s in self._streams.values())
        margin_mass = (tot_margin / tot_scores
                       if tot_scores >= cfg.min_scores else None)
        feature_psi = {}
        if len(self._feat_window) >= cfg.min_windows:
            for name, sk in self._features.items():
                if name in ref.features:
                    feature_psi[name] = psi(ref.features[name], sk,
                                            cfg.psi_alpha)

        record = None
        if self._observed % cfg.journal_every == 0:
            stream_psi = {
                s: round(psi(ref.score, ss.score, cfg.psi_alpha), 4)
                for s, ss in self._streams.items()
                if self._stream_ready(ss)}
            worst_stream, worst_score = (None, None)
            if stream_psi:
                worst_stream = max(stream_psi, key=stream_psi.get)
                worst_score = stream_psi[worst_stream]
            worst_feature = (max(feature_psi.values())
                             if feature_psi else None)
            record = {
                "version": (f"v{self._version}"
                            if self._version is not None else None),
                "windows": self._observed,
                "streams": len(self._streams),
                "worst_score_psi": worst_score,
                "worst_stream": worst_stream,
                "stream_psi": stream_psi,
                "feature_psi": {k: round(v, 4)
                                for k, v in sorted(feature_psi.items())},
                "worst_feature_psi": (round(worst_feature, 4)
                                     if worst_feature is not None else None),
                "margin_mass": (round(tot_margin / tot_scores, 4)
                                if tot_scores else None),
                "ref_margin_mass": round(ref.margin_mass, 4),
            }
        return {"score_psi": score_psi, "alert_z": alert_z,
                "margin_mass": margin_mass,
                "feature_psi": feature_psi}, record

    def _stream_ready(self, st: _StreamState) -> bool:
        return (len(st.window) >= self.cfg.min_windows
                and st.scores >= self.cfg.min_scores)

    def _alert_z(self, st: _StreamState) -> Optional[float]:
        """Trailing alert rate vs the reference rate, as a z-score.  The
        reference proportion is clamped away from 0/1 by its own sample
        size (a rate estimated from W windows cannot be known better than
        1/(W+2)) so a zero-alert reference stays finite."""
        ref = self._ref
        n = len(st.window)
        if n == 0 or ref.windows == 0:
            return None
        floor = 1.0 / (ref.windows + 2)
        p0 = min(max(ref.alert_rate, floor), 1.0 - floor)
        live = st.alerts / n
        return (live - p0) / math.sqrt(p0 * (1.0 - p0) / n)

    # -- reading --------------------------------------------------------------

    def snapshot(self) -> Optional[dict]:
        """The bundle-embeddable state: the FULL reference profile plus
        every live trailing sketch and its divergence — `nerrf doctor`
        and `nerrf quality show` reconstruct the drift table from this
        alone.  None without a reference (null-not-fake)."""
        with self._lock:
            ref = self._ref
            if ref is None:
                return None
            cfg = self.cfg
            per_stream = {}
            for s, st in self._streams.items():
                per_stream[s] = {
                    "windows": len(st.window),
                    "observed": st.count,
                    "scores": st.scores,
                    "alert_rate": (round(st.alerts / len(st.window), 4)
                                   if st.window else None),
                    "alert_rate_z": (round(self._alert_z(st), 3)
                                     if self._alert_z(st) is not None
                                     else None),
                    "score_psi": (round(psi(ref.score, st.score,
                                            cfg.psi_alpha), 4)
                                  if self._stream_ready(st) else None),
                    "score_quantiles": st.score.quantiles(),
                    "score_sketch": st.score.to_dict(),
                }
            tot_scores = sum(s.scores for s in self._streams.values())
            tot_margin = sum(s.margin for s in self._streams.values())
            features = {}
            for name, sk in self._features.items():
                features[name] = {
                    "psi": (round(psi(ref.features[name], sk, cfg.psi_alpha),
                                  4)
                            if (name in ref.features
                                and len(self._feat_window)
                                >= cfg.min_windows) else None),
                    "sketch": sk.to_dict(),
                }
            return {
                "version": (f"v{self._version}"
                            if self._version is not None else None),
                "windows_observed": self._observed,
                "margin_mass": (round(tot_margin / tot_scores, 4)
                                if tot_scores else None),
                "per_stream": per_stream,
                "features": features,
                "reference": ref.to_dict(),
            }
