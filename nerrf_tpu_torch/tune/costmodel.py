"""Fit a per-bucket latency + padding cost model over the tune corpus.

The question the search needs answered is "what does one window cost on
rung ``(n, e, s)`` under aggregation ``mode``?".  Three evidence tiers
feed the answer, strongest first:

1. **Measured** — `export_tune`'s per-bucket cost table (device seconds
   per batch straight from archived serve telemetry).  A bucket with
   enough batches is taken at face value for the mode that actually
   served it.
2. **Fitted** — a two-parameter closed-form surface (``alpha`` scales
   the analytic work term, ``beta`` prices per-layer kernel launches)
   least-squares fitted to the measured points, used to extrapolate to
   rungs and modes the corpus never ran.  The work term mirrors the
   model's real compute: dense per-layer matmuls shared by every mode,
   O(N²·H) adjacency work for ``dense_adj`` vs O(E·H) for the edge
   kernels, an LSTM term linear in ``max_seqs`` so oversized sequence
   capacity costs what it costs.
3. **Priors** — the devtime analytic FLOP surface
   (`devtime.costmodel.serve_program_costs`) anchors buckets with thin
   or missing measurements when available, and a kernel microbenchmark
   artifact, when one is given, calibrates the dense-vs-fused crossover so
   the routing choice cites a measured number, not a guess.

The port's copy of ``nerrf_tpu/tune/costmodel.py``, with one deliberate
difference: the port has no ``DENSE_ADJ_MAX_NODES`` (its ``auto`` serves
every bucket ``fused``), so the crossover the fit assumes when no kernel
bench is given is `DENSE_FUSED_PRIOR_NODES`, the reference's authored
constant, measured on the CPU and the TPU and not on the card; the
artifact's provenance says so.

An empty corpus is a refusal, not a garbage fit: `fit_cost_model` raises
`TuneError` (one line, operator-facing) when there is nothing to fit.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

from nerrf_tpu_torch.tune.artifact import TuneError

Bucket = Tuple[int, int, int]

_TAG = re.compile(r"^(\d+)n/(\d+)e/(\d+)s$")

# Sequential kernel launches per GNN layer by aggregation mode, the
# reference's weights — the segment path is ~6 small kernels/layer (gathers
# + banded segment means), the dense/fused paths collapse each layer's
# aggregate to ONE kernel (a fixed cost a launch is exactly what `beta`
# fits).  The fit reads the same table as the reference so a corpus gives
# both packages the same surface.
LAUNCHES_PER_LAYER = {"segment": 6.0, "dense_adj": 1.0, "fused": 1.0}

# The dense_adj↔fused crossover (nodes) the fit assumes when no kernel bench
# is given: the reference's ``DENSE_ADJ_MAX_NODES``, measured on the CPU and
# the TPU.  No measurement of the card's crossover exists yet (ROADMAP B.R1).
DENSE_FUSED_PRIOR_NODES = 1024

# Below this many archived batches a bucket's mean is noise, not signal —
# it informs the fit but does not override the fitted surface.
MIN_MEASURED_BATCHES = 2


def parse_tag(tag: str) -> Bucket:
    m = _TAG.match(tag)
    if not m:
        raise TuneError(f"unparseable bucket tag {tag!r} in corpus")
    return tuple(int(g) for g in m.groups())  # type: ignore[return-value]


def load_kernel_bench_crossover(path) -> Optional[dict]:
    """The measured dense_adj↔fused crossover from the kernel-bench
    artifact: ``{"nodes": N, "source": path, "degraded": bool}`` or None
    when the artifact is absent/unreadable/crossover-less (a prior can be
    missing; the fit then falls back to the authored constant)."""
    try:
        report = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None
    xover = (report.get("routing") or {}).get("measured_crossover_nodes")
    if not xover:
        return None
    return {"nodes": float(xover), "source": str(path),
            "degraded": bool(report.get("degraded"))}


class LadderCostModel:
    """Expected device seconds for one window on a rung, per mode.

    ``cost(bucket, mode)`` is what the ladder search minimizes; it is a
    pure function of the fitted parameters and the measured table, so a
    fit over the same corpus is bit-deterministic — no wall clock, no
    RNG.
    """

    def __init__(self, hidden: int, num_layers: int,
                 alpha: float, beta: float, dense_gamma: float,
                 measured: Dict[Tuple[Bucket, str], float],
                 analytic: Optional[
                     Dict[Tuple[int, int], Tuple[float, int]]] = None,
                 analytic_alpha: Optional[float] = None,
                 provenance: Optional[dict] = None):
        self.hidden = hidden
        self.num_layers = num_layers
        self.alpha = alpha
        self.beta = beta
        self.dense_gamma = dense_gamma
        self.measured = dict(measured)
        self.analytic = dict(analytic or {})
        self.analytic_alpha = analytic_alpha
        self.provenance = provenance or {}

    # -- the closed-form work surface (FLOPs per window) ----------------

    def work(self, bucket: Bucket, mode: str) -> float:
        n, e, s = bucket
        h, layers = float(self.hidden), float(self.num_layers)
        # per-layer dense matmuls every mode runs (w_msg + w_self on 2h)
        shared = 6.0 * n * h * h * layers
        if mode == "dense_adj":
            agg = self.dense_gamma * 2.0 * n * n * h * layers
        else:  # fused and segment both do O(E) aggregation work
            agg = 8.0 * e * h * layers
        # LSTM head: gates over max_seqs sequences — linear in s, so the
        # search pays for sequence capacity it doesn't need
        lstm = 8.0 * s * 100.0 * h * h
        return shared + agg + lstm

    def launches(self, mode: str) -> float:
        return LAUNCHES_PER_LAYER[mode] * self.num_layers

    def auto_mode(self, bucket: Bucket) -> str:
        """The mode the untuned auto rule serves this bucket with — what
        the analytic surface was traced at."""
        from nerrf_tpu_torch.models.graphsage import GraphSAGEConfig
        return GraphSAGEConfig(hidden=self.hidden,
                               num_layers=self.num_layers
                               ).resolved_aggregation(bucket[0])

    # -- the fitted/measured/prior cost ---------------------------------

    def cost(self, bucket: Bucket, mode: str) -> float:
        """Expected device seconds for ONE window padded to ``bucket``
        and aggregated via ``mode``."""
        y = self.measured.get((tuple(bucket), mode))
        if y is not None:
            return y
        fitted = (self.alpha * self.work(bucket, mode)
                  + self.beta * self.launches(mode))
        if self.analytic_alpha is not None:
            anchor = self.analytic.get((bucket[0], bucket[1]))
            if anchor is not None:
                # thin-measurement rung with an analytic anchor: the
                # devtime FLOP surface (traced at this graph rung's auto
                # mode and ladder seq) sets the level, the fitted surface
                # contributes only the delta to THIS bucket/mode so
                # routing and seq sizing still discriminate
                flops, s_traced = anchor
                traced = (bucket[0], bucket[1], s_traced)
                base_mode = self.auto_mode(bucket)
                return (self.analytic_alpha * flops
                        + self.beta * self.launches(mode)
                        + self.alpha * (self.work(bucket, mode)
                                        - self.work(traced, base_mode)))
        return fitted

    def source(self, bucket: Bucket, mode: str) -> str:
        if (tuple(bucket), mode) in self.measured:
            return "measured"
        if (self.analytic_alpha is not None
                and (bucket[0], bucket[1]) in self.analytic):
            return "analytic_prior"
        return "measured_fit"

    def to_dict(self) -> dict:
        return {
            "hidden": self.hidden, "num_layers": self.num_layers,
            "alpha": self.alpha, "beta": self.beta,
            "dense_gamma": self.dense_gamma,
            "analytic_alpha": self.analytic_alpha,
            "measured_points": len(self.measured),
            "analytic_points": len(self.analytic),
            "provenance": self.provenance,
        }


def _measured_points(corpus: dict, model_cfg,
                     min_batches: int) -> Dict[Tuple[Bucket, str], float]:
    """``(bucket, served_mode) → device seconds per window`` for every
    corpus bucket with enough batches to trust.  The served mode is
    re-derived from the model config's own auto rule at that bucket —
    the single definition the forward used when the telemetry was
    recorded."""
    table = corpus.get("bucket_cost") or {}
    points: Dict[Tuple[Bucket, str], float] = {}
    for tag, row in table.items():
        bucket = parse_tag(tag)
        batches = int(row.get("batches") or 0)
        windows = int(row.get("windows") or 0)
        mean = row.get("device_seconds_mean")
        if batches < min_batches or not windows or mean is None:
            continue
        per_window = float(mean) * batches / windows
        mode = model_cfg.resolved_aggregation(bucket[0])
        points[(bucket, mode)] = per_window
    return points


def _lstsq2(rows, ys) -> Tuple[float, float]:
    """Nonnegative-clamped least squares for ``y = a·w + b·k`` — two
    normal-equation unknowns, solved closed-form (no numpy dependence in
    the fit keeps it bit-deterministic across BLAS builds)."""
    sww = sum(w * w for w, _ in rows)
    skk = sum(k * k for _, k in rows)
    swk = sum(w * k for w, k in rows)
    swy = sum(w * y for (w, _), y in zip(rows, ys))
    sky = sum(k * y for (_, k), y in zip(rows, ys))
    det = sww * skk - swk * swk
    if det > 1e-12 * max(sww * skk, 1e-30):
        a = (swy * skk - sky * swk) / det
        b = (sky * sww - swy * swk) / det
    else:  # degenerate (one point, or collinear): work-only fit
        a = swy / sww if sww > 0 else 0.0
        b = 0.0
    if b < 0:
        # a clamped coefficient means the OTHER one must be re-solved
        # alone, or the surface over-predicts every unmeasured bucket
        b = 0.0
        a = swy / sww if sww > 0 else 0.0
    if a <= 0:  # pathological corpus: fall back to pure launch pricing
        a = 0.0
        b = max(sky / skk if skk > 0 else 0.0, 0.0)
    return a, max(b, 0.0)


def fit_cost_model(corpus: dict, model_cfg=None,
                   analytic: Optional[Dict[str, float]] = None,
                   kernel_bench: Optional[dict] = None,
                   min_batches: int = MIN_MEASURED_BATCHES
                   ) -> LadderCostModel:
    """Fit the ladder cost model over a tune corpus.

    ``analytic`` is an optional ``bucket tag → flops`` surface from
    `devtime.costmodel.serve_program_costs`; ``kernel_bench`` the dict
    `load_kernel_bench_crossover` returns.  Raises `TuneError` when the
    corpus carries nothing fittable (satellite: polite refusal)."""
    if model_cfg is None:
        from nerrf_tpu_torch.models.graphsage import GraphSAGEConfig
        model_cfg = GraphSAGEConfig()
    if not isinstance(corpus, dict) or corpus.get("kind") != "nerrf_tune_corpus":
        raise TuneError("not a tune corpus (want kind='nerrf_tune_corpus' "
                        "from `nerrf archive export --tune`)")
    if not corpus.get("windows_observed"):
        raise TuneError("tune corpus is empty (0 windows observed) — "
                        "archive a serve run first")
    points = _measured_points(corpus, model_cfg, min_batches)
    if not points:
        raise TuneError("tune corpus has no usable bucket_cost "
                        "measurements — nothing to fit")

    # dense↔fused crossover prior: calibrate gamma so the modeled
    # crossover lands on the measured one (gamma scales dense_adj's
    # quadratic term; at the crossover node count n*, dense work ==
    # fused work with the ladder's e = 2n edge rule)
    xover = float((kernel_bench or {}).get("nodes") or DENSE_FUSED_PRIOR_NODES)
    dense_gamma = 8.0 * (2.0 * xover) / (2.0 * xover * xover)  # = 8/n*

    probe = LadderCostModel(model_cfg.hidden, model_cfg.num_layers,
                            1.0, 0.0, dense_gamma, {})
    rows = [(probe.work(b, m), probe.launches(m)) for b, m in points]
    ys = list(points.values())
    alpha, beta = _lstsq2(rows, ys)

    # analytic anchor: one scale from measured seconds to devtime FLOPs,
    # median over the overlap (robust to a single odd bucket).  Keyed by
    # GRAPH rung (n, e) with the traced seq kept alongside — the search
    # proposes seq capacities the trace never ran, and the fitted surface
    # supplies that delta (see LadderCostModel.cost)
    analytic_by_rung: Dict[Tuple[int, int], Tuple[float, int]] = {}
    analytic_alpha = None
    if analytic:
        for tag, flops in analytic.items():
            n, e, s = parse_tag(tag)
            analytic_by_rung[(n, e)] = (float(flops), s)
        ratios = sorted(
            y / analytic_by_rung[(b[0], b[1])][0]
            for (b, _m), y in points.items()
            if analytic_by_rung.get((b[0], b[1])))
        if ratios:
            analytic_alpha = ratios[len(ratios) // 2]

    prov = {
        "measured_buckets": sorted(
            f"{b[0]}n/{b[1]}e/{b[2]}s [{m}]" for b, m in points),
        "min_batches": min_batches,
        "kernel_bench": kernel_bench or {
            "nodes": float(DENSE_FUSED_PRIOR_NODES),
            "source": "tune/costmodel.py DENSE_FUSED_PRIOR_NODES, the "
                      "reference's DENSE_ADJ_MAX_NODES measured on the CPU "
                      "and the TPU, not on the card (no artifact supplied)",
            "degraded": None},
        "analytic_surface": sorted(analytic) if analytic else None,
    }
    return LadderCostModel(
        model_cfg.hidden, model_cfg.num_layers, alpha, beta, dense_gamma,
        points, analytic_by_rung, analytic_alpha, prov)
