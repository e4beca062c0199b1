"""Search ladder space + per-rung kernel routing against the fitted cost.

The decision variables are exactly the two knobs serving exposes:

* **rung placement** — which ``(max_nodes, max_edges, max_seqs)`` buckets
  the ladder carries (bounded count, every rung inside the CUDA kernels'
  own limits via `ops.kernels.rung_limits`, the checks their launchers
  make, so a tuned ladder can never propose a rung a launcher would
  refuse);
* **per-rung kernel routing** — which of {fused, dense_adj, segment} each
  rung's programs aggregate with, replacing the single global
  ``auto`` rule with a fitted table.

The objective is expected padded device seconds per window over the
observed demand: each demand point (a weighted (nodes, edges, files)
draw reconstructed from the corpus sketches — admitted AND rejected, so
demand beyond the current top rung pulls the ladder up) is assigned
through the REAL `serve.config.select_bucket` admission rule, pays the
fitted cost of the rung it lands on, and pays a rejection penalty when
no rung fits.  Enumeration is exhaustive over bounded rung subsets —
small, deterministic, and the static ladder is itself in the candidate
set, so the tuned result can never be worse than static under the fitted
model.

The port's copy of ``nerrf_tpu/tune/search.py`` but for `budget_clean`: the
reference gates rungs with the Pallas kernels' VMEM audit, the port with
its CUDA kernels' limits at the rung.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from nerrf_tpu_torch.tune.artifact import TuneError, build_artifact
from nerrf_tpu_torch.tune.costmodel import Bucket, LadderCostModel

MODES = ("fused", "dense_adj", "segment")

# Hard ceiling on candidate node rungs, the reference's: the rung gate
# below enforces the kernels' real boundary; this just bounds the
# enumeration.
MAX_CANDIDATE_NODES = 16384
SEQ_MIN, SEQ_MAX = 32, 512


def _pow2_at_least(x: float) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


class DemandPoint:
    __slots__ = ("nodes", "edges", "files", "weight")

    def __init__(self, nodes: int, edges: int, files: int, weight: float):
        self.nodes, self.edges, self.files = nodes, edges, files
        self.weight = weight


def _capacity_quantile(sk, rank: float) -> int:
    """Capacity needed at ``rank``: the right edge of the rank's sketch
    bin (what `Sketch.quantile` reports), EXCEPT in the unbounded top bin
    where quantile() can only report the left edge — double it, the same
    headroom rule the count ladder itself uses between rungs."""
    top = int(sk.counts[-1])
    if top and rank > 1.0 - top / sk.total:
        return int(sk.edges[-1]) * 2
    return int(sk.quantile(rank))


def _sketch_points(dist: dict) -> List[DemandPoint]:
    """Reconstruct weighted demand points from one marginal-sketch block
    (``{"nodes": {...}, "edges": {...}, "files": {...}}``) by comonotone
    quantile coupling: segment [0, 1] at the union of ALL THREE
    marginals' cumulative bin boundaries, and read each segment's
    (nodes, edges, files) need at its mid-rank from each marginal.  The
    monotone-dependence assumption (bigger windows have more of
    everything) holds for graph windows; taking every marginal's
    boundaries — not just the node bins — is what keeps a tail that
    lives in only ONE marginal visible (e.g. attack bursts: few nodes,
    thousands of event edges)."""
    from nerrf_tpu_torch.quality.sketch import Sketch

    sks = {}
    for k in ("nodes", "edges", "files"):
        if dist and dist.get(k):
            sk = Sketch.from_dict(dist[k]["sketch"])
            if sk.total:
                sks[k] = sk
    nodes_sk = sks.get("nodes")
    if nodes_sk is None:
        return []
    total = nodes_sk.total
    cuts = {0.0, 1.0}
    for sk in sks.values():
        cum = 0
        for c in sk.counts:
            cum += int(c)
            if 0 < cum < sk.total:
                cuts.add(cum / sk.total)
    ranks = sorted(cuts)
    points: List[DemandPoint] = []
    for lo, hi in zip(ranks, ranks[1:]):
        w = (hi - lo) * total
        if w <= 0.0:
            continue
        mid = (lo + hi) / 2.0
        n_need = max(_capacity_quantile(nodes_sk, mid), 1)
        e_need = (_capacity_quantile(sks["edges"], mid)
                  if "edges" in sks else 2 * n_need)
        f_need = (_capacity_quantile(sks["files"], mid)
                  if "files" in sks else 16)
        points.append(DemandPoint(n_need, max(e_need, 1), max(f_need, 1),
                                  float(w)))
    return points


def demand_points(corpus: dict) -> List[DemandPoint]:
    """The weighted demand the ladder must serve: admitted windows from
    ``window_size_distribution`` plus rejected-at-admission windows from
    ``rejected_window_size_distribution`` (when the corpus carries it) —
    the demand beyond the current top rung that only satellites into the
    sketches since the rejected-window recording landed."""
    points = _sketch_points(corpus.get("window_size_distribution") or {})
    points += _sketch_points(
        corpus.get("rejected_window_size_distribution") or {})
    if not points:
        raise TuneError("tune corpus has no window-size distribution — "
                        "nothing to place rungs over")
    return points


def budget_clean(n: int, e: int, model_cfg=None) -> bool:
    """True iff every segment kernel launches at this rung for the model's
    width and the serve batch (``ServeConfig().batch_size``) — the checks
    the launchers themselves make (`ops.kernels.rung_limits`), invoked as a
    search gate so a tuned ladder launches by construction."""
    from nerrf_tpu_torch.graph.builder import NODE_FEATURE_DIM
    from nerrf_tpu_torch.models.graphsage import GraphSAGEConfig
    from nerrf_tpu_torch.ops.kernels import rung_limits
    from nerrf_tpu_torch.serve.config import ServeConfig

    hidden = (model_cfg.hidden if model_cfg is not None
              else GraphSAGEConfig().hidden)
    width = max(hidden, NODE_FEATURE_DIM)
    return rung_limits(n, e, width, ServeConfig().batch_size)["ok"]


def candidate_graph_rungs(points: Sequence[DemandPoint],
                          model_cfg=None) -> List[Tuple[int, int]]:
    """Power-of-two ``(max_nodes, max_edges)`` rungs covering the demand
    window, budget-gated.  Edge capacity starts at the ladder's 2n rule
    (what the static ladder uses) and widens by powers of two up to the
    edge need the demand at that node rung actually carries — dense
    windows (many events between few inodes: attack bursts) overflow a
    2n rung on edges alone, and admission rejects on edge overflow."""
    top = max(p.nodes for p in points)
    rungs: List[Tuple[int, int]] = []
    n = 256
    # demand entirely below the 256 floor still needs the floor rung
    while n <= min(max(_pow2_at_least(top), 256), MAX_CANDIDATE_NODES):
        edge_need = max((p.edges for p in points if p.nodes <= n),
                        default=0)
        e = 2 * n
        e_top = max(2 * n, min(_pow2_at_least(edge_need),
                               2 * MAX_CANDIDATE_NODES))
        while e <= e_top:
            if budget_clean(n, e, model_cfg):
                rungs.append((n, e))
            e <<= 1
        n <<= 1
    if not rungs:
        raise TuneError("no candidate rung inside the kernels' limits "
                        "covers the observed demand")
    return rungs


# Candidate-set ceiling for the exhaustive ladder enumeration: with
# combinations up to max_rungs the search is O(C(len(cands), max_rungs));
# 24 keeps the worst case (max_rungs 4) around 10k ladders.  The prune is
# deterministic (demand coverage, then bucket order).
MAX_CANDIDATE_BUCKETS = 24


def candidate_buckets(points: Sequence[DemandPoint],
                      model_cfg=None) -> List[Bucket]:
    """Full ``(max_nodes, max_edges, max_seqs)`` candidates: graph rungs
    crossed with the power-of-two sequence capacities the demand's file
    counts actually need.  Sequence capacity is a REAL search dimension,
    not a per-rung afterthought: `select_bucket` treats seq overflow as
    soft but prefers a seq-covering rung, and the LSTM term prices seq
    slots like any other padding — a ladder carrying (n,e)×{64,256} seq
    variants lets small-file traffic stop paying for the file-heavy
    tail's slots (exactly the structure the static default ladder's
    graph×seq product encodes by hand)."""
    rungs = candidate_graph_rungs(points, model_cfg)
    seqs = sorted({min(max(_pow2_at_least(p.files), SEQ_MIN), SEQ_MAX)
                   for p in points})
    cands = [(n, e, s) for n, e in rungs for s in seqs]
    if len(cands) > MAX_CANDIDATE_BUCKETS:
        def coverage(b: Bucket) -> float:
            return sum(p.weight for p in points if p.nodes <= b[0]
                       and p.edges <= b[1] and p.files <= b[2])
        cands.sort(key=lambda b: (-coverage(b), b))
        cands = sorted(cands[:MAX_CANDIDATE_BUCKETS])
    return cands


def _assign(points: Sequence[DemandPoint],
            buckets: Tuple[Bucket, ...]) -> List[Optional[Bucket]]:
    """Each demand point's admission outcome on this ladder, through the
    REAL first-fit rule serving uses."""
    from nerrf_tpu_torch.serve.config import select_bucket

    return [select_bucket(p.nodes, p.edges, p.files, buckets)
            for p in points]


def route_ladder(model: LadderCostModel,
                 buckets: Tuple[Bucket, ...]) -> Tuple[Tuple[int, str], ...]:
    """Fitted per-rung kernel choice: for each distinct node rung, the
    argmin-cost mode (ties break toward fewer launches, then name — the
    deterministic order the artifact pins)."""
    routing = []
    seen = set()
    for b in sorted(buckets):
        if b[0] in seen:
            continue
        seen.add(b[0])
        best = min(MODES, key=lambda m: (model.cost(b, m),
                                         model.launches(m), m))
        routing.append((b[0], best))
    return tuple(routing)


def expected_cost(model: LadderCostModel, points: Sequence[DemandPoint],
                  buckets: Tuple[Bucket, ...],
                  routing: Optional[Tuple[Tuple[int, str], ...]],
                  model_cfg=None, reject_cost: Optional[float] = None
                  ) -> float:
    """Expected padded device seconds per window over the demand.  With
    ``routing=None`` each rung pays the UNTUNED auto rule's mode — the
    static baseline scored under the same fitted model, so the
    tuned-vs-static comparison has no wall-clock dependence.

    ``reject_cost`` is what an admission-rejected point pays — and what
    a SEQ-TRUNCATED point pays (its rung's ``max_seqs`` below the file
    need: `select_bucket`'s soft overflow serves the window but silently
    drops the sparsest per-file sequences, an evidence loss no padding
    saving justifies).  It must be shared across every ladder being
    compared and dominate any serving cost (a ladder must never "win"
    by shedding or truncating traffic a taller rung could carry).
    Default: 10× this ladder's costliest rung."""
    if model_cfg is None:
        from nerrf_tpu_torch.models.graphsage import GraphSAGEConfig
        model_cfg = GraphSAGEConfig(hidden=model.hidden,
                                    num_layers=model.num_layers)
    table = dict(routing) if routing else None

    def mode_for(bucket: Bucket) -> str:
        if table is not None:
            for cap in sorted(table):
                if bucket[0] <= cap:
                    return table[cap]
        return model_cfg.resolved_aggregation(bucket[0])

    if reject_cost is None:
        reject_cost = 10.0 * max(model.cost(b, mode_for(b))
                                 for b in buckets)
    total_w = sum(p.weight for p in points)
    acc = 0.0
    for p, b in zip(points, _assign(points, buckets)):
        # a file need past SEQ_MAX is truncated on EVERY ladder under
        # comparison (candidates clamp there) — charge only truncation
        # a taller-seq ladder could have avoided
        truncated = (b is not None and b[2] < p.files
                     and b[2] < SEQ_MAX)
        acc += p.weight * (reject_cost if b is None or truncated
                           else model.cost(b, mode_for(b)))
    return acc / max(total_w, 1e-9)


def search_ladder(model: LadderCostModel, points: Sequence[DemandPoint],
                  static_buckets: Tuple[Bucket, ...],
                  max_rungs: Optional[int] = None,
                  model_cfg=None) -> dict:
    """Exhaustive search over bounded rung subsets (static ladder
    included), each with its fitted routing table; returns the argmin and
    both sides of the static-vs-tuned comparison."""
    from itertools import combinations

    static_buckets = tuple(sorted(tuple(b) for b in static_buckets))
    if max_rungs is None:
        max_rungs = max(len({b[0] for b in static_buckets}), 3)

    cands = candidate_buckets(points, model_cfg)
    # ONE rejection price for every ladder scored (static included):
    # 10× the costliest candidate rung under the worst mode, so shedding
    # admissible traffic can never beat serving it
    reject = 10.0 * max(model.cost((n, e, SEQ_MAX), m)
                        for n, e in {c[:2] for c in cands} for m in MODES)
    static_score = expected_cost(model, points, static_buckets, None,
                                 model_cfg, reject_cost=reject)

    ladders: List[Tuple[Bucket, ...]] = [static_buckets]
    for k in range(1, min(max_rungs, len(cands)) + 1):
        ladders.extend(combinations(cands, k))

    best = None
    for ladder in ladders:
        routing = route_ladder(model, ladder)
        score = expected_cost(model, points, ladder, routing, model_cfg,
                              reject_cost=reject)
        key = (score, len(ladder), ladder)  # deterministic tie-break
        if best is None or key < best[0]:
            best = (key, ladder, routing, score)

    _key, ladder, routing, score = best
    return {
        "buckets": ladder,
        "routing": routing,
        "expected": {
            "static_device_seconds_per_window": static_score,
            "tuned_device_seconds_per_window": score,
            "improvement": ((static_score - score) / static_score
                            if static_score > 0 else 0.0),
        },
        "candidates_scored": len(ladders),
    }


def tune(corpus: dict, model_cfg=None,
         analytic: Optional[Dict[str, float]] = None,
         kernel_bench: Optional[dict] = None,
         max_rungs: Optional[int] = None,
         static_buckets: Optional[Tuple[Bucket, ...]] = None) -> dict:
    """Corpus in, versioned tuned-ladder artifact out — the whole fit +
    search pipeline `nerrf tune` runs.  Deterministic for a fixed corpus
    (no RNG, no wall clock); raises `TuneError` on an unfittable one."""
    from nerrf_tpu_torch.tune.costmodel import fit_cost_model

    gnn_cfg = model_cfg.gnn if hasattr(model_cfg, "gnn") else model_cfg
    model = fit_cost_model(corpus, gnn_cfg, analytic=analytic,
                           kernel_bench=kernel_bench)
    points = demand_points(corpus)
    if static_buckets is None:
        from nerrf_tpu_torch.serve.config import ServeConfig
        static_buckets = ServeConfig().buckets
    result = search_ladder(model, points, tuple(static_buckets),
                           max_rungs=max_rungs, model_cfg=gnn_cfg)
    fit = dict(model.to_dict())
    fit["demand_points"] = len(points)
    fit["candidates_scored"] = result["candidates_scored"]
    fit["rung_sources"] = {
        f"{b[0]}n/{b[1]}e/{b[2]}s": model.source(b, dict(
            result["routing"]).get(b[0], "fused"))
        for b in result["buckets"]}
    return build_artifact(result["buckets"], result["routing"],
                          result["expected"], fit, corpus=corpus)
