"""GraphSAGE-T edge/node anomaly classifier: the port of
``nerrf_tpu/models/graphsage.py`` ``GraphSAGET``.

Takes a batch of padded window graphs ([B, N] nodes, [B, E] edges sorted by
destination) and returns ``edge_logit`` [B, E], ``node_logit`` [B, N] and
``node_emb`` [B, N, H].  Compute runs in ``cfg.dtype`` (bfloat16) over
float32 params, LayerNorm statistics in float32, as the reference does.

Three aggregation modes:

* ``fused``: a per-forward precompute, then ONE op per layer,
  :func:`nerrf_tpu_torch.ops.sage_aggregate` over the pre-normalized
  dst-sorted and src-sorted edge views (the CUDA kernel on the card);
* ``dense_adj``: the same precompute, then one [N, N] @ [N, H] matmul per
  layer against the normalized adjacency (``torch.matmul``, as the
  reference leaves it to XLA);
* ``segment``: the reference's per-layer gather + banded segment mean: two
  :func:`~nerrf_tpu_torch.ops.gather_rows` and two weighted
  :func:`~nerrf_tpu_torch.ops.segment_mean` (``sorted_ids=True``, the
  banded kernel) per layer, over the dst-sorted edges and a src-sorted view
  taken once per forward, with the four id vectors' segment plans.

``auto`` resolves to ``fused`` for every bucket that a ``routing`` table
(the reference's per-rung table, consulted first) does not cover, so that
kernel runs on every forward; the reference's ``DENSE_ADJ_MAX_NODES``
crossover was measured on the CPU and the TPU and does not carry over.

The ``fused`` and ``dense_adj`` precompute (each node's weight totals, the
layer-invariant edge-embedding sums) goes through the port's deterministic
segment sums over the edges' segment plans, taken once per forward and
shared with every layer's kernel and the edge head's gathers: two runs on
the card give the same bits.  Dropout after ``final_ln`` runs only when the
forward is given a ``torch.Generator`` (training).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nerrf_tpu_torch.graph.builder import (
    AUX_VOCAB,
    EDGE_FEATURE_DIM,
    NODE_FEATURE_DIM,
)
from nerrf_tpu_torch.models.layers import Dense, Embed, LayerNorm, dropout, gelu
from nerrf_tpu_torch.ops import (
    SegmentPlan, gather_rows, sage_aggregate, segment_mean, segment_plan,
    segment_sum, segment_sum_sorted)

AGGREGATIONS = ("fused", "dense_adj", "segment")


@dataclasses.dataclass(frozen=True)
class GraphSAGEConfig:
    hidden: int = 160
    num_layers: int = 28
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    aggregation: str = "auto"
    # the reference's per-rung routing table: sorted ((max_nodes, mode), ...)
    # pairs consulted before the ``auto`` rule, the smallest entry whose
    # max_nodes covers the padded node bucket winning; None keeps ``auto``
    routing: Optional[Tuple[Tuple[int, str], ...]] = None

    def __post_init__(self):
        # one canonical shape (JSON hands back lists), junk refused here
        if self.routing is not None:
            table = tuple(sorted((int(cap), str(mode))
                                 for cap, mode in self.routing))
            for cap, mode in table:
                if mode not in AGGREGATIONS:
                    raise ValueError(
                        f"unknown aggregation {mode!r} in routing table; "
                        "expected 'fused', 'dense_adj' or 'segment'")
                if cap <= 0:
                    raise ValueError("routing table max_nodes must be "
                                     f"positive, got {cap}")
            object.__setattr__(self, "routing", table)

    @property
    def small(self) -> "GraphSAGEConfig":
        return dataclasses.replace(self, hidden=32, num_layers=4)

    def resolved_aggregation(self, num_nodes: Optional[int] = None) -> str:
        """The mode the forward runs for a padded node bucket of
        ``num_nodes``: an explicit ``aggregation``; else the routing table's
        smallest covering entry; else ``fused`` (the port's ``auto``)."""
        if self.aggregation != "auto":
            if self.aggregation not in AGGREGATIONS:
                raise ValueError(f"unknown aggregation {self.aggregation!r}; "
                                 "expected 'auto', 'fused', 'dense_adj' or "
                                 "'segment'")
            return self.aggregation
        if self.routing and num_nodes is not None:
            for cap, mode in self.routing:   # sorted: smallest cover wins
                if num_nodes <= cap:
                    return mode
        return "fused"


def edge_plans(edge_src, edge_dst, num_nodes) -> Dict[str, SegmentPlan]:
    """The :func:`~nerrf_tpu_torch.ops.segment_plan` of each edge id vector,
    graph structure taken once per forward: ``dst`` of the builder's
    dst-sorted ids (row pointers only), ``src`` of the source ids (its stable
    sort order is the src-sorted view's edge order, its row pointers that
    view's)."""
    return {"dst": segment_plan(edge_dst, num_nodes, sorted_ids=True),
            "src": segment_plan(edge_src, num_nodes)}


def fused_edge_views(edge_src, edge_dst, w32, num_nodes, plans=None):
    """Per-forward normalized edge views (the reference's
    ``fused_edge_views``), batched over windows.

    Returns ``(edges, d_fwd, d_rev, inv_f, inv_r)``: ``edges`` is the 8-tuple
    :func:`sage_aggregate` takes (both sorted edge orders, each direction's
    pre-normalized weights ``ŵ = w·inv`` in both orders); ``d``/``inv`` the
    per-node weight totals and safe inverses.  ``edge_dst`` must be the
    builder's sorted-by-dst ids and ``w32`` float32 edge weights with masked
    edges zeroed.  ``plans`` are :func:`edge_plans` of the ids (built here
    when not given): ``d_fwd`` is the banded sum over ``dst``, ``d_rev`` the
    order-independent sum over ``src``, and the src-sorted view is taken in
    ``src``'s sort order; both sums deterministic on the card."""
    if plans is None:
        plans = edge_plans(edge_src, edge_dst, num_nodes)
    d_fwd = segment_sum_sorted(w32[..., None], edge_dst, num_nodes,
                               plan=plans["dst"])[..., 0]
    d_rev = segment_sum(w32[..., None], edge_src, num_nodes,
                        plan=plans["src"])[..., 0]
    inv_f = 1.0 / torch.clamp_min(d_fwd, 1e-6)
    inv_r = 1.0 / torch.clamp_min(d_rev, 1e-6)
    src_order = plans["src"].perm
    wf_d = w32 * torch.gather(inv_f, 1, edge_dst.long())
    wr_d = w32 * torch.gather(inv_r, 1, edge_src.long())
    edges = (edge_dst,                                   # nondecreasing dst ids
             edge_src,                                   # message source per edge
             torch.gather(edge_src, 1, src_order),       # nondecreasing src ids
             torch.gather(edge_dst, 1, src_order),       # message source, src order
             wf_d,
             torch.gather(wf_d, 1, src_order),
             torch.gather(wr_d, 1, src_order),
             wr_d)
    return edges, d_fwd, d_rev, inv_f, inv_r


def _segment_view(edge_src, edge_dst, e_emb, edge_w, num_nodes):
    """The ``segment`` mode's per-forward view: the dst-sorted edges as the
    builder gives them, plus a src-sorted view (a stable argsort per
    window) of the ids, the message sources, ``e_emb`` and the weights,
    shared by every layer (the reference's ``rev_view``); and the
    :func:`~nerrf_tpu_torch.ops.segment_plan` of each id vector, graph
    structure taken once for every layer's sums and gathers' backward."""
    src_order = torch.argsort(edge_src, dim=1, stable=True)
    take = lambda t: torch.gather(t, 1, src_order)
    e_emb_s = torch.gather(
        e_emb, 1, src_order[..., None].expand(-1, -1, e_emb.shape[-1]))
    src_sorted = take(edge_src)      # nondecreasing segment ids
    dst_srcorder = take(edge_dst)    # message source per edge
    plans = {"src": segment_plan(edge_src, num_nodes),
             "dst_srcorder": segment_plan(dst_srcorder, num_nodes),
             "dst": segment_plan(edge_dst, num_nodes, sorted_ids=True),
             "src_sorted": segment_plan(src_sorted, num_nodes, sorted_ids=True)}
    return (edge_src, edge_dst, e_emb, edge_w, src_sorted, dst_srcorder,
            e_emb_s, take(edge_w), plans)


def dense_adjacency(edge_src, edge_dst, w32, num_nodes):
    """The raw weighted adjacency [B, N, N] (row dst, column src, duplicate
    pairs summed): the reference's ``segment_sum`` of the weights onto the
    N·N keys ``dst·N + src``, deterministic without a plan over N² segments
    (537 MB of pointers at N = 4096).  Each window's keys are sorted stably;
    run heads (a key unlike its left neighbour) number the runs 0, 1, ...
    by a cumulative sum, nondecreasing ids that :func:`segment_sum_sorted`
    sums the permuted weights over; each run's sum is then written at its
    head's key, so every kept entry has one writer, and the other edges
    write 0 to a spare column that is dropped.  No host sync, no atomics on
    kept values."""
    B, E = edge_dst.shape
    n = num_nodes
    keys, order = torch.sort(edge_dst.long() * n + edge_src.long(), dim=1,
                             stable=True)
    head = torch.ones_like(keys, dtype=torch.bool)
    head[:, 1:] = keys[:, 1:] != keys[:, :-1]
    run = torch.cumsum(head, dim=1, dtype=torch.int32) - 1
    sums = segment_sum_sorted(torch.gather(w32, 1, order)[..., None], run, E,
                              plan=segment_plan(run, E, sorted_ids=True))[..., 0]
    val = torch.where(head, torch.gather(sums, 1, run.long()), 0.0)
    out = torch.zeros(B, n * n + 1, dtype=w32.dtype, device=w32.device)
    out.scatter_(1, torch.where(head, keys, n * n), val)
    return out[:, :n * n].view(B, n, n)


def _precomputed_view(mode, edge_src, edge_dst, e_emb, w32, n, dt, plans):
    """The ``fused`` and ``dense_adj`` modes' per-forward aggregation state,
    shared by all layers, so each layer costs ONE op (the fused kernel or
    one matmul): the layer-invariant e_emb term folds into c_sum, and
    s_f/s_r carry the empty-segment zeroing.  Four segment sums over the
    edges' ``plans`` (:func:`edge_plans`): each direction's weight totals
    and weighted e_emb sums, the dst direction banded, the src direction
    through ``src``'s sort order; ``c_*`` carry e_emb's gradient through
    the sums' adjoint gathers."""
    edges, d_fwd, d_rev, inv_f, inv_r = fused_edge_views(
        edge_src, edge_dst, w32, n, plans)
    we = w32[..., None] * e_emb.float()
    c_f = segment_sum_sorted(we, edge_dst, n, plan=plans["dst"])
    c_r = segment_sum(we, edge_src, n, plan=plans["src"])
    c_sum = (c_f * inv_f[..., None] + c_r * inv_r[..., None]).to(dt)
    s_f = (d_fwd * inv_f).to(dt)
    s_r = (d_rev * inv_r).to(dt)
    if mode == "fused":
        return (edges, (plans["dst"].ptr, plans["src"].ptr), c_sum, s_f, s_r)
    # the raw weighted adjacency, whose normalized form serves every layer
    # as one matmul
    w_raw = dense_adjacency(edge_src, edge_dst, w32, n)
    adj = (w_raw * inv_f[..., None]
           + w_raw.transpose(1, 2) * inv_r[..., None]).to(dt)
    return (adj, c_sum, s_f, s_r)


class SageBlock(nn.Module):
    """One residual GraphSAGE block: pre-LN, bidirectional weighted-mean
    aggregation with shared message weights plus a per-direction bias."""

    def __init__(self, hidden: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.ln = LayerNorm(hidden, dtype)
        self.w_msg = Dense(hidden, hidden, dtype)
        self.dir_bias = nn.Parameter(torch.zeros(2, hidden))
        self.w_self = Dense(2 * hidden, hidden, dtype)

    def init_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.dir_bias.zero_()

    def forward(self, h, view, mode: str):
        hn = self.ln(h)
        msg = self.w_msg(hn)
        dir_bias = self.dir_bias.to(self.dtype)
        n = msg.shape[1]
        if mode == "segment":
            # src→dst messages land on dst (builder-sorted ids: the banded
            # kernel); dst→src messages ride the src-sorted view, so that
            # direction is banded too
            (edge_src, edge_dst, e_emb, edge_w,
             src_sorted, dst_srcorder, e_emb_s, w_s, plans) = view
            m_fwd = (gather_rows(msg, edge_src, plan=plans["src"]) + e_emb
                     + dir_bias[0])
            agg_fwd = segment_mean(m_fwd, edge_dst, n, weights=edge_w,
                                   sorted_ids=True, plan=plans["dst"])
            m_rev = (gather_rows(msg, dst_srcorder, plan=plans["dst_srcorder"])
                     + e_emb_s + dir_bias[1])
            agg_rev = segment_mean(m_rev, src_sorted, n, weights=w_s,
                                   sorted_ids=True, plan=plans["src_sorted"])
            upd = self.w_self(torch.cat([hn, agg_fwd + agg_rev], dim=-1))
            return h + gelu(upd)
        if mode == "fused":
            edges, row_ptrs, c_sum, s_f, s_r = view
            agg = sage_aggregate(msg, *edges, n, row_ptrs=row_ptrs)
        else:
            adj, c_sum, s_f, s_r = view
            agg = torch.matmul(adj, msg)
        agg = (agg + c_sum + dir_bias[0] * s_f[..., None]
               + dir_bias[1] * s_r[..., None])
        upd = self.w_self(torch.cat([hn, agg], dim=-1))
        return h + gelu(upd)


class GraphSAGET(nn.Module):
    def __init__(self, cfg: GraphSAGEConfig) -> None:
        super().__init__()
        self.cfg = cfg
        H, dt = cfg.hidden, cfg.dtype
        self.type_emb = Embed(4, H, dt)
        self.aux_emb = Embed(AUX_VOCAB, H, dt)
        self.node_enc = Dense(NODE_FEATURE_DIM, H, dt)
        self.edge_enc = Dense(EDGE_FEATURE_DIM, H, dt)
        self.blocks = nn.ModuleList(SageBlock(H, dt)
                                    for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(H, dt)
        self.node_head = Dense(H, 1, torch.float32)
        self.edge_head_1 = Dense(4 * H, H, dt)
        self.edge_head_2 = Dense(H, 1, torch.float32)

    def forward(self, node_feat, node_type, node_aux, node_mask,
                edge_src, edge_dst, edge_feat, edge_mask,
                dropout_gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dt = cfg.dtype
        n = node_feat.shape[1]
        nmask = node_mask[..., None].to(dt)

        h = self.node_enc(node_feat)
        h = gelu(h + self.type_emb(node_type) + self.aux_emb(node_aux))
        h = h * nmask

        e_emb = gelu(self.edge_enc(edge_feat))
        # causality weight (edge_feat[..., 12]) gates messages; masked edges → 0
        w32 = (edge_feat[..., 12] + 0.1) * edge_mask.to(torch.float32)

        mode = cfg.resolved_aggregation(n)
        if mode == "segment":
            view = _segment_view(edge_src, edge_dst, e_emb, w32.to(dt), n)
            plans = view[-1]
        else:
            plans = edge_plans(edge_src, edge_dst, n)
            view = _precomputed_view(mode, edge_src, edge_dst, e_emb, w32, n,
                                     dt, plans)

        for block in self.blocks:
            h = block(h, view, mode) * nmask

        h = dropout(self.final_ln(h), cfg.dropout, dropout_gen)
        node_logit = self.node_head(h)[..., 0]
        h_src = gather_rows(h, edge_src, plan=plans["src"])
        h_dst = gather_rows(h, edge_dst, plan=plans["dst"])
        pair = torch.cat([h_src, h_dst, h_src * h_dst, e_emb], dim=-1)
        z = gelu(self.edge_head_1(pair))
        edge_logit = self.edge_head_2(z)[..., 0]
        return {
            "edge_logit": torch.where(edge_mask, edge_logit, -30.0),
            "node_logit": torch.where(node_mask, node_logit, -30.0),
            "node_emb": h.float(),
        }
