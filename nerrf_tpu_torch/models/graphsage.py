"""GraphSAGE-T edge/node anomaly classifier: the port of
``nerrf_tpu/models/graphsage.py`` ``GraphSAGET``.

Takes a batch of padded window graphs ([B, N] nodes, [B, E] edges sorted by
destination) and returns ``edge_logit`` [B, E], ``node_logit`` [B, N] and
``node_emb`` [B, N, H].  Compute runs in ``cfg.dtype`` (bfloat16) over
float32 params, LayerNorm statistics in float32, as the reference does.

Two aggregation modes, each a per-forward precompute plus ONE op per layer:

* ``fused``: :func:`nerrf_tpu_torch.ops.sage_aggregate` over the
  pre-normalized dst-sorted and src-sorted edge views (the CUDA kernel on
  the card);
* ``dense_adj``: one [N, N] @ [N, H] matmul per layer against the normalized
  adjacency (``torch.matmul``, as the reference leaves it to XLA).

``auto`` resolves to ``fused`` for every bucket, so the kernel runs on every
forward; the reference's ``DENSE_ADJ_MAX_NODES`` crossover was measured on
the CPU and the TPU and does not carry over.  The reference's ``segment``
mode (per-layer gather + banded segment mean) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from nerrf_tpu_torch.graph.builder import (
    AUX_VOCAB,
    EDGE_FEATURE_DIM,
    NODE_FEATURE_DIM,
)
from nerrf_tpu_torch.models.layers import Dense, Embed, LayerNorm, gelu
from nerrf_tpu_torch.ops import gather_rows, sage_aggregate, sage_row_ptrs

AGGREGATIONS = ("fused", "dense_adj")


@dataclasses.dataclass(frozen=True)
class GraphSAGEConfig:
    hidden: int = 160
    num_layers: int = 28
    dtype: torch.dtype = torch.bfloat16
    aggregation: str = "auto"

    @property
    def small(self) -> "GraphSAGEConfig":
        return dataclasses.replace(self, hidden=32, num_layers=4)

    def resolved_aggregation(self) -> str:
        if self.aggregation == "auto":
            return "fused"
        if self.aggregation not in AGGREGATIONS:
            raise ValueError(f"unknown aggregation {self.aggregation!r}; "
                             "expected 'auto', 'fused' or 'dense_adj'")
        return self.aggregation


def _segment_sum_rows(values: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Per-window scatter-add of [B, E] or [B, E, F] rows onto
    ``num_segments`` slots (ids are in range: graph structure).  The
    reference's ``jax.ops.segment_sum`` precompute, not a kernel."""
    B = values.shape[0]
    out = torch.zeros((B, num_segments) + values.shape[2:],
                      dtype=values.dtype, device=values.device)
    index = ids.long()
    if values.dim() == 3:
        index = index[..., None].expand_as(values)
    return out.scatter_add_(1, index, values)


def fused_edge_views(edge_src, edge_dst, w32, num_nodes):
    """Per-forward normalized edge views (the reference's
    ``fused_edge_views``), batched over windows.

    Returns ``(edges, d_fwd, d_rev, inv_f, inv_r)``: ``edges`` is the 8-tuple
    :func:`sage_aggregate` takes (both sorted edge orders, each direction's
    pre-normalized weights ``ŵ = w·inv`` in both orders); ``d``/``inv`` the
    per-node weight totals and safe inverses.  ``edge_dst`` must be the
    builder's sorted-by-dst ids and ``w32`` float32 edge weights with masked
    edges zeroed."""
    d_fwd = _segment_sum_rows(w32, edge_dst, num_nodes)
    d_rev = _segment_sum_rows(w32, edge_src, num_nodes)
    inv_f = 1.0 / torch.clamp_min(d_fwd, 1e-6)
    inv_r = 1.0 / torch.clamp_min(d_rev, 1e-6)
    src_order = torch.argsort(edge_src, dim=1, stable=True)
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
        if mode == "fused":
            edges, row_ptrs, c_sum, s_f, s_r = view
            agg = sage_aggregate(msg, *edges, msg.shape[1], row_ptrs=row_ptrs)
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
                edge_src, edge_dst, edge_feat, edge_mask) -> Dict[str, torch.Tensor]:
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

        # per-forward aggregation state shared by all layers: each layer then
        # costs ONE op (the fused kernel or one matmul); the layer-invariant
        # e_emb term folds into c_sum, and s_f/s_r carry the empty-segment
        # zeroing
        mode = cfg.resolved_aggregation()
        edges, d_fwd, d_rev, inv_f, inv_r = fused_edge_views(
            edge_src, edge_dst, w32, n)
        we = w32[..., None] * e_emb.float()
        c_f = _segment_sum_rows(we, edge_dst, n)
        c_r = _segment_sum_rows(we, edge_src, n)
        c_sum = (c_f * inv_f[..., None] + c_r * inv_r[..., None]).to(dt)
        s_f = (d_fwd * inv_f).to(dt)
        s_r = (d_rev * inv_r).to(dt)
        if mode == "fused":
            view = (edges, sage_row_ptrs(edges[0], edges[2], n), c_sum, s_f, s_r)
        else:
            # one [E] → [N·N] scatter builds the raw weighted adjacency whose
            # normalized form serves every layer as one matmul
            flat = edge_dst.long() * n + edge_src.long()
            w_raw = _segment_sum_rows(w32, flat, n * n).view(-1, n, n)
            adj = (w_raw * inv_f[..., None]
                   + w_raw.transpose(1, 2) * inv_r[..., None]).to(dt)
            view = (adj, c_sum, s_f, s_r)

        for block in self.blocks:
            h = block(h, view, mode) * nmask

        h = self.final_ln(h)
        node_logit = self.node_head(h)[..., 0]
        h_src = gather_rows(h, edge_src)
        h_dst = gather_rows(h, edge_dst)
        pair = torch.cat([h_src, h_dst, h_src * h_dst, e_emb], dim=-1)
        z = gelu(self.edge_head_1(pair))
        edge_logit = self.edge_head_2(z)[..., 0]
        return {
            "edge_logit": torch.where(edge_mask, edge_logit, -30.0),
            "node_logit": torch.where(node_mask, node_logit, -30.0),
            "node_emb": h.float(),
        }
