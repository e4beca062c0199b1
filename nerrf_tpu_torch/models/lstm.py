"""Bidirectional LSTM impact predictor: the port of
``nerrf_tpu/models/lstm.py`` ``ImpactLSTM``.

[B, S, T, F] per-file event sequences (left-padded, ``seq_mask`` marking real
events) → ``seq_logit`` [B, S] and ``seq_emb`` [B, S, hidden].  The math is
the reference's (its ``fused`` and ``rnn`` impls compute the same function),
with both directions batched in one time loop and the input projection
hoisted over all T, as its ``fused`` impl does (one ``bmm`` a direction
before the loop, one ``h·W_hh`` ``bmm`` a step inside it; the projection
rounded to the compute type before the loop, as the reference rounds
``xin``):

* ``in_proj`` Dense + gelu, masked; then flipped to the prefix-first layout
  so ``lengths`` bounds each sequence's valid prefix;
* each layer runs both directions in one batched time loop: the backward
  direction reads each sequence reversed within its valid prefix
  (``_flip_valid``), and its outputs are flipped back; gates in the order
  i, f, g, o, the bias on the recurrent side only (``bias_ih`` is a zero
  buffer, kept for PyTorch's LSTM layout and never trained); ``c`` and ``h``
  carried in the compute type;
* per layer, ``merge_i`` Dense + gelu over [fwd, bwd], masked;
* a mask-aware mean pool, ``pool_ln``, dropout (training only) and a
  float32 ``head``; ``seq_emb`` is the pooled embedding *after* dropout, as
  the reference returns it (it feeds the fusion).

The recurrence is a plain PyTorch loop over time (the reference's
``lax.scan``, not a Pallas kernel), not ``torch.nn.LSTM``: the loop keeps
the reference's masking, flips and rounding points exactly.  Dropout runs
only when the forward is given a ``torch.Generator`` (a training forward).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from nerrf_tpu_torch.data.sequences import SEQ_FEATURE_DIM
from nerrf_tpu_torch.models.layers import (
    Dense, LayerNorm, dropout, gelu, lecun_normal_)


LSTM_IMPLS = ("auto", "fused", "rnn")


@dataclasses.dataclass(frozen=True)
class LSTMConfig:
    hidden: int = 256
    num_layers: int = 2
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    # the reference's implementation choice, carried so that its config
    # (a checkpoint's model_config.json) builds this one.  Its impls are the
    # same math over the same params; the port has one code path for all
    # three values, so impl changes nothing here.
    impl: str = "auto"

    def __post_init__(self):
        if self.impl not in LSTM_IMPLS:
            raise ValueError(f"unknown LSTM impl {self.impl!r}; expected "
                             "'auto', 'fused' or 'rnn'")

    @property
    def small(self) -> "LSTMConfig":
        return dataclasses.replace(self, hidden=32, num_layers=1)


class LSTMCell(nn.Module):
    """One direction of one layer: ``weight_ih`` [4H, in], ``weight_hh``
    [4H, H], ``bias_ih`` (a zero buffer: the reference has no input-side
    bias) and ``bias_hh`` [4H], gates i, f, g, o."""

    def __init__(self, in_features: int, hidden: int) -> None:
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.register_buffer("bias_ih", torch.zeros(4 * hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))

    def init_(self, gen: torch.Generator) -> None:
        """flax OptimizedLSTMCell's kinds: lecun_normal input kernels and an
        orthogonal [H, H] recurrent kernel per gate, zero biases."""
        H = self.weight_hh.shape[1]
        with torch.no_grad():
            for g in range(4):
                lecun_normal_(self.weight_ih[g * H:(g + 1) * H],
                              self.weight_ih.shape[1], gen)
                nn.init.orthogonal_(self.weight_hh[g * H:(g + 1) * H],
                                    generator=gen)
            self.bias_ih.zero_()
            self.bias_hh.zero_()


def _flip_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence of x [..., T, F] within its valid prefix
    (prefix-first layout); positions at or beyond ``lengths`` become zero."""
    T = x.shape[-2]
    src = lengths[..., None] - 1 - torch.arange(T, device=x.device)
    ok = src >= 0
    src = torch.where(ok, src, 0)
    g = torch.gather(x, -2, src[..., None].expand(*src.shape, x.shape[-1]))
    return g * ok[..., None].to(x.dtype)


class ImpactLSTM(nn.Module):
    def __init__(self, cfg: LSTMConfig) -> None:
        super().__init__()
        self.cfg = cfg
        H, dt = cfg.hidden, cfg.dtype
        self.in_proj = Dense(SEQ_FEATURE_DIM, H, dt)
        # cells[2i] = layer i forward, cells[2i+1] = layer i backward (the
        # reference's OptimizedLSTMCell_{2i+d})
        self.cells = nn.ModuleList(LSTMCell(H, H)
                                   for _ in range(2 * cfg.num_layers))
        self.merges = nn.ModuleList(Dense(2 * H, H, dt)
                                    for _ in range(cfg.num_layers))
        self.pool_ln = LayerNorm(H, dt)
        self.head = Dense(H, 1, torch.float32)

    def _bilayer(self, x: torch.Tensor, lengths: torch.Tensor, layer: int):
        """One BiLSTM layer: x [R, T, H] → (fwd, bwd) [R, T, H]."""
        dt = self.cfg.dtype
        R, T, _ = x.shape
        H = self.cfg.hidden
        fw, bw = self.cells[2 * layer], self.cells[2 * layer + 1]
        wi = torch.stack([fw.weight_ih.t(), bw.weight_ih.t()]).to(dt)   # [2,in,4H]
        wh = torch.stack([fw.weight_hh.t(), bw.weight_hh.t()]).to(dt)   # [2,H,4H]
        bias = torch.stack([fw.bias_ih + fw.bias_hh,
                            bw.bias_ih + bw.bias_hh]).to(dt)[:, None, :]
        # the input projection of every step, hoisted out of the loop: one
        # product a direction over all T, time-major so each step reads one
        # [2, R, 4H] slice
        xs = torch.stack([x, _flip_valid(x, lengths)])                  # [2,R,T,in]
        xs = xs.transpose(1, 2).reshape(2, T * R, -1)                   # [2,T·R,in]
        xin = torch.bmm(xs, wi).view(2, T, R, 4 * H)
        h = torch.zeros(2, R, H, dtype=dt, device=x.device)
        c = torch.zeros_like(h)
        hs = torch.empty(T, 2, R, H, dtype=dt, device=x.device)
        for t in range(T):
            gates = xin[:, t] + torch.bmm(h, wh) + bias
            gi, gf, gg, go = gates.chunk(4, dim=-1)
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
            hs[t] = h
        hs = hs.permute(1, 2, 0, 3)                                     # [2,R,T,H]
        return hs[0], _flip_valid(hs[1], lengths)

    def forward(self, seq_feat: torch.Tensor, seq_mask: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        dt = self.cfg.dtype
        lead = seq_feat.shape[:-2]
        T = seq_feat.shape[-2]
        feat = seq_feat.reshape(-1, T, seq_feat.shape[-1])
        mask = seq_mask.reshape(-1, T)
        x = gelu(self.in_proj(feat)) * mask[..., None].to(dt)
        # left-padded input → prefix-first layout, so "lengths" bounds the
        # valid prefix
        lengths = mask.sum(-1)
        x = torch.flip(x, dims=(-2,))
        mask_pf = torch.flip(mask, dims=(-1,))[..., None].to(dt)
        for i, merge in enumerate(self.merges):
            fwd, bwd = self._bilayer(x, lengths, i)
            x = gelu(merge(torch.cat([fwd, bwd], dim=-1))) * mask_pf
        pooled = (x * mask_pf).sum(-2) / torch.clamp_min(mask_pf.sum(-2), 1.0)
        pooled = dropout(self.pool_ln(pooled), self.cfg.dropout, dropout_gen)
        logit = self.head(pooled)[..., 0]
        return {"seq_logit": logit.reshape(lead),
                "seq_emb": pooled.float().reshape(*lead, -1)}
