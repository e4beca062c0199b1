"""StreamNet: the long-context per-event detector over whole traces, the port
of ``nerrf_tpu/models/stream.py``.

A pre-LN causal transformer over a trace's event stream (``data/stream.py``):
every event attends to all events before it, so slow-burn structure across
windows (recon minutes before encryption) reaches one model.  Each block is
LayerNorm → one ``qkv`` projection split into q, k, v (``head`` h is the
contiguous slice ``[h·D, (h+1)·D)`` of each) → causal attention
(:func:`~nerrf_tpu_torch.parallel.ring.ring_self_attention`, the CUDA
kernels on the card) → ``proj`` → dropout → residual, then LayerNorm → MLP
(×``mlp_mult``, tanh GELU) → dropout → residual.  Dense layers compute in
``cfg.dtype`` over float32 params, LayerNorms keep float32 statistics with
eps 1e-6 (``models/layers.py``), and the head computes in float32.

``cfg.remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, ``use_reentrant=False``): the forward keeps
only the blocks' inputs.  Dropout draws from an explicit ``torch.Generator``
that ``checkpoint`` does not restore, so a block's two masks are drawn
before the block runs and passed in: the recompute applies the same masks,
and the gradients with remat are those without.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from nerrf_tpu_torch.data.stream import STREAM_FEATURE_DIM
from nerrf_tpu_torch.device import resolve_device
from nerrf_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    apply_dropout,
    dropout_mask,
    gelu,
    init_params_,
)
from nerrf_tpu_torch.parallel.ring import ring_self_attention


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    dim: int = 128
    # one 128-wide head (the reference's choice: width over head count)
    num_heads: int = 1
    num_layers: int = 4
    mlp_mult: int = 4
    dropout: float = 0.1
    dtype: Any = torch.bfloat16
    # recompute each block in the backward pass (activation memory of the
    # blocks' inputs only)
    remat: bool = True


class _Block(nn.Module):
    def __init__(self, cfg: StreamConfig) -> None:
        super().__init__()
        self.cfg = cfg
        dim, dt = cfg.dim, cfg.dtype
        self.attn_ln = LayerNorm(dim, dt)
        self.qkv = Dense(dim, 3 * dim, dt)
        self.proj = Dense(dim, dim, dt)
        self.mlp_ln = LayerNorm(dim, dt)
        self.mlp_in = Dense(dim, cfg.mlp_mult * dim, dt)
        self.mlp_out = Dense(cfg.mlp_mult * dim, dim, dt)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                mlp_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        h = cfg.num_heads
        y = self.attn_ln(x)
        q, k, v = self.qkv(y).split(cfg.dim, dim=-1)
        shape = y.shape[:-1] + (h, cfg.dim // h)
        out = ring_self_attention(q.reshape(shape), k.reshape(shape),
                                  v.reshape(shape), causal=True)
        out = self.proj(out.reshape(y.shape))
        x = x + apply_dropout(out, attn_mask, cfg.dropout)

        y = self.mlp_ln(x)
        y = self.mlp_out(gelu(self.mlp_in(y)))
        return x + apply_dropout(y, mlp_mask, cfg.dropout)


class StreamNet(nn.Module):
    """[B, T, F] event-stream features and a [B, T] mask (True = a real
    event; padding trails) → ``event_logits`` [B, T] (0 off the mask) and
    ``stream_logit`` [B] (the max over the valid events).  A training
    forward passes ``dropout_gen``, a ``torch.Generator`` on the model's
    device; without it the forward is deterministic."""

    def __init__(self, cfg: StreamConfig = StreamConfig()) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = Dense(STREAM_FEATURE_DIM, cfg.dim, cfg.dtype)
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(cfg.dim, cfg.dtype)
        self.head = Dense(cfg.dim, 1, torch.float32)

    def forward(self, feat: torch.Tensor, mask: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        x = gelu(self.embed(feat))
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.blocks:
            masks = [dropout_mask(x.shape, cfg.dropout, dropout_gen, x.device)
                     for _ in range(2)]
            if remat:
                x = checkpoint(block, x, *masks, use_reentrant=False)
            else:
                x = block(x, *masks)
        logits = self.head(self.final_ln(x))[..., 0]
        logits = torch.where(mask, logits, 0.0)
        # an attack trace is one whose stream holds attack events
        stream_logit = torch.where(mask, logits, -1e30).amax(dim=-1)
        return {"event_logits": logits, "stream_logit": stream_logit}


def build_streamnet(cfg: StreamConfig = StreamConfig(), seed: int = 0,
                    device=None) -> StreamNet:
    """A StreamNet with params drawn as flax's initializers draw them (kinds,
    not bits) from a ``torch.Generator`` seeded with ``seed``, on ``device``
    (the card unless ``device='cpu'``)."""
    dev = resolve_device(device)
    model = StreamNet(cfg)
    init_params_(model, torch.Generator().manual_seed(seed))
    return model.to(dev)


def stream_loss(outputs: Dict[str, torch.Tensor], labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Masked per-event sigmoid BCE; ``labels`` float32 [B, T] in {0, 1}."""
    from nerrf_tpu_torch.train.loop import _weighted_bce

    return _weighted_bce(outputs["event_logits"], labels, mask.float(), 1.0)
