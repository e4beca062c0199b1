"""Exact softmax attention over [B, T, H, D]: the port of the reference's
single-device attention, ``nerrf_tpu/parallel/ring.py`` ``_attention_local``
(an XLA program, not a Pallas kernel), which StreamNet runs in every layer.

:func:`causal_attention` (``causal`` a flag; StreamNet passes True) has two
versions, as the sparse ops of :mod:`.segment` do:

* on CUDA tensors, :class:`CausalAttention`, an autograd Function over the
  three entry points of ``csrc/flash_attention.cu``: ``attention_fwd`` (O and
  the rows' log-sum-exp, the scores never leaving the chip) in the forward,
  ``attention_bwd_dq`` and ``attention_bwd_dkdv`` in the backward, each
  launch counted in :data:`LAUNCHES`; a failed build or launch raises;
* on CPU tensors, :func:`attention_dense`, the plain version: the
  reference's ``_attention_dense`` on inputs upcast to float32 (as
  ``_attention_local`` runs it for T <= 1024), the [B, H, T, T] scores
  materialised, masked with -1e30, a softmax, the product with V, the result
  cast back.  It is what the kernels are held against, on the card inside
  ``ops.plain_ops()``.

No fallback joins them.  The kernels take one of two routes, fixed by the
type and the head width (``kernels.attention_route``): bfloat16 at D = 64
and 128 runs all three entries on the tensor cores, which round P to
bfloat16 before P·V (the denominator summed from the float32 P), as the
reference's blockwise path (T > 1024) does (``ring.py:109-111``), and Pᵀ
and dSᵀ before dV += Pᵀ·dO and dK += dSᵀ·Q; dQ += dS·K takes dS as two
bfloat16 parts, hi + lo (about 16 bits: with dS rounded once to bfloat16
the stream probe's held-out AUC fell below its gate at one init seed of
eight, PERF.md); float32 at every width and
bfloat16 at D = 16 and 32 keep P and dS in float32, as the plain version
and the reference's T <= 1024 path do.  The bfloat16 tolerance covers the
rounding (``tests/test_torch_stream.py`` emulates it).

Layout: q, k and v may be strided views (StreamNet's are slices of one
``qkv`` projection) as long as they share their strides and D is
contiguous; otherwise they are copied contiguous first.  On the
tensor-core route they are read by TMA, which takes 16-byte-aligned bases
and strides that are multiples of 16 bytes (StreamNet's views are):
``kernels.launch_attention`` raises on others.  O and the gradients come
out contiguous.
"""

from __future__ import annotations

from typing import Dict

import torch

from nerrf_tpu_torch.ops import kernels
from nerrf_tpu_torch.ops.segment import _use_kernel

# Kernel launches since the last reset_launches(); a wrapper adds one where
# it launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {"attention_fwd": 0, "attention_bwd_dq": 0,
                            "attention_bwd_dkdv": 0}
_NEG = -1e30


def reset_launches() -> None:
    kernels.reset_counts(LAUNCHES)


def attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    """Materialised attention in float32 over [B, T, H, D], returned in
    ``q``'s type.  O(T²) memory: tests, checks and the CPU only."""
    dt = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        scores = torch.where(keep, scores, torch.full((), _NEG, device=q.device))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).to(dt)


def _one_layout(q, k, v):
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"attention: q, k, v of types {q.dtype}, {k.dtype}, {v.dtype}")
    kernels.dtype_code(q)
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"attention: q, k, v of shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}; the kernel takes one "
                         "[B, T, H, D]")
    if q.stride() == k.stride() == v.stride() and q.stride(-1) == 1:
        return q, k, v
    return q.contiguous(), k.contiguous(), v.contiguous()


def _launch(name: str, q, *args, **kw) -> None:
    kernels.launch_attention(name, q, *args, **kw)
    kernels.count_launch(LAUNCHES, name)


class CausalAttention(torch.autograd.Function):
    """The kernels' autograd Function (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = _one_layout(q, k, v)
        B, T, H, D = q.shape
        scale = D ** -0.5
        o = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
        lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
        if o.numel():
            _launch("attention_fwd", q, k, v, causal, scale, o, lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(o.dtype).contiguous()
        dq, dk, dv = (torch.empty_like(o) for _ in range(3))
        if o.numel():
            # rowsum(dO∘O), written by the tensor-core attention_bwd_dq,
            # read by the tensor-core attention_bwd_dkdv
            delta = torch.empty_like(lse)
            rows = dict(o=o, dout=do, lse=lse, delta=delta)
            _launch("attention_bwd_dq", q, k, v, ctx.causal, ctx.scale, dq, **rows)
            _launch("attention_bwd_dkdv", q, k, v, ctx.causal, ctx.scale, dk, dv,
                    **rows)
        return dq, dk, dv, None


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True) -> torch.Tensor:
    """softmax(q·kᵀ / sqrt(D), causal mask when ``causal``)·v over [B, T, H,
    D], in ``q``'s type: the kernels on CUDA tensors, :func:`attention_dense`
    on CPU tensors."""
    if _use_kernel("attention", q, k, v):
        return CausalAttention.apply(q, k, v, causal)
    return attention_dense(q, k, v, causal)
