"""Self-attention over [B, T, H, D] for StreamNet: the single-card half of
the reference's ``nerrf_tpu/parallel/ring.py``.

At ``sp`` = 1 the reference's ``ring_self_attention`` runs
``_attention_local`` (exact attention, blockwise with an online softmax
above T = 1024); here both names run :func:`~nerrf_tpu_torch.ops.attention.
causal_attention`, the hand-written CUDA kernels on the card and the plain
version on the CPU.  The ring over the ``sp`` axis (``_ring_shard``: K/V
blocks passed between devices) is not ported: a mesh whose ``sp`` is above 1
raises (ROADMAP A.7, the ``sp`` ring over DDP).
"""

from __future__ import annotations

import torch

from nerrf_tpu_torch.ops.attention import causal_attention


def _attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool) -> torch.Tensor:
    """Exact single-device attention (the reference's ``_attention_local``)."""
    return causal_attention(q, k, v, causal)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh=None, *, causal: bool = True) -> torch.Tensor:
    """Exact attention over [B, T, H, D] on one card.  ``mesh``: None or a
    ``config.MeshConfig``; an ``sp`` axis above 1 raises (the ``sp`` ring is
    ROADMAP A.7)."""
    if mesh is not None and mesh.sp != 1:
        raise NotImplementedError(
            f"ring attention over an sp axis of {mesh.sp} devices is not ported "
            "(ROADMAP A.7: the sp ring over DDP); the port runs StreamNet on one card")
    return _attention_local(q, k, v, causal)
