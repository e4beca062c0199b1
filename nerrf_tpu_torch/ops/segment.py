"""Sparse neighbour-aggregation ops: the port's counterpart of
``nerrf_tpu/ops/segment.py`` and the three TPU kernels behind it.

Each op takes one window (2-D operands) or a batch of windows (a leading
batch dimension) and has two versions:

* the CUDA kernel (``csrc/<op>.cu``, bound in :mod:`.kernels`), launched when
  the operands lie on a CUDA device: one launch per call, the whole batch in
  its grid, counted in :data:`LAUNCHES`;
* the plain PyTorch version (``<op>_plain``), run when the operands lie on
  the CPU.  It is the reference the kernel is held against.

There is no fallback between them: a CUDA operand launches the kernel or
raises.  :func:`plain_ops` runs the plain versions on the card on purpose,
for comparing a forward against its kernels.

Source notes (the kernels' own files say more):

``segment_sum``
    replaces ``pallas_segment._segment_sum_call``.  Bound by bytes on the
    H100 (data + ids + out over 3.35 TB/s).  The wrapper stable-sorts the ids
    and takes row pointers; the kernel reduces each segment's run in f32 with
    no atomics, so it is deterministic.
``gather_rows``
    replaces ``pallas_segment._gather_call``.  Bound by bytes (touched table
    rows + idx + out); a coalesced element-per-thread copy.
``sage_aggregate``
    replaces ``pallas_segment._sage_call`` (``sage_aggregate_fused``).  Bound
    by bytes (msg + ids + weights + out); one warp per output row walks the
    row's band in both sorted edge views, with row pointers taken once per
    forward (:func:`sage_row_ptrs`), skips weight-0 edges (the builder's
    padding) and sums in f32 registers.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from nerrf_tpu_torch.device import resolve_device
from nerrf_tpu_torch.ops import kernels

# Kernel launches per op since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {"sage_aggregate": 0, "gather_rows": 0,
                            "segment_sum": 0}
_FORCE_PLAIN = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def plain_ops():
    """Run the plain PyTorch versions on CUDA operands too, inside the block
    (to compare a forward with its kernels)."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


def active_impls(device=None) -> Dict[str, str]:
    """Which version serves each op for operands on ``device``: ``cuda`` (the
    kernel) or ``plain``."""
    dev = resolve_device(device)
    kind = "cuda" if dev.type == "cuda" and not _FORCE_PLAIN else "plain"
    return {op: kind for op in LAUNCHES}


def _use_kernel(op: str, *ts: torch.Tensor) -> bool:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"{op}: operands on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return not _FORCE_PLAIN
    raise RuntimeError(f"{op}: no kernel or plain version for {dev}")


def _batched(*ts: torch.Tensor) -> Tuple[bool, tuple]:
    """Add the batch dimension to one window's operands (the first operand
    is 2-D for one window, 3-D for a batch)."""
    single = ts[0].dim() == 2
    return single, tuple(t[None] for t in ts) if single else ts


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _window_offsets(B: int, n: int, device) -> torch.Tensor:
    return (torch.arange(B, device=device, dtype=torch.int64) * n)[:, None]


# --- segment_sum -------------------------------------------------------------


def segment_sum_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """[B, S, F] rows → [B, num_segments, F] sums in f32, cast back to
    ``data``'s type; ids outside [0, num_segments) are dropped (as
    ``jax.ops.segment_sum`` drops them — ``index_add_`` itself would raise)."""
    B, S, F = data.shape
    out = torch.zeros(B * num_segments, F, dtype=torch.float32,
                      device=data.device)
    if num_segments and S:
        ok = (segment_ids >= 0) & (segment_ids < num_segments)
        flat = torch.where(ok, segment_ids.long()
                           + _window_offsets(B, num_segments, data.device), 0)
        rows = torch.where(ok[..., None], data.float(), 0.0)
        out.index_add_(0, flat.reshape(-1), rows.reshape(-1, F))
    return out.view(B, num_segments, F).to(data.dtype)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of ``data`` ([S, F], or [B, S, F] per window) into
    ``num_segments`` buckets by ``segment_ids``; order-independent, ids
    outside [0, num_segments) dropped."""
    single, (data, segment_ids) = _batched(data, segment_ids)
    if _use_kernel("segment_sum", data, segment_ids):
        out = _segment_sum_cuda(data, segment_ids, num_segments)
    else:
        out = segment_sum_plain(data, segment_ids, num_segments)
    return out[0] if single else out


def _segment_sum_cuda(data, segment_ids, num_segments):
    B, S, F = data.shape
    data = data.contiguous()
    kernels.dtype_code(data)
    sorted_ids, perm = torch.sort(_int32(segment_ids), dim=1, stable=True)
    ptr = torch.searchsorted(
        sorted_ids,
        torch.arange(num_segments + 1, dtype=torch.int32, device=data.device)
        .expand(B, -1).contiguous(), out_int32=True)
    out = torch.empty(B, num_segments, F, dtype=data.dtype, device=data.device)
    if out.numel():
        kernels.launch_segment_sum(data, ptr, _int32(perm), num_segments, out)
        LAUNCHES["segment_sum"] += 1
    return out


# --- gather_rows -------------------------------------------------------------


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[b, idx[b]]`` for [B, N, F] / [B, E]; out-of-range idx gives a
    zero row (as the TPU kernel's one-hot product does)."""
    B, N, F = table.shape
    ok = (idx >= 0) & (idx < N)
    safe = torch.where(ok, idx.long(), 0)
    if N == 0:
        return torch.zeros(B, idx.shape[1], F, dtype=table.dtype,
                           device=table.device)
    rows = torch.gather(table, 1, safe[..., None].expand(-1, -1, F))
    return torch.where(ok[..., None], rows, torch.zeros((), dtype=table.dtype,
                                                        device=table.device))


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``table[idx]`` ([N, F] / [E], or batched per window)."""
    single, (table, idx) = _batched(table, idx)
    if _use_kernel("gather_rows", table, idx):
        table = table.contiguous()
        kernels.dtype_code(table)
        out = torch.empty(table.shape[0], idx.shape[1], table.shape[2],
                          dtype=table.dtype, device=table.device)
        if out.numel():
            kernels.launch_gather_rows(table, _int32(idx), out)
            LAUNCHES["gather_rows"] += 1
    else:
        out = gather_rows_plain(table, idx)
    return out[0] if single else out


# --- sage_aggregate ----------------------------------------------------------


def sage_row_ptrs(dst_ids: torch.Tensor, src_ids: torch.Tensor,
                  num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row pointers [B, num_nodes + 1] (int32) of the two nondecreasing id
    vectors: node n's edges in either view are ``[ptr[n], ptr[n+1])``.  Ids
    outside [0, num_nodes) fall outside every row (the TPU kernel's
    ``_band_ptrs`` convention).  Graph structure: take them once per
    forward and pass them to every layer's :func:`sage_aggregate`."""
    B = dst_ids.shape[0]
    nodes = torch.arange(num_nodes + 1, dtype=torch.int32,
                         device=dst_ids.device).expand(B, -1).contiguous()
    return (torch.searchsorted(_int32(dst_ids), nodes, out_int32=True),
            torch.searchsorted(_int32(src_ids), nodes, out_int32=True))


def sage_aggregate_plain(msg, dst_ids, src_by_dst, src_ids, dst_by_src,
                         wf_d, wf_s, wr_s, wr_d, num_nodes):
    """Gather + segment-sum composition of :func:`sage_aggregate` (the
    counterpart of ``segment.sage_aggregate_xla``); ``wf_s``/``wr_d`` are
    unused forward."""
    del wf_s, wr_d
    m = msg.float()
    fwd = segment_sum_plain(wf_d[..., None].float()
                            * gather_rows_plain(m, src_by_dst),
                            dst_ids, num_nodes)
    rev = segment_sum_plain(wr_s[..., None].float()
                            * gather_rows_plain(m, dst_by_src),
                            src_ids, num_nodes)
    return (fwd + rev).to(msg.dtype)


def sage_aggregate(msg, dst_ids, src_by_dst, src_ids, dst_by_src,
                   wf_d, wf_s, wr_s, wr_d, num_nodes: int, *,
                   row_ptrs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Fused bidirectional SAGE aggregation over pre-sorted edge views::

        out[n] = Σ_{e: dst(e)=n} wf(e)·msg[src(e)] + Σ_{e: src(e)=n} wr(e)·msg[dst(e)]

    Same contract as the JAX package's ``ops.sage_aggregate``: ``(dst_ids,
    src_by_dst)`` is the dst-sorted edge list, ``(src_ids, dst_by_src)`` the
    src-sorted view, weights pre-normalized, each in both orders
    (``wf_s``/``wr_d`` serve the adjoint and are unused forward).  Sortedness
    of ``dst_ids``/``src_ids`` is a contract; ``msg`` has ``num_nodes`` rows.
    An edge of weight 0 adds nothing (the kernel skips it; the plain version
    adds 0·msg, the same for finite ``msg``).
    ``row_ptrs`` are :func:`sage_row_ptrs` of the two id vectors, taken here
    when not given."""
    single, (msg, dst_ids, src_by_dst, src_ids, dst_by_src,
             wf_d, wf_s, wr_s, wr_d) = _batched(
        msg, dst_ids, src_by_dst, src_ids, dst_by_src, wf_d, wf_s, wr_s, wr_d)
    if not _use_kernel("sage_aggregate", msg, dst_ids, src_ids, wf_d, wr_s):
        out = sage_aggregate_plain(msg, dst_ids, src_by_dst, src_ids,
                                   dst_by_src, wf_d, wf_s, wr_s, wr_d,
                                   num_nodes)
        return out[0] if single else out
    if msg.shape[1] != num_nodes:
        raise ValueError(f"sage_aggregate: msg has {msg.shape[1]} rows, "
                         f"num_nodes is {num_nodes}")
    msg = msg.contiguous()
    kernels.dtype_code(msg)
    if row_ptrs is None:
        row_ptrs = sage_row_ptrs(dst_ids, src_ids, num_nodes)
    ptr_f, ptr_r = (_int32(p) for p in row_ptrs)
    out = torch.empty_like(msg)
    if out.numel():
        kernels.launch_sage_aggregate(
            msg, ptr_f, _int32(src_by_dst), wf_d.float().contiguous(),
            ptr_r, _int32(dst_by_src), wr_s.float().contiguous(), out)
        LAUNCHES["sage_aggregate"] += 1
    return out[0] if single else out
