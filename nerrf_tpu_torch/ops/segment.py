"""Sparse neighbour-aggregation ops: the port's counterpart of
``nerrf_tpu/ops/segment.py`` and the five TPU kernels behind it.

Each op takes one window (2-D operands) or a batch of windows (a leading
batch dimension) and has two versions:

* the CUDA kernel (``csrc/<op>.cu``, bound in :mod:`.kernels`), launched when
  the operands lie on a CUDA device: one launch per call, the whole batch in
  its grid, counted in :data:`LAUNCHES`;
* the plain PyTorch version (``<op>_plain``), run when the operands lie on
  the CPU.  It is the reference the kernel is held against.

Operands on the ``meta`` device take the plain version's shape logic too:
the cost model (`devtime.costmodel`) traces a forward on meta tensors to
count its matmuls, and a meta tensor holds no data for a kernel to read.
That is a shape trace, not a fallback: nothing runs and nothing launches.

There is no fallback between them: a CUDA operand launches the kernel or
raises.  :func:`plain_ops` runs the plain versions on the card on purpose,
for comparing a forward against its kernels.

Every op is a ``torch.autograd.Function`` on both devices, differentiable in
its data operand (``data``/``table``/``msg``) only: ids and weights are graph
structure, as in the reference's ``custom_vjp``s.  Its backward calls the
adjoint *op*, which dispatches the same way, so the CPU runs the same
pairing as the card:

* ``segment_sum`` ↔ ``gather_rows`` (each other's adjoint);
* ``segment_sum_sorted`` ↔ ``gather_rows_sorted`` (the banded pair);
* ``sage_aggregate`` → ``sage_aggregate`` with the two directions' weights
  exchanged across the two sorted views, over the same row pointers.

Graph structure is taken once per forward: :func:`segment_plan` of an id
vector holds its stable sort permutation (none for sorted ids) and its row
pointers, from which the two segment-sum kernels take their chunk map on
the card (:meth:`SegmentPlan.chunks` spells it out; ``sage_aggregate``
takes the same map over both views' pointers, :func:`sage_chunks`).  ``segment_sum``,
``segment_sum_sorted``, ``gather_rows``, ``gather_rows_sorted`` and
``segment_mean`` take it as ``plan=`` (a gather keeps it for its backward,
the adjoint sum); without one the CUDA path builds it per call (a sort and
a ``searchsorted``, or the ``searchsorted`` alone).  The plain versions
ignore it.  L = :data:`CHUNK_ROWS` = 32 rows per chunk: one chunk map
serves every row width, a chunk's 32 permuted row numbers are one coalesced
load, and the longest segment costs one warp 32 rows plus the add of its
partials, ceil(len / 32) + 1 rows of f32 at most.

Source notes (the kernels' own files say more):

``segment_sum``
    replaces ``pallas_segment._segment_sum_call``.  Bound by bytes on the
    H100 (data + ids + out over 3.35 TB/s).  Design (``csrc/segment_chunks.cuh``):
    the plan's stable sort permutation and row pointers make each segment a
    contiguous run; every segment is cut into chunks of at most 32 rows,
    one warp each, so no long segment (the builder's padding tail, the
    fusion's slot N) is left to one warp; the chunks of a long segment
    write f32 partials that the last chunk to arrive adds in chunk order
    (one launch; a second launch for the combine measured slower on the
    H100).  f32 sums in a fixed order, no atomics on values: deterministic.
``gather_rows``
    replaces ``pallas_segment._gather_call``.  Bound by bytes (touched table
    rows + idx + out).  Design (``csrc/gather_rows.cuh``, shared with
    ``gather_rows_sorted``): a copy of bits, one thread per 16-byte pack of
    an output row (a row's packs on consecutive lanes, its id loaded once),
    32-bit index math, a grid sized from the pack count; rows that are no
    multiple of 16 bytes, or a table off 16-byte alignment, take the 4-byte
    or element-wise layout of the same kernel.  Bit-equal to the plain
    version.
``sage_aggregate``
    replaces ``pallas_segment._sage_call`` (``sage_aggregate_fused``).  Bound
    by bytes (msg + ids + weights + out).  Design: the same chunked
    reduction over one row space that joins both sorted edge views (node
    n's dst-view band, then its src-view band; :func:`sage_chunks` spells
    out the map), so no long band is left to one warp; a chunk's weight-0
    edges (the builder's padding) are dropped before the loads, and a
    chunk of nothing but padding writes no partial.  Row pointers are
    taken once per forward (:func:`sage_row_ptrs`, or the two views'
    segment plans).
``segment_sum_sorted``
    replaces ``pallas_segment._segment_sum_sorted_call``.  Bound by bytes.
    The same chunked reduction with the identity permutation: the ids are
    nondecreasing (a contract), so its plan has no sort.  Rows of 16
    features or fewer (the F = 1 weight denominators) go lanes over rows.
``gather_rows_sorted``
    replaces ``pallas_segment._gather_sorted_call``, the banded sum's
    adjoint.  Bound by bytes.  The row copy of ``gather_rows``: the band the
    TPU kernel walks to bound its one-hot product is free on the card, and
    the sorted ids change nothing in the copy (the padding tail's repeated
    row is served by L1 and L2).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from nerrf_tpu_torch.device import resolve_device
from nerrf_tpu_torch.ops import kernels

# Kernel launches per op since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {"sage_aggregate": 0, "gather_rows": 0,
                            "segment_sum": 0, "segment_sum_sorted": 0,
                            "gather_rows_sorted": 0}
_FORCE_PLAIN = False


def reset_launches() -> None:
    kernels.reset_counts(LAUNCHES)


@contextlib.contextmanager
def plain_ops():
    """Run the plain PyTorch versions on CUDA operands too, inside the block
    (to compare a forward, or a backward, with its kernels)."""
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
    if dev.type in ("cpu", "meta"):  # meta: a shape trace, no data to read
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


def _row_numbers(B: int, num_rows: int, device: torch.device) -> torch.Tensor:
    """[B, num_rows + 1] int32 row numbers, made once per calling stream:
    a tensor made on one stream may not have been written yet when another
    stream reads it (serve's scorer and a retrain worker run on two)."""
    stream = kernels._stream(device) if device.type == "cuda" else 0
    return _row_numbers_on(B, num_rows, device, stream)


@functools.lru_cache(maxsize=32)
def _row_numbers_on(B: int, num_rows: int, device: torch.device,
                    stream: int) -> torch.Tensor:
    return torch.arange(num_rows + 1, dtype=torch.int32,
                        device=device).expand(B, -1).contiguous()


def _row_ptrs(sorted_ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """[B, num_rows + 1] int32 pointers into nondecreasing [B, E] ids: row
    n's entries are ``[ptr[n], ptr[n+1])``; ids outside [0, num_rows) fall
    outside every row."""
    rows = _row_numbers(sorted_ids.shape[0], num_rows, sorted_ids.device)
    return torch.searchsorted(_int32(sorted_ids), rows, out_int32=True)


CHUNK_ROWS = kernels.CHUNK_ROWS


class SegmentPlan(NamedTuple):
    """Graph structure of one [B, S] id vector over N segments, for the
    segment-sum kernels and the gathers' backward.

    ``perm`` [B, S] int64 is the stable sort order of the ids (``None`` when
    they are nondecreasing); ``ptr`` [B, N + 1] int32 the row pointers over
    the sorted ids (ids outside [0, N) fall outside every row), from which
    the kernels take the chunk map (:meth:`chunks`)."""

    perm: Optional[torch.Tensor]
    ptr: torch.Tensor
    num_rows: int

    @property
    def num_segments(self) -> int:
        return self.ptr.shape[1] - 1

    @property
    def num_chunk_slots(self) -> int:
        """N + ceil(S / CHUNK_ROWS): the kernels' grid, in warps per window."""
        return self.num_segments + -(-self.num_rows // CHUNK_ROWS)

    def chunks(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The chunk map the kernels derive from ``ptr``, as [B, K] tensors
        (segment, lo, hi) per chunk slot, segment -1 where no segment owns
        the slot (:func:`_chunk_map`)."""
        return _chunk_map(self.ptr, self.num_chunk_slots)


def _chunk_map(ptr: torch.Tensor, K: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chunked reductions' map over row pointers ``ptr`` [B, N + 1]: the
    rows are cut at multiples of CHUNK_ROWS and at the segment boundaries,
    so segment n owns slots [n + ptr[n] // CHUNK_ROWS, n + 1 + ptr[n + 1] //
    CHUNK_ROWS), the exclusive prefix sum of its chunk counts in closed
    form.  (segment, lo, hi) per slot as [B, K] tensors, segment -1 where
    no segment owns the slot."""
    L, N = CHUNK_ROWS, ptr.shape[1] - 1
    ptr = ptr.long()
    start = torch.arange(N + 1, device=ptr.device) + ptr // L
    k = torch.arange(K, device=ptr.device).expand(ptr.shape[0], -1)
    n = torch.searchsorted(start.contiguous(), k.contiguous(), right=True) - 1
    owned = (n >= 0) & (n < N)
    n = n.clamp(0, max(N - 1, 0))
    p0 = torch.gather(ptr, 1, n)
    p1 = torch.gather(ptr, 1, n + 1) if N else p0
    tile = p0 // L + (k - torch.gather(start, 1, n))
    lo = torch.maximum(p0, tile * L)
    hi = torch.minimum(p1, (tile + 1) * L)
    return (torch.where(owned, n, -1), torch.where(owned, lo, 0),
            torch.where(owned, hi, 0))


def segment_plan(ids: torch.Tensor, num_segments: int, *,
                 sorted_ids: bool = False) -> SegmentPlan:
    """The :class:`SegmentPlan` of ``ids`` ([S], or [B, S] per window):
    graph structure, so take it once per forward and pass it to every op
    over the same ids.  ``sorted_ids=True`` asserts the ids are
    nondecreasing per window (no sort; such a plan also serves
    :func:`segment_sum` and :func:`gather_rows`).  Plain PyTorch, on the
    ids' device, with no host synchronisation."""
    ids = _int32(ids[None] if ids.dim() == 1 else ids)
    perm, keys = None, ids
    if not sorted_ids:
        keys, perm = torch.sort(ids, dim=1, stable=True)
    return SegmentPlan(perm=perm, ptr=_row_ptrs(keys, num_segments),
                       num_rows=ids.shape[1])


def _check_plan(op: str, plan: Optional[SegmentPlan], ids: torch.Tensor,
                num_segments: int, *, sorted_only: bool = False) -> None:
    if plan is None:
        return
    B, S = ids.shape
    if tuple(plan.ptr.shape) != (B, num_segments + 1) or plan.num_rows != S:
        raise ValueError(
            f"{op}: the plan covers {plan.ptr.shape[0]} windows of "
            f"{plan.num_rows} ids over {plan.num_segments} segments; the "
            f"operands have {B} of {S} over {num_segments}")
    if sorted_only and plan.perm is not None:
        raise ValueError(f"{op}: takes the plan of nondecreasing ids "
                         "(segment_plan(..., sorted_ids=True))")


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


def _segment_sum_cuda(name, data, segment_ids, num_segments, plan):
    B, S, F = data.shape
    data = data.contiguous()
    kernels.dtype_code(data)
    if plan is None:
        plan = segment_plan(segment_ids, num_segments,
                            sorted_ids=name == "segment_sum_sorted")
    out = torch.empty(B, num_segments, F, dtype=data.dtype, device=data.device)
    if out.numel():
        kernels.launch_segment_sum(name, data, plan, out)
        kernels.count_launch(LAUNCHES, name)
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, plan):
        ctx.save_for_backward(segment_ids)
        ctx.plan = plan
        if _use_kernel("segment_sum", data, segment_ids):
            return _segment_sum_cuda("segment_sum", data, segment_ids,
                                     num_segments, plan)
        return segment_sum_plain(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return gather_rows(g, segment_ids, plan=ctx.plan), None, None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """Sum rows of ``data`` ([S, F], or [B, S, F] per window) into
    ``num_segments`` buckets by ``segment_ids``; order-independent, ids
    outside [0, num_segments) dropped.  ``plan``: :func:`segment_plan` of
    the ids (either kind), built here when not given.  Backward:
    :func:`gather_rows`."""
    single, (data, segment_ids) = _batched(data, segment_ids)
    _check_plan("segment_sum", plan, segment_ids, num_segments)
    out = _SegmentSum.apply(data, segment_ids, num_segments, plan)
    return out[0] if single else out


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


def _gather_cuda(name: str, table, idx):
    table = table.contiguous()
    kernels.dtype_code(table)
    out = torch.empty(table.shape[0], idx.shape[1], table.shape[2],
                      dtype=table.dtype, device=table.device)
    if out.numel():
        kernels.launch_gather(name, table, _int32(idx), out)
        kernels.count_launch(LAUNCHES, name)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, plan):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[1]
        ctx.plan = plan
        if _use_kernel("gather_rows", table, idx):
            return _gather_cuda("gather_rows", table, idx)
        return gather_rows_plain(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return segment_sum(g, idx, ctx.num_rows, plan=ctx.plan), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor, *,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """Row gather ``table[idx]`` ([N, F] / [E], or batched per window);
    out-of-range idx gives a zero row.  Backward: :func:`segment_sum`, over
    ``plan`` (:func:`segment_plan` of ``idx`` into N rows) when given."""
    single, (table, idx) = _batched(table, idx)
    _check_plan("gather_rows", plan, idx, table.shape[1])
    out = _GatherRows.apply(table, idx, plan)
    return out[0] if single else out


# --- segment_sum_sorted / gather_rows_sorted (the banded pair) ---------------


class _SegmentSumSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, plan):
        ctx.save_for_backward(segment_ids)
        ctx.plan = plan
        if _use_kernel("segment_sum_sorted", data, segment_ids):
            return _segment_sum_cuda("segment_sum_sorted", data, segment_ids,
                                     num_segments, plan)
        return segment_sum_plain(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return (gather_rows_sorted(g, segment_ids, plan=ctx.plan),
                None, None, None)


def segment_sum_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, *,
                       plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """:func:`segment_sum` for ``segment_ids`` nondecreasing per window (the
    builder's dst-sorted edges, or the src-sorted view): the banded kernel.
    Sortedness is a contract, not a hint: on unsorted ids the kernel drops
    rows (the plain version does not care).  ``plan``: the ids'
    ``segment_plan(..., sorted_ids=True)``, built here when not given.
    Backward: :func:`gather_rows_sorted`."""
    single, (data, segment_ids) = _batched(data, segment_ids)
    _check_plan("segment_sum_sorted", plan, segment_ids, num_segments,
                sorted_only=True)
    out = _SegmentSumSorted.apply(data, segment_ids, num_segments, plan)
    return out[0] if single else out


class _GatherRowsSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, plan):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[1]
        ctx.plan = plan
        if _use_kernel("gather_rows_sorted", table, idx):
            return _gather_cuda("gather_rows_sorted", table, idx)
        return gather_rows_plain(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return (segment_sum_sorted(g, idx, ctx.num_rows, plan=ctx.plan),
                None, None)


def gather_rows_sorted(table: torch.Tensor, idx: torch.Tensor, *,
                       plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """:func:`gather_rows` for ``idx`` nondecreasing per window: the banded
    sum's adjoint.  Backward: :func:`segment_sum_sorted`, over ``plan``
    (``segment_plan(idx, N, sorted_ids=True)``) when given."""
    single, (table, idx) = _batched(table, idx)
    _check_plan("gather_rows_sorted", plan, idx, table.shape[1],
                sorted_only=True)
    out = _GatherRowsSorted.apply(table, idx, plan)
    return out[0] if single else out


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, weights: Optional[torch.Tensor] = None,
                 *, sorted_ids: bool = False,
                 plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """(Weighted) mean aggregation, safe for empty segments: the reference's
    ``segment_mean``.  ``weights`` is [E] / [B, E] (or with a trailing 1);
    the numerator sums ``data · w`` and the denominator ``w``, each one
    segment sum over the same ``plan``.  ``sorted_ids=True`` routes both to
    :func:`segment_sum_sorted` (its contract), the default to the
    order-independent :func:`segment_sum`."""
    sum_fn = segment_sum_sorted if sorted_ids else segment_sum
    if weights is not None:
        w = weights[..., None] if weights.dim() == segment_ids.dim() else weights
        total = sum_fn(data * w, segment_ids, num_segments, plan=plan)
        denom = sum_fn(w, segment_ids, num_segments, plan=plan)
    else:
        total = sum_fn(data, segment_ids, num_segments, plan=plan)
        denom = sum_fn(torch.ones(data.shape[:-1] + (1,), dtype=data.dtype,
                                  device=data.device), segment_ids,
                       num_segments, plan=plan)
    return total / torch.clamp_min(denom, 1e-6)


# --- sage_aggregate ----------------------------------------------------------


def sage_row_ptrs(dst_ids: torch.Tensor, src_ids: torch.Tensor,
                  num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row pointers [B, num_nodes + 1] (int32) of the two nondecreasing id
    vectors: node n's edges in either view are ``[ptr[n], ptr[n+1])``.  Ids
    outside [0, num_nodes) fall outside every row (the TPU kernel's
    ``_band_ptrs`` convention).  Graph structure: take them once per
    forward and pass them to every layer's :func:`sage_aggregate`."""
    return _row_ptrs(dst_ids, num_nodes), _row_ptrs(src_ids, num_nodes)


def sage_chunks(ptr_f: torch.Tensor, ptr_r: torch.Tensor, num_edges: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chunk map ``sage_aggregate``'s kernel takes on the card, written
    out: both views of a window as one row space.  Both id vectors are
    nondecreasing, so ``q = ptr_f + ptr_r`` is itself a row pointer, and node
    n's merged rows [q[n], q[n + 1]) are its dst-view band followed by its
    src-view band; :func:`_chunk_map` cuts them over N + ceil(2E /
    CHUNK_ROWS) slots a window.  Returns [B, K] tensors (node, lo, hi, mid)
    per slot: merged row r of node n is dst-sorted edge r - ptr_r[n] when r
    < mid = ptr_f[n + 1] + ptr_r[n], else src-sorted edge r - ptr_f[n + 1]
    (node -1 and zeros where no node owns the slot)."""
    N = ptr_f.shape[1] - 1
    K = N + -(-2 * num_edges // CHUNK_ROWS)
    node, lo, hi = _chunk_map(ptr_f.long() + ptr_r.long(), K)
    n = node.clamp_min(0)
    mid = torch.gather(ptr_f.long(), 1, (n + 1).clamp_max(N)) + torch.gather(
        ptr_r.long(), 1, n)
    return node, lo, hi, torch.where(node >= 0, mid, 0)


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


def _sage_cuda(msg, dst_ids, src_by_dst, src_ids, dst_by_src, wf_d, wr_s,
               num_nodes, row_ptrs):
    if msg.shape[1] != num_nodes:
        raise ValueError(f"sage_aggregate: msg has {msg.shape[1]} rows, "
                         f"num_nodes is {num_nodes}")
    msg = msg.contiguous()
    kernels.dtype_code(msg)
    ptr_f, ptr_r = (_int32(p) for p in row_ptrs)
    out = torch.empty_like(msg)
    if out.numel():
        kernels.launch_sage_aggregate(
            msg, ptr_f, _int32(src_by_dst), wf_d.float().contiguous(),
            ptr_r, _int32(dst_by_src), wr_s.float().contiguous(), out)
        kernels.count_launch(LAUNCHES, "sage_aggregate")
    return out


class _SageAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, dst_ids, src_by_dst, src_ids, dst_by_src,
                wf_d, wf_s, wr_s, wr_d, num_nodes, ptr_f, ptr_r):
        if _use_kernel("sage_aggregate", msg, dst_ids, src_ids, wf_d, wr_s):
            if ptr_f is None:
                ptr_f, ptr_r = sage_row_ptrs(dst_ids, src_ids, num_nodes)
            out = _sage_cuda(msg, dst_ids, src_by_dst, src_ids, dst_by_src,
                             wf_d, wr_s, num_nodes, (ptr_f, ptr_r))
        else:
            out = sage_aggregate_plain(msg, dst_ids, src_by_dst, src_ids,
                                       dst_by_src, wf_d, wf_s, wr_s, wr_d,
                                       num_nodes)
        ctx.save_for_backward(dst_ids, src_by_dst, src_ids, dst_by_src,
                              wf_d, wf_s, wr_s, wr_d, ptr_f, ptr_r)
        ctx.num_nodes = num_nodes
        return out

    @staticmethod
    def backward(ctx, g):
        (dst_ids, src_by_dst, src_ids, dst_by_src, wf_d, wf_s, wr_s, wr_d,
         ptr_f, ptr_r) = ctx.saved_tensors
        # (Wf + Wr)ᵀ g: Wfᵀ scatters to src, the src-sorted band with the
        # forward weights (wf_s); Wrᵀ scatters to dst, the dst-sorted band
        # with the reverse weights (wr_d).  The same op with the weights
        # exchanged across the views (the exchanged slots carry wf_d/wr_s,
        # so the adjoint's adjoint is the forward again)
        row_ptrs = None if ptr_f is None else (ptr_f, ptr_r)
        gmsg = sage_aggregate(g, dst_ids, src_by_dst, src_ids, dst_by_src,
                              wr_d, wr_s, wf_s, wf_d, ctx.num_nodes,
                              row_ptrs=row_ptrs)
        return (gmsg,) + (None,) * 11


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
    when not given.  Differentiable in ``msg``: the backward is this op with
    the weights exchanged (the reference's ``_sage_bwd``)."""
    single, (msg, dst_ids, src_by_dst, src_ids, dst_by_src,
             wf_d, wf_s, wr_s, wr_d) = _batched(
        msg, dst_ids, src_by_dst, src_ids, dst_by_src, wf_d, wf_s, wr_s, wr_d)
    ptr_f, ptr_r = (None, None) if row_ptrs is None else row_ptrs
    out = _SageAggregate.apply(msg, dst_ids, src_by_dst, src_ids, dst_by_src,
                               wf_d, wf_s, wr_s, wr_d, num_nodes, ptr_f, ptr_r)
    return out[0] if single else out
