"""The port's aggregation ops (nerrf_tpu_torch.ops) against the JAX package's
Pallas kernels, run in interpret mode on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions, which
are what the CUDA kernels are held against on the card (chip_smoke.py).
Inputs come from numpy with a seed; tolerance rtol = atol = 1e-5 in float32
(the same sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerrf_tpu.ops import pallas_segment
from nerrf_tpu_torch.ops import segment as ops

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _graph(E, N, seed, zero_frac=0.0):
    """A random graph in both sorted views + both weight vectors in both
    orders (the sage_aggregate argument tuple minus msg), as numpy."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = np.sort(rng.integers(0, N, E)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, E).astype(np.float32)
    if zero_frac:
        w[rng.random(E) < zero_frac] = 0.0  # masked edges
    order = np.argsort(src, kind="stable")
    wf_d = (w * rng.uniform(0.5, 2.0, E)).astype(np.float32)
    wr_d = (w * rng.uniform(0.5, 2.0, E)).astype(np.float32)
    return (dst, src, src[order], dst[order],
            wf_d, wf_d[order], wr_d[order], wr_d)


def _pallas_sage(msg, edges, n):
    return np.asarray(pallas_segment.sage_aggregate_fused(
        jnp.asarray(msg), *map(jnp.asarray, edges), n, True))


def _port_sage(msg, edges, n):
    return ops.sage_aggregate(torch.from_numpy(msg),
                              *map(torch.from_numpy, edges), n).numpy()


@pytest.fixture(autouse=True)
def _no_kernel_launches_on_cpu():
    ops.reset_launches()
    yield
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}, \
        "CPU tensors must take the plain versions"


@pytest.mark.parametrize("E,N,F", [(37, 11, 5), (128, 128, 128), (300, 50, 33)])
@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_sum_matches_pallas(E, N, F, sorted_ids):
    ids = np.random.default_rng(0).integers(0, N, size=E).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    data = _rand((E, F), 1)
    want = pallas_segment.segment_sum(jnp.asarray(data), jnp.asarray(ids), N, True)
    got = ops.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_segment_sum_drops_out_of_range_ids():
    # the fusion routes invalid sequences past the last segment; ids outside
    # [0, N) are dropped as jax.ops.segment_sum drops them (index_add_ would
    # raise on them)
    N, F = 9, 6
    ids = np.array([0, -1, 3, 9, 40, 8, 3, -7], np.int32)
    data = _rand((len(ids), F), 2)
    want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=N)
    got = ops.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(pallas_segment.segment_sum(
            jnp.asarray(data), jnp.asarray(ids), N, True)), **TOL)


def test_segment_sum_empty_segments_are_zero():
    ids = torch.tensor([0, 0, 3], dtype=torch.int32)
    out = ops.segment_sum(torch.ones(3, 4), ids, 6).numpy()
    assert (out[1] == 0).all() and (out[4:] == 0).all()
    np.testing.assert_allclose(out[0], 2.0)
    np.testing.assert_allclose(out[3], 1.0)


def test_gather_rows_matches_pallas():
    table = _rand((45, 19), 2)
    idx = np.random.default_rng(3).integers(0, 45, size=130).astype(np.int32)
    want = pallas_segment.gather_rows(jnp.asarray(table), jnp.asarray(idx), True)
    got = ops.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gather_rows_out_of_range_gives_zero_rows():
    table = _rand((16, 7), 4)
    idx = np.array([3, -1, 15, 16, 200, 0], np.int32)
    want = pallas_segment.gather_rows(jnp.asarray(table), jnp.asarray(idx), True)
    got = ops.gather_rows(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert (got[[1, 3, 4]] == 0).all()


@pytest.mark.parametrize("E,N,F", [(37, 11, 5), (128, 128, 128),
                                   (300, 150, 33), (513, 257, 130)])
def test_sage_aggregate_matches_pallas(E, N, F):
    edges = _graph(E, N, seed=E)
    msg = _rand((N, F), E + 1)
    np.testing.assert_allclose(_port_sage(msg, edges, N),
                               _pallas_sage(msg, edges, N), **TOL)


def test_sage_aggregate_masked_edges_contribute_nothing():
    edges = _graph(200, 64, seed=3, zero_frac=0.4)
    msg = _rand((64, 20), 4)
    np.testing.assert_allclose(_port_sage(msg, edges, 64),
                               _pallas_sage(msg, edges, 64), **TOL)


def test_sage_aggregate_empty_segments_are_exactly_zero():
    # every edge lands on nodes {0, 1}; all other rows must be exact zeros
    E, N, F = 40, 50, 7
    rng = np.random.default_rng(5)
    src = rng.integers(0, 2, E).astype(np.int32)
    dst = np.sort(rng.integers(0, 2, E)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, E).astype(np.float32)
    order = np.argsort(src, kind="stable")
    edges = (dst, src, src[order], dst[order], w, w[order], w[order], w)
    msg = _rand((N, F), 6)
    got = _port_sage(msg, edges, N)
    assert np.max(np.abs(got[2:])) == 0.0
    np.testing.assert_allclose(got, _pallas_sage(msg, edges, N), **TOL)


def test_sage_aggregate_skewed_band():
    # every edge on one node: one row's band spans the whole edge list
    E, N, F = 400, 257, 9
    rng = np.random.default_rng(23)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = np.full(E, 131, np.int32)
    w = rng.uniform(0.1, 1.0, E).astype(np.float32)
    order = np.argsort(src, kind="stable")
    edges = (dst, src, src[order], dst[order], w, w[order], w[order], w)
    msg = _rand((N, F), 24)
    np.testing.assert_allclose(_port_sage(msg, edges, N),
                               _pallas_sage(msg, edges, N), **TOL)


def test_degenerate_shapes():
    out = ops.sage_aggregate(torch.zeros(5, 4),
                             *[torch.zeros(0, dtype=torch.int32)] * 4,
                             *[torch.zeros(0)] * 4, 5)
    assert out.shape == (5, 4) and float(out.abs().sum()) == 0.0
    s = ops.segment_sum(torch.zeros(0, 4), torch.zeros(0, dtype=torch.int32), 5)
    assert s.shape == (5, 4) and float(s.abs().sum()) == 0.0
    g = ops.gather_rows(torch.zeros(3, 4), torch.zeros(0, dtype=torch.int32))
    assert g.shape == (0, 4)


def test_batch_of_windows_matches_per_window_pallas():
    # the port runs a batch of windows as a leading dimension (one kernel
    # launch on the card); each window must match the reference alone
    B, E, N, F = 3, 150, 40, 9
    per = [_graph(E, N, seed=10 + b) for b in range(B)]
    edges = tuple(np.stack([p[i] for p in per]) for i in range(8))
    msg = _rand((B, N, F), 20)
    got = _port_sage(msg, edges, N)
    assert got.shape == (B, N, F)
    for b in range(B):
        np.testing.assert_allclose(got[b], _pallas_sage(msg[b], per[b], N), **TOL)

    table = _rand((B, N, F), 21)
    idx = np.random.default_rng(22).integers(0, N, (B, E)).astype(np.int32)
    g = ops.gather_rows(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    data = _rand((B, E, F), 23)
    s = ops.segment_sum(torch.from_numpy(data), torch.from_numpy(idx), N).numpy()
    for b in range(B):
        np.testing.assert_allclose(g[b], np.asarray(pallas_segment.gather_rows(
            jnp.asarray(table[b]), jnp.asarray(idx[b]), True)), **TOL)
        np.testing.assert_allclose(s[b], np.asarray(pallas_segment.segment_sum(
            jnp.asarray(data[b]), jnp.asarray(idx[b]), N, True)), **TOL)


def test_precomputed_row_ptrs_match_searchsorted():
    B, E, N = 2, 90, 30
    per = [_graph(E, N, seed=40 + b) for b in range(B)]
    dst = np.stack([p[0] for p in per])
    src_s = np.stack([p[2] for p in per])
    ptr_f, ptr_r = ops.sage_row_ptrs(torch.from_numpy(dst),
                                     torch.from_numpy(src_s), N)
    for b in range(B):
        np.testing.assert_array_equal(
            ptr_f[b].numpy(), np.searchsorted(dst[b], np.arange(N + 1)))
        np.testing.assert_array_equal(
            ptr_r[b].numpy(), np.searchsorted(src_s[b], np.arange(N + 1)))
    edges = tuple(np.stack([p[i] for p in per]) for i in range(8))
    msg = torch.from_numpy(_rand((B, N, 6), 41))
    targs = [torch.from_numpy(e) for e in edges]
    np.testing.assert_allclose(
        ops.sage_aggregate(msg, *targs, N, row_ptrs=(ptr_f, ptr_r)).numpy(),
        ops.sage_aggregate(msg, *targs, N).numpy(), **TOL)


def test_cpu_impls_are_plain_and_plain_ops_restores():
    assert ops.active_impls("cpu") == {k: "plain" for k in ops.LAUNCHES}
    with ops.plain_ops():
        assert ops._FORCE_PLAIN
    assert not ops._FORCE_PLAIN


# --- the banded pair: segment_sum_sorted / gather_rows_sorted ----------------


def _sorted_case(case):
    """(data [E, F], nondecreasing ids [E], N) for the banded kernel's cases
    of the JAX package's tests (tests/test_pallas_ops.py), plus F = 1 (the
    weight denominators of segment_mean)."""
    rng = np.random.default_rng(21)
    if case == "skewed":            # every edge on one segment
        E, N, F = 400, 257, 9
        ids = np.full(E, 131)
    elif case == "builder_padding":  # sorted prefix, padding on the last node
        N, E, F = 64, 128, 12
        ids = np.concatenate([np.sort(rng.integers(0, 50, size=90)),
                              np.full(38, N - 1)])
    elif case == "band_past_end":   # upper segments' bands past the last edge
        E, N, F = 128, 257, 7
        ids = np.sort(rng.integers(0, 60, E))
    else:
        E, N, F = case
        ids = np.sort(rng.integers(0, N, size=E))
    return _rand((len(ids), F), 22), ids.astype(np.int32), N


@pytest.mark.parametrize("case", [(37, 11, 5), (300, 300, 64), (512, 40, 130),
                                  (300, 50, 1), "skewed", "builder_padding",
                                  "band_past_end"], ids=str)
def test_segment_sum_sorted_matches_pallas(case):
    data, ids, N = _sorted_case(case)
    want = pallas_segment.segment_sum_sorted(jnp.asarray(data),
                                             jnp.asarray(ids), N, True)
    got = ops.segment_sum_sorted(torch.from_numpy(data), torch.from_numpy(ids), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_segment_sum_sorted_drops_out_of_range_and_takes_empty():
    # sorted ids may start below 0 and end at or past N: those rows drop
    N, F = 12, 4
    ids = np.array([-3, -1, 0, 0, 4, 11, 12, 30], np.int32)
    data = _rand((len(ids), F), 3)
    want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=N)
    got = ops.segment_sum_sorted(torch.from_numpy(data), torch.from_numpy(ids), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    empty = ops.segment_sum_sorted(torch.zeros(2, 0, 3),
                                   torch.zeros(2, 0, dtype=torch.int32), 5)
    assert empty.shape == (2, 5, 3) and float(empty.abs().sum()) == 0.0


def test_gather_rows_sorted_matches_pallas_sparse_spread():
    # sparse sorted ids: each 128-edge tile spans many 128-row table tiles
    N, F, E = 2000, 10, 256
    idx = np.sort(np.random.default_rng(33).integers(0, N, E)).astype(np.int32)
    table = _rand((N, F), 34)
    want = pallas_segment._gather_sorted_call(jnp.asarray(table),
                                              jnp.asarray(idx), interpret=True)
    got = ops.gather_rows_sorted(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gather_rows_sorted_out_of_range_gives_zero_rows():
    table = _rand((16, 7), 4)
    idx = np.array([-2, -1, 0, 3, 3, 15, 16, 200], np.int32)
    got = ops.gather_rows_sorted(torch.from_numpy(table),
                                 torch.from_numpy(idx)).numpy()
    assert (got[[0, 1, 6, 7]] == 0).all()
    np.testing.assert_array_equal(got[2:6], table[idx[2:6]])


# --- both gathers against the Pallas gathers ---------------------------------


def _gather_ids(case, B, N, E, rng):
    """[B, E] int32 ids, nondecreasing per window, for the gathers' cases."""
    if case == "out_of_range":        # ids at or past N; below 0 in window 0
        ids = rng.integers(0, N + 6, (B, E))
        ids[:, 0] = N
        ids[0, 1:40] = rng.integers(-6, 0, 39)
    else:                             # the builder's padding tail on row N - 1
        ids = np.concatenate([rng.integers(0, N - 1, (B, E - 60)),
                              np.full((B, 60), N - 1)], axis=1)
    return np.sort(ids, axis=1).astype(np.int32)


@pytest.mark.parametrize("case", ["out_of_range", "padding_tail"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 7, 24, 160])
@pytest.mark.parametrize("op", ["gather_rows", "gather_rows_sorted"])
def test_gathers_match_pallas_gathers(op, F, dtype, case):
    """Both gathers on a batch of windows against the JAX package's Pallas
    gathers (interpret mode), one window at a time: the same bits, since
    both are copies (the one-hot product adds one nonzero term per row).
    ``gather_rows`` takes the ids in random order, ``gather_rows_sorted``
    sorted.  The sorted Pallas kernel reads the wrong band for a 128-id tile
    whose first id is negative (its band starts at table tile -1), so for
    ids below 0 both ops are held against ``gather_rows``'s Pallas kernel,
    which computes the same function."""
    rng = np.random.default_rng(F)
    B, N, E = 2, 50, 140
    ids = _gather_ids(case, B, N, E, rng)
    if op == "gather_rows":
        ids = rng.permutation(ids, axis=1)
    table = _rand((B, N, F), F + 1)
    port = getattr(ops, op)(torch.from_numpy(table).to(getattr(torch, dtype)),
                            torch.from_numpy(ids))
    assert port.shape == (B, E, F) and port.dtype == getattr(torch, dtype)
    for b in range(B):
        t, i = jnp.asarray(table[b], getattr(jnp, dtype)), jnp.asarray(ids[b])
        if op == "gather_rows_sorted" and ids[b, 0] >= 0:
            want = pallas_segment._gather_sorted_call(t, i, interpret=True)
        else:
            want = pallas_segment.gather_rows(t, i, True)
        np.testing.assert_array_equal(port[b].float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
        bad = (ids[b] < 0) | (ids[b] >= N)
        assert bad.any() == (case == "out_of_range")
        assert not port[b][torch.from_numpy(bad)].any()


def test_gather_launch_refuses_shapes_past_32_bit_indexing():
    # the row-copy kernel indexes in 32 bits and takes windows as its grid's
    # y index: the launcher refuses larger operands before touching a device
    from nerrf_tpu_torch.ops import kernels

    idx = torch.zeros(1, 1, dtype=torch.int32)
    for table, ids in ((torch.zeros(1, 1, 1).expand(1, 2 ** 16, 2 ** 15), idx),
                       (torch.zeros(1, 1, 1).expand(1, 4, 2 ** 16),
                        idx.expand(1, 2 ** 15)),
                       (torch.zeros(1, 1, 1).expand(2 ** 16, 1, 1),
                        idx.expand(2 ** 16, 1))):
        out = torch.zeros(1, 1, 1).expand(table.shape[0], ids.shape[1],
                                          table.shape[2])
        with pytest.raises(ValueError, match="32-bit|windows"):
            kernels.launch_gather("gather_rows", table, ids, out)


def test_segment_mean_matches_reference():
    # the reference's weighted mean (numerator and denominator each one
    # segment sum; empty segments 0), sorted and order-independent routes
    from nerrf_tpu.ops import segment as jseg

    E, N, F = 90, 20, 6
    rng = np.random.default_rng(8)
    ids = np.sort(rng.integers(0, N - 3, E)).astype(np.int32)
    data = _rand((E, F), 9)
    w = rng.uniform(0.0, 1.0, E).astype(np.float32)
    want = jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids), N,
                             weights=jnp.asarray(w), sorted_ids=True)
    for sorted_ids in (True, False):
        got = ops.segment_mean(torch.from_numpy(data), torch.from_numpy(ids), N,
                               weights=torch.from_numpy(w), sorted_ids=sorted_ids)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids), N)
    got = ops.segment_mean(torch.from_numpy(data), torch.from_numpy(ids), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- gradients: each Function's backward against the reference's custom_vjp --


def _grad_case(op):
    """(port op, reference custom_vjp in interpret mode, data, graph args)
    for one of the five Functions; the data operand comes first."""
    rng = np.random.default_rng(50)
    E, N, F = 160, 37, 11
    ids = rng.integers(0, N, E).astype(np.int32)
    sorted_ids = np.sort(ids)
    if op == "sage_aggregate":
        edges = _graph(E, N, seed=51, zero_frac=0.2)
        return (lambda m: ops.sage_aggregate(m, *map(torch.from_numpy, edges), N),
                lambda m: pallas_segment.sage_aggregate_fused(
                    m, *map(jnp.asarray, edges), N, True),
                _rand((N, F), 52))
    if op == "segment_sum":
        return (lambda d: ops.segment_sum(d, torch.from_numpy(ids), N),
                lambda d: pallas_segment.segment_sum(d, jnp.asarray(ids), N, True),
                _rand((E, F), 53))
    if op == "segment_sum_sorted":
        return (lambda d: ops.segment_sum_sorted(d, torch.from_numpy(sorted_ids), N),
                lambda d: pallas_segment.segment_sum_sorted(
                    d, jnp.asarray(sorted_ids), N, True),
                _rand((E, F), 54))
    if op == "gather_rows":
        return (lambda t: ops.gather_rows(t, torch.from_numpy(ids)),
                lambda t: pallas_segment.gather_rows(t, jnp.asarray(ids), True),
                _rand((N, F), 55))
    # gather_rows_sorted: the reference has no custom_vjp of its own for the
    # banded gather (it is only ever an adjoint); its function is gather_rows
    # on sorted indices
    return (lambda t: ops.gather_rows_sorted(t, torch.from_numpy(sorted_ids)),
            lambda t: pallas_segment.gather_rows(t, jnp.asarray(sorted_ids), True),
            _rand((N, F), 56))


@pytest.mark.parametrize("op", ["sage_aggregate", "segment_sum", "gather_rows",
                                "segment_sum_sorted", "gather_rows_sorted"])
def test_function_backward_matches_reference_vjp(op):
    port, ref, x = _grad_case(op)
    out_shape = np.asarray(ref(jnp.asarray(x))).shape
    cot = _rand(out_shape, 60)
    want = jax.grad(lambda v: jnp.sum(ref(v) * jnp.asarray(cot)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_batched_backward_keeps_windows_apart():
    # a batch of windows in one call: each window's gradient is its own
    B, E, N, F = 2, 60, 17, 5
    rng = np.random.default_rng(61)
    ids = np.sort(rng.integers(0, N, (B, E)), axis=1).astype(np.int32)
    data = torch.from_numpy(_rand((B, E, F), 62)).requires_grad_(True)
    cot = torch.from_numpy(_rand((B, N, F), 63))
    (g,) = torch.autograd.grad(
        ops.segment_sum_sorted(data, torch.from_numpy(ids), N), data, cot)
    for b in range(B):
        np.testing.assert_array_equal(g[b].numpy(), cot[b].numpy()[ids[b]])


# --- segment plans: graph structure taken once per forward -------------------


def _plan_case(case):
    """([B, S] int32 ids, N, sorted_ids) for segment_plan's cases."""
    rng = np.random.default_rng(70)
    if case == "unsorted":
        return rng.integers(-3, 43, (3, 200)).astype(np.int32), 40, False
    if case == "builder_padding":     # sorted live prefix, 300-row tail
        ids = np.concatenate([np.sort(rng.integers(0, 63, (2, 212)), axis=1),
                              np.full((2, 300), 63)], axis=1)
        return ids.astype(np.int32), 64, True
    if case == "out_of_range_sorted":
        return np.sort(rng.integers(-50, 90, (2, 150)), axis=1).astype(np.int32), 40, True
    if case == "fewer_rows_than_a_chunk":
        return rng.integers(0, 9, (2, 7)).astype(np.int32), 9, False
    if case == "one_segment":
        return np.zeros((1, 100), np.int32), 1, True
    return np.zeros((2, 0), np.int32), 5, False          # no rows


@pytest.mark.parametrize("case", ["unsorted", "builder_padding",
                                  "out_of_range_sorted", "fewer_rows_than_a_chunk",
                                  "one_segment", "no_rows"])
def test_segment_plan_invariants(case):
    """The plan against numpy, and ``SegmentPlan.chunks()``, the chunk map
    written out in PyTorch, against the map's invariants.  chunks() is the
    spec of the kernels' own map (``Chunk::find`` in
    csrc/segment_chunks.cuh), which runs only on the card: chip_smoke.py's
    long-band and plan checks hold that one."""
    ids, N, sorted_ids = _plan_case(case)
    B, S = ids.shape
    L = ops.CHUNK_ROWS
    plan = ops.segment_plan(torch.from_numpy(ids), N, sorted_ids=sorted_ids)
    order = np.argsort(ids, axis=1, kind="stable")
    keys = np.take_along_axis(ids, order, 1)
    if sorted_ids:
        assert plan.perm is None
    else:
        np.testing.assert_array_equal(plan.perm.numpy(), order)
    seg, lo, hi = (t.numpy() for t in plan.chunks())
    K = N + -(-S // L)
    assert seg.shape == (B, K) and plan.num_chunk_slots == K
    for b in range(B):
        ptr = np.searchsorted(keys[b], np.arange(N + 1))
        np.testing.assert_array_equal(plan.ptr[b].numpy(), ptr)
        owned = seg[b] >= 0
        # every segment has at least one chunk, in segment order
        assert np.array_equal(np.unique(seg[b, owned]), np.arange(N))
        assert np.all(np.diff(seg[b, owned]) >= 0)
        # chunks of at most L rows, each within its own segment
        assert np.all(hi[b, owned] - lo[b, owned] <= L)
        assert np.all(lo[b, owned] <= hi[b, owned])
        for n, a, z in zip(seg[b, owned], lo[b, owned], hi[b, owned]):
            assert np.all(keys[b, a:z] == n)
        # the chunks cover every in-range row exactly once, in order, and
        # no out-of-range one
        rows = np.concatenate([np.arange(a, z) for a, z
                               in zip(lo[b, owned], hi[b, owned])] + [[]])
        in_range = np.flatnonzero((keys[b] >= 0) & (keys[b] < N))
        np.testing.assert_array_equal(rows, in_range)
        # within the static bound N + ceil(S / L), a segment of len rows in
        # at most ceil(len / L) + 1 chunks
        assert owned.sum() <= K
        lens = np.diff(ptr)
        counts = np.bincount(seg[b, owned], minlength=N)
        assert np.all(counts <= np.maximum(1, -(-lens // L)) + 1)


def _plan_op(op):
    """(op(x, plan), x, the ids' plan) for the ops that take a plan."""
    rng = np.random.default_rng(71)
    B, E, N, F = 2, 96, 13, 6
    ids = rng.integers(-1, N + 1, (B, E)).astype(np.int32)
    sorted_ids = np.sort(ids, axis=1)
    w = rng.uniform(0.0, 1.0, (B, E)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    if op == "segment_sum":
        return (lambda d, p: ops.segment_sum(d, t(ids), N, plan=p),
                _rand((B, E, F), 72), ops.segment_plan(t(ids), N))
    if op == "gather_rows":
        return (lambda m, p: ops.gather_rows(m, t(ids), plan=p),
                _rand((B, N, F), 73), ops.segment_plan(t(ids), N))
    if op == "segment_sum_sorted":
        return (lambda d, p: ops.segment_sum_sorted(d, t(sorted_ids), N, plan=p),
                _rand((B, E, F), 74), ops.segment_plan(t(sorted_ids), N, sorted_ids=True))
    if op == "gather_rows_sorted":
        return (lambda m, p: ops.gather_rows_sorted(m, t(sorted_ids), plan=p),
                _rand((B, N, F), 75), ops.segment_plan(t(sorted_ids), N, sorted_ids=True))
    return (lambda d, p: ops.segment_mean(d, t(sorted_ids), N, weights=t(w),
                                          sorted_ids=True, plan=p),
            _rand((B, E, F), 76), ops.segment_plan(t(sorted_ids), N, sorted_ids=True))


@pytest.mark.parametrize("op", ["segment_sum", "gather_rows", "segment_sum_sorted",
                                "gather_rows_sorted", "segment_mean"])
def test_ops_with_a_plan_match_ops_without(op):
    """Forward and backward with the ids' plan equal those without, bit for
    bit.  On the CPU the plain versions ignore the plan, so this holds the
    ops' plumbing (a gather hands its plan to its adjoint sum); that the
    kernels give the same bits with and without a plan is checked on the
    card by chip_smoke.py."""
    fn, x, plan = _plan_op(op)
    results = []
    for p in (None, plan):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = fn(xt, p)
        cot = torch.from_numpy(_rand(tuple(out.shape), 77))
        (g,) = torch.autograd.grad(out, xt, cot)
        results.append((out.detach().numpy(), g.numpy()))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_array_equal(results[0][1], results[1][1])


def test_a_plan_must_fit_its_operands():
    ids = torch.from_numpy(np.sort(np.random.default_rng(78).integers(
        0, 10, (2, 30))).astype(np.int32))
    data = torch.ones(2, 30, 3)
    with pytest.raises(ValueError):       # another number of segments
        ops.segment_sum(data, ids, 12, plan=ops.segment_plan(ids, 10))
    with pytest.raises(ValueError):       # the banded sum takes a sorted plan
        ops.segment_sum_sorted(data, ids, 10, plan=ops.segment_plan(ids, 10))
    sorted_plan = ops.segment_plan(ids, 10, sorted_ids=True)
    np.testing.assert_array_equal(
        ops.segment_sum(data, ids, 10, plan=sorted_plan).numpy(),
        ops.segment_sum(data, ids, 10).numpy())


@pytest.mark.parametrize("sorted_op", [False, True])
def test_builder_padding_long_band_matches_pallas(sorted_op):
    # the builder's layout: 212 live edges, then a 300-row padding tail on
    # the last of 64 nodes (the band one warp walked before the chunked
    # kernels); the order-independent sum gets the rows shuffled
    rng = np.random.default_rng(79)
    E, N, F = 512, 64, 24
    ids = np.concatenate([np.sort(rng.integers(0, N - 1, E - 300)),
                          np.full(300, N - 1)]).astype(np.int32)
    if not sorted_op:
        ids = rng.permutation(ids)
    data = _rand((E, F), 80)
    if sorted_op:
        want = pallas_segment.segment_sum_sorted(jnp.asarray(data), jnp.asarray(ids),
                                                 N, True)
        got = ops.segment_sum_sorted(torch.from_numpy(data), torch.from_numpy(ids), N,
                                     plan=ops.segment_plan(torch.from_numpy(ids), N,
                                                           sorted_ids=True))
    else:
        want = pallas_segment.segment_sum(jnp.asarray(data), jnp.asarray(ids), N, True)
        got = ops.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), N,
                              plan=ops.segment_plan(torch.from_numpy(ids), N))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- sage_aggregate's chunk map: both views as one row space -----------------


def _sage_chunk_case(case):
    """([B, E] dst-sorted ids, [B, E] src ids, N) for the merged chunk map's
    cases: the builder's layout (live edges, then a padding tail on the last
    node in both views), a long band in either view or both on one node,
    and no edges."""
    rng = np.random.default_rng(90)
    B, N, E = 2, 64, 600
    dst = rng.integers(0, N - 1, (B, E))
    src = rng.integers(0, N - 1, (B, E))
    if case == "padding_tail":        # 300 padding edges on node N - 1
        dst[:, -300:] = N - 1
        src[:, -300:] = N - 1
    elif case == "band_dst":          # one node's 130-edge band, dst view
        dst[:, :130] = 17
    elif case == "band_src":          # the same in the src view
        src[:, :130] = 17
    elif case == "bands_both":        # long bands in both views on one node
        dst[:, :130] = 5
        src[:, 130:270] = 5
    elif case == "no_edges":
        dst, src = dst[:, :0], src[:, :0]
    return np.sort(dst, axis=1).astype(np.int32), src.astype(np.int32), N


@pytest.mark.parametrize("case", ["padding_tail", "band_dst", "band_src",
                                  "bands_both", "no_edges"])
def test_sage_chunk_map_invariants(case):
    """``sage_chunks``, the Python spelling of the map sage_aggregate's
    kernel takes over ptr_f + ptr_r on the card: every edge of both sorted
    views falls in exactly one chunk of its own node, no chunk holds more
    than 32 rows, every node has a chunk, and a window has at most N +
    ceil(2E / 32) slots."""
    dst, src, N = _sage_chunk_case(case)
    B, E = dst.shape
    L = ops.CHUNK_ROWS
    order = np.argsort(src, axis=1, kind="stable")
    src_s = np.take_along_axis(src, order, 1)
    ptr_f, ptr_r = ops.sage_row_ptrs(torch.from_numpy(dst),
                                     torch.from_numpy(src_s), N)
    node, lo, hi, mid = (t.numpy() for t in ops.sage_chunks(ptr_f, ptr_r, E))
    K = N + -(-2 * E // L)
    assert node.shape == (B, K)
    for b in range(B):
        owned = node[b] >= 0
        assert np.array_equal(np.unique(node[b, owned]), np.arange(N))
        assert np.all(np.diff(node[b, owned]) >= 0)
        assert np.all((hi[b] - lo[b])[owned] <= L)
        seen_f, seen_r = np.zeros(E, int), np.zeros(E, int)
        pf, pr = ptr_f[b].numpy(), ptr_r[b].numpy()
        for n, a, z, m in zip(node[b, owned], lo[b, owned], hi[b, owned],
                              mid[b, owned]):
            assert pf[n] + pr[n] <= a <= z <= pf[n + 1] + pr[n + 1]
            for r in range(a, z):
                if r < m:             # dst-view band: edge r - ptr_r[n]
                    e = r - pr[n]
                    assert dst[b, e] == n
                    seen_f[e] += 1
                else:                 # src-view band: edge r - ptr_f[n + 1]
                    e = r - pf[n + 1]
                    assert src_s[b, e] == n
                    seen_r[e] += 1
        assert np.all(seen_f == 1) and np.all(seen_r == 1)
        # a node's chunks: ceil(len / L) or one more, at least one
        lens = (pf[1:] + pr[1:]) - (pf[:-1] + pr[:-1])
        counts = np.bincount(node[b, owned], minlength=N)
        assert np.all(counts <= np.maximum(1, -(-lens // L)) + 1)
    if case == "bands_both":          # node 5's two long bands share chunks
        five = node[0] == 5
        assert five.sum() >= (130 + 140) // L


def test_sage_aggregate_long_bands_match_pallas():
    # the chunk map's cases through the op: long bands in either view and
    # both, the builder's padding tail, weights of masked edges 0, at F = 24
    for case in ("padding_tail", "band_dst", "band_src", "bands_both"):
        dst, src, N = _sage_chunk_case(case)
        rng = np.random.default_rng(91)
        w = rng.uniform(0.1, 1.0, dst.shape).astype(np.float32)
        if case == "padding_tail":
            w[:, -300:] = 0.0
        order = np.argsort(src, axis=1, kind="stable")
        take = lambda a: np.take_along_axis(a, order, 1)
        wf = (w * rng.uniform(0.5, 2.0, w.shape)).astype(np.float32)
        wr = (w * rng.uniform(0.5, 2.0, w.shape)).astype(np.float32)
        msg = _rand((dst.shape[0], N, 24), 92)
        for b in range(dst.shape[0]):
            edges = (dst[b], src[b], take(src)[b], take(dst)[b], wf[b],
                     take(wf)[b], take(wr)[b], wr[b])
            np.testing.assert_allclose(_port_sage(msg[b], edges, N),
                                       _pallas_sage(msg[b], edges, N),
                                       err_msg=case, **TOL)
