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
