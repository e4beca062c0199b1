#!/usr/bin/env python3
"""Chip smoke of nerrf_tpu_torch, the PyTorch/CUDA port of NERRF detection.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's three CUDA kernels from ``nerrf_tpu_torch/ops/csrc/``
(``nvcc``, ``sm_90a``, on first use), holds each against its plain PyTorch
version on the card at the main path's shapes (float32 and bfloat16, plus
masked edges, empty segments, skewed bands and empty inputs), then drives
``model_detect`` with the full-width ``NerrfNet`` (28-layer GraphSAGE-T of
width 160, 2×256 BiLSTM, bfloat16, random weights from a seed) over a
simulated trace whose windows land on the 4096-node / 4096-edge /
4096-sequence rung.  The launch counters must show every kernel on that
run; the forward is compared with the same forward on the plain versions,
and a small float32 detection on the card with the same detection on the
CPU.  Each kernel is then checked and timed on the inputs the main path
gives it (the first batch's edge views and sequence routing), beside its
plain version, one PyTorch library call and its bound.

Prints the card's name and power limit, one JSON line with each kernel's
launches, error, times and bound, the detection rate, the steady run's
breakdown and the card's busy share from a profiler trace, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line, when
a phase fails or there is no card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import warnings

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, and float32
# operations/s outside the tensor cores (the kernels sum in f32 registers)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

MAIN_B, MAIN_N, MAIN_E, MAIN_F = 8, 4096, 4096, 160   # sage / gather shapes
SEQ_S, SEQ_F = 4096, 24                                # fusion segment_sum
# kernel vs plain version, per element: |Δ| ≤ TOL · (1 + Σ|terms|), where
# Σ|terms| is the element's sum of absolute terms.  float32: both sum in f32
# and only the order differs, an error that grows with the terms' magnitude
# (a skewed row sums 4096 of them); bfloat16: both sum in f32 and round once
# to bf16, so they are at most one bf16 ulp (2^-8 relative) apart
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# full-width forward, kernels vs plain versions on the card: bf16 results
# that differ by one ulp after an op diverge slowly through 28 residual
# layers (measured on the H100, see PERF.md); seq_logit never meets a kernel
LOGIT_ATOL = 0.25
# small float32 detection, card (kernels) vs CPU (plain versions)
DETECT_ATOL = 1e-4


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _close(name, got, want, dtype_name, scale=None):
    """Kernel result vs plain result: equal bits when ``scale`` is None (a
    copy), else within TOL · (1 + scale) element by element."""
    import torch

    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if got.numel() else 0.0
    if scale is None:
        ok = torch.equal(got, want)
    else:
        ok = bool((diff <= TOL[dtype_name] * (1.0 + scale)).all())
    if not ok:
        _fail(f"{name} [{dtype_name}]: kernel disagrees with its plain "
              f"version, max |Δ| {err}")
    return err


def _both(fn, *args, **kw):
    """``fn`` on the kernels, then on the plain versions, same inputs."""
    import torch

    from nerrf_tpu_torch.ops import plain_ops

    got = fn(*args, **kw)
    with plain_ops():
        want = fn(*args, **kw)
    torch.cuda.synchronize()
    return got, want


def _sage_scale(msg, edges, n):
    """Σ |w|·|msg| per output element of sage_aggregate (plain version)."""
    from nerrf_tpu_torch.ops import plain_ops, sage_aggregate

    with plain_ops():
        return sage_aggregate(msg.float().abs(), *edges[:4],
                              *(w.abs() for w in edges[4:]), n)


def _segment_scale(data, ids, n):
    """Σ |data| per output element of segment_sum (plain version)."""
    from nerrf_tpu_torch.ops import plain_ops, segment_sum

    with plain_ops():
        return segment_sum(data.float().abs(), ids, n)


# --- inputs at the main path's shapes ---------------------------------------


def sage_graph(B, N, E, gen, device, n_valid=None, zero_frac=0.0, dst_values=None):
    """Builder-like window graphs: dst-sorted edges, the padding tail pointing
    at the last node with weight 0, the src-sorted view, and pre-normalized
    weights in both orders."""
    import torch

    n_valid = E if n_valid is None else n_valid
    src = torch.randint(0, N, (B, E), generator=gen)
    dst = (torch.randint(0, N, (B, E), generator=gen) if dst_values is None
           else torch.full((B, E), dst_values))
    dst, _ = torch.sort(dst, dim=1)
    w = torch.rand(B, E, generator=gen) * 0.9 + 0.1
    if zero_frac:
        w[torch.rand(B, E, generator=gen) < zero_frac] = 0.0
    if n_valid < E:
        dst[:, n_valid:] = N - 1
        src[:, n_valid:] = N - 1
        w[:, n_valid:] = 0.0
    wf_d = w * (torch.rand(B, E, generator=gen) * 1.5 + 0.5)
    wr_d = w * (torch.rand(B, E, generator=gen) * 1.5 + 0.5)
    order = torch.argsort(src, dim=1, stable=True)
    take = lambda t: torch.gather(t, 1, order)
    edges = (dst, src, take(src), take(dst), wf_d, take(wf_d), take(wr_d), wr_d)
    return tuple(t.to(torch.int32).to(device) if not t.is_floating_point()
                 else t.to(device) for t in edges)


def check_kernels() -> dict:
    """Each kernel against its plain version on the card, float32 and
    bfloat16, on synthetic inputs at the main path's shapes and on the edge
    cases (masked edges, empty rows, a skewed band, odd and empty shapes).
    Returns the max |Δ| of each case, by kernel."""
    import torch

    from nerrf_tpu_torch.ops import segment as ops

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    B, N, E, F = MAIN_B, MAIN_N, MAIN_E, MAIN_F

    report = {}

    # ---- sage_aggregate
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        cases = {   # name: (B, N, E, F, sage_graph options)
            "main": (B, N, E, F, dict(n_valid=E - 300)),
            "masked": (B, N, E, F, dict(zero_frac=0.4)),
            "skewed": (B, N, E, F, dict(dst_values=131)),
            "odd": (3, 257, 513, 130, {}),
        }
        for case, (Bc, Nc, Ec, Fc, opts) in cases.items():
            edges = sage_graph(Bc, Nc, Ec, gen, dev, **opts)
            msg = torch.randn(Bc, Nc, Fc, generator=gen).to(dev, dt)
            got, want = _both(ops.sage_aggregate, msg, *edges, Nc)
            errs[f"{case}/{name}"] = _close(f"sage_aggregate {case}", got, want,
                                            name, _sage_scale(msg, edges, Nc))
        # every edge on nodes {0, 1} of 50: all other rows exactly zero
        edges = sage_graph(2, 2, 40, gen, dev)
        msg = torch.randn(2, 50, 7, generator=gen).to(dev, dt)
        got, want = _both(ops.sage_aggregate, msg, *edges, 50)
        if float(got[:, 2:].abs().max()) != 0.0:
            _fail("sage_aggregate: empty rows are not exactly zero")
        _close("sage_aggregate empty-rows", got, want, name,
               _sage_scale(msg, edges, 50))
        # degenerate: no edges at all
        e0 = [torch.zeros(B, 0, dtype=torch.int32, device=dev)] * 4
        w0 = [torch.zeros(B, 0, device=dev)] * 4
        got = ops.sage_aggregate(torch.randn(B, 64, F, device=dev).to(dt), *e0, *w0, 64)
        torch.cuda.synchronize()
        if got.shape != (B, 64, F) or float(got.abs().max()) != 0.0:
            _fail("sage_aggregate: E=0 must give zeros")
    report["sage_aggregate"] = errs

    # ---- gather_rows
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        table = torch.randn(B, N, F, generator=gen).to(dev, dt)
        idx = torch.randint(0, N, (B, E), generator=gen)
        idx[:, ::97] = -1          # out of range: zero rows
        idx[:, 5::101] = N + 5
        idx = idx.to(torch.int32).to(dev)
        got, want = _both(ops.gather_rows, table, idx)
        errs[f"main/{name}"] = _close("gather_rows", got, want, name)
        odd_t = torch.randn(45, 19, generator=gen).to(dev, dt)
        odd_i = torch.randint(0, 45, (130,), generator=gen).to(torch.int32).to(dev)
        got, want = _both(ops.gather_rows, odd_t, odd_i)
        errs[f"odd/{name}"] = _close("gather_rows odd", got, want, name)
        got = ops.gather_rows(table, torch.zeros(B, 0, dtype=torch.int32, device=dev))
        if got.shape != (B, 0, F):
            _fail("gather_rows: E=0 must give an empty result")
    report["gather_rows"] = errs

    # ---- segment_sum
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        data = torch.randn(B, SEQ_S, SEQ_F, generator=gen).to(dev, dt)
        ids = torch.randint(0, N + 1, (B, SEQ_S), generator=gen)
        ids[:, ::53] = -1
        ids[:, 7::61] = N + 40
        ids = ids.to(torch.int32).to(dev)
        got, want = _both(ops.segment_sum, data, ids, N + 1)
        errs[f"main/{name}"] = _close("segment_sum", got, want, name,
                                      _segment_scale(data, ids, N + 1))
        again = ops.segment_sum(data, ids, N + 1)
        if not torch.equal(got, again):
            _fail("segment_sum: two runs on the same inputs differ")
        sparse = torch.zeros(1, 3, dtype=torch.int32, device=dev)
        sparse[0, 2] = 3
        got = ops.segment_sum(torch.ones(1, 3, 4, device=dev).to(dt), sparse, 6)
        torch.cuda.synchronize()
        if float(got[0, 0, 0]) != 2.0 or float(got[0, 3, 0]) != 1.0 \
                or float(got[0, [1, 2, 4, 5]].abs().max()) != 0.0:
            _fail("segment_sum: empty segments are not exactly zero")
        got = ops.segment_sum(torch.zeros(B, 0, SEQ_F, device=dev).to(dt),
                              torch.zeros(B, 0, dtype=torch.int32, device=dev), 5)
        torch.cuda.synchronize()
        if got.shape != (B, 5, SEQ_F) or float(got.abs().max()) != 0.0:
            _fail("segment_sum: S=0 must give zeros")
    report["segment_sum"] = errs
    return report


def sage_library_ms(msg, edges, N):
    """One cuSPARSE product computing the same aggregation: the block-diagonal
    [B·N, B·N] CSR matrix of both directions' weights times msg.  None when
    this PyTorch has no CSR product for msg's type."""
    import torch

    B, _, F = msg.shape
    dst, src, src_s, dst_s, wf_d, _, wr_s, _ = edges
    off = torch.arange(B, device=msg.device)[:, None] * N
    rows = torch.cat([dst.long() + off, src_s.long() + off], 1).reshape(-1)
    cols = torch.cat([src.long() + off, dst_s.long() + off], 1).reshape(-1)
    vals = torch.cat([wf_d, wr_s], 1).reshape(-1).to(msg.dtype)
    mat = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (B * N, B * N),
                                  check_invariants=False).coalesce()
    with warnings.catch_warnings():     # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        mat = mat.to_sparse_csr()
    dense = msg.reshape(B * N, F)
    try:
        return cuda_ms(lambda: torch.sparse.mm(mat, dense))
    except (RuntimeError, NotImplementedError) as e:
        print(f"library_ms for sage_aggregate not measured: {e}".splitlines()[0])
        return None


def time_kernels(batch: dict, report: dict) -> dict:
    """Each kernel on the inputs the main path gives it (the first batch of
    8 windows of the main-path trace: its edge views, its sequence routing;
    random activations of the model's widths and types): the kernel against
    its plain version, and the times of the kernel, the plain version (the
    same call under ``plain_ops``; it ignores the precomputed row pointers) and
    one PyTorch library call computing the same function, beside the bound
    of the work these inputs need."""
    import torch

    from nerrf_tpu_torch.models.graphsage import fused_edge_views
    from nerrf_tpu_torch.ops import gather_rows, plain_ops, sage_aggregate
    from nerrf_tpu_torch.ops import sage_row_ptrs, segment_sum

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(99)
    t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    B, N = t["node_mask"].shape
    E = t["edge_mask"].shape[1]
    F, elt = MAIN_F, 2                           # bf16 activations

    def timed(name, call, library, nbytes, ops, scale=None):
        got, want = _both(call)
        dtype_name = str(got.dtype).split(".")[1]
        report[name][f"mainpath/{dtype_name}"] = _close(
            f"{name} mainpath", got, want, dtype_name, scale)
        ms = cuda_ms(call)
        with plain_ops():
            plain_ms = cuda_ms(call, iters=10)
        b_ms, b_by = bound_ms(nbytes, ops)
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=library())

    # sage_aggregate: the model's edge views; every layer launches on them
    w32 = (t["edge_feat"][..., 12] + 0.1) * t["edge_mask"].float()
    edges = fused_edge_views(t["edge_src"], t["edge_dst"], w32, N)[0]
    ptrs = sage_row_ptrs(edges[0], edges[2], N)
    msg = torch.randn(B, N, F, generator=gen).to(dev, torch.bfloat16)
    live = int((edges[4] != 0).sum() + (edges[6] != 0).sum())
    out = {"sage_aggregate": timed(
        "sage_aggregate",
        lambda: sage_aggregate(msg, *edges, N, row_ptrs=ptrs),
        lambda: sage_library_ms(msg, edges, N),
        2 * B * N * F * elt + B * E * (4 * 4 + 2 * 4), 2 * F * live,
        _sage_scale(msg, edges, N))}
    out["sage_aggregate"]["live_edges_per_window"] = live / B
    out["sage_aggregate"]["longest_band"] = [
        int(torch.zeros(B, N, device=dev).scatter_add_(
            1, ids.long(), (w != 0).float()).max())
        for ids, w in ((edges[0], edges[4]), (edges[2], edges[6]))]

    # gather_rows: the edge head's h[src] (h[dst] is the same work)
    h = torch.randn(B, N, F, generator=gen).to(dev, torch.bfloat16)
    idx = t["edge_src"]
    flat_idx = (idx.long() + torch.arange(B, device=dev)[:, None] * N).reshape(-1)
    rows = sum(int(torch.unique(idx[b]).numel()) for b in range(B))
    out["gather_rows"] = timed(
        "gather_rows", lambda: gather_rows(h, idx),
        lambda: cuda_ms(lambda: torch.index_select(h.reshape(B * N, F), 0, flat_idx)),
        rows * F * elt + idx.numel() * 4 + B * E * F * elt, 0)

    # segment_sum: the fusion's float32 rows into N + 1 slots, unmatched
    # sequences routed to slot N
    sni = t["seq_node_idx"]
    ids = torch.where(sni >= 0, sni, N).to(torch.int32)
    S = ids.shape[1]
    data = torch.randn(B, S, SEQ_F, generator=gen).to(dev)
    flat = (ids.long() + torch.arange(B, device=dev)[:, None] * (N + 1)).reshape(-1)
    longest_run = int(torch.bincount(flat).max())
    out["segment_sum"] = timed(
        "segment_sum", lambda: segment_sum(data, ids, N + 1),
        lambda: cuda_ms(lambda: torch.zeros(B * (N + 1), SEQ_F, device=dev)
                        .index_add_(0, flat, data.reshape(-1, SEQ_F))),
        data.numel() * 4 + ids.numel() * 4 + B * (N + 1) * SEQ_F * 4,
        data.numel(), _segment_scale(data, ids, N + 1))
    out["segment_sum"]["longest_run"] = longest_run
    return out


# --- the main path ------------------------------------------------------------


def run_main_path() -> dict:
    import numpy as np
    import torch

    from nerrf_tpu_torch import tracing
    from nerrf_tpu_torch.data import SimConfig, simulate_trace
    from nerrf_tpu_torch.models import JointConfig, build_nerrfnet
    from nerrf_tpu_torch.ops import LAUNCHES, plain_ops, reset_launches
    from nerrf_tpu_torch.pipeline import (
        MODEL_INPUTS, fit_capacity, make_eval_fn, model_detect, pad_batch)
    from nerrf_tpu_torch.train.data import DatasetConfig, windows_of_trace

    cfg = JointConfig()
    model = build_nerrfnet(cfg, seed=0)
    trace = simulate_trace(SimConfig(duration_sec=120.0, benign_rate_hz=200.0,
                                     num_target_files=48, seed=5))
    ds = fit_capacity(trace, DatasetConfig())
    rung = (ds.graph.max_nodes, ds.graph.max_edges, ds.max_seqs)
    print(f"main path: {trace.events.num_valid} events, rung "
          f"{rung[0]}n/{rung[1]}e/{rung[2]}s, hidden {cfg.gnn.hidden} x "
          f"{cfg.gnn.num_layers} layers, LSTM {cfg.lstm.num_layers}x{cfg.lstm.hidden}")
    if rung != (4096, 4096, 4096):
        _fail(f"the trace landed on rung {rung}, not 4096n/4096e/4096s")

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    det = model_detect(trace, model)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    windows = [s.args["windows"] for s in tracing.records()
               if s.name == "bucket_pad"][-1]
    batches = math.ceil(windows / 8)
    want = {"sage_aggregate": cfg.gnn.num_layers * batches,
            "gather_rows": 2 * batches, "segment_sum": batches}
    print(f"launches {launches}, expected {want} ({windows} windows, "
          f"{batches} batches)")
    if launches != want:
        _fail(f"launch counts {launches} != {want}")

    t0 = time.perf_counter()
    det2 = model_detect(trace, model)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    scores = np.array(list(det.file_scores.values()))
    if not len(scores) or not np.all(np.isfinite(scores)) \
            or scores.min() < 0 or scores.max() > 1:
        _fail("model_detect gave no file scores, or scores outside [0, 1]")
    if det.file_scores != det2.file_scores:
        print("note: two model_detect runs differ in the last bits "
              "(scatter_add_ precompute order)")

    # the same forward on the plain versions
    samples = windows_of_trace(trace, ds)
    batch = pad_batch(samples[:8], 8)
    eval_fn = make_eval_fn(model)
    got = eval_fn(batch)
    with plain_ops():
        want_out = eval_fn(batch)
    logit_err = {}
    for k in ("node_logit", "edge_logit", "seq_logit"):
        d = float(np.max(np.abs(got[k] - want_out[k])))
        logit_err[k] = d
        if not (np.all(np.isfinite(got[k])) and d <= LOGIT_ATOL):
            _fail(f"{k}: kernels vs plain versions max |Δ| {d} > {LOGIT_ATOL}")
    print(f"full-width forward, kernels vs plain: max |Δlogit| {logit_err}")

    # where the steady run's time goes: host lowering (its bucket_pad span),
    # its detect_score spans, and on the card the forward of one batch of 8
    # and that forward's LSTM tower
    spans = tracing.records()
    lower_s = [s.dur for s in spans if s.name == "bucket_pad"][-1]
    score_s = sum(s.dur for s in [s for s in spans
                                  if s.name == "detect_score"][-batches:])
    args = [torch.from_numpy(np.ascontiguousarray(batch[k])).cuda()
            for k in MODEL_INPUTS]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(*args), iters=3, warmup=1)
        lstm_ms = cuda_ms(lambda: model.lstm(args[8], args[9]), iters=3, warmup=1)
    print(f"steady run breakdown: host lowering {lower_s:.3f} s, scoring "
          f"{score_s:.3f} s over {batches} batches; one batch on the card: "
          f"forward {fwd_ms:.1f} ms, of which LSTM {lstm_ms:.1f} ms, GNN + "
          f"fusion {fwd_ms - lstm_ms:.1f} ms")
    device_busy_share(lambda: model_detect(trace, model), steady_s)
    return dict(windows=windows, batches=batches, launches=launches,
                first_s=first_s, steady_s=steady_s,
                windows_per_s=windows / steady_s,
                first_windows_per_s=windows / first_s, logit_err=logit_err,
                flagged=len(det.flagged_files()), files=len(det.file_scores),
                batch=batch)


def device_busy_share(run, wall_s: float) -> None:
    """Kernel and copy time on the card during ``run()`` (a profiler trace,
    summed over the device's own events: not over the host-side operators
    and spans, which carry their kernels' time again), over ``wall_s``, the
    same run's unprofiled wall time; and the kernels that took the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    self_us = lambda e: getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0))
    evts = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=self_us, reverse=True)
    busy_s = sum(self_us(e) for e in evts) / 1e6
    if busy_s <= 0:
        seen = sorted({str(e.device_type) for e in prof.key_averages()})
        print("device busy share: not measured (the profiler saw no device "
              f"events; event device types {seen})")
        return
    top = ", ".join(f"{e.key[:60]} {self_us(e) / 1e3:.1f} ms x{e.count}"
                    for e in evts[:8])
    print(f"device busy share of the steady run {busy_s / wall_s:.3f} "
          f"({busy_s:.3f} s of kernels in {wall_s:.3f} s); top kernels: {top}")


def check_small_detect() -> float:
    """Small float32 detection: the card's kernels against the CPU's plain
    versions, same converted weights."""
    import torch

    from nerrf_tpu_torch.data import SimConfig, simulate_trace
    from nerrf_tpu_torch.graph import GraphConfig
    from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig
    from nerrf_tpu_torch.models import build_nerrfnet
    from nerrf_tpu_torch.pipeline import model_detect
    from nerrf_tpu_torch.train.data import DatasetConfig

    cfg = JointConfig(gnn=GraphSAGEConfig(hidden=32, num_layers=4,
                                          dtype=torch.float32),
                      lstm=LSTMConfig(hidden=32, num_layers=2,
                                      dtype=torch.float32))
    cpu = build_nerrfnet(cfg, seed=3, device="cpu")
    gpu = build_nerrfnet(cfg, seed=3)
    tr = simulate_trace(SimConfig(duration_sec=60.0, attack=True,
                                  attack_start_sec=20.0, num_target_files=4,
                                  benign_rate_hz=20.0, seed=2))
    ds = DatasetConfig(graph=GraphConfig(window_sec=45.0, stride_sec=20.0,
                                         max_nodes=64, max_edges=128),
                       seq_len=24, max_seqs=32)
    a = model_detect(tr, cpu, ds, device="cpu").file_scores
    b = model_detect(tr, gpu, ds).file_scores
    if a.keys() != b.keys():
        _fail("small detection: CPU and card score different files")
    err = max(abs(a[k] - b[k]) for k in a)
    if err > DETECT_ATOL:
        _fail(f"small detection: card vs CPU file scores max |Δ| {err}")
    return err


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from nerrf_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the nerrf_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    smi = _smi()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    try:
        t0 = time.perf_counter()
        built = kernels.build()
        print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
              f"(per source: {built})")
        for name in kernels.KERNELS:
            log = kernels.library_path(name).with_suffix(".log")
            if log.exists():
                for line in log.read_text().splitlines():
                    if "registers" in line or "spill" in line:
                        print(f"ptxas {name}: {line.strip()}")
        errors = check_kernels()
        main_path = run_main_path()
        timing = time_kernels(main_path["batch"], errors)
        small_err = check_small_detect()
    except Exception as e:  # any failed phase fails the smoke
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    replaces = {
        "sage_aggregate": "nerrf_tpu/ops/pallas_segment.py:440",
        "gather_rows": "nerrf_tpu/ops/pallas_segment.py:325",
        "segment_sum": "nerrf_tpu/ops/pallas_segment.py:91",
    }
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"nerrf_tpu_torch/ops/csrc/{name}.cu",
         "replaces": replaces[name],
         "launches": main_path["launches"][name],
         "max_abs_err": max(errors[name].values()),
         **{k: timing[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}}
        for name in kernels.KERNELS]}
    print("kernel errors by case: " + json.dumps(errors))
    print(f"sage_aggregate on the main path: "
          f"{timing['sage_aggregate']['live_edges_per_window']:.1f} weighted "
          f"edges per window in both views, of {2 * MAIN_E} slots; longest "
          f"band (dst view, src view) {timing['sage_aggregate']['longest_band']} "
          f"live edges; segment_sum's longest run "
          f"{timing['segment_sum']['longest_run']} rows")
    print(f"model_detect 4096n/4096e/4096s: {main_path['windows']} windows in "
          f"{main_path['batches']} batches; first run {main_path['first_s']:.3f} s "
          f"({main_path['first_windows_per_s']:.3f} windows/s), steady "
          f"{main_path['steady_s']:.3f} s ({main_path['windows_per_s']:.3f} "
          f"windows/s); {main_path['files']} files scored, "
          f"{main_path['flagged']} flagged; small f32 detection card vs CPU "
          f"max |Δ| {small_err:.2e}; on {smi}")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
