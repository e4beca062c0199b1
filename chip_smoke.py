#!/usr/bin/env python3
"""Chip smoke of nerrf_tpu_torch, the PyTorch/CUDA port of NERRF detection and
training.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's five CUDA kernels from ``nerrf_tpu_torch/ops/csrc/``
(``nvcc``, ``sm_90a``, one process per source, all started together) and
holds each against its plain PyTorch version on the card (float32 and
bfloat16; masked edges, empty segments, skewed bands, bands past the end,
out-of-range ids, empty inputs; for ``sage_aggregate``'s chunked two-view
reduction 1193-edge bands in either view and in both on one node and the
builder's padding tail, at F = 160 and 24, bit-equal over two runs; for the
two chunked segment sums long
segments at F = 160, 24 and 1: 4096 rows on one segment, the builder's
padding tail at both rungs, fewer rows than a chunk; for the two gathers,
one row-copy kernel, bit for bit: F = 160, 24, 19, 7 and 1, tables off
16-byte alignment, both rungs' padding tails, long runs of one id), each
result of the chunked sums bit-equal over two runs and with or without the
ids' segment plan, and each op's backward (an autograd Function whose
backward is the adjoint kernel) against the plain version's gradient, with
and without a plan.  Then it drives the four paths the port has, each with the
launch counters set to 0 just before it and read just after:

* ``model_detect`` with the full-width ``NerrfNet`` (28-layer GraphSAGE-T of
  width 160, 2x256 BiLSTM, bfloat16, random weights from a seed) over a
  simulated trace whose windows land on the 4096-node / 4096-edge /
  4096-sequence rung (``fused`` aggregation);
* ``OnlineDetectionService``, the online serve scorer, with the same model:
  warmup of a one-bucket ladder (the rung ``fit_capacity`` gives over four
  streams of the detection trace's recipe, seeds 5-8), the four streams fed
  concurrently from their own threads in blocks of 200 events, each
  stream's result bit-equal to ``model_detect``, a hot swap to a seed-1
  model (bit-equal too), and the default ladder of 10 buckets;
* ``train_nerrfnet`` at the ``configs/joint-100h.json`` rung (the same
  model with dropout 0.1, batches of 8 graphs of 1024 nodes / 2048 edges and
  128 sequences of 100 steps, AdamW on the warmup-cosine schedule) in the
  ``segment`` aggregation mode, for 20 steps over ``make_corpus`` cut to 2
  traces;
* ``run_experiment``, the experiment runner, over ``configs/joint-100h.json``
  cut to 6 traces (2 held out) and 200 steps in the ``fused`` mode (the
  port's ``auto``): training, the held-out evaluation, the checkpoint and
  the calibration of the file threshold over nine simulated incidents.
  The checkpoint is loaded back: the loaded model must give the in-memory
  model's ``model_detect`` bits on the held-out attack trace and reproduce
  ``metrics.json``'s held-out metrics; the calibration must be in the
  sidecar or reported unreachable.  A small float32 experiment runs on the
  card and on the CPU from the same init, and their held-out metrics and
  calibrations must agree.

The counters must show the launches derived from the model's structure on
each (on the serve path, in every scored batch), and two ``model_detect``
runs must give the same file scores, bit for bit; the serve run must drop
no window, fail none, score none at a shape it did not warm, and share
batches across streams.  One training step's gradients are compared, kernels against plain
versions, in ``segment`` and ``fused`` modes, and two runs on the kernels
must give the same bits; a small float32 detection and
a small float32 training run on the card are compared with the same runs on
the CPU.  Each kernel is then checked and timed at its call sites on the
inputs each path gives it (its first batch's edge views and sequence
routing), beside its plain version, one PyTorch library call and its bound,
with the host's enqueue time per call (with the launch's host path as it
is, and untrimmed) and the profiler's device time per launch of the kernel
and of the library call; the chunked sums also with their structure built
per call, and on the same rows with the padding tail spread over distinct
segments (``sage_aggregate`` with every band spread, and with its padding
tail alone spread).  Where one gather call's host time goes is split step
by step.
The result line holds each kernel at its main call site on its own path, as
the path calls it.

Prints the card's name and power limit, one JSON line with each kernel's
launches (and its launches per serve batch and per experiment run), error,
times (ms, host_us, device_ms, library_ms, library_device_ms) and bound,
the detection rate, the serve rate, latency and warmup times, the training
rate and its breakdown, the experiment's steps/s, time split, held-out
metrics, calibration and gates, the card's busy share from profiler
traces, and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result
line, when a phase fails or there is no card.
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

# the training rung: configs/joint-100h.json, its corpus cut to 2 traces (1
# attack, 1 benign, 600 s each) and its 12000 steps to 20; the loss is read
# every 5 steps (the config logs every 500)
ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_CONFIG = os.path.join(ROOT, "configs", "joint-100h.json")
TRAIN_TRACES = 2
TRAIN_STEPS = 20
TRAIN_LOG_EVERY = 5
TRAIN_RUNG = (1024, 2048, 128, 100)     # nodes, edges, sequences, steps
# one full-width step's gradients, kernels vs plain versions, per parameter:
# ‖Δg‖ ≤ GRAD_RTOL[mode]·‖g‖ (the measured values are in PERF.md).  Two runs
# on the kernels give the same bits in both modes (checked).  segment:
# kernels and plain versions sum each row in f32 and round once to bf16, and
# every run on the H100 read 0, plain vs plain 0 too.  fused: kernels vs
# plain read 1.759e-2 and 1.761e-2 (gnn.aux_emb.weight; median 4.3e-3),
# plain vs plain 2.8e-3 and 3.4e-3 (the plain sums' index_add_ atomics),
# in two runs on an H100 80GB HBM3 at 700 W: sums taken in another order
# leave bf16 forwards one ulp apart after an op, carried through 28 residual
# layers and back.  The limit was 0.05 while the precompute's own atomics
# added to that spread
GRAD_RTOL = {"segment": 1e-3, "fused": 0.025}
# small float32 training (3 steps), card vs CPU: relative loss difference
SMALL_TRAIN_RTOL = 1e-4

# the experiment phase: configs/joint-100h.json through run_experiment, its
# corpus cut from 24 traces to 6 (eval_fraction 0.25 holds out 2: corpus-4-
# benign and corpus-5-atk; at 4 traces the one held-out trace is benign and
# every AUC reads its degenerate 0.5), its 12000 steps to 200 and its loss
# read every 50 steps (the config: 500); nothing else changed
EXPERIMENT_TRACES = 6
EXPERIMENT_STEPS = 200
EXPERIMENT_LOG_EVERY = 50
# the runner's report, as the reference's train/run.py writes it
REPORT_KEYS = {"experiment", "backend", "devices", "num_steps", "steps_per_sec",
               "metrics", "calibration", "gates", "wall_seconds"}
HELD_OUT = ("edge_auc", "node_auc", "seq_auc", "seq_f1", "node_f1")
# the small float32 experiment (configs/toy-graphsage.json's shapes, dropout
# 0, segment mode, 20 steps), card vs CPU: each held-out metric of
# metrics.json (4 decimals) within two units of its last decimal (a value on
# a rounding boundary may round either way), the calibration's cuts within
# 1e-5 (the CPU tests hold the port against the reference at these limits)
SMALL_RUN_STEPS = 20
SMALL_RUN_ATOL = 2e-4
SMALL_CUT_ATOL = 1e-5


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def _sync() -> None:
    import torch

    torch.cuda.synchronize()


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


def device_split(fn, iters: int = 20, warmup: int = 3) -> dict:
    """Device time of one ``fn()`` call by kernel, from a ``torch.profiler``
    trace of ``iters`` calls after ``warmup``: {kernel name: ms per call},
    the card's own events only (not the host-side operators)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    _sync()
    self_us = lambda e: getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0))
    split = {}
    for _ in range(3):  # a trace that caught no device event is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            _sync()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and self_us(e) > 0 \
                    and not getattr(e, "is_user_annotation", False):
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ").split("<")[0].split("(")[0]
                name = ("nerrf::" if "nerrf::" in e.key else "") + name.split("::")[-1][:48]
                split[name] = split.get(name, 0.0) + self_us(e) / 1e3 / iters
        if split:
            break
    return split


def port_kernel_ms(split: dict) -> float:
    """The port's own kernels' share of a :func:`device_split`."""
    return sum(v for k, v in split.items() if k.startswith("nerrf::"))


def host_us(fn, iters: int = 200, warmup: int = 10) -> float:
    """Host time per ``fn()`` call in µs, not waiting for the card: the
    enqueue cost that bounds a launch-bound loop of such calls."""
    for _ in range(warmup):
        fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    _sync()
    return us


def _untrimmed_stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def _untrimmed_launch(name: str, device, *args, stream=None) -> None:
    """``kernels._launch`` before its host trims: the guard through the
    ``torch.cuda.device`` context manager, the stream handle through a
    ``torch.cuda.Stream`` object."""
    import torch

    from nerrf_tpu_torch.ops import kernels

    with torch.cuda.device(device):
        err = kernels._fn(name)(*args, _untrimmed_stream(device)
                                if stream is None else stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def host_us_trimmed_untrimmed(fn) -> tuple:
    """:func:`host_us` of ``fn`` as the port launches, and with the launch's
    stream handle and device guard taken as before their trims; in turns
    (trimmed, untrimmed, untrimmed, trimmed), each side's mean."""
    from nerrf_tpu_torch.ops import kernels

    def untrimmed():
        launch, stream = kernels._launch, kernels._stream
        kernels._launch, kernels._stream = _untrimmed_launch, _untrimmed_stream
        try:
            return host_us(fn)
        finally:
            kernels._launch, kernels._stream = launch, stream

    a, b, c, d = host_us(fn), untrimmed(), untrimmed(), host_us(fn)
    return (a + d) / 2, (b + c) / 2


def round_robin_ms(fns: dict, rounds: int = 15, warmup: int = 2) -> dict:
    """Median ms of each ``fns`` entry on the host clock, synced before and
    after each call, the entries run in turn round after round."""
    import statistics

    times = {name: [] for name in fns}
    for r in range(warmup + rounds):
        for name, fn in fns.items():
            _sync()
            t0 = time.perf_counter()
            fn()
            _sync()
            if r >= warmup:
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(v) for name, v in times.items()}


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
    from nerrf_tpu_torch.ops import plain_ops

    got = fn(*args, **kw)
    with plain_ops():
        want = fn(*args, **kw)
    _sync()
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


def sage_graph(B, N, E, gen, device, n_valid=None, zero_frac=0.0, dst_values=None,
               dst_band=None, src_band=None):
    """Builder-like window graphs: dst-sorted edges, the padding tail pointing
    at the last node with weight 0, the src-sorted view, and pre-normalized
    weights in both orders.  ``dst_band``/``src_band`` = (node, count): the
    first / last ``count`` edges of each window have that node as their
    destination / source, a long band in the dst / src view."""
    import torch

    n_valid = E if n_valid is None else n_valid
    src = torch.randint(0, N, (B, E), generator=gen)
    dst = (torch.randint(0, N, (B, E), generator=gen) if dst_values is None
           else torch.full((B, E), dst_values))
    if dst_band:
        dst[:, :dst_band[1]] = dst_band[0]
    if src_band:
        src[:, E - src_band[1]:] = src_band[0]
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
    """``sage_aggregate`` and ``segment_sum`` against their plain versions
    on the card, float32 and bfloat16, on synthetic inputs at the detection
    path's shapes and on the edge cases (masked edges, empty rows, a skewed
    band, odd and empty shapes; for sage_aggregate's chunked reduction also
    1193-edge bands in either view and in both on one node and the padding
    tail, at F = 160 and 24, bit-equal over two runs).  Returns the max |Δ|
    of each case, by kernel."""
    import torch

    from nerrf_tpu_torch.ops import kernels
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
        # the redesign's cases at F = 160 and 24: a 1193-edge live band (the
        # detection rung's longest) in the dst view, in the src view, and one
        # in each view on one node; the builder's padding tail (2100 weight-0
        # edges a view on the last node, the detection rung's).  Each result
        # bit-equal over two runs
        bands = {
            "band-dst": dict(dst_band=(17, 1193)),
            "band-src": dict(src_band=(17, 1193)),
            "bands-both": dict(dst_band=(5, 1193), src_band=(5, 1193)),
            "padding-detect": dict(n_valid=E - 2100),
        }
        for case, opts in bands.items():
            edges = sage_graph(B, N, E, gen, dev, **opts)
            for Fc in (MAIN_F, SEQ_F):
                msg = torch.randn(B, N, Fc, generator=gen).to(dev, dt)
                got, want = _both(ops.sage_aggregate, msg, *edges, N)
                errs[f"{case}/F{Fc}/{name}"] = _close(
                    f"sage_aggregate {case} F={Fc}", got, want, name,
                    _sage_scale(msg, edges, N))
                if not torch.equal(got, ops.sage_aggregate(msg, *edges, N)):
                    _fail(f"sage_aggregate {case} F={Fc}: two runs differ")
        _sync()
        if any(bool(buf.any()) for (_, _, sdt), buf in kernels._SCRATCH.items()
               if sdt == torch.int32):
            _fail("sage_aggregate: the arrival counters were not reset")
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
        _sync()
        if got.shape != (B, 64, F) or float(got.abs().max()) != 0.0:
            _fail("sage_aggregate: E=0 must give zeros")
    report["sage_aggregate"] = errs

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
        _sync()
        if float(got[0, 0, 0]) != 2.0 or float(got[0, 3, 0]) != 1.0 \
                or float(got[0, [1, 2, 4, 5]].abs().max()) != 0.0:
            _fail("segment_sum: empty segments are not exactly zero")
        got = ops.segment_sum(torch.zeros(B, 0, SEQ_F, device=dev).to(dt),
                              torch.zeros(B, 0, dtype=torch.int32, device=dev), 5)
        _sync()
        if got.shape != (B, 5, SEQ_F) or float(got.abs().max()) != 0.0:
            _fail("segment_sum: S=0 must give zeros")
    report["segment_sum"] = errs
    return report


def sage_library(msg, edges, N):
    """One cuSPARSE product computing the same aggregation: the block-diagonal
    [B·N, B·N] CSR matrix of both directions' weights times msg, as a
    callable.  None when this PyTorch has no CSR product for msg's type."""
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
        torch.sparse.mm(mat, dense)
    except (RuntimeError, NotImplementedError) as e:
        print(f"library_ms for sage_aggregate not measured: {e}".splitlines()[0])
        return None
    return lambda: torch.sparse.mm(mat, dense)


def time_kernels(batch: dict, report: dict, tag: str) -> dict:
    """Each kernel on the inputs a path gives it (the first batch of 8
    windows of that path: its edge views, its sequence routing; random
    activations of the model's widths and types): the kernel against its
    plain version, and the times of the kernel, the plain version (the same
    call under ``plain_ops``; it ignores the precomputed row pointers) and
    one PyTorch library call computing the same function, beside the bound
    of the work these inputs need; the host's enqueue time of the call
    (``host_us``, and ``host_us_untrimmed`` with the launch's stream handle
    and device guard as they were before their trims), and from the
    profiler the device time per call of the port's kernel (``device_ms``)
    and of the library call (``library_device_ms``, all its kernels).  One
    entry per call site,
    named by its kernel where that is the kernel's main call site on the
    training path.  ``tag`` names the inputs in ``report``."""
    import torch

    from nerrf_tpu_torch.models.graphsage import fused_edge_views
    from nerrf_tpu_torch.ops import (
        gather_rows, gather_rows_sorted, plain_ops, sage_aggregate,
        sage_row_ptrs, segment_plan, segment_sum, segment_sum_sorted)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(99)
    t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    B, N = t["node_mask"].shape
    E = t["edge_mask"].shape[1]
    F, elt = MAIN_F, 2                           # bf16 activations
    offsets = torch.arange(B, device=dev)[:, None]

    def timed(name, call, library, nbytes, ops, scale=None, case="",
              per_call=None, band_free=None):
        got, want = _both(call)
        dtype_name = str(got.dtype).split(".")[1]
        report[name][f"{tag}{case}/{dtype_name}"] = _close(
            f"{name} {tag}{case}", got, want, dtype_name, scale)
        ms = cuda_ms(call)
        with plain_ops():
            plain_ms = cuda_ms(call, iters=10)
        b_ms, b_by = bound_ms(nbytes, ops)
        res = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None if library is None else cuda_ms(library),
                   library_device_ms=None if library is None
                   else sum(device_split(library).values()),
                   device_ms=port_kernel_ms(device_split(call)))
        res["host_us"], res["host_us_untrimmed"] = host_us_trimmed_untrimmed(call)
        if per_call is not None:
            # the chunked reductions: ms and host enqueue time with the
            # structure built per call (no plan or row pointers), and the
            # device time per launch of the same rows with the padding tail
            # (for sage_aggregate every band) spread over distinct segments
            # (band-free)
            res["per_call_ms"] = cuda_ms(per_call)
            res["per_call_host_us"] = host_us(per_call)
            res["band_free_device_ms"] = port_kernel_ms(device_split(band_free))
        return res

    def longest_run(ids, n):
        return int(torch.bincount((ids.long() + offsets * n).reshape(-1)).max())

    # sage_aggregate: the model's edge views; every layer launches on them
    w32 = (t["edge_feat"][..., 12] + 0.1) * t["edge_mask"].float()
    edges = fused_edge_views(t["edge_src"], t["edge_dst"], w32, N)[0]
    ptrs = sage_row_ptrs(edges[0], edges[2], N)
    msg = torch.randn(B, N, F, generator=gen).to(dev, torch.bfloat16)
    live = int((edges[4] != 0).sum() + (edges[6] != 0).sum())
    ramp = torch.arange(E, device=dev).expand(B, -1)

    def respread(src, dst):
        """The views of the same edges (weights) with other endpoints,
        re-sorted by destination as the builder sorts."""
        order = torch.argsort(dst, dim=1, stable=True)
        take = lambda x: torch.gather(x, 1, order)
        views = fused_edge_views(take(src).to(torch.int32), take(dst).to(torch.int32),
                                 take(w32), N)[0]
        vp = sage_row_ptrs(views[0], views[2], N)
        return lambda: sage_aggregate(msg, *views, N, row_ptrs=vp)

    # band-free: every edge's endpoints spread over distinct nodes (dst e % N,
    # src a permutation of it), so no node has a long band in either view;
    # padding spread: only the padding tail's endpoints spread, the live
    # bands kept, so (as is) - (padding spread) is the padding node's share
    spread_dst, spread_src = ramp % N, (ramp * 1031 + 7) % N
    pad = ~t["edge_mask"]
    pad_spread = respread(torch.where(pad, spread_src, t["edge_src"]),
                          torch.where(pad, spread_dst, t["edge_dst"]))
    out = {"sage_aggregate": timed(
        "sage_aggregate",
        lambda: sage_aggregate(msg, *edges, N, row_ptrs=ptrs),
        sage_library(msg, edges, N),
        2 * B * N * F * elt + B * E * (4 * 4 + 2 * 4), 2 * F * live,
        _sage_scale(msg, edges, N),
        per_call=lambda: sage_aggregate(msg, *edges, N),
        band_free=respread(spread_src, spread_dst))}
    out["sage_aggregate"]["pad_spread_device_ms"] = port_kernel_ms(device_split(pad_spread))
    out["sage_aggregate"]["live_edges_per_window"] = live / B
    out["sage_aggregate"]["padding_edges_per_window"] = float(pad.sum()) / B
    out["sage_aggregate"]["longest_band"] = [
        int(torch.zeros(B, N, device=dev).scatter_add_(
            1, ids.long(), (w != 0).float()).max())
        for ids, w in ((edges[0], edges[4]), (edges[2], edges[6]))]

    # gather_rows: the edge head's h[src] (h[dst] is the same work)
    h = torch.randn(B, N, F, generator=gen).to(dev, torch.bfloat16)
    idx = t["edge_src"]
    flat_idx = (idx.long() + offsets * N).reshape(-1)
    rows = sum(int(torch.unique(idx[b]).numel()) for b in range(B))
    out["gather_rows"] = timed(
        "gather_rows", lambda: gather_rows(h, idx),
        lambda: torch.index_select(h.reshape(B * N, F), 0, flat_idx),
        rows * F * elt + idx.numel() * 4 + B * E * F * elt, 0)

    # the padding tail (edge_mask false) spread over distinct segments: the
    # band-free ids the chunked sums are also timed on
    live = t["edge_mask"]
    spread = (torch.arange(E, device=dev) % N).expand(B, -1)
    band_free = lambda ids: torch.where(live, ids, spread).to(torch.int32)

    # segment_sum, two call sites.  The backward of a layer's gather (h[src]):
    # a [B, E, H] bf16 cotangent summed by the unsorted edge_src into N rows,
    # the padding tail's rows all on the last node; 58 of a segment-mode
    # training step's 59 launches are such backwards, each over the plan the
    # forward took once
    src = t["edge_src"]
    flat_src = (src.long() + offsets * N).reshape(-1)
    gsrc = torch.randn(B, E, F, generator=gen).to(dev, torch.bfloat16)
    plan_src = segment_plan(src, N)
    src_free = band_free(src)
    plan_free = segment_plan(src_free, N)
    out["segment_sum"] = timed(
        "segment_sum", lambda: segment_sum(gsrc, src, N, plan=plan_src),
        lambda: torch.zeros(B * N, F, dtype=gsrc.dtype, device=dev)
        .index_add_(0, flat_src, gsrc.reshape(-1, F)),
        gsrc.numel() * elt + src.numel() * 4 + B * N * F * elt, gsrc.numel(),
        _segment_scale(gsrc, src, N), case="-gather-backward",
        per_call=lambda: segment_sum(gsrc, src, N),
        band_free=lambda: segment_sum(gsrc, src_free, N, plan=plan_free))
    out["segment_sum"]["longest_run"] = longest_run(src, N)
    # the fusion: float32 rows into N + 1 slots, unmatched sequences routed to
    # slot N (the detection path's one call, once per training forward; the
    # path passes no plan, so the call builds its own)
    sni = t["seq_node_idx"]
    ids = torch.where(sni >= 0, sni, N).to(torch.int32)
    S = ids.shape[1]
    ids_free = torch.where(sni >= 0, sni, torch.arange(S, device=dev) % (N + 1)
                           ).to(torch.int32)
    data = torch.randn(B, S, SEQ_F, generator=gen).to(dev)
    flat = (ids.long() + offsets * (N + 1)).reshape(-1)
    out["segment_sum_fusion"] = timed(
        "segment_sum", lambda: segment_sum(data, ids, N + 1),
        lambda: torch.zeros(B * (N + 1), SEQ_F, device=dev)
        .index_add_(0, flat, data.reshape(-1, SEQ_F)),
        data.numel() * 4 + ids.numel() * 4 + B * (N + 1) * SEQ_F * 4,
        data.numel(), _segment_scale(data, ids, N + 1), case="-fusion",
        per_call=lambda: segment_sum(data, ids, N + 1),
        band_free=lambda: segment_sum(data, ids_free, N + 1))
    out["segment_sum_fusion"]["longest_run"] = longest_run(ids, N + 1)

    # segment_sum_sorted: a segment-mode layer's weighted messages (data·w,
    # [B, E, H] bf16) onto the dst-sorted ids, and its weight denominator
    # (w, [B, E, 1]); every band includes the padding edges (weight 0); both
    # over the plan the forward took once
    dst = t["edge_dst"]
    flat_dst = (dst.long() + offsets * N).reshape(-1)
    plan_dst = segment_plan(dst, N, sorted_ids=True)
    dst_free = torch.sort(band_free(dst), dim=1)[0]
    plan_dst_free = segment_plan(dst_free, N, sorted_ids=True)
    wmsg = torch.randn(B, E, F, generator=gen).to(dev, torch.bfloat16)
    w1 = w32.to(torch.bfloat16)[..., None]
    for key, d in (("segment_sum_sorted", wmsg), ("segment_sum_sorted_f1", w1)):
        Fd = d.shape[-1]
        out[key] = timed(
            "segment_sum_sorted",
            lambda d=d: segment_sum_sorted(d, dst, N, plan=plan_dst),
            lambda d=d, Fd=Fd: torch.zeros(B * N, Fd, dtype=d.dtype, device=dev)
            .index_add_(0, flat_dst, d.reshape(-1, Fd)),
            d.numel() * elt + dst.numel() * 4 + B * N * Fd * elt, d.numel(),
            _segment_scale(d, dst, N), case="" if Fd == F else "-f1",
            per_call=lambda d=d: segment_sum_sorted(d, dst, N),
            band_free=lambda d=d: segment_sum_sorted(d, dst_free, N,
                                                     plan=plan_dst_free))
    src_sorted = torch.sort(t["edge_src"], dim=1)[0]
    out["segment_sum_sorted"]["longest_band"] = [
        longest_run(dst, N), longest_run(src_sorted, N)]

    # gather_rows_sorted: the backward of that sum, a [B, N, H] bf16
    # cotangent gathered by the dst-sorted ids
    g = torch.randn(B, N, F, generator=gen).to(dev, torch.bfloat16)
    rows = sum(int(torch.unique(dst[b]).numel()) for b in range(B))
    out["gather_rows_sorted"] = timed(
        "gather_rows_sorted", lambda: gather_rows_sorted(g, dst),
        lambda: torch.index_select(g.reshape(B * N, F), 0, flat_dst),
        rows * F * elt + dst.numel() * 4 + B * E * F * elt, 0)
    return out


def gather_host_split(batch: dict) -> dict:
    """Where the host's time of one gather call goes, at the training rung
    (a layer's ``msg[edge_src]``, [8, 1024, 160] bf16 by [8, 2048] int32):
    the enqueue time (µs per call, not waiting for the card) of the op call
    whole, of each step of its chain on the same operands alone (the
    ``ctypes`` call also on a dtype code the entry refuses before it
    launches), and of the raw spellings of the launch's stream handle and
    device guard; the whole call and the launcher also with the launch
    untrimmed."""
    import torch

    from nerrf_tpu_torch.ops import gather_rows, kernels
    from nerrf_tpu_torch.ops import segment as ops

    dev = torch.device("cuda", torch.cuda.current_device())
    idx = torch.from_numpy(batch["edge_src"]).to(dev)
    B, E = idx.shape
    N, F = batch["node_mask"].shape[1], MAIN_F
    table = torch.randn(B, N, F, device=dev).to(torch.bfloat16)
    out = torch.empty(B, E, F, dtype=table.dtype, device=dev)
    fn = kernels._fn("gather_rows")
    args = (table.data_ptr(), kernels.dtype_code(table), idx.data_ptr(), B, N, E,
            F, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

    class Noop(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, i, plan):
            return t

    def device_guard():
        with torch.cuda.device(dev):
            pass

    def raw_guard():
        torch._C._cuda_maybeExchangeDevice(torch._C._cuda_exchangeDevice(dev.index))

    steps = {
        "c_ctypes_call": lambda: fn(*args),
        "c0_ctypes_call_no_launch": lambda: fn(args[0], -1, *args[2:]),
        "d_current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "e_device_guard": device_guard,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "raw_device_exchange": raw_guard,
        "function_apply_noop": lambda: Noop.apply(table, idx, None),
        "use_kernel": lambda: ops._use_kernel("gather_rows", table, idx),
        "table_contiguous": lambda: table.contiguous(),
        "int32_idx": lambda: ops._int32(idx),
        "torch_empty": lambda: torch.empty(B, E, F, dtype=table.dtype, device=dev),
        "empty_call": lambda: None,
    }
    # 200 calls of a step that launches (the card's queue takes them all
    # without the host waiting), 2000 of the others
    split = {name: host_us(step, iters=200 if name == "c_ctypes_call" else 2000,
                           warmup=50)
             for name, step in steps.items()}
    for name, step in (("a_gather_rows", lambda: gather_rows(table, idx)),
                       ("b_launch_gather",
                        lambda: kernels.launch_gather("gather_rows", table, idx, out))):
        split[name], split[f"{name}_untrimmed"] = host_us_trimmed_untrimmed(step)
    _sync()
    return split


# --- the main path ------------------------------------------------------------


def detect_trace():
    """The detection cell's simulated trace and the dataset config of the
    rung it lands on."""
    from nerrf_tpu_torch.data import SimConfig, simulate_trace
    from nerrf_tpu_torch.pipeline import fit_capacity
    from nerrf_tpu_torch.train.data import DatasetConfig

    trace = simulate_trace(SimConfig(duration_sec=120.0, benign_rate_hz=200.0,
                                     num_target_files=48, seed=5))
    return trace, fit_capacity(trace, DatasetConfig())


def run_main_path() -> dict:
    import numpy as np
    import torch

    from nerrf_tpu_torch import tracing
    from nerrf_tpu_torch.models import JointConfig, build_nerrfnet
    from nerrf_tpu_torch.ops import LAUNCHES, plain_ops, reset_launches
    from nerrf_tpu_torch.pipeline import (
        MODEL_INPUTS, make_eval_fn, model_detect, pad_batch)
    from nerrf_tpu_torch.train.data import windows_of_trace

    cfg = JointConfig()
    model = build_nerrfnet(cfg, seed=0, device="cuda")
    trace, ds = detect_trace()
    rung = (ds.graph.max_nodes, ds.graph.max_edges, ds.max_seqs)
    print(f"main path: {trace.events.num_valid} events, rung "
          f"{rung[0]}n/{rung[1]}e/{rung[2]}s, hidden {cfg.gnn.hidden} x "
          f"{cfg.gnn.num_layers} layers, LSTM {cfg.lstm.num_layers}x{cfg.lstm.hidden}")
    if rung != (4096, 4096, 4096):
        _fail(f"the trace landed on rung {rung}, not 4096n/4096e/4096s")

    _sync()
    reset_launches()
    t0 = time.perf_counter()
    det = model_detect(trace, model, device="cuda")
    _sync()
    first_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    windows = [s.args["windows"] for s in tracing.records()
               if s.name == "bucket_pad"][-1]
    batches = math.ceil(windows / 8)
    want = {k: batches * v for k, v in fused_forward_launches(cfg.gnn.num_layers).items()}
    print(f"launches {launches}, expected {want} ({windows} windows, "
          f"{batches} batches)")
    if launches != want:
        _fail(f"launch counts {launches} != {want}")

    t0 = time.perf_counter()
    det2 = model_detect(trace, model, device="cuda")
    _sync()
    steady_s = time.perf_counter() - t0
    scores = np.array(list(det.file_scores.values()))
    if not len(scores) or not np.all(np.isfinite(scores)) \
            or scores.min() < 0 or scores.max() > 1:
        _fail("model_detect gave no file scores, or scores outside [0, 1]")
    if det.file_scores != det2.file_scores:
        diff = max(abs(det.file_scores[k] - det2.file_scores.get(k, math.inf))
                   for k in det.file_scores)
        _fail(f"two model_detect runs differ: file scores max |Δ| {diff}")
    print(f"two model_detect runs: {len(det.file_scores)} file scores, bit-equal")

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
    args = [torch.from_numpy(np.ascontiguousarray(batch[k])).to("cuda")
            for k in MODEL_INPUTS]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(*args), iters=3, warmup=1)
        lstm_ms = cuda_ms(lambda: model.lstm(args[8], args[9]), iters=3, warmup=1)
    print(f"steady run breakdown: host lowering {lower_s:.3f} s, scoring "
          f"{score_s:.3f} s over {batches} batches; one batch on the card: "
          f"forward {fwd_ms:.1f} ms, of which LSTM {lstm_ms:.1f} ms, GNN + "
          f"fusion {fwd_ms - lstm_ms:.1f} ms")
    device_busy_share("the steady model_detect run",
                      lambda: model_detect(trace, model, device="cuda"), steady_s)
    return dict(windows=windows, batches=batches, launches=launches,
                first_s=first_s, steady_s=steady_s,
                windows_per_s=windows / steady_s,
                first_windows_per_s=windows / first_s, logit_err=logit_err,
                flagged=len(det.flagged_files()), files=len(det.file_scores),
                batch=batch)


def device_busy_share(what: str, run, wall_s: float):
    """Kernel and copy time on the card during ``run()`` (a profiler trace,
    summed over the device's own events: not over the host-side operators
    and spans, which carry their kernels' time again), over ``wall_s``, the
    same run's unprofiled wall time; and the kernels that took the most.
    Returns the share, or None when the trace caught no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        _sync()
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
        return None
    top = ", ".join(f"{e.key[:60]} {self_us(e) / 1e3:.1f} ms x{e.count}"
                    for e in evts[:8])
    print(f"device busy share of {what} {busy_s / wall_s:.3f} "
          f"({busy_s:.3f} s of kernels in {wall_s:.3f} s); top kernels: {top}")
    return busy_s / wall_s


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
    gpu = build_nerrfnet(cfg, seed=3, device="cuda")
    tr = simulate_trace(SimConfig(duration_sec=60.0, attack=True,
                                  attack_start_sec=20.0, num_target_files=4,
                                  benign_rate_hz=20.0, seed=2))
    ds = DatasetConfig(graph=GraphConfig(window_sec=45.0, stride_sec=20.0,
                                         max_nodes=64, max_edges=128),
                       seq_len=24, max_seqs=32)
    a = model_detect(tr, cpu, ds, device="cpu").file_scores
    b = model_detect(tr, gpu, ds, device="cuda").file_scores
    if a.keys() != b.keys():
        _fail("small detection: CPU and card score different files")
    err = max(abs(a[k] - b[k]) for k in a)
    if err > DETECT_ATOL:
        _fail(f"small detection: card vs CPU file scores max |Δ| {err}")
    return err


# --- the serve path ------------------------------------------------------------

# the serve cell: four streams from the detection trace's recipe, seeds 5 and
# 7 attacks, 6 and 8 benign, each fed by its own thread in blocks of 200
# events; batches of 8 and the reference's defaults for every other knob
SERVE_SEEDS = {5: True, 6: False, 7: True, 8: False}
SERVE_BLOCK = 200
SERVE_BATCH = 8


def serve_traces() -> dict:
    """{stream id: trace} of the serve cell."""
    from nerrf_tpu_torch.data import SimConfig, simulate_trace

    return {f"s{seed}": simulate_trace(SimConfig(
        duration_sec=120.0, benign_rate_hz=200.0, num_target_files=48,
        seed=seed, attack=attack)) for seed, attack in SERVE_SEEDS.items()}


def _blocks(trace, size: int = SERVE_BLOCK):
    import dataclasses

    ev = trace.events
    for i in range(0, len(ev), size):
        yield type(ev)(**{f.name: getattr(ev, f.name)[i:i + size]
                          for f in dataclasses.fields(ev)})


def _counter_total(reg, name: str, **labels) -> float:
    """A counter summed over its label series (those matching ``labels``)."""
    series = reg.snapshot()["counters"].get(name, {})
    want = [f"{k}={v}" for k, v in labels.items()]
    return sum(v for key, v in series.items()
               if all(w in key.split(",") for w in want))


def replay(svc, traces: dict, suffix: str = "") -> tuple:
    """Each trace as one stream of ``svc``, fed from its own thread as the
    reference's ``connect`` actors feed it (join, one ``feed`` per block,
    ``leave``).  Returns ({stream: DetectionResult}, seconds from the first
    feed to the last leave)."""
    import threading

    dets, errors = {}, []

    def actor(sid, trace):
        try:
            svc.join(sid)
            for block in _blocks(trace):
                svc.feed(sid, block, trace.strings)
            dets[sid] = svc.leave(sid, timeout=600.0)
        except Exception as e:  # noqa: BLE001 — raised below, on the caller
            errors.append(e)

    threads = [threading.Thread(target=actor, args=(sid + suffix, tr),
                                name=f"feeder-{sid}{suffix}")
               for sid, tr in traces.items()]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return dets, wall_s


def _counting_service():
    """``OnlineDetectionService`` with each forward's kernel launches kept in
    ``batch_launches``: the launches one ``_run_eval`` call adds to the
    counters, read on the thread that calls it (the only one launching
    while it runs: the start() thread at warmup, then the scorer)."""
    from nerrf_tpu_torch.ops import LAUNCHES
    from nerrf_tpu_torch.serve import OnlineDetectionService

    class CountingService(OnlineDetectionService):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.batch_launches = []

        def _run_eval(self, eval_fn, batch):
            before = dict(LAUNCHES)
            out = super()._run_eval(eval_fn, batch)
            self.batch_launches.append(
                {k: LAUNCHES[k] - before[k] for k in LAUNCHES})
            return out

    return CountingService


def _serve_gates(reg, svc, from_batch: int, want: dict, what: str) -> dict:
    """The serve run's gates: no window dropped, failed or scored at an
    unwarmed shape, no failed batch, and each forward since ``from_batch``
    launching the derived counts.  Returns the run's counters."""
    got = {k: _counter_total(reg, f"serve_{k}") for k in (
        "admission_dropped_total", "windows_failed_total",
        "batch_failures_total", "recompiles_total", "windows_scored_total",
        "windows_skipped_total", "windows_admitted_total", "batches_total")}
    bad = {k: v for k, v in got.items() if k in (
        "admission_dropped_total", "windows_failed_total",
        "batch_failures_total", "recompiles_total") and v}
    if bad:
        _fail(f"{what}: {bad}")
    per_batch = svc.batch_launches[from_batch:]
    if not per_batch or any(b != want for b in per_batch):
        _fail(f"{what}: launches per batch {per_batch} != {want}")
    return got


def run_serve_path(detect_rung: tuple) -> dict:
    """The online serve scorer at full width: warmup of the one-bucket ladder
    that fits the four streams, the streams fed concurrently, parity of each
    stream's result with ``model_detect`` bit for bit, a hot swap, and the
    default ladder of 10 buckets."""
    import dataclasses

    import numpy as np
    import torch

    from nerrf_tpu_torch.data import Trace
    from nerrf_tpu_torch.models import JointConfig, build_nerrfnet
    from nerrf_tpu_torch.observability import MetricsRegistry
    from nerrf_tpu_torch.ops import LAUNCHES, kernels, reset_launches
    from nerrf_tpu_torch.pipeline import fit_capacity, model_detect
    from nerrf_tpu_torch.serve import ServeConfig, bucket_tag
    from nerrf_tpu_torch.train.data import DatasetConfig, windows_of_trace

    model_cfg = JointConfig()
    model = build_nerrfnet(model_cfg, seed=0, device="cuda")
    traces = serve_traces()
    fits = [fit_capacity(tr, DatasetConfig()) for tr in traces.values()]
    bucket = (max(f.graph.max_nodes for f in fits),
              max(f.graph.max_edges for f in fits),
              max(f.max_seqs for f in fits))
    tag = bucket_tag(bucket)
    cfg = ServeConfig(buckets=(bucket,), batch_size=SERVE_BATCH)
    ds = cfg.dataset_config(bucket)
    windows = {sid: len(windows_of_trace(tr, ds)) for sid, tr in traces.items()}
    print(f"serve path: {len(traces)} streams "
          f"({', '.join(f'{sid} {tr.events.num_valid} events' for sid, tr in traces.items())}), "
          f"one-bucket ladder {tag} (model_detect's rung for s5 alone: "
          f"{bucket_tag(detect_rung)}), {sum(windows.values())} windows to score, "
          f"batches of {SERVE_BATCH}, blocks of {SERVE_BLOCK} events")
    per_batch = fused_forward_launches(model_cfg.gnn.num_layers)

    reg, log = MetricsRegistry(), []
    svc = _counting_service()(model, cfg, registry=reg, window_log=log,
                              device="cuda")
    _sync()
    reset_launches()
    t0 = time.perf_counter()
    svc.start()
    start_s = time.perf_counter() - t0
    warm = dict(LAUNCHES)
    if not svc.ready()[0]:
        _fail(f"serve: not ready after start(): {svc.ready()}")
    forward_kernels = {k for k, v in per_batch.items() if v}
    if not forward_kernels <= set(kernels._FNS):
        _fail(f"serve: kernel libraries {sorted(forward_kernels - set(kernels._FNS))} "
              "not loaded before admission opened")
    if list(svc.warmup_seconds) != [tag] or svc.batch_launches != [per_batch] \
            or warm != per_batch:
        _fail(f"serve warmup: buckets {svc.warmup_seconds}, launches per batch "
              f"{svc.batch_launches} (counters {warm}) != {per_batch}")
    print(f"serve warmup: {svc.warmup_seconds} s per bucket, start() "
          f"{start_s:.3f} s, launches {warm} (derived {per_batch})")

    t_run = time.perf_counter()
    dets, wall_s = replay(svc, traces)
    stages = serve_stages(t_run)
    got = _serve_gates(reg, svc, 1, per_batch, "serve run")
    want_scored = sum(windows.values())
    if got["windows_scored_total"] != want_scored \
            or got["windows_admitted_total"] != want_scored:
        _fail(f"serve run: {got['windows_scored_total']:.0f} windows scored and "
              f"{got['windows_admitted_total']:.0f} admitted, model_detect "
              f"scores {want_scored}")
    occupancy = reg.value("serve_batch_occupancy", labels={"bucket": tag},
                          stat="mean")
    if not occupancy > 1:
        _fail(f"serve run: mean batch occupancy {occupancy} (no batch shared)")
    batches = int(got["batches_total"])
    lat = np.array([w[2] for w in log])
    p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
    late = int(sum(w[3] for w in log))
    print(f"serve run: {len(traces)} streams, {want_scored} windows scored "
          f"({got['windows_skipped_total']:.0f} skipped below min_events), "
          f"{batches} batches, mean occupancy {occupancy:.3f}, launches per "
          f"batch {per_batch} in all {len(svc.batch_launches) - 1}; "
          f"{want_scored / wall_s:.3f} windows/s from the first feed to the "
          f"last leave ({wall_s:.3f} s); admit→demux p50 {p50 * 1e3:.1f} ms, "
          f"p99 {p99 * 1e3:.1f} ms, {late} past the "
          f"{cfg.window_deadline_sec} s deadline")
    print("serve run by stage (host clock, the service's spans: count, seconds "
          "in all, mean ms): " + json.dumps(stages))
    busy = device_busy_share("the serve run (4 streams)",
                             lambda: replay(svc, traces, suffix="-profiled"),
                             wall_s)

    # hot swap: a seed-1 model's weights as version 2, then seed 5 again
    model1 = build_nerrfnet(model_cfg, seed=1, device="cuda")
    svc.swap_params(model1.state_dict(), version=2)
    swapped, _ = replay(svc, {"s5": traces["s5"]}, suffix="@v2")
    narrow = dataclasses.replace(model_cfg, gnn=dataclasses.replace(
        model_cfg.gnn, hidden=model_cfg.gnn.hidden // 2))
    try:
        svc.swap_params(build_nerrfnet(narrow, seed=1, device="cpu").state_dict(),
                        version=3)
        _fail("serve: a swap to another width did not raise")
    except ValueError as e:
        print(f"serve: a swap to width {narrow.gnn.hidden} raised: {e}")
    if svc.live_version != 2:
        _fail(f"serve: live version {svc.live_version} after the refused swap")
    svc.stop()
    _serve_gates(reg, svc, 1, per_batch, "serve run with the swap")

    # parity, after stop(): each stream bit-equal to model_detect
    def offline(sid, m):
        tr = traces[sid]
        return model_detect(Trace(events=tr.events, strings=tr.strings,
                                  ground_truth=None, labels=None, name=sid),
                            m, ds_cfg=ds, auto_capacity=False,
                            batch_size=SERVE_BATCH, device="cuda")

    fields = ("file_scores", "file_window_scores", "proc_scores", "file_bytes",
              "threshold")
    checks = [(sid, dets[sid], model, "serve[max]") for sid in traces] + \
        [("s5", swapped["s5@v2"], model1, "serve[max]@v2")]
    for sid, det, m, detector in checks:
        want = offline(sid, m)
        differ = [f for f in fields if getattr(det, f) != getattr(want, f)]
        if differ or det.detector != detector:
            _fail(f"serve {sid} ({detector}): {differ or det.detector} differ "
                  "from model_detect")
    print(f"serve parity: {len(checks)} streams' DetectionResults bit-equal "
          f"to model_detect ({', '.join(fields)}), detectors serve[max] and "
          f"serve[max]@v2; {sum(len(d.file_scores) for d in dets.values())} "
          f"file scores")

    # the default ladder: ten buckets at full width
    reg2 = MetricsRegistry()
    svc2 = _counting_service()(model, ServeConfig(batch_size=SERVE_BATCH),
                               registry=reg2, device="cuda")
    svc2.start()
    print(f"serve default ladder warmup (s per bucket): {svc2.warmup_seconds}")
    if len(svc2.warmup_seconds) != len(svc2.cfg.buckets):
        _fail(f"serve default ladder: warmed {list(svc2.warmup_seconds)} of "
              f"{len(svc2.cfg.buckets)} buckets")
    _, wall2 = replay(svc2, traces)
    svc2.stop()
    got2 = {k: _counter_total(reg2, f"serve_{k}") for k in (
        "recompiles_total", "batch_failures_total", "windows_failed_total",
        "windows_admitted_total", "windows_scored_total")}
    oversize = _counter_total(reg2, "serve_admission_dropped_total",
                              reason="oversize")
    other_drops = _counter_total(reg2, "serve_admission_dropped_total") - oversize
    if got2["recompiles_total"] or got2["batch_failures_total"] \
            or got2["windows_failed_total"] or other_drops \
            or got2["windows_scored_total"] != got2["windows_admitted_total"]:
        _fail(f"serve default ladder: {got2}, {other_drops} windows dropped "
              "for another reason than oversize")
    if any(b != svc2.batch_launches[0] for b in svc2.batch_launches):
        _fail(f"serve default ladder: launches per batch differ: "
              f"{svc2.batch_launches}")
    occ = reg2.snapshot()["histograms"].get("serve_batch_occupancy", {})
    per_bucket = {k.split("=", 1)[1]: int(v["sum"])
                  for k, v in occ.get("series", {}).items()}
    print(f"serve default ladder: {got2['windows_scored_total']:.0f} windows "
          f"scored, {oversize:.0f} oversize, 0 recompiles, 0 failures in "
          f"{wall2:.3f} s; windows scored per bucket {per_bucket}")
    return dict(streams=len(traces), windows=want_scored, batches=batches,
                occupancy=occupancy, windows_per_s=want_scored / wall_s,
                wall_s=wall_s, p50_ms=p50 * 1e3, p99_ms=p99 * 1e3, busy=busy,
                warmup_s=svc.warmup_seconds, ladder_warmup_s=svc2.warmup_seconds,
                per_bucket=per_bucket, bucket=tag, per_batch=per_batch,
                stages=stages)


def serve_stages(since: float) -> dict:
    """The serve plane's spans opened after ``since``, by stage: window
    admission (lowering included, on the feeder threads), batch close (the
    closer thread), the forward with its copies (the scorer thread) and
    the demux."""
    from nerrf_tpu_torch import tracing

    spans = [sp for sp in tracing.records() if sp.t0 >= since]
    out = {}
    for name in ("serve_admit", "serve_batch_close", "serve_device_score",
                 "serve_demux"):
        d = [sp.dur for sp in spans if sp.name == name]
        out[name] = {"count": len(d), "s": round(sum(d), 4),
                     "mean_ms": round(1e3 * sum(d) / len(d), 3) if d else None}
    return out


# --- the banded pair and every op's backward -----------------------------------


def sorted_ids(B, N, E, gen, device, n_valid=None, lo=0, hi=None):
    """Nondecreasing [B, E] int32 ids in [lo, hi); with ``n_valid`` the
    builder's layout: a sorted prefix of live edges, then the padding tail on
    the last node."""
    import torch

    ids = torch.randint(lo, N if hi is None else hi, (B, E), generator=gen)
    if n_valid is not None:
        ids[:, :n_valid] = torch.randint(0, N - 1, (B, n_valid), generator=gen)
        ids[:, n_valid:] = N - 1
    return torch.sort(ids, dim=1)[0].to(torch.int32).to(device)


def check_banded_kernels() -> dict:
    """``segment_sum_sorted`` (F = 160 and F = 1) against its plain version
    on the card, float32 and bfloat16, at the training rung's shapes: the
    builder's padding layout, a skewed band, bands past the end, ids out of
    range, E = 0."""
    import torch

    from nerrf_tpu_torch.ops import segment as ops

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4321)
    N, E = TRAIN_RUNG[:2]
    B, F = 8, MAIN_F
    pad = E - 1190                      # the rung's typical live edge count
    report = {"segment_sum_sorted": {}}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        cases = {
            "padding": sorted_ids(B, N, E, gen, dev, n_valid=pad),
            "skewed": torch.full((B, E), 131, dtype=torch.int32, device=dev),
            "past_end": sorted_ids(B, N, E, gen, dev, hi=60),
            "out_of_range": sorted_ids(B, N, E, gen, dev, lo=-40, hi=N + 40),
        }
        for Fc in (F, 1):
            for case, ids in cases.items():
                data = torch.randn(B, E, Fc, generator=gen).to(dev, dt)
                got, want = _both(ops.segment_sum_sorted, data, ids, N)
                report["segment_sum_sorted"][f"{case}/F{Fc}/{name}"] = _close(
                    f"segment_sum_sorted {case} F={Fc}", got, want, name,
                    _segment_scale(data, ids, N))
                if case == "padding" and not torch.equal(
                        got, ops.segment_sum_sorted(data, ids, N)):
                    _fail("segment_sum_sorted: two runs on the same inputs differ")
            got = ops.segment_sum_sorted(torch.zeros(B, 0, Fc, device=dev).to(dt),
                                         torch.zeros(B, 0, dtype=torch.int32,
                                                     device=dev), N)
            _sync()
            if got.shape != (B, N, Fc) or float(got.abs().max()) != 0.0:
                _fail("segment_sum_sorted: E=0 must give zeros")
    return report


def check_gathers(report: dict) -> None:
    """Both gathers (one row-copy kernel) against the plain version on the
    card, bit for bit, float32 and bfloat16: ``gather_rows`` on ids in random
    order, ``gather_rows_sorted`` on the same ids sorted per window.  The
    cases: the main call sites' shapes (F = 160 at both rungs, the builder's
    padding tail on the last node; the fusion's backward, [8, 1025, 24]
    float32 by [8, 128] ids mostly on slot N), F = 1 and F = 7 (rows that
    are no multiple of 16 bytes), a table one element off a 16-byte boundary
    (the element-wise layouts), ids below 0 and at or past N (zero rows),
    sparse ids, one window of 2-D operands, E = 0, and for the sorted gather
    long runs of one id (runs of ~256, and one id for all 2048)."""
    import torch

    from nerrf_tpu_torch.ops import segment as ops

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8642)
    ids_of = lambda B, N, E, **kw: sorted_ids(B, N, E, gen, dev, **kw)
    cases = {   # name: (table shape, float dtypes, nondecreasing ids [B, E], shift)
        "train-padding": ((8, 1024, MAIN_F), None, ids_of(8, 1024, 2048, n_valid=2048 - 1192), 0),
        "detect-padding": ((8, 4096, MAIN_F), None, ids_of(8, 4096, 4096, n_valid=4096 - 3121), 0),
        "detect-out-of-range": ((8, 4096, MAIN_F), None,
                                ids_of(8, 4096, 4096, lo=-40, hi=4096 + 40), 0),
        "fusion-backward": ((8, 1025, SEQ_F), (torch.float32,),
                            ids_of(8, 1025, 128, lo=900, hi=1025 + 300).clamp_max(1024), 0),
        "F1": ((8, 1024, 1), None, ids_of(8, 1024, 2048, lo=-3, hi=1027), 0),
        "F7": ((8, 1024, 7), None, ids_of(8, 1024, 2048, lo=-3, hi=1027), 0),
        "misaligned": ((8, 1024, MAIN_F), None, ids_of(8, 1024, 2048, n_valid=2048 - 1192), 1),
        "misaligned-F24": ((8, 1025, SEQ_F), None, ids_of(8, 1025, 128, lo=-2, hi=1027), 1),
        "spread": ((8, 1024, MAIN_F), None, ids_of(8, 1024, 256), 0),
        "one-window": ((1, 45, 19), None, ids_of(1, 45, 130, lo=-2, hi=47), 0),
        "runs": ((8, 1024, MAIN_F), None, ids_of(8, 1024, 2048, lo=500, hi=508), 0),
        "one-id": ((8, 1024, MAIN_F), None, torch.full((8, 2048), 131, dtype=torch.int32,
                                                       device=dev), 0),
        "E0": ((8, 1024, MAIN_F), None, torch.zeros(8, 0, dtype=torch.int32, device=dev), 0),
    }
    for case, (shape, dtypes, ids, shift) in cases.items():
        B, N, F = shape
        shuffled = torch.gather(ids, 1, torch.argsort(
            torch.rand(ids.shape, generator=gen), dim=1).to(dev))
        for dt in dtypes or (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            flat = torch.empty(B * N * F + shift, dtype=dt, device=dev)
            table = flat[shift:].view(B, N, F)
            table.copy_(torch.randn(B, N, F, generator=gen))
            for op, op_ids in ((ops.gather_rows, shuffled), (ops.gather_rows_sorted, ids)):
                t, i = (table[0], op_ids[0]) if case == "one-window" else (table, op_ids)
                got, want = _both(op, t, i)
                report[op.__name__][f"{case}/{name}"] = _close(
                    f"{op.__name__} {case}", got, want, name)
                if got.shape != (*i.shape, F):
                    _fail(f"{op.__name__} {case}: result of shape {tuple(got.shape)}")
                bad = (i < 0) | (i >= N)
                if bool(got[bad].any()):
                    _fail(f"{op.__name__} {case}: out-of-range ids must give zero rows")


def check_long_bands(report: dict) -> None:
    """``segment_sum`` (ids in random order) and ``segment_sum_sorted``
    against their plain versions on long segments, float32 and bfloat16, at
    F = 160, 24 and 1: a single segment of 4096 rows, the builder's padding
    layout at the training rung (1192-row tail on the last of 1024 nodes)
    and at the detection rung (3121 rows on the last of 4096), ids out of
    range with most segments empty, and fewer rows than a chunk.  At F = 160
    and 24 the rows also start one element past a 16-byte boundary (a view
    into a flat buffer), which the kernels read element by element instead
    of in 16-byte packs.  Each result is bit-equal over two runs, and with
    the ids' plan given."""
    import torch

    from nerrf_tpu_torch.ops import kernels
    from nerrf_tpu_torch.ops import segment as ops

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2468)
    cases = {   # name: (B, N, S, sorted_ids options)
        "single4096": (2, 1024, 4096, dict(lo=517, hi=518)),
        "padding-train": (8, 1024, 2048, dict(n_valid=2048 - 1192)),
        "padding-detect": (8, 4096, 4096, dict(n_valid=4096 - 3121)),
        "empty-out-of-range": (8, 1024, 300, dict(lo=-40, hi=1064)),
        "short": (8, 1024, 20, dict(lo=-3, hi=1027)),
    }
    for case, (B, N, S, opts) in cases.items():
        ids = sorted_ids(B, N, S, gen, dev, **opts)
        shuffled = torch.gather(ids, 1, torch.argsort(
            torch.rand(B, S, generator=gen), dim=1).to(dev))
        for op, op_ids, srt in ((ops.segment_sum, shuffled, False),
                                (ops.segment_sum_sorted, ids, True)):
            name = op.__name__
            plan = ops.segment_plan(op_ids, N, sorted_ids=srt)
            for dt in (torch.float32, torch.bfloat16):
                dname = str(dt).split(".")[1]
                for F, shift in ((MAIN_F, 0), (MAIN_F, 1), (SEQ_F, 0),
                                 (SEQ_F, 1), (1, 0)):
                    flat = torch.empty(B * S * F + shift, dtype=dt, device=dev)
                    data = flat[shift:].view(B, S, F)
                    data.copy_(torch.randn(B, S, F, generator=gen))
                    fc = f"F{F}{'-misaligned' if shift else ''}"
                    got, want = _both(op, data, op_ids, N)
                    report[name][f"{case}/{fc}/{dname}"] = _close(
                        f"{name} {case} {fc}", got, want, dname,
                        _segment_scale(data, op_ids, N))
                    if not torch.equal(got, op(data, op_ids, N)):
                        _fail(f"{name} {case} {fc}: two runs differ")
                    if not torch.equal(got, op(data, op_ids, N, plan=plan)):
                        _fail(f"{name} {case} {fc}: the result with a plan "
                              "differs from the one without")
            _sync()
            if any(bool(buf.any()) for (_, _, dt), buf in kernels._SCRATCH.items()
                   if dt == torch.int32):
                _fail(f"{name} {case}: the arrival counters were not reset")


def check_plans() -> None:
    """Forward and backward of the four ops that take a plan, with the ids'
    plan and without, bit for bit, at the training rung's padding layout."""
    import torch

    from nerrf_tpu_torch.ops import segment as ops

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1357)
    N, E = TRAIN_RUNG[:2]
    B, F = 8, MAIN_F
    ids = sorted_ids(B, N, E, gen, dev, n_valid=E - 1190)
    shuffled = torch.gather(ids, 1, torch.argsort(
        torch.rand(B, E, generator=gen), dim=1).to(dev))
    for dt in (torch.float32, torch.bfloat16):
        rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev, dt)
        cases = {   # op: (fn(x, plan), x, cotangent, plan)
            "segment_sum": (lambda d, p: ops.segment_sum(d, shuffled, N, plan=p),
                            rnd(B, E, F), rnd(B, N, F), ops.segment_plan(shuffled, N)),
            "gather_rows": (lambda t, p: ops.gather_rows(t, shuffled, plan=p),
                            rnd(B, N, F), rnd(B, E, F), ops.segment_plan(shuffled, N)),
            "segment_sum_sorted": (
                lambda d, p: ops.segment_sum_sorted(d, ids, N, plan=p),
                rnd(B, E, F), rnd(B, N, F), ops.segment_plan(ids, N, sorted_ids=True)),
            "gather_rows_sorted": (
                lambda t, p: ops.gather_rows_sorted(t, ids, plan=p),
                rnd(B, N, F), rnd(B, E, F), ops.segment_plan(ids, N, sorted_ids=True)),
        }
        for op, (fn, x, cot, plan) in cases.items():
            for with_plan in (None, plan):
                xs = x.detach().requires_grad_(True)
                out = fn(xs, with_plan)
                (g,) = torch.autograd.grad(out, xs, cot)
                if with_plan is None:
                    want = (out.detach(), g)
                elif not (torch.equal(out, want[0]) and torch.equal(g, want[1])):
                    _fail(f"{op} [{dt}]: forward or backward with a plan "
                          "differs from the one without")
    _sync()


def _vjp(fn, x, cot):
    """d⟨fn(x), cot⟩/dx through the op's autograd Function."""
    import torch

    x = x.detach().requires_grad_(True)
    out = fn(x)
    if out.grad_fn is None:
        _fail(f"{fn}: the output carries no grad_fn")
    (g,) = torch.autograd.grad(out, x, cot)
    return g


def check_backward(report: dict) -> None:
    """Each op's backward on the card (the adjoint kernel) against the plain
    version's gradient, for a fixed random cotangent, at the training rung's
    shapes; and the launches each backward makes (its adjoint's kernel)."""
    import torch

    from nerrf_tpu_torch.ops import (
        LAUNCHES, plain_ops, reset_launches, sage_row_ptrs)
    from nerrf_tpu_torch.ops import segment as ops

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(777)
    N, E = TRAIN_RUNG[:2]
    B, F, S = 8, MAIN_F, TRAIN_RUNG[2]
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev, dt)
        edges = sage_graph(B, N, E, gen, dev, n_valid=E - 1190)
        ptrs = sage_row_ptrs(edges[0], edges[2], N)
        # the adjoint's weights: (wr_d, ·, wf_s, ·) in the forward's slots
        adj = (*edges[:4], edges[7], edges[6], edges[5], edges[4])
        unsorted = torch.randint(-3, N + 3, (B, E), generator=gen).to(torch.int32).to(dev)
        fusion = torch.randint(-1, N + 1, (B, S), generator=gen).to(torch.int32).to(dev)
        banded = sorted_ids(B, N, E, gen, dev, n_valid=E - 1190)
        cases = {   # op: (fn, x, cotangent, Σ|terms| of the adjoint, launches)
            "sage_aggregate": (
                lambda m: ops.sage_aggregate(m, *edges, N, row_ptrs=ptrs),
                rnd(B, N, F), rnd(B, N, F), lambda c: _sage_scale(c, adj, N),
                {"sage_aggregate": 2}),
            "segment_sum": (
                lambda d: ops.segment_sum(d, fusion, N + 1), rnd(B, S, SEQ_F),
                rnd(B, N + 1, SEQ_F), None, {"segment_sum": 1, "gather_rows": 1}),
            "gather_rows": (
                lambda t: ops.gather_rows(t, unsorted), rnd(B, N, F), rnd(B, E, F),
                lambda c: _segment_scale(c, unsorted, N),
                {"gather_rows": 1, "segment_sum": 1}),
            "segment_sum_sorted": (
                lambda d: ops.segment_sum_sorted(d, banded, N), rnd(B, E, F),
                rnd(B, N, F), None,
                {"segment_sum_sorted": 1, "gather_rows_sorted": 1}),
            "gather_rows_sorted": (
                lambda t: ops.gather_rows_sorted(t, banded), rnd(B, N, F),
                rnd(B, E, F), lambda c: _segment_scale(c, banded, N),
                {"gather_rows_sorted": 1, "segment_sum_sorted": 1}),
        }
        for op, (fn, x, cot, scale, launched) in cases.items():
            reset_launches()
            got = _vjp(fn, x, cot)
            moved = {k: v for k, v in LAUNCHES.items() if v}
            if moved != launched:
                _fail(f"{op} forward + backward launched {moved}, not {launched}")
            with plain_ops():
                want = _vjp(fn, x, cot)
            _sync()
            report[op][f"backward/{name}"] = _close(
                f"{op} backward", got, want, name,
                None if scale is None else scale(cot))


# --- the training path ----------------------------------------------------------


def train_rung():
    """The training rung: ``configs/joint-100h.json``'s corpus cut to
    TRAIN_TRACES traces, its dataset config (1024n/2048e graphs, 128
    sequences of 100 steps), its model (bf16, dropout 0.1) in ``segment``
    mode and its optimizer settings with TRAIN_STEPS steps."""
    import torch

    from nerrf_tpu_torch.data import make_corpus
    from nerrf_tpu_torch.graph import GraphConfig
    from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig
    from nerrf_tpu_torch.train.data import DatasetConfig, build_dataset
    from nerrf_tpu_torch.train.loop import TrainConfig

    with open(TRAIN_CONFIG) as f:
        exp = json.load(f)
    c, d, t = exp["corpus"], exp["dataset"], exp["train"]
    traces = make_corpus(TRAIN_TRACES, attack_fraction=c["attack_fraction"],
                         base_seed=c["base_seed"], duration_sec=c["duration_sec"],
                         num_target_files=c["num_target_files"],
                         benign_rate_hz=c["benign_rate_hz"])
    ds_cfg = DatasetConfig(graph=GraphConfig(**d["graph"]), seq_len=d["seq_len"],
                           max_seqs=d["max_seqs"], min_events=d["min_events"])
    ds = build_dataset(traces, ds_cfg)
    dtype = lambda name: {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
    g, lstm = t["model"]["gnn"], t["model"]["lstm"]
    model = JointConfig(
        gnn=GraphSAGEConfig(hidden=g["hidden"], num_layers=g["num_layers"],
                            dropout=g["dropout"], dtype=dtype(g["dtype"]),
                            aggregation="segment"),
        lstm=LSTMConfig(hidden=lstm["hidden"], num_layers=lstm["num_layers"],
                        dropout=lstm["dropout"], dtype=dtype(lstm["dtype"])),
        fuse=t["model"]["fuse"])
    keep = ("batch_size", "learning_rate", "warmup_steps", "weight_decay",
            "edge_loss_weight", "node_loss_weight", "seq_loss_weight",
            "pos_weight", "seed")
    cfg = TrainConfig(model=model, num_steps=TRAIN_STEPS,
                      eval_every=TRAIN_LOG_EVERY, **{k: t[k] for k in keep})
    return traces, ds, cfg


def train_launches(num_layers: int, steps: int, eval_batches: int) -> dict:
    """Kernel launches of a segment-mode ``train_nerrfnet`` run, derived from
    the model's structure.  A training step's forward launches, per layer, 2
    ``gather_rows`` (messages from src and from dst) and 4
    ``segment_sum_sorted`` (each direction's weighted sum and its weight
    denominator); outside the layers the edge head's 2 ``gather_rows`` and
    the fusion's 1 ``segment_sum``.  Its backward launches, for each
    ``gather_rows`` one ``segment_sum``, for each F = H
    ``segment_sum_sorted`` one ``gather_rows_sorted``, and for the fusion's
    ``segment_sum`` one ``gather_rows``; the weight denominators carry no
    gradient.  The final evaluation runs the forward once per batch."""
    L = num_layers
    fwd = {"sage_aggregate": 0, "gather_rows": 2 * L + 2, "segment_sum": 1,
           "segment_sum_sorted": 4 * L, "gather_rows_sorted": 0}
    bwd = {"sage_aggregate": 0, "gather_rows": 1, "segment_sum": 2 * L + 2,
           "segment_sum_sorted": 0, "gather_rows_sorted": 2 * L}
    return {k: steps * (fwd[k] + bwd[k]) + eval_batches * fwd[k] for k in fwd}


def fused_forward_launches(num_layers: int) -> dict:
    """Kernel launches of one ``fused``-mode forward of a batch, derived
    from the model: one ``sage_aggregate`` per layer; the precompute's four
    sums (each direction's weight totals and its weighted edge-embedding
    sums: over the dst-sorted ids 2 ``segment_sum_sorted``, over the source
    ids' plan 2 ``segment_sum``); the fusion's ``segment_sum``; the edge
    head's 2 ``gather_rows``."""
    return {"sage_aggregate": num_layers, "gather_rows": 2, "segment_sum": 3,
            "segment_sum_sorted": 2, "gather_rows_sorted": 0}


def step_launches(mode: str, num_layers: int) -> dict:
    """Kernel launches of one training step's forward and backward in
    ``mode``.  A ``fused`` step's backward launches one ``sage_aggregate``
    per layer (its adjoint), for each of the edge head's 2 ``gather_rows``
    one ``segment_sum``, for the fusion's ``segment_sum`` one
    ``gather_rows``, and for the edge-embedding sums their adjoints, one
    ``gather_rows_sorted`` (dst) and one ``gather_rows`` (src); the weight
    totals carry no gradient."""
    if mode == "segment":
        return train_launches(num_layers, 1, 0)
    fwd = fused_forward_launches(num_layers)
    bwd = {"sage_aggregate": num_layers, "gather_rows": 2, "segment_sum": 2,
           "segment_sum_sorted": 0, "gather_rows_sorted": 1}
    return {k: fwd[k] + bwd[k] for k in fwd}


def run_train_path(traces, ds, cfg) -> dict:
    """``train_nerrfnet`` on the training rung with the counters from 0: the
    launches it must make, finite losses, params that moved, steps/s; then
    one step's forward and backward times with the LSTM's share and the
    card's busy share over a few steps."""
    import numpy as np
    import torch

    from nerrf_tpu_torch.models import build_nerrfnet
    from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
    from nerrf_tpu_torch.train.data import padding_waste_fractions
    from nerrf_tpu_torch.train.loop import (
        batch_to_device, clip_by_global_norm_, make_loss_fn, make_train_step,
        train_nerrfnet)

    a = ds.arrays
    rung = (a["node_feat"].shape[1], a["edge_src"].shape[1],
            a["seq_feat"].shape[1], a["seq_feat"].shape[2])
    print(f"training path: {len(traces)} traces "
          f"({sum(t.events.num_valid for t in traces)} events), {len(ds)} "
          f"windows, rung {rung[0]}n/{rung[1]}e/{rung[2]}s x {rung[3]} steps, "
          f"padding waste {padding_waste_fractions(a)}, "
          f"{cfg.model.gnn.resolved_aggregation()} mode, batch {cfg.batch_size}, "
          f"{cfg.num_steps} steps")
    if rung != TRAIN_RUNG:
        _fail(f"the training set landed on rung {rung}, not {TRAIN_RUNG}")

    _sync()
    reset_launches()
    t0 = time.perf_counter()
    res = train_nerrfnet(ds, cfg=cfg, log=print, device="cuda")
    _sync()
    wall_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    eval_batches = math.ceil(len(ds) / cfg.batch_size)
    want = train_launches(cfg.model.gnn.num_layers, cfg.num_steps, eval_batches)
    per_step = train_launches(cfg.model.gnn.num_layers, 1, 0)
    print(f"training launches {launches}, expected {want} ({cfg.num_steps} steps "
          f"of {per_step}, and {eval_batches} evaluation batches)")
    if launches != want:
        _fail(f"training launch counts {launches} != {want}")
    losses = [h["loss"] for h in res.history]
    if not losses or not np.all(np.isfinite(losses)):
        _fail(f"training losses are not finite: {res.history}")
    if not all(np.isfinite(v) for v in res.metrics.values()):
        _fail(f"training metrics are not finite: {res.metrics}")
    model = res.state.model
    init = build_nerrfnet(cfg.model, seed=cfg.seed, device="cuda").state_dict()
    still = [n for n, p in model.named_parameters() if torch.equal(p, init[n])]
    if still:
        _fail(f"{len(still)} params did not change in training: {still[:5]}")

    # one step on the card: forward, forward + backward, and the LSTM's part
    # of each (its own forward, and its backward from its two outputs)
    batch = batch_to_device(a, np.arange(cfg.batch_size), "cuda")
    loss_fn = make_loss_fn(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        loss_fn(batch, gen)[0].backward()

    def lstm_fwd():
        return model.lstm(batch["seq_feat"], batch["seq_mask"], gen)

    def lstm_fwd_bwd():
        model.zero_grad(set_to_none=True)
        out = lstm_fwd()
        (out["seq_logit"].sum() + out["seq_emb"].sum()).backward()

    def clip_adamw():   # on the gradients fwd_bwd just left
        clip_by_global_norm_([p.grad for p in model.parameters()], 1.0)
        state.optimizer.step()

    # host-bound work (launches dominate), so each part is timed on the host
    # clock between syncs, the parts in turn (clip_adamw right after
    # fwd_bwd) for 15 rounds after 2 warm-up rounds, and the medians kept:
    # drifts of the shared host hit all alike
    step = make_train_step(model, cfg)
    state = res.state
    ms = round_robin_ms({"step": lambda: step(state, batch, gen),
                         "fwd_bwd": fwd_bwd, "clip_adamw": clip_adamw,
                         "fwd": lambda: loss_fn(batch, gen),
                         "lstm_fwd_bwd": lstm_fwd_bwd, "lstm_fwd": lstm_fwd})
    step_ms, fb_ms, f_ms = ms["step"], ms["fwd_bwd"], ms["fwd"]
    lf_ms, lfb_ms = ms["lstm_fwd"], ms["lstm_fwd_bwd"]
    print(f"training step on the card (batch of {cfg.batch_size}, medians of 15): "
          f"whole step {step_ms:.1f} ms; forward {f_ms:.1f} ms, of which LSTM "
          f"{lf_ms:.1f} ms ({lf_ms / f_ms:.2f}); backward {fb_ms - f_ms:.1f} ms, "
          f"of which LSTM {lfb_ms - lf_ms:.1f} ms "
          f"({(lfb_ms - lf_ms) / (fb_ms - f_ms):.2f}); clip and AdamW "
          f"{ms['clip_adamw']:.1f} ms")

    def steps(k=3):
        for _ in range(k):
            step(state, batch, gen)
        _sync()

    t0 = time.perf_counter()
    steps()
    device_busy_share("3 training steps", steps, time.perf_counter() - t0)
    return dict(launches=launches, per_step=per_step, wall_s=wall_s,
                steps_per_sec=res.steps_per_sec, history=res.history,
                metrics=res.metrics, step_ms=step_ms, fwd_ms=f_ms,
                opt_ms=ms["clip_adamw"],
                bwd_ms=fb_ms - f_ms, lstm_fwd_ms=lf_ms,
                lstm_bwd_ms=lfb_ms - lf_ms,
                batch={k: v[:cfg.batch_size] for k, v in a.items()})


def check_step_grads(ds, cfg) -> dict:
    """One full-width training step's gradients, kernels against plain
    versions, in ``segment`` and ``fused`` modes: the same params, batch and
    dropout masks (a generator seeded alike), per parameter relative to its
    gradient norm, against each of two plain runs (the larger counts).  Two
    runs on the kernels must give the same bits; the two plain runs give the
    spread the plain versions' own atomics (``index_add_``) put between two
    runs.  The counters show that the first run launched the step's kernels
    and the plain runs none."""
    import dataclasses

    import numpy as np
    import torch

    from nerrf_tpu_torch.models import build_nerrfnet
    from nerrf_tpu_torch.ops import LAUNCHES, plain_ops, reset_launches
    from nerrf_tpu_torch.train.loop import batch_to_device, make_loss_fn

    batch = batch_to_device(ds.arrays, np.arange(cfg.batch_size), "cuda")
    out = {}
    for mode in ("segment", "fused"):
        mcfg = dataclasses.replace(cfg.model, gnn=dataclasses.replace(
            cfg.model.gnn, aggregation=mode))
        model = build_nerrfnet(mcfg, seed=cfg.seed, device="cuda").train()
        loss_fn = make_loss_fn(model, dataclasses.replace(cfg, model=mcfg))

        def grads():
            model.zero_grad(set_to_none=True)
            loss, _ = loss_fn(batch, torch.Generator(device="cuda").manual_seed(5))
            loss.backward()
            return loss.item(), {n: p.grad.detach().float().clone()
                                 for n, p in model.named_parameters()}

        reset_launches()
        lk, gk = grads()
        launched, want = dict(LAUNCHES), step_launches(mode, mcfg.gnn.num_layers)
        lk2, gk2 = grads()
        differ = [n for n in gk if not torch.equal(gk[n], gk2[n])]
        if differ or lk != lk2:
            _fail(f"{mode} gradients: two kernel runs differ (loss {lk} vs {lk2}; "
                  f"{len(differ)} params, e.g. {differ[:4]})")
        reset_launches()
        with plain_ops():
            lp, gp = grads()
            _, gp2 = grads()
        if launched != want or any(LAUNCHES.values()):
            _fail(f"{mode} gradients: the kernel run launched {launched} (want "
                  f"{want}), the plain runs {dict(LAUNCHES)}")
        rel = lambda a, b: {n: float((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-30))
                            for n in b}
        err2, spread = rel(gk, gp2), rel(gp2, gp)
        err = {n: max(e, err2[n]) for n, e in rel(gk, gp).items()}
        worst = max(err, key=err.get)
        out[mode] = dict(loss_kernels=lk, loss_plain=lp, max_rel=err[worst],
                         worst=worst, median_rel=float(np.median(list(err.values()))),
                         plain_spread=max(spread.values()))
        print(f"one step's gradients, {mode} mode, kernels ({launched}; two runs "
              f"bit-equal) vs plain: loss {lk:.6f} vs {lp:.6f}; per-parameter "
              f"‖Δg‖/‖g‖ max {err[worst]:.3e} "
              f"({worst}), median {out[mode]['median_rel']:.3e}; plain vs plain "
              f"max {out[mode]['plain_spread']:.3e}")
        if not (np.isfinite(lk) and err[worst] <= GRAD_RTOL[mode]):
            _fail(f"{mode} gradients: kernels vs plain {err[worst]} > "
                  f"{GRAD_RTOL[mode]} ({worst})")
    return out


def check_small_train() -> float:
    """A small float32 training run (``JointConfig().small``, segment mode,
    dropout 0: the CPU's and the card's generators draw different masks), 3
    steps on the card (kernels) and on the CPU (plain versions), from the same
    init and batches: the relative difference of the losses."""
    import dataclasses

    import torch

    from nerrf_tpu_torch.data import make_corpus
    from nerrf_tpu_torch.graph import GraphConfig
    from nerrf_tpu_torch.models import JointConfig
    from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
    from nerrf_tpu_torch.train.data import DatasetConfig, build_dataset
    from nerrf_tpu_torch.train.loop import TrainConfig, train_nerrfnet

    small = JointConfig().small
    model = dataclasses.replace(
        small, gnn=dataclasses.replace(small.gnn, dtype=torch.float32, dropout=0.0,
                                       aggregation="segment"),
        lstm=dataclasses.replace(small.lstm, dtype=torch.float32, dropout=0.0))
    ds = build_dataset(
        make_corpus(2, duration_sec=60.0, num_target_files=4, benign_rate_hz=20.0,
                    base_seed=3),
        DatasetConfig(graph=GraphConfig(window_sec=45.0, stride_sec=20.0,
                                        max_nodes=64, max_edges=128),
                      seq_len=24, max_seqs=32))
    cfg = TrainConfig(model=model, batch_size=4, num_steps=3, warmup_steps=1,
                      eval_every=1)
    reset_launches()
    cpu = train_nerrfnet(ds, cfg=cfg, device="cpu")
    if any(LAUNCHES.values()):
        _fail(f"small training on the CPU launched kernels: {LAUNCHES}")
    card = train_nerrfnet(ds, cfg=cfg, device="cuda")
    launched = dict(LAUNCHES)
    a = [h["loss"] for h in cpu.history]
    b = [h["loss"] for h in card.history]
    err = max(abs(x - y) / abs(x) for x, y in zip(a, b))
    print(f"small f32 training, card ({launched}) vs CPU: losses {b} vs {a}")
    path = ("gather_rows", "segment_sum", "segment_sum_sorted", "gather_rows_sorted")
    if not all(launched[k] for k in path):
        _fail(f"small training on the card did not launch every kernel of "
              f"its path: {launched}")
    if len(a) != 3 or err > SMALL_TRAIN_RTOL:
        _fail(f"small training: card vs CPU losses differ by {err} (relative)")
    return err


# --- the experiment runner --------------------------------------------------------


class _Tee:
    """stderr as it is, kept as well: the runner logs there."""

    def __init__(self, stream):
        self.stream, self.lines = stream, []

    def write(self, s):
        self.lines.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.lines)


def _run_logged(run_experiment, *args, **kw):
    """``run_experiment(*args, **kw)`` with its log kept, and its
    ``TrainResult`` (the in-memory model): ``(report, result, log)``."""
    import contextlib

    from nerrf_tpu_torch.train import loop

    real, kept = loop.train_nerrfnet, {}

    def keep(*a, **k):
        kept["result"] = real(*a, **k)
        return kept["result"]

    tee = _Tee(sys.stderr)
    loop.train_nerrfnet = keep
    try:
        with contextlib.redirect_stderr(tee):
            report = run_experiment(*args, **kw)
    finally:
        loop.train_nerrfnet = real
    return report, kept["result"], tee.text()


def _span_seconds(since: float) -> dict:
    """Seconds per span name over the spans opened after ``since``."""
    from nerrf_tpu_torch import tracing

    out = {}
    for sp in tracing.records():
        if sp.t0 >= since:
            out[sp.name] = out.get(sp.name, 0.0) + sp.dur
    return out


def _check_calibration(model_dir, log: str, what: str) -> str:
    """The calibration as the sidecar and the log give it: a node_threshold
    with recall >= 0.5 (and the robust leg where its log line reached a
    cut), or "unreachable" in the log and no calibration in the sidecar."""
    from nerrf_tpu_torch.train.checkpoint import load_calibration

    cal = load_calibration(model_dir)
    if "calibration failed" in log:
        _fail(f"{what}: the calibration raised: {log[log.index('calibration failed'):][:300]}")
    if cal:
        robust = "calibration[robust]" in log and "→ unreachable" not in \
            log.split("calibration[robust]")[1].splitlines()[0]
        if cal["node_threshold_recall"] < 0.5 or robust != ("node_threshold_robust" in cal):
            _fail(f"{what}: calibration {cal} does not match the log")
        return f"calibrated {cal}"
    if "calibration unreachable" not in log:
        _fail(f"{what}: no calibration in the sidecar and none reported unreachable")
    return "unreachable (the checkpoint keeps the 0.5 default)"


def run_experiment_path() -> dict:
    """``run_experiment`` of ``configs/joint-100h.json`` cut to
    EXPERIMENT_TRACES traces and EXPERIMENT_STEPS steps, on the card with
    the counters from 0 (``auto`` gives ``fused``).  Gates: the launches
    derived from the model over 200 fused steps, the held-out evaluation's
    batches and the calibration's batches (window counts from the host
    lowering); finite losses and params that moved; the checkpoint loads,
    and the loaded model gives the in-memory model's ``model_detect`` bits on
    the held-out attack trace and reproduces ``metrics.json``'s held-out
    metrics; the calibration written or reported unreachable;
    ``experiment.json`` and ``metrics.json`` as the reference writes them."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from nerrf_tpu_torch.config import Experiment
    from nerrf_tpu_torch.models import NerrfNet, build_nerrfnet
    from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
    from nerrf_tpu_torch.pipeline import (
        calibrate_file_thresholds, calibration_traces, fit_capacity, make_eval_fn,
        model_detect)
    from nerrf_tpu_torch.train.checkpoint import load_checkpoint
    from nerrf_tpu_torch.train.data import DatasetConfig, build_dataset, windows_of_trace
    from nerrf_tpu_torch.train.loop import evaluate
    from nerrf_tpu_torch.train.run import run_experiment

    with open(TRAIN_CONFIG) as f:
        spec = json.load(f)
    spec["corpus"]["num_traces"] = EXPERIMENT_TRACES
    spec["train"]["num_steps"] = EXPERIMENT_STEPS
    spec["train"]["eval_every"] = EXPERIMENT_LOG_EVERY
    tmp = tempfile.mkdtemp(prefix="nerrf-experiment-")
    try:
        path, out = os.path.join(tmp, "joint-100h-cut.json"), os.path.join(tmp, "out")
        with open(path, "w") as f:
            json.dump(spec, f, indent=2)
        exp = Experiment.load(path)
        cfg = exp.train
        B, L = cfg.batch_size, cfg.model.gnn.num_layers

        # window counts from the host lowering, apart from the run
        train_traces, eval_traces = exp.build_corpus()
        eval_ds = build_dataset(eval_traces, exp.dataset)
        cal_windows = [len(windows_of_trace(tr, fit_capacity(tr, DatasetConfig())))
                       for tr in calibration_traces()]
        eval_batches = math.ceil(len(eval_ds) / B)
        cal_batches = sum(math.ceil(w / B) for w in cal_windows)
        fwd, step = fused_forward_launches(L), step_launches("fused", L)
        want = {k: cfg.num_steps * step[k] + (eval_batches + cal_batches) * fwd[k]
                for k in step}
        print(f"experiment path: {exp.name} cut to {len(train_traces)} + "
              f"{len(eval_traces)} traces ({[t.name for t in eval_traces]} held "
              f"out: {len(eval_ds)} windows, {eval_batches} batches), "
              f"{cfg.num_steps} steps, calibration over {len(cal_windows)} incidents "
              f"({cal_windows} windows, {cal_batches} batches); expected launches "
              f"{want}")

        _sync()
        reset_launches()
        since = time.perf_counter()
        report, res, log = _run_logged(run_experiment, path, out, device="cuda")
        _sync()
        wall_s = time.perf_counter() - since
        launches = dict(LAUNCHES)
        print(f"experiment launches {launches}, expected {want} ({cfg.num_steps} "
              f"fused steps of {step}, {eval_batches} + {cal_batches} forwards of {fwd})")
        if launches != want:
            _fail(f"experiment launch counts {launches} != {want}")
        if "gnn aggregation=fused" not in log:
            _fail("the experiment did not train in fused mode")
        losses = [h["loss"] for h in res.history]
        if len(losses) != cfg.num_steps // EXPERIMENT_LOG_EVERY + 1 or \
                not np.all(np.isfinite(losses)):
            _fail(f"experiment losses: {res.history}")
        spans = _span_seconds(since)

        # the artifacts
        if Experiment.load(os.path.join(out, "experiment.json")) != exp:
            _fail("experiment.json differs from the input")
        with open(os.path.join(out, "metrics.json")) as f:
            written = json.load(f)
        if written != report or set(report) != REPORT_KEYS or \
                (report["backend"], report["devices"]) != ("cuda", 1):
            _fail(f"metrics.json {sorted(written)} is not the report the reference "
                  f"writes ({sorted(REPORT_KEYS)})")
        t0 = time.perf_counter()
        state, lcfg = load_checkpoint(os.path.join(out, "model"))
        with torch.device("cuda"):
            loaded = NerrfNet(lcfg)
        loaded.load_state_dict(state, strict=True)
        loaded.eval()
        _sync()
        load_s = time.perf_counter() - t0
        if lcfg != cfg.model:
            _fail(f"the checkpoint's config {lcfg} != the run's {cfg.model}")
        init = build_nerrfnet(cfg.model, seed=cfg.seed, device="cuda").state_dict()
        trained = res.state.model.state_dict()
        still = [n for n, _ in loaded.named_parameters() if torch.equal(state[n].cuda(), init[n])]
        differ = [n for n in trained if not torch.equal(state[n].cuda(), trained[n])]
        if still or differ:
            _fail(f"checkpoint: {len(still)} params equal their init ({still[:4]}), "
                  f"{len(differ)} differ from the trained model ({differ[:4]})")
        incident = eval_traces[-1]
        a = model_detect(incident, res.state.model, device="cuda")
        b = model_detect(incident, loaded, device="cuda")
        if (a.file_scores, a.file_window_scores, a.proc_scores) != \
                (b.file_scores, b.file_window_scores, b.proc_scores):
            _fail(f"model_detect on {incident.name}: the loaded model's bits differ")
        again = evaluate(make_eval_fn(loaded), eval_ds, B)
        again = {k: round(float(v), 4) for k, v in again.items()}
        if again != report["metrics"]:
            _fail(f"the loaded model's held-out metrics {again} != metrics.json's "
                  f"{report['metrics']}")
        calibration = _check_calibration(os.path.join(out, "model"), log, "experiment")
        if calibration.startswith("unreachable"):
            # what the cut reaches without the recall floor (not counted: the
            # counters were read above)
            floorless = calibrate_file_thresholds(loaded, min_recall=0.0, device="cuda")
            reached = {agg: [c.kind, round(c.threshold, 4), round(c.recall, 4)]
                       for agg, c in floorless.items()}
            calibration += (" at recall >= 0.5; without the floor: "
                            + (json.dumps(reached) if reached else "unreachable"))
        params_bytes = os.path.getsize(os.path.join(out, "model", "params.pt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    split = {
        "corpus_and_dataset_s": spans.get("build_corpus", 0.0) + spans.get("build_dataset", 0.0),
        "training_s": spans.get("train_setup", 0.0) + spans.get("train_loop", 0.0),
        "held_out_eval_s": spans.get("eval", 0.0),
        "calibration_s": spans.get("calibrate", 0.0),
        "checkpoint_save_s": spans.get("checkpoint", 0.0),
        "checkpoint_load_s": load_s,
    }
    print(f"experiment run: {wall_s:.1f} s; split {json.dumps({k: round(v, 3) for k, v in split.items()})}; "
          f"{report['steps_per_sec']} steps/s after step 0; losses "
          f"{[round(x, 4) for x in losses]}; held-out "
          f"{json.dumps({k: report['metrics'][k] for k in HELD_OUT})}; calibration "
          f"{calibration}; gates {report['gates']}; params.pt {params_bytes} bytes; "
          f"model_detect on {incident.name} bit-equal after the load "
          f"({len(a.file_scores)} files); held-out metrics reproduced from the "
          f"checkpoint")
    return dict(launches=launches, report=report, wall_s=wall_s, split=split,
                calibration=calibration, params_bytes=params_bytes,
                eval_batches=eval_batches, cal_batches=cal_batches)


def check_small_experiment() -> dict:
    """A small float32 experiment (``configs/toy-graphsage.json``'s corpus,
    dataset and model widths; dropout 0, ``segment`` mode, SMALL_RUN_STEPS
    steps, calibration on) through ``run_experiment`` on the card (kernels)
    and on the CPU (plain versions), from the same init (drawn on the CPU
    generator on both): the held-out metrics within SMALL_RUN_ATOL, the same
    calibration within SMALL_CUT_ATOL or unreachable on both."""
    import shutil
    import tempfile

    from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
    from nerrf_tpu_torch.train.run import run_experiment

    with open(os.path.join(ROOT, "configs", "toy-graphsage.json")) as f:
        spec = json.load(f)
    for part in ("gnn", "lstm"):
        spec["train"]["model"][part].update(dtype="float32", dropout=0.0)
    spec["train"]["model"]["gnn"]["aggregation"] = "segment"
    spec["train"]["num_steps"] = SMALL_RUN_STEPS
    tmp = tempfile.mkdtemp(prefix="nerrf-small-experiment-")
    try:
        path = os.path.join(tmp, "toy-f32.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        runs = {}
        for dev in ("cpu", "cuda"):
            reset_launches()
            report, _, log = _run_logged(run_experiment, path, os.path.join(tmp, dev),
                                         device=dev)
            _sync()
            runs[dev] = (report, dict(LAUNCHES),
                         _check_calibration(os.path.join(tmp, dev, "model"), log,
                                            f"small experiment on {dev}"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (cpu, cpu_launches, _), (card, card_launches, cal_text) = runs["cpu"], runs["cuda"]
    path_kernels = ("gather_rows", "segment_sum", "segment_sum_sorted", "gather_rows_sorted")
    if any(cpu_launches.values()) or not all(card_launches[k] for k in path_kernels):
        _fail(f"small experiment: launches on the CPU {cpu_launches}, on the card "
              f"{card_launches}")
    gap = {k: abs(card["metrics"][k] - cpu["metrics"][k]) for k in HELD_OUT}
    cal, ccal = card["calibration"] or {}, cpu["calibration"] or {}
    cut_gap = {k: abs(cal[k] - ccal[k]) for k in cal.keys() & ccal.keys()
               if isinstance(cal[k], float)}
    print(f"small f32 experiment ({SMALL_RUN_STEPS} steps), card ({card_launches}) vs "
          f"CPU: held-out {json.dumps({k: card['metrics'][k] for k in HELD_OUT})} vs "
          f"{json.dumps({k: cpu['metrics'][k] for k in HELD_OUT})}, max |Δ| "
          f"{max(gap.values()):.1e}; calibration {cal_text} on the card, "
          f"{ccal or 'unreachable'} on the CPU")
    if max(gap.values()) > SMALL_RUN_ATOL:
        _fail(f"small experiment: held-out metrics card vs CPU differ by {gap}")
    if cal.keys() != ccal.keys() or any(v > SMALL_CUT_ATOL for v in cut_gap.values()) or \
            any(cal[k] != ccal[k] for k in cal.keys() & ccal.keys() if k.endswith("kind")):
        _fail(f"small experiment: calibration card {cal} vs CPU {ccal}")
    return dict(gap=max(gap.values()), card=card, cpu=cpu)


def kernel_times() -> dict:
    """Each kernel's times at its call sites on the first batch of both
    rungs (:func:`time_kernels`: device ms per launch, band-free and the
    rest), and each library's registers from ``ptxas``, for the package on
    ``sys.path``."""
    from nerrf_tpu_torch.ops import kernels
    from nerrf_tpu_torch.pipeline import pad_batch
    from nerrf_tpu_torch.train.data import windows_of_trace

    kernels.build()
    regs = {name: [int(line.split("Used ")[1].split()[0]) for line in
                   kernels.library_path(name).with_suffix(".log").read_text().splitlines()
                   if "registers" in line]
            for name in kernels.KERNELS}
    trace, ds = detect_trace()
    detect = pad_batch(windows_of_trace(trace, ds)[:8], 8)
    _, train_ds, cfg = train_rung()
    train = {k: v[:cfg.batch_size] for k, v in train_ds.arrays.items()}
    report = {name: {} for name in kernels.KERNELS}
    keep = ("ms", "host_us", "device_ms", "band_free_device_ms", "pad_spread_device_ms")
    out = {"registers": regs}
    for tag, batch in (("detect", detect), ("train", train)):
        out[tag] = {site: {k: v for k, v in res.items() if k in keep}
                    for site, res in time_kernels(batch, report, tag).items()}
    return out


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
    # --kernel-times ROOT: only the kernel times of the package under ROOT
    # (another tree of this repository), to hold two trees against each
    # other in one call, in turns
    times_of = sys.argv[2] if sys.argv[1:2] == ["--kernel-times"] else None
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(times_of) if times_of else here)
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
    if times_of:
        print(json.dumps({"root": times_of, "card": smi, **kernel_times()}))
        return 0
    try:
        t0 = time.perf_counter()
        built = kernels.build()
        print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
              f"(per source: {built})")
        for name in kernels.KERNELS:
            log = kernels.library_path(name).with_suffix(".log")
            if log.exists():
                for line in log.read_text().splitlines():
                    if "entry function" in line or "registers" in line \
                            or "spill" in line:
                        print(f"ptxas {name}: {line.strip()}")
        errors = check_kernels()
        errors.update(check_banded_kernels())
        errors.update(gather_rows={}, gather_rows_sorted={})
        check_gathers(errors)
        check_long_bands(errors)
        check_backward(errors)
        check_plans()
        main_path = run_main_path()
        detect_timing = time_kernels(main_path["batch"], errors, "detect")
        small_err = check_small_detect()
        serve = run_serve_path((MAIN_N, MAIN_E, SEQ_S))
        traces, train_ds, train_cfg = train_rung()
        train = run_train_path(traces, train_ds, train_cfg)
        grads = check_step_grads(train_ds, train_cfg)
        small_train_err = check_small_train()
        experiment = run_experiment_path()
        small_experiment = check_small_experiment()
        timing = time_kernels(train["batch"], errors, "train")
        split = gather_host_split(train["batch"])
    except Exception as e:  # any failed phase fails the smoke
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    replaces = {
        "sage_aggregate": "nerrf_tpu/ops/pallas_segment.py:440",
        "gather_rows": "nerrf_tpu/ops/pallas_segment.py:325",
        "segment_sum": "nerrf_tpu/ops/pallas_segment.py:91",
        "segment_sum_sorted": "nerrf_tpu/ops/pallas_segment.py:156",
        "gather_rows_sorted": "nerrf_tpu/ops/pallas_segment.py:241",
    }
    # each kernel on the path it runs on: its launches from that path's run,
    # its times on that path's inputs at its main call site.  The fused
    # sage_aggregate runs on the detection path only; the others on the
    # training path, segment_sum timed as the gathers' backward
    path = {name: "model_detect" if name == "sage_aggregate" else "train_nerrfnet"
            for name in kernels.KERNELS}
    runs = {"model_detect": (main_path, detect_timing),
            "train_nerrfnet": (train, timing)}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "host_us", "device_ms")
    trims = ("host_us_untrimmed",)
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"nerrf_tpu_torch/ops/csrc/{name}.cu",
         "replaces": replaces[name],
         "path": path[name],
         "launches": runs[path[name]][0]["launches"][name],
         "max_abs_err": max(errors[name].values()),
         **{k: runs[path[name]][1][name][k] for k in keys},
         "band_free_device_ms": runs[path[name]][1][name].get("band_free_device_ms"),
         "serve_launches": serve["per_batch"][name],
         "experiment_launches": experiment["launches"][name]}
        for name in kernels.KERNELS]}
    print("kernel errors by case: " + json.dumps(errors))
    chunked = ("per_call_ms", "per_call_host_us", "band_free_device_ms",
               "pad_spread_device_ms")
    for tag, tm in (("detection rung (4096n/4096e/4096s)", detect_timing),
                    ("training rung (1024n/2048e/128s)", timing)):
        print(f"kernel times at the {tag}, by call site (ms: as the path calls "
              f"it, CUDA events; host_us: the host's enqueue time of that call, "
              f"host_us_untrimmed: the same with the launch untrimmed; "
              f"device_ms: the kernel's device time per launch, and "
              f"library_device_ms: the library call's, profiler; per_call_ms, "
              f"per_call_host_us: structure built per call; band_free_device_ms: "
              f"padding tail spread, for sage_aggregate every band; "
              f"pad_spread_device_ms: sage_aggregate with its padding tail "
              f"spread, live bands kept): " + json.dumps(
                  {site: {k: tm[site][k] for k in keys + trims + chunked
                          if k in tm[site]}
                   for site in tm}))
    print("host split of one gather_rows call at the training rung (µs per "
          "call, enqueue only): " + json.dumps(split))
    for tag, tm, E in (("detection", detect_timing, MAIN_E),
                       ("training", timing, TRAIN_RUNG[1])):
        print(f"{tag} rung: sage_aggregate "
              f"{tm['sage_aggregate']['live_edges_per_window']:.1f} weighted "
              f"edges per window in both views, of {2 * E} slots, "
              f"{tm['sage_aggregate']['padding_edges_per_window']:.1f} padding "
              f"edges a view on the last node; longest live "
              f"band (dst view, src view) {tm['sage_aggregate']['longest_band']}; "
              f"segment_sum_sorted's longest band, padding included (dst, src) "
              f"{tm['segment_sum_sorted']['longest_band']} rows; segment_sum's "
              f"longest run {tm['segment_sum']['longest_run']} rows as the "
              f"gathers' backward, {tm['segment_sum_fusion']['longest_run']} "
              f"in the fusion")
    print(f"model_detect 4096n/4096e/4096s: {main_path['windows']} windows in "
          f"{main_path['batches']} batches; first run {main_path['first_s']:.3f} s "
          f"({main_path['first_windows_per_s']:.3f} windows/s), steady "
          f"{main_path['steady_s']:.3f} s ({main_path['windows_per_s']:.3f} "
          f"windows/s); {main_path['files']} files scored, "
          f"{main_path['flagged']} flagged; small f32 detection card vs CPU "
          f"max |Δ| {small_err:.2e}; on {smi}")
    busy = "not measured" if serve["busy"] is None else f"{serve['busy']:.3f}"
    print(f"serve {serve['bucket']} (OnlineDetectionService, {serve['streams']} "
          f"streams fed concurrently): {serve['windows']} windows in "
          f"{serve['batches']} batches (mean occupancy {serve['occupancy']:.3f}), "
          f"{serve['windows_per_s']:.3f} windows/s from the first feed to the "
          f"last leave; admit→demux p50 {serve['p50_ms']:.1f} ms, p99 "
          f"{serve['p99_ms']:.1f} ms; device busy share {busy}; warmup "
          f"{serve['warmup_s']} s; default ladder warmup "
          f"{serve['ladder_warmup_s']} s, windows per bucket "
          f"{serve['per_bucket']}; every stream and the swapped one bit-equal "
          f"to model_detect; on {smi}")
    print(f"train_nerrfnet {TRAIN_RUNG[0]}n/{TRAIN_RUNG[1]}e/{TRAIN_RUNG[2]}s "
          f"segment mode: {train_cfg.num_steps} steps, "
          f"{train['steps_per_sec']:.3f} steps/s (after step 0), "
          f"{train['wall_s']:.1f} s with set-up and evaluation; losses "
          f"{[round(h['loss'], 4) for h in train['history']]}; launches per step "
          f"{train['per_step']}; step {train['step_ms']:.1f} ms, forward "
          f"{train['fwd_ms']:.1f} ms (LSTM {train['lstm_fwd_ms']:.1f}), backward "
          f"{train['bwd_ms']:.1f} ms (LSTM {train['lstm_bwd_ms']:.1f}); "
          f"gradients kernels vs plain max ‖Δg‖/‖g‖ segment "
          f"{grads['segment']['max_rel']:.3e}, fused {grads['fused']['max_rel']:.3e}; "
          f"small f32 training card vs CPU {small_train_err:.2e}; on {smi}")
    r = experiment["report"]
    print(f"experiment joint-100h (cut: {EXPERIMENT_TRACES} traces, "
          f"{EXPERIMENT_STEPS} steps) through run_experiment, fused mode: "
          f"{r['steps_per_sec']} steps/s after step 0; {experiment['wall_s']:.1f} s, "
          f"split {json.dumps({k: round(v, 3) for k, v in experiment['split'].items()})}; "
          f"held-out {json.dumps({k: r['metrics'][k] for k in HELD_OUT})}; "
          f"calibration {experiment['calibration']}; gates {r['gates']}; params.pt "
          f"{experiment['params_bytes']} bytes; launches {experiment['launches']}; "
          f"small f32 experiment card vs CPU max |Δ| {small_experiment['gap']:.1e}; "
          f"on {smi}")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
