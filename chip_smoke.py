#!/usr/bin/env python3
"""Chip smoke of nerrf_tpu_torch, the PyTorch/CUDA port of NERRF detection,
training and undo.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's seven CUDA sources from ``nerrf_tpu_torch/ops/csrc/``
(``nvcc``, ``sm_90a``, one process per source, all started together), holds
the five sparse-aggregation kernels against their plain PyTorch versions on
the card (float32 and
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
and without a plan.  Then it drives the paths the port has, each with the
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
  cut to 6 traces (2 held out) and 40 steps in the ``fused`` mode (the
  port's ``auto``): training, the held-out evaluation, the checkpoint and
  the calibration of the file threshold over nine simulated incidents.
  The checkpoint is loaded back: the loaded model must give the in-memory
  model's ``model_detect`` bits on the held-out attack trace and reproduce
  ``metrics.json``'s held-out metrics; the calibration must be in the
  sidecar or reported unreachable.  A small float32 experiment runs on the
  card and on the CPU from the same init, and their held-out metrics and
  calibrations must agree;
* the reference's own training paths on the training rung: the streamed
  step, the scheduled step (the dataset and the index schedule on the card,
  uploaded by ``device_put_chunked`` through pinned buffers on a side
  stream, itself held bit-equal to a plain copy) and one superstep of 5,
  5 steps each, bit-equal in losses and final params, 59/59/112/56
  launches a step, and their steps/s and busy share in turns;
  ``train_elastic`` for 10 steps with dropout on, and again preempted at
  step 4 and resumed, bit-equal;
  one telemetry-on step (its ``grad_norm`` against a float64 norm of the
  same gradients, its cost a step) and ``train_nerrfnet`` with a
  ``TrainHealthMonitor`` on a dataset with one NaN window, halted at that
  window's step with empty metrics;
* a disk corpus generated by the port's ``generate_corpus`` (1 h of 600 s
  traces, 64 windows a shard, configs/joint-100h.json's dataset) and
  ``run_experiment`` over it: 60 full-width ``fused`` steps rotating the
  shards through the card (the first batch of each shard bit-equal to its
  rows on the host), checkpoints every 30 steps, the calibration, and the
  reloaded checkpoint bit-equal in ``model_detect``.

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

Then the undo path (``nerrf_tpu_torch.planner``, ``respond``, ``rollback``):
the device MCTS search kernel (``mcts_search``, one thread block a tree;
its resident entry, the working set in shared memory, where that fits, else
its global entry) held against its plain version on the card with the
heuristic value, every tree array bit-equal, on ``bench.py``'s planner
domain, an all-clean domain, a terminal root and two larger buckets, at 64
and 800 simulations, and on the 512f/32p bucket at 2500 (the global
entry),
and two kernel runs bit-equal; the value net fit on the card, the kernel's
own value function within 1e-5·(1+|v|) of ``ValueNet`` on 4096 rows, and
the kernel's plan equal to the plain version's; the planner cell
(rollouts/s of ``DeviceMCTS``, the host ``MCTSPlanner`` and the plain
version, in turns); ``BatchedDeviceMCTS`` (B = 1 and per-lane trees equal
to ``DeviceMCTS``'s, mixed buckets refused, waves, no wave outside the
warmed set; incidents/s at B = 1-8); and the undo run of
``run_recovery_bench``'s M1 incident in ``cmd_undo``'s order
(``heuristic_detect``, ``build_undo_domain``, ``fit_to_domain``,
``make_planner``, ``plan``, ``SandboxGate.rehearse``,
``RollbackExecutor.execute``) with the counters from 0: ⌈800/128⌉ search
launches, the gate approved, the restore verified, no byte lost and no
clean file reverted; then the same incident detected with the experiment's
checkpoint (28/2/3/2/0 launches a batch).

Then the online response chain (``run_respond_chain``): the reference
bench's four staged attack families and one incident without a snapshot
context through a live ``ResponseRouter`` on the card (every family one
verified plan, the no-context incident rejected with its journaled reason,
no recompile after ``start()``, the ``mcts_search`` launches derived from
the router's waves); the M1 incident trace (one window) and the detection
cell's seed-5 trace (15 windows) over the gRPC wire (``TraceReplayServer``
on 127.0.0.1:0 → ``TrackerClient`` with the native decoder →
``TraceStore`` with the native engine → ``query``), detected bit-equal to
the originals; and ``OnlineDetectionService`` with the experiment's
checkpoint ``connect``ed to each server in turn, ``attach_respond`` to a
second router, each run read alone: its result bit-equal to
``model_detect``, 28/2/3/2/0 launches a batch, every alert admitted or
counted below the severity gate, every admitted incident answered (rejected
with a reason: no snapshot context binds an alert's ``ino:`` targets), the
``mcts_search`` launches derived from that run's waves, no recompile.

Then the command line (``run_cli_path``, ``python -m nerrf_tpu_torch.cli``):
the README's ``simulate`` as a subprocess, ``undo`` and ``status`` (exit 0,
the incident recovered and verified, no byte lost, no clean file
reverted), ``serve`` of a CSV trace as a subprocess drained by ``ingest``
(every event back, bit-equal in ``model_detect``), and in-process with the
counters read around each: ``undo --model-dir`` with ``--trace-out`` and
``trace``, ``train-detector`` (50 steps, 8 traces; exit 0, the checkpoint
reloaded bit-equal), ``warmup``, ``serve-detect`` over two streams (each
bit-equal to ``model_detect``, 28/2/3/2/0 a forward, no recompile) and
``respond`` (every family verified), each leg's launches derived.

Then the model lifecycle (``run_lifecycle_path``) on the experiment's
checkpoint at full width: the quality profile built on the card
(28/2/3/2/0 a batch, the batches derived from the host lowering), a
registry booted into the serve scorer through ``ModelManager`` with the
archive attached, a nudged candidate promoted and a constant-logit one
vetoed by the guardrails after shadow scoring (56/4/6/4/0 a batch with a
shadow staged, 28/2/3/2/0 without), ``models rollback``, serve bit-equal
to ``model_detect`` after the promotion and after the rollback, ``archive
verify`` clean and ``report``'s window count the windows served, and the
CLI's ``models``, ``quality``, ``archive`` and ``report`` exit 0.

Then the continuous-learning loop (``run_learn_path``, benchmarks/
run_learn_bench.py's flow) on the experiment's checkpoint as v1: its
quality profile shipped into a fresh registry, the scorer booted from LIVE
on the serve cell's ladder with the quality monitor, a replay buffer
(``attach_learn``), the flight recorder (``attach_flight``) and a
``RetrainSupervisor``; three unshifted streams over the wire, oracle
dispositions (one through ``alerts label``), three streams at ``drift=0.8``
during which the one ``quality_drift`` bundle fires and the supervisor
retrains once on its own CUDA stream (replay and shifted synth, 30 steps at
batch 4) while serve scores on, that leg and the retrain gated on the sum
of their launches (its forwards × 28/2/3/2/0, 30 × 56/4/5/2/1, the
retrain's evaluation forwards); ``archive export --replay`` joining the
labels; v2 published with its provenance, staged and promoted by the
guardrails after shifted legs with a shadow (56/4/6/4/0 a batch); a parity
stream bit-equal to ``model_detect`` under v2; v2's shifted edge AUC within
0.10 of v1's unshifted; ``doctor`` on the drift bundle and on a later
bundle whose learn section names the retrain; a retrain at a learning rate
of 1e12 aborted by the health monitor with nothing published.

Then the device-time plane (``run_devtime_path``) on the experiment's
checkpoint: the card's row of the peak table (which also sets every bound
here: no row, no smoke); the serve cell rung's cost traced on meta tensors
with no launch, its FLOPs equal to ``serve_flops_closed_form``; the train
step's cost cold and memoized; two of the serve cell's streams on a
service with the plane on and one with it off, legs in turns (windows/s;
28/2/3/2/0 a batch, bit-equal to ``model_detect``), the MFU, utilization,
useful-FLOPs and headroom gauges, utilization beside the profiler's busy
share of one leg; a breached p99 with ``profile_on_p99_sec`` (one bundle
whose ``torch_trace/`` holds the scorer's kernel events; ``doctor`` on
it); ``profile costs --measure 5 --cross-check`` (measured MFU =
flops / (peak × seconds a call)), ``profile capture`` locally and with
``--target`` against a ``serve-detect --profiler-port`` subprocess (port
kernel events in each trace); SLO-aware shedding (three healthy streams
paced on a small rung and a burner on the serve rung at three times the
plane-on legs' windows/s: ``capacity_saturation`` journaled, every
``fleet_shed`` victim the burner, the healthy streams bit-equal to
``model_detect``); the experiment run's train MFU gauge.

Then StreamNet (``run_stream_path``): the three attention entry points of
``flash_attention.cu`` against the plain version (forward O and dQ, dK, dV
against its autograd, within TOL·(1 + Σ|terms|), two kernel runs
bit-equal) at the stream leg's and the probe's shapes, a ragged T with two
16-wide heads and the 32- and 64-wide heads, causal and not, f32 and bf16,
timed beside ``scaled_dot_product_attention`` and the bound; bench.py's
stream leg (``StreamNet(StreamConfig())`` at full width over its corpus's
first 6 traces as 12 x 4096 events, step 0 and 50 steps, the launches
derived from the model, two dropout-0 gradients bit-equal); and
``run_stream_eval.py``'s quality probe at its defaults (the record's
segment and event counts, 300 steps, the logit-space threshold, held-out
event AUC >= 0.90, the stream checkpoint reloaded bit-equal).

Prints the card's name and power limit, one JSON line with each kernel's
launches (and its launches per serve batch and per experiment run), error,
times (ms, host_us, device_ms, library_ms, library_device_ms; the device
times from profiler traces that caught every launch, else null) and bound,
the detection rate, the serve rate, latency and warmup times, the training
rate and its breakdown, the experiment's steps/s, time split, held-out
metrics, calibration and gates, the card's busy share from profiler
traces, the undo path's rollouts/s, incidents/s and MTTR split, and as its
last line ``{"ok": true, "device": {...}}``; before it the training paths'
and the disk corpus run's lines (steps/s in turns, the upload's GB/s,
checkpoint bytes and seconds, the telemetry's cost, shards rotated, data
wait, held-out metrics), each phase's seconds on one line, and the
lifecycle's line (the profile's seconds, ms a scoring call with and
without a shadow staged, windows/s of legs with and without one, the
guardrails' decisions, the archive's bytes), the learn phase's line and
the device-time phase's line.
Exits non-zero, with no result line, when a phase fails or there is no
card.

``python3 chip_smoke.py --stream-probe SEED [SEED ...]`` runs only the
stream quality probe, once for each init seed (the spread of its held-out
event AUC over inits), and prints one JSON line of their readings.

``python3 chip_smoke.py --lifecycle`` runs only the lifecycle phase, on a
seeded full-width checkpoint, and prints one JSON line of its readings.
``python3 chip_smoke.py --learn [ROOT]`` runs only the learn phase the same
way, for the package under ROOT (this tree by default), and
``python3 chip_smoke.py --devtime [ROOT]`` the device-time phase (its train
MFU from a 5-step run at the training rung).

``python3 chip_smoke.py --planner [ROOT]`` runs only the search kernel:
with no ROOT its entries' ``ptxas`` lines, ``check_mcts`` on both entries
and ``check_value_net``; then the search's timings (``planner_times``) for
the package under ROOT (this tree by default), so that two trees can be
timed in turns in one call; one JSON line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

# the card's peaks, read from the port's one peak table
# (nerrf_tpu_torch/devtime/peaks.py, NVIDIA's data sheet) for the card the
# smoke runs on, by set_peaks(): HBM bytes/s, float32 operations/s outside
# the tensor cores (the kernels sum in f32 registers) and bf16 operations/s
# on them.  A card without a row fails the smoke: no guessed figure
HBM_BYTES_PER_S = None
F32_OPS_PER_S = None
BF16_OPS_PER_S = None

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
# rounds of the step's part-by-part timing (15 until the smoke's own time
# was cut, ROADMAP B.C1)
TRAIN_TIMING_ROUNDS = 7
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
# every AUC reads its degenerate 0.5), its 12000 steps to 40 (200 until
# the smoke's own time was cut, ROADMAP B.C1; at 20 the checkpoint raised no
# alert on the M1 incident, which the respond chain gates) and its loss read
# every 20 steps (the config: 500); nothing else changed
EXPERIMENT_TRACES = 6
EXPERIMENT_STEPS = 40
EXPERIMENT_LOG_EVERY = 20
# the runner's report, as the reference's train/run.py writes it
REPORT_KEYS = {"experiment", "backend", "devices", "num_steps", "steps_per_sec",
               "metrics", "calibration", "gates", "wall_seconds"}
HELD_OUT = ("edge_auc", "node_auc", "seq_auc", "seq_f1", "node_f1")
# the small float32 experiment (configs/toy-graphsage.json's shapes, dropout
# 0, segment mode, 20 steps), card vs CPU: each held-out metric of
# metrics.json (4 decimals) within two units of its last decimal (a value on
# a rounding boundary may round either way), the calibration's cuts within
# 1e-5 (the CPU tests hold the port against the reference at these limits)
SMALL_RUN_STEPS = 10           # 20 until the smoke's own time was cut (B.C1)
SMALL_RUN_ATOL = 2e-4
SMALL_CUT_ATOL = 1e-5
# the small experiment calibrates over one incident of each of five scenarios
# on both sides (the CPU tests' subset; all nine until the smoke's own time
# was cut, ROADMAP B.C1)
SMALL_CALIBRATION = dict(n_traces=1, exclude_scenarios=frozenset(
    {"partial-encrypt", "exfil-encrypt", "benign-atomic-rewrite"}))


# each phase's seconds of command time, in the order run (_timed)
PHASE_SECONDS = {}


def _timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds kept in PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def set_peaks():
    """Set the roofline constants from the port's peak table for the card
    (torch.cuda.get_device_name()), read from this checkout's
    ``nerrf_tpu_torch/devtime/peaks.py`` whatever package a mode times.
    Returns the card's row, None when the table has none."""
    import importlib.util

    import torch

    global HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_OPS_PER_S
    spec = importlib.util.spec_from_file_location(
        "nerrf_peaks_table", os.path.join(ROOT, "nerrf_tpu_torch", "devtime", "peaks.py"))
    table = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = table  # its dataclass resolves its module
    spec.loader.exec_module(table)
    peaks = table.resolve_kind(torch.cuda.get_device_name(0))
    if peaks is not None:
        HBM_BYTES_PER_S = peaks.hbm_gbps * 1e9
        F32_OPS_PER_S = peaks.tflops_f32 * 1e12
        BF16_OPS_PER_S = peaks.tflops_bf16 * 1e12
    return peaks


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


class Split(dict):
    """A :func:`device_split`: {kernel name: device ms per call, or None
    where the trace lost launches}; ``lost``: {kernel name (or prefix):
    {"captured": n, "expected": m}} for the kernels it caught short."""

    lost: dict


def device_split(fn, iters: int = 20, warmup: int = 3, launches=None) -> Split:
    """Device time of one ``fn()`` call by kernel, from a ``torch.profiler``
    trace of ``iters`` calls after ``warmup``: {kernel name: ms per call},
    the card's own events only (not the host-side operators).  Each kernel's
    captured launches (``key_averages()``'s ``count``) are held against
    those the calls make: ``iters`` × n for the kernels whose names start
    with a prefix of ``launches`` ({prefix: n a call}, their counts summed),
    else a whole multiple of ``iters`` (the next one up expected).  A trace
    that caught no device event or lost launches is taken again, up to 5
    in all; after the last, a kernel caught short reads None, with its
    counts in ``.lost``: never a low number.  {} when no trace caught a
    device event (not measured: :func:`split_ms` and :func:`port_kernel_ms`
    give None for it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    _sync()
    self_us = lambda e: getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0))
    launches = launches or {}
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            _sync()
        us, counts = {}, {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and self_us(e) > 0 \
                    and not getattr(e, "is_user_annotation", False):
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ").split("<")[0].split("(")[0]
                name = ("nerrf::" if "nerrf::" in e.key else "") + name.split("::")[-1][:48]
                us[name] = us.get(name, 0.0) + self_us(e)
                counts[name] = counts.get(name, 0) + e.count
        lost = {}
        for prefix, n in launches.items():
            names = [k for k in counts if k.startswith(prefix)]
            got = sum(counts[k] for k in names)
            if got != iters * n:
                lost.update({k: {"captured": got, "expected": iters * n}
                             for k in names or [prefix]})
        for k, c in counts.items():
            if c % iters and not any(k.startswith(p) for p in launches):
                lost[k] = {"captured": c, "expected": -(-c // iters) * iters}
        if us and not lost:
            break
    split = Split({k: None if k in lost else v / 1e3 / iters for k, v in us.items()})
    split.lost = lost
    return split


def split_ms(split: Split):
    """All the kernels' time of a :func:`device_split`, None if it caught
    none or lost launches (a failed measurement, never 0 or a low number)."""
    return sum(split.values()) if split and not split.lost else None


def port_kernel_ms(split: Split):
    """The port's own kernels' share of a :func:`device_split`, None if it
    caught none of them or lost launches of one."""
    ours = [v for k, v in split.items() if k.startswith("nerrf::")]
    if not ours or any(k.startswith("nerrf::") for k in split.lost):
        return None
    return sum(ours)


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
                   else split_ms(device_split(library)),
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


def device_busy_share(what: str, run, wall_s):
    """Kernel and copy time on the card during ``run()`` (a profiler trace,
    summed over the device's own events: not over the host-side operators
    and spans, which carry their kernels' time again), over ``wall_s``, the
    same run's unprofiled wall time (or a callable giving a wall time that
    ``run`` measured itself); and the kernels that took the most.  Returns
    the share, or None when the trace caught no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        _sync()
    if callable(wall_s):
        wall_s = wall_s()
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


def _counting_service(per: str = "forward"):
    """``OnlineDetectionService`` with the kernel launches of each forward
    (``per="forward"``: one ``_run_eval`` call) or of each scored batch
    (``per="batch"``: one ``_score_fn`` call, the live forward and a staged
    shadow's) kept in ``batch_launches``, read on the thread that calls it
    (the only one launching while it runs: the start() thread at warmup,
    then the scorer)."""
    from nerrf_tpu_torch.ops import LAUNCHES
    from nerrf_tpu_torch.serve import OnlineDetectionService

    hook = {"forward": "_run_eval", "batch": "_score_fn"}[per]

    def counted(self, *args):
        before = dict(LAUNCHES)
        out = getattr(OnlineDetectionService, hook)(self, *args)
        self.batch_launches.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        return out

    class CountingService(OnlineDetectionService):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.batch_launches = []

    setattr(CountingService, hook, counted)
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
    # two of the four streams (four until the device-time phase needed the
    # smoke's time, ROADMAP B.C1)
    _, wall2 = replay(svc2, {sid: traces[sid] for sid in ("s5", "s6")})
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
    # fwd_bwd) for TRAIN_TIMING_ROUNDS rounds after 2 warm-up rounds, and the
    # medians kept: drifts of the shared host hit all alike
    step = make_train_step(model, cfg)
    state = res.state
    ms = round_robin_ms({"step": lambda: step(state, batch, gen),
                         "fwd_bwd": fwd_bwd, "clip_adamw": clip_adamw,
                         "fwd": lambda: loss_fn(batch, gen),
                         "lstm_fwd_bwd": lstm_fwd_bwd, "lstm_fwd": lstm_fwd},
                      rounds=TRAIN_TIMING_ROUNDS)
    step_ms, fb_ms, f_ms = ms["step"], ms["fwd_bwd"], ms["fwd"]
    lf_ms, lfb_ms = ms["lstm_fwd"], ms["lstm_fwd_bwd"]
    print(f"training step on the card (batch of {cfg.batch_size}, medians of "
          f"{TRAIN_TIMING_ROUNDS}): "
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


# --- the reference's own training paths: resident, elastic, trainwatch ----------

SUPERSTEP_K = 5                 # one superstep of 5 makes RESIDENT_STEPS
# the resident paths' depth: each flavor takes 5 of the cell's steps (all
# 20 until the smoke's own time was cut, ROADMAP B.C1)
RESIDENT_STEPS = 5
# the busy share of each flavor is read over this many steps (supersteps of
# as many): a profiler trace of 20 steps takes minutes to summarize (2
# until the smoke's own time was cut, ROADMAP B.C1)
BUSY_STEPS = 1
# the elastic run's depth: 10 steps, a checkpoint every 3 (40 and 10 until
# the smoke's own time was cut, ROADMAP B.C1)
ELASTIC_STEPS = 10
ELASTIC_SAVE_EVERY = 3
ELASTIC_FAULT_AT = 4            # after the step-3 checkpoint, before step 6's
# the in-step grad_norm (f32 sums) against a float64 norm of the same raw
# gradients, relative
TELEMETRY_RTOL = 1e-5
NAN_STEPS = 10


def _bits_equal(a: dict, b: dict) -> list:
    """Names of the tensors of two state dicts that differ in any bit."""
    import torch

    return [n for n in a if not torch.equal(a[n], b[n])]


def check_upload(arrays) -> dict:
    """``device_put_chunked`` on the card: the side-stream upload in 1 MiB
    chunks and in one chunk a array, each bit-equal to a plain copy, and the
    rate of the default one (device seconds of its copies)."""
    import torch

    from nerrf_tpu_torch.train.loop import device_put_chunked

    plain = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
    out = {}
    for tag, max_bytes in (("1 MiB chunks", 1 << 20), ("64 MiB chunks", 64 << 20)):
        up = device_put_chunked(arrays, max_bytes=max_bytes, device="cuda")
        up.wait()
        bad = [k for k in arrays if not torch.equal(up.arrays[k], plain[k])]
        if bad:
            _fail(f"device_put_chunked ({tag}) differs from a plain copy: {bad}")
        out[tag] = up.nbytes / up.seconds() / 1e9
    print(f"device_put_chunked: {sum(v.nbytes for v in arrays.values())} bytes, "
          f"bit-equal to a plain copy in 1 MiB and 64 MiB chunks; upload rate "
          f"(device seconds of the side stream) "
          f"{json.dumps({k: round(v, 3) for k, v in out.items()})} GB/s")
    return out


def run_resident_paths(ds, cfg) -> dict:
    """The Training cell's dataset and config through the streamed step (a
    batch copied from the host each step), the scheduled step (the dataset
    and the index schedule on the card) and SUPERSTEP_K-step supersteps,
    each from the same init with one dropout generator seeded alike and the
    counters from 0: the losses and final params bit-equal across the three,
    59/59/112/56 launches a step on each; then steps/s of each, in turns
    (two rounds, both gated), and the busy share of BUSY_STEPS steps of each
    under the profiler, over their share of the rounds' wall time."""
    import dataclasses

    import numpy as np
    import torch

    from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
    from nerrf_tpu_torch.train.loop import (
        batch_to_device, init_state, make_idx_schedule, make_train_step,
        make_train_step_scheduled, make_train_superstep)

    upload = check_upload(ds.arrays)
    cfg = dataclasses.replace(cfg, num_steps=RESIDENT_STEPS)
    sched = make_idx_schedule(len(ds), cfg)
    n = cfg.num_steps
    if n % SUPERSTEP_K:
        _fail(f"{n} steps are not whole supersteps of {SUPERSTEP_K}")

    def drive(kind, n):
        """``(state, losses, run)``: a fresh state and generator and the step
        built; ``run()`` takes n steps."""
        state = init_state(cfg, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
        losses = []
        if kind == "streamed":
            step = make_train_step(state.model, cfg)

            def run():
                for s in range(n):
                    losses.append(step(state, batch_to_device(ds.arrays, sched[s], "cuda"),
                                       gen)[1])
        elif kind == "scheduled":
            step = make_train_step_scheduled(state.model, cfg, ds.arrays, sched)

            def run():
                for _ in range(n):
                    losses.append(step(state, gen)[1])
        else:
            k = min(n, SUPERSTEP_K)
            step = make_train_superstep(state.model, cfg, ds.arrays, sched, k)

            def run():
                for _ in range(n // k):
                    losses.extend(step(state, gen)[1].unbind())
        _sync()
        return state, losses, run

    kinds = ("streamed", "scheduled", "superstep")
    per_step = step_launches("segment", cfg.model.gnn.num_layers)
    want = {k: n * v for k, v in per_step.items()}
    walls = {k: [] for k in kinds}
    first = {}
    for rnd in range(2):
        for kind in kinds:
            state, losses, run = drive(kind, n)
            reset_launches()
            t0 = time.perf_counter()
            run()
            _sync()
            walls[kind].append(time.perf_counter() - t0)
            launched = dict(LAUNCHES)
            if launched != want:
                _fail(f"{kind} steps launched {launched}, want {want} ({n} of {per_step})")
            got = (torch.stack(losses).cpu(), {k: v.detach().clone()
                                               for k, v in state.model.state_dict().items()})
            if not torch.isfinite(got[0]).all():
                _fail(f"{kind} steps: losses not finite {got[0]}")
            if kind not in first:
                first[kind] = got
            ref = first["streamed"]
            if not torch.equal(got[0], ref[0]) or _bits_equal(got[1], ref[1]):
                _fail(f"round {rnd}: {kind} steps differ from the streamed steps: losses "
                      f"{got[0].tolist()} vs {ref[0].tolist()}; params "
                      f"{_bits_equal(got[1], ref[1])[:4]}")
            del state, run
    busy = {}
    for kind in kinds:
        _, _, run = drive(kind, BUSY_STEPS)
        busy[kind] = device_busy_share(f"{BUSY_STEPS} {kind} steps", run,
                                       float(np.mean(walls[kind])) * BUSY_STEPS / n)
    sps = {k: [round(n / w, 3) for w in walls[k]] for k in kinds}
    print(f"resident paths on the Training cell ({n} steps, segment, dropout "
          f"{cfg.model.gnn.dropout}): streamed = scheduled = superstep (K = "
          f"{SUPERSTEP_K}) bit for bit in losses and final params, two rounds; "
          f"{per_step} launches a step on each; steps/s in turns {json.dumps(sps)}; "
          f"busy share {json.dumps(busy)}")
    return dict(steps_per_s=sps, busy=busy, upload_gbps=upload, per_step=per_step,
                losses=first["streamed"][0].tolist())


def run_elastic_path(ds, cfg) -> dict:
    """``train_elastic`` on the Training cell for ELASTIC_STEPS steps with
    dropout on, checkpoints every ELASTIC_SAVE_EVERY; then again in another
    directory with ``fault_at(ELASTIC_FAULT_AT)``, the ``Preemption`` caught
    and the run resumed: the final params bit-equal to the uninterrupted
    run's; the uninterrupted run's launches ELASTIC_STEPS segment steps and
    its evaluation's forwards."""
    import dataclasses
    import tempfile

    from nerrf_tpu_torch import tracing
    from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
    from nerrf_tpu_torch.train.elastic import (
        STATE_FILENAME, Preemption, fault_at, latest_step, train_elastic)

    cfg = dataclasses.replace(cfg, num_steps=ELASTIC_STEPS)
    tmp = tempfile.mkdtemp(prefix="nerrf-elastic-")
    try:
        since = time.perf_counter()
        reset_launches()
        t0 = time.perf_counter()
        ref = train_elastic(ds, cfg=cfg, ckpt_dir=os.path.join(tmp, "ref"),
                            save_every=ELASTIC_SAVE_EVERY, device="cuda")
        _sync()
        ref_s = time.perf_counter() - t0
        launched = dict(LAUNCHES)
        eval_batches = math.ceil(len(ds) / cfg.batch_size)
        want = train_launches(cfg.model.gnn.num_layers, cfg.num_steps, eval_batches)
        if launched != want:
            _fail(f"elastic run launched {launched}, want {want}")
        saves = [sp.dur for sp in tracing.records()
                 if sp.name == "checkpoint" and sp.t0 >= since]
        state_bytes = os.path.getsize(os.path.join(
            tmp, "ref", f"step_{ELASTIC_SAVE_EVERY:08d}", STATE_FILENAME))
        pre = os.path.join(tmp, "pre")
        try:
            train_elastic(ds, cfg=cfg, ckpt_dir=pre, save_every=ELASTIC_SAVE_EVERY,
                          fault=fault_at(ELASTIC_FAULT_AT), device="cuda")
            _fail("the fault did not preempt the run")
        except Preemption:
            pass
        resumed_from = latest_step(pre)
        t0 = time.perf_counter()
        lines = []
        res = train_elastic(ds, cfg=cfg, ckpt_dir=pre, save_every=ELASTIC_SAVE_EVERY,
                            device="cuda", log=lines.append)
        _sync()
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    differ = _bits_equal(ref.state.model.state_dict(), res.state.model.state_dict())
    if resumed_from != ELASTIC_SAVE_EVERY or f"resumed from step {resumed_from}" not in lines \
            or differ or res.state.step != cfg.num_steps:
        _fail(f"elastic resume from step {resumed_from}: {len(differ)} params differ from "
              f"the uninterrupted run ({differ[:4]}), log {lines[:2]}")
    if ref.history[-1] != res.history[-1]:
        _fail(f"elastic: last losses {ref.history[-1]} vs {res.history[-1]}")
    print(f"elastic: {cfg.num_steps} steps (dropout {cfg.model.gnn.dropout}, checkpoints "
          f"every {ELASTIC_SAVE_EVERY}) in {ref_s:.1f} s at {ref.steps_per_sec:.3f} "
          f"steps/s; preempted at step {ELASTIC_FAULT_AT}, resumed from step "
          f"{resumed_from} in {resume_s:.1f} s: final params bit-equal to the "
          f"uninterrupted run; a checkpoint {state_bytes} bytes, saved in "
          f"{min(saves):.3f}-{max(saves):.3f} s; launches {launched}")
    return dict(steps_per_sec=ref.steps_per_sec, save_s=[min(saves), max(saves)],
                state_bytes=state_bytes, launches=launched)


def run_trainwatch_path(ds, cfg) -> dict:
    """One telemetry-on step of the Training cell: its floats, its grad_norm
    against a float64 norm of the same raw gradients (a twin model from the
    same init, the same batch and dropout seed), and the step's time with
    and without telemetry, in turns.  Then ``train_nerrfnet`` with a
    ``TrainHealthMonitor`` on a copy of the dataset whose window first
    scheduled at a step past 0 has NaN node features: the monitor latches
    the divergence once, at that step, the loop halts there and the metrics
    come back empty."""
    import dataclasses

    import numpy as np
    import torch

    from nerrf_tpu_torch.train.data import WindowDataset
    from nerrf_tpu_torch.train.loop import (
        _telemetry_floats, batch_to_device, init_state, make_idx_schedule,
        make_loss_fn, make_train_step, train_nerrfnet)
    from nerrf_tpu_torch.trainwatch import TrainHealthMonitor

    tcfg = dataclasses.replace(cfg, telemetry=True)
    batch = batch_to_device(ds.arrays, np.arange(cfg.batch_size), "cuda")
    state = init_state(tcfg, "cuda")
    state.step = cfg.warmup_steps  # at the peak learning rate: the params move
    step = make_train_step(state.model, tcfg)
    _, _, aux = step(state, batch, torch.Generator(device="cuda").manual_seed(3))
    floats = _telemetry_floats(aux)
    twin = init_state(cfg, "cuda").model
    make_loss_fn(twin, cfg)(batch, torch.Generator(device="cuda").manual_seed(3))[0].backward()
    want = math.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in twin.parameters()
                         if p.grad is not None))
    err = abs(floats["grad_norm"] - want) / want
    print(f"trainwatch: one telemetry-on step: {json.dumps(floats)}; grad_norm vs a "
          f"float64 norm of the same gradients {floats['grad_norm']} vs {want} "
          f"(relative {err:.2e})")
    if not err <= TELEMETRY_RTOL or any(floats["nonfinite"].values()):
        _fail(f"telemetry grad_norm {floats['grad_norm']} vs {want} (relative {err})")
    off = make_train_step(state.model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(4)
    ms = round_robin_ms({"off": lambda: off(state, batch, gen),
                         "on": lambda: step(state, batch, gen)}, rounds=8)
    print(f"trainwatch: a training step with telemetry {ms['on']:.1f} ms, without "
          f"{ms['off']:.1f} ms (host clock, medians of 8 in turns)")

    ncfg = dataclasses.replace(tcfg, num_steps=NAN_STEPS, eval_every=1)
    sched = make_idx_schedule(len(ds), ncfg)
    for at in range(1, NAN_STEPS):
        fresh = set(sched[at].tolist()) - set(sched[:at].ravel().tolist())
        if fresh:
            break
    arrays = dict(ds.arrays, node_feat=ds.arrays["node_feat"].copy())
    arrays["node_feat"][min(fresh)] = np.nan
    logs = []
    monitor = TrainHealthMonitor(log=logs.append)
    res = train_nerrfnet(WindowDataset(arrays), cfg=ncfg, device="cuda",
                         monitor=monitor, log=logs.append)
    fired = [m for m in logs if "train_divergence" in m]
    print(f"trainwatch: NaN window first scheduled at step {at}: latched "
          f"{monitor.diverged}, halted after {len(res.history)} logged steps, metrics "
          f"{res.metrics}; trigger log {fired}")
    if (monitor.diverged is None or monitor.diverged[0] != at or len(fired) != 1
            or res.metrics != {} or [h["step"] for h in res.history] != list(range(at + 1))
            or "non-finite" not in monitor.diverged[1]):
        _fail(f"trainwatch halt: diverged {monitor.diverged}, history {res.history}, "
              f"metrics {res.metrics}, log {logs}")
    return dict(floats=floats, grad_norm_err=err, step_ms=ms, nan_step=at)


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


def _run_logged(run_experiment, *args, keep: str = "train_nerrfnet", **kw):
    """``run_experiment(*args, **kw)`` with its log kept, and the
    ``TrainResult`` (the in-memory model) of its trainer ``keep`` (a function
    of ``train/loop.py``): ``(report, result, log)``."""
    import contextlib

    from nerrf_tpu_torch.train import loop

    real, kept = getattr(loop, keep), {}

    def keeping(*a, **k):
        kept["result"] = real(*a, **k)
        return kept["result"]

    tee = _Tee(sys.stderr)
    setattr(loop, keep, keeping)
    try:
        with contextlib.redirect_stderr(tee):
            report = run_experiment(*args, **kw)
    finally:
        setattr(loop, keep, real)
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
        # a calibrated checkpoint ships the quality profile built at its cut
        profiled = shipped_profile_forwards(os.path.join(out, "model"))
        want = {k: v + profiled * fwd[k] for k, v in want.items()}
        print(f"experiment launches {launches}, expected {want} ({cfg.num_steps} "
              f"fused steps of {step}, {eval_batches} + {cal_batches} + {profiled} "
              f"forwards of {fwd})")
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
        # the undo run (run_undo_path) detects with this checkpoint
        model_dir = tempfile.mkdtemp(prefix="nerrf-undo-model-")
        shutil.copytree(os.path.join(out, "model"), model_dir, dirs_exist_ok=True)
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
                eval_batches=eval_batches, cal_batches=cal_batches, model_dir=model_dir)


def check_small_experiment() -> dict:
    """A small float32 experiment (``configs/toy-graphsage.json``'s corpus,
    dataset and model widths; dropout 0, ``segment`` mode, SMALL_RUN_STEPS
    steps, calibration on over SMALL_CALIBRATION's incidents) through
    ``run_experiment`` on the card (kernels)
    and on the CPU (plain versions), from the same init (drawn on the CPU
    generator on both): the held-out metrics within SMALL_RUN_ATOL, the same
    calibration within SMALL_CUT_ATOL or unreachable on both."""
    import functools
    import tempfile

    from nerrf_tpu_torch import pipeline
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
        real = pipeline.calibrate_file_thresholds
        pipeline.calibrate_file_thresholds = functools.partial(real, **SMALL_CALIBRATION)
        try:
            for dev in ("cpu", "cuda"):
                reset_launches()
                report, _, log = _run_logged(run_experiment, path,
                                             os.path.join(tmp, dev), device=dev)
                _sync()
                runs[dev] = (report, dict(LAUNCHES),
                             _check_calibration(os.path.join(tmp, dev, "model"), log,
                                                f"small experiment on {dev}"))
        finally:
            pipeline.calibrate_file_thresholds = real
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


# --- the disk corpus through the experiment runner ------------------------------

# the corpus: CorpusSpec's defaults (600 s traces at 40 Hz, 24 files, hard
# scenarios, auto-fit) cut from 100 h to 1 h (6 traces) and from 2000
# windows a shard to 64, windowed with configs/joint-100h.json's dataset
CORPUS_HOURS = 1.0
CORPUS_SHARD_WINDOWS = 64
CORPUS_STEPS = 60           # 200 until the smoke's own time was cut (B.C1)
CORPUS_CKPT_EVERY = 30
CORPUS_MIN_ROTATIONS = 3


def _shard_plan(corpus_dir, cfg, passes: int = 2) -> list:
    """The sharded trainer's first step on each shard it trains and that
    step's batch indices, replayed from its rules: the shard order of
    ``iter_train_shards(seed + epoch)``, ``_shard_steps`` steps a shard,
    the indices drawn from ``default_rng((seed, 0))`` in step order.
    ``[(step, shard name, idx)]``."""
    import numpy as np

    from nerrf_tpu_torch.train.corpus import ShardedCorpus
    from nerrf_tpu_torch.train.loop import _shard_steps

    sc = ShardedCorpus(corpus_dir)
    windows = {s["name"]: s["windows"] for s in sc.manifest["shards"]}
    order = np.random.default_rng((cfg.seed, 0))
    plan, done, epoch = [], 0, 0
    while done < cfg.num_steps:
        for i in np.random.default_rng(cfg.seed + epoch).permutation(len(sc.train_shards)):
            name = sc.train_shards[int(i)]
            n = windows[name]
            steps = min(_shard_steps({"node_feat": np.empty((n, 0))}, cfg, passes),
                        cfg.num_steps - done)
            for j in range(steps):
                idx = order.choice(n, size=min(cfg.batch_size, n), replace=False)
                if j == 0:
                    plan.append((done, name, idx))
                done += 1
            if done == cfg.num_steps:
                break
        epoch += 1
    return plan


def run_disk_corpus_path(config_path: str = TRAIN_CONFIG, steps: int = CORPUS_STEPS,
                         hours: float = CORPUS_HOURS) -> dict:
    """A disk corpus generated by the port's ``generate_corpus`` (joint-100h's
    dataset config, ``hours`` of 600 s traces, CORPUS_SHARD_WINDOWS windows a
    shard), then ``run_experiment`` on a copy of the config whose
    ``corpus_dir`` points at it: full width, ``fused``, ``steps`` steps,
    ``ckpt_every`` CORPUS_CKPT_EVERY, to a calibrated checkpoint (or one
    reported unreachable), on the card with the counters from 0.  Gates: the
    launches derived from the model (the steps, the held-out batches, the
    calibration's batches); at least CORPUS_MIN_ROTATIONS shard rotations;
    the first batch trained on each shard equal, bit for bit, to the same
    rows loaded on the host (the upload's event waited on); the reloaded
    checkpoint bit-equal in ``model_detect``; the corpus extras in
    ``metrics.json``; the last full-state checkpoint at the last step."""
    import tempfile

    import numpy as np
    import torch

    from nerrf_tpu_torch.config import Experiment
    from nerrf_tpu_torch.data import SimConfig, simulate_trace
    from nerrf_tpu_torch.models import NerrfNet
    from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
    from nerrf_tpu_torch.pipeline import (
        calibration_traces, fit_capacity, model_detect)
    from nerrf_tpu_torch.train import loop
    from nerrf_tpu_torch.train.checkpoint import load_checkpoint
    from nerrf_tpu_torch.train.corpus import CorpusSpec, ShardedCorpus, generate_corpus
    from nerrf_tpu_torch.train.data import DatasetConfig, windows_of_trace
    from nerrf_tpu_torch.train.elastic import latest_step
    from nerrf_tpu_torch.train.run import run_experiment

    with open(config_path) as f:
        spec = json.load(f)
    tmp = tempfile.mkdtemp(prefix="nerrf-corpus-")
    try:
        cdir, out = os.path.join(tmp, "corpus"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        man = generate_corpus(cdir, CorpusSpec(hours=hours,
                                               shard_windows=CORPUS_SHARD_WINDOWS),
                              dataset=Experiment.load(config_path).dataset)
        gen_s = time.perf_counter() - t0
        spec["corpus_dir"] = cdir
        spec["train"]["num_steps"] = steps
        spec["train"]["eval_every"] = EXPERIMENT_LOG_EVERY
        path = os.path.join(tmp, "joint-100h-disk.json")
        with open(path, "w") as f:
            json.dump(spec, f, indent=2)
        exp = Experiment.load(path)
        cfg = exp.train
        B, L = cfg.batch_size, cfg.model.gnn.num_layers
        sc = ShardedCorpus(cdir)
        eval_ds = sc.eval_dataset()
        cal_windows = [len(windows_of_trace(tr, fit_capacity(tr, DatasetConfig())))
                       for tr in calibration_traces()]
        eval_batches = math.ceil(len(eval_ds) / B)
        cal_batches = sum(math.ceil(w / B) for w in cal_windows)
        fwd, step = fused_forward_launches(L), step_launches("fused", L)
        want = {k: cfg.num_steps * step[k] + (eval_batches + cal_batches) * fwd[k]
                for k in step}
        plan = _shard_plan(cdir, cfg)
        nbytes = sum(os.path.getsize(os.path.join(cdir, sc.train_shards[0], f))
                     for f in os.listdir(os.path.join(cdir, sc.train_shards[0])))
        print(f"disk corpus: {man['num_traces']} traces, {man['train_windows']} train "
              f"windows in {len(sc.train_shards)} shards ({nbytes} bytes the first), "
              f"{man['eval_windows']} held out, capacities {man['graph_capacity']}, "
              f"scenarios {man['scenario_counts']}, generated in {gen_s:.1f} s; "
              f"{len(plan)} shards to train over {cfg.num_steps} steps; expected "
              f"launches {want}")

        # the first batch of each shard, as the trainer gathered it on the card
        firsts, real_step = {s: None for s, _, _ in plan}, loop.make_train_step

        def recording_step(model, c):
            step_fn = real_step(model, c)

            def run(state, batch, gen=None):
                if state.step in firsts and firsts[state.step] is None:
                    firsts[state.step] = {k: v.cpu() for k, v in batch.items()}
                return step_fn(state, batch, gen)

            return run

        _sync()
        reset_launches()
        since = time.perf_counter()
        loop.make_train_step = recording_step
        try:
            report, res, log = _run_logged(run_experiment, path, out,
                                           ckpt_every=CORPUS_CKPT_EVERY, device="cuda",
                                           keep="train_sharded_stream")
        finally:
            loop.make_train_step = real_step
        _sync()
        wall_s = time.perf_counter() - since
        launches = dict(LAUNCHES)
        spans = _span_seconds(since)
        # a calibrated checkpoint ships the quality profile built at its cut
        profiled = shipped_profile_forwards(os.path.join(out, "model"))
        want = {k: v + profiled * fwd[k] for k, v in want.items()}
        print(f"disk corpus run launches {launches}, expected {want} ({profiled} "
              f"profile forwards)")
        if launches != want:
            _fail(f"disk corpus launch counts {launches} != {want}")
        info = res.info
        if info["shards"] != len(plan) or info["shards"] - 1 < CORPUS_MIN_ROTATIONS:
            _fail(f"shards trained {info['shards']}, planned {len(plan)} (at least "
                  f"{CORPUS_MIN_ROTATIONS} rotations)")
        for s, name, idx in plan:
            host = sc.load_shard(name, upcast=True)
            got = firsts[s]
            bad = [k for k in host if got is None or not torch.equal(
                got[k], torch.from_numpy(np.ascontiguousarray(host[k][idx])))]
            if bad:
                _fail(f"step {s}, the first on {name}: the batch on the card differs "
                      f"from the host rows in {bad}")
        losses = [h["loss"] for h in res.history]
        if len(losses) != cfg.num_steps // EXPERIMENT_LOG_EVERY or \
                not np.all(np.isfinite(losses)):
            _fail(f"disk corpus losses: {res.history}")
        extras = {"corpus_hours": round(man["hours"], 2),
                  "corpus_train_windows": man["train_windows"],
                  "corpus_eval_windows": man["eval_windows"]}
        with open(os.path.join(out, "metrics.json")) as f:
            written = json.load(f)
        if written != report or set(report) != REPORT_KEYS | set(extras) or \
                any(report[k] != v for k, v in extras.items()):
            _fail(f"disk corpus metrics.json {written}")
        if latest_step(os.path.join(out, "train_state")) != cfg.num_steps:
            _fail("the last full-state checkpoint is not at the last step")
        t0 = time.perf_counter()
        state, lcfg = load_checkpoint(os.path.join(out, "model"))
        with torch.device("cuda"):
            loaded = NerrfNet(lcfg)
        loaded.load_state_dict(state, strict=True)
        loaded.eval()
        _sync()
        load_s = time.perf_counter() - t0
        differ = _bits_equal({k: v.cuda() for k, v in state.items()},
                             res.state.model.state_dict())
        incident = simulate_trace(SimConfig(duration_sec=180.0, attack=True,
                                            num_target_files=24, benign_rate_hz=40.0,
                                            seed=4321), name="corpus-check-atk")
        a = model_detect(incident, res.state.model, device="cuda")
        b = model_detect(incident, loaded, device="cuda")
        if differ or (a.file_scores, a.file_window_scores, a.proc_scores) != \
                (b.file_scores, b.file_window_scores, b.proc_scores):
            _fail(f"disk corpus checkpoint: {len(differ)} params differ, or "
                  f"model_detect's bits after the load")
        calibration = _check_calibration(os.path.join(out, "model"), log, "disk corpus")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    upload_gbps = (info["upload_bytes"] / info["upload_device_s"] / 1e9
                   if info["upload_device_s"] else None)
    split = {
        "generate_s": gen_s,
        "eval_split_s": spans.get("build_dataset", 0.0),
        "training_s": spans.get("train_setup", 0.0) + spans.get("train_loop", 0.0),
        "data_wait_s": info["data_wait_s"],
        "held_out_eval_s": spans.get("eval", 0.0),
        "calibration_s": spans.get("calibrate", 0.0),
        "checkpoint_save_s": spans.get("checkpoint", 0.0),
        "checkpoint_load_s": load_s,
    }
    print(f"disk corpus run: {wall_s:.1f} s; {info['shards']} shards trained "
          f"({info['shards'] - 1} rotations), first batch of each bit-equal to its "
          f"host rows; data wait {info['data_wait_s']:.3f} s; upload "
          f"{info['upload_bytes']} bytes at {upload_gbps} GB/s (side stream's device "
          f"seconds); {report['steps_per_sec']} steps/s after step 0; split "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})}; losses "
          f"{[round(x, 4) for x in losses]}; held-out "
          f"{json.dumps({k: report['metrics'][k] for k in HELD_OUT})}; calibration "
          f"{calibration}; model_detect on {incident.name} bit-equal after the load "
          f"({len(a.file_scores)} files)")
    return dict(launches=launches, report=report, wall_s=wall_s, split=split,
                shards=info["shards"], upload_gbps=upload_gbps,
                data_wait_s=info["data_wait_s"], calibration=calibration)


# --- the undo path: the search kernel, the value net, the planners, undo ----

MCTS_SIMS = 800                 # MCTSConfig's default, the spec's 500-1000 band
MCTS_CHECK_SIMS = (64, MCTS_SIMS)
# a case whose working set outgrows a block's shared memory, so that
# check_mcts holds the global entry too: the 512f/32p bucket at 2500
# simulations
MCTS_GLOBAL_CASE = ("512f/32p bucket 300f/20p", 2500)
# rows of the chain floor's table (64 x A floats in shared memory)
CHAIN_ROWS = 64
# the in-kernel value net against ValueNet.__call__ (cuBLAS and torch's
# GELU): |Δ| ≤ VALUE_RTOL·(1 + |v|), for the order of the dot products and
# tanhf
VALUE_RTOL = 1e-5
VALUE_ROWS = 4096
BATCH_SLOTS = (1, 2, 4, 8)
# run_recovery_bench's M1 incident: 45 files of 2-5 MB
UNDO_FILES = dict(num_files=45, min_file_bytes=2_000_000, max_file_bytes=5_000_000)


def bench_domain():
    """``bench.py``'s planner domain (M1 scale: 45 files, 4 processes,
    beta(0.4, 0.4) scores from ``default_rng(7)``, 2-5 MB at stake)."""
    import numpy as np

    from nerrf_tpu_torch.planner import UndoDomain

    prng = np.random.default_rng(7)
    F, P = 45, 4
    return UndoDomain(
        file_paths=[f"/app/uploads/doc_{i}.lockbit3" for i in range(F)],
        file_scores=prng.beta(0.4, 0.4, F).astype(np.float32),
        file_loss_mb=prng.uniform(2.0, 5.0, F).astype(np.float32),
        proc_names=[f"{4000 + p}:python3" for p in range(P)],
        proc_scores=np.array([0.95] + [0.1] * (P - 1), np.float32),
        max_steps=64)


def seeded_domain(F: int, P: int, seed: int):
    """An incident of F files and P processes drawn from ``seed`` as the
    bench domain is drawn."""
    import numpy as np

    from nerrf_tpu_torch.planner import UndoDomain

    rng = np.random.default_rng(seed)
    return UndoDomain(
        file_paths=[f"/srv/data/f_{i}.lockbit3" for i in range(F)],
        file_scores=rng.beta(0.4, 0.4, F).astype(np.float32),
        file_loss_mb=rng.uniform(2.0, 5.0, F).astype(np.float32),
        proc_names=[f"{4000 + p}:python3" for p in range(P)],
        proc_scores=rng.uniform(0.0, 1.0, P).astype(np.float32),
        max_steps=64)


def mcts_domains() -> dict:
    """``check_mcts``'s cases: name → (domain, root state or None)."""
    import numpy as np

    from nerrf_tpu_torch.planner import UndoDomain

    bench = bench_domain()
    clean = UndoDomain(  # tests/test_planner.py's all-clean domain
        file_paths=[f"/app/f{i}.dat" for i in range(6)],
        file_scores=np.full(6, 0.02, np.float32),
        file_loss_mb=np.full(6, 2.0, np.float32),
        proc_names=["200:nginx"], proc_scores=np.array([0.01], np.float32),
        max_steps=16)
    stopped = bench.initial_state()
    stopped[bench.F + bench.P + 2] = 1.0
    return {"bench 45f/4p": (bench, None), "all-clean 6f/1p": (clean, None),
            "terminal root": (bench, stopped),
            "floor bucket 200f/12p": (seeded_domain(200, 12, 11), None),
            "512f/32p bucket 300f/20p": (seeded_domain(300, 20, 12), None)}


def _tree_diff(a, b) -> list:
    """The tree arrays in which two trees differ."""
    import torch

    return [f for f in a._fields if not torch.equal(getattr(a, f), getattr(b, f))]


def _nodes_differ(a, b) -> int:
    """Node slots of tree 0 in which any array of two trees differs."""
    import torch

    M = a.visits.shape[1]
    bad = torch.zeros(M, dtype=torch.bool, device=a.visits.device)
    for f in a._fields:
        if f != "n_nodes":
            ne = getattr(a, f)[0] != getattr(b, f)[0]
            bad |= ne.reshape(M, -1).any(1)
    return int(bad.sum())


def _mean_depth(tree) -> float:
    """Select levels per simulation of tree 0: a simulation's backup visits
    its path, one node more than its levels."""
    v = tree.visits[0].double()
    return float(v.sum() / v[0]) - 1.0


def _search_tree(dm, root=None, plain=False, sims=None):
    """One search on a fresh tree of ``dm`` in one call, synced."""
    from nerrf_tpu_torch.ops import mcts as ops_mcts

    tree = dm.init_tree(root)
    run = ops_mcts.search_chunk_plain if plain else ops_mcts.search_chunk
    run(tree, dm.cfg.num_simulations if sims is None else sims, dm._ctx, dm._weights)
    _sync()
    return tree


def search_kernel_name(route: str) -> str:
    """The profiler's name of the search entry ``route`` launches."""
    from nerrf_tpu_torch.ops import mcts as ops_mcts

    return f"nerrf::{ops_mcts.ROUTE_ENTRY[route]}_kernel"


def _chunked_tree(dm, root=None):
    """A fresh tree of ``dm`` searched as ``DeviceMCTS.plan`` searches it
    (``run_chunks``: launches of ≤ 128 simulations, each but the first on
    a tree that already has nodes), synced."""
    from nerrf_tpu_torch.planner.device_mcts import run_chunks

    tree = dm.init_tree(root)
    run_chunks(tree, dm._ctx, dm._weights, dm.cfg, time.perf_counter())
    _sync()
    return tree


def check_mcts() -> dict:
    """``mcts_search`` against its plain version on the card, heuristic
    value, on each of :func:`mcts_domains` at 64 and 800 simulations and on
    MCTS_GLOBAL_CASE: every tree array bit-equal, and two kernel runs
    bit-equal; each case's launches counted on the entry ``search_route``
    names, the 2500-simulation case on the global entry and the others on
    the resident one, whose shared bytes the C entry and ``ops.mcts`` agree
    on.  The 800- and 2500-simulation cases also run the kernel in the
    plan's chunks (:func:`_chunked_tree`, ⌈sims/128⌉ launches, all but the
    first resuming a tree with nodes): every tree array bit-equal to the
    plain version's whole search, the launches counted on the same
    entry."""
    from nerrf_tpu_torch.ops import kernels
    from nerrf_tpu_torch.ops import mcts as ops_mcts
    from nerrf_tpu_torch.planner import DeviceMCTS, MCTSConfig
    from nerrf_tpu_torch.planner.device_mcts import CHUNK_SIMULATIONS

    domains = mcts_domains()
    cases = [(name, sims) for name in domains for sims in MCTS_CHECK_SIMS]
    out = {}
    for name, sims in cases + [MCTS_GLOBAL_CASE]:
        d, root = domains[name]
        dm = DeviceMCTS(d, MCTSConfig(num_simulations=sims), device="cuda")
        route = dm.route
        want = "global" if (name, sims) == MCTS_GLOBAL_CASE else "resident"
        M, Fp, Pp = sims + 1, dm._dims["F"], dm._dims["P"]
        smem = ops_mcts.resident_shared_bytes(M, Fp, Pp, 0)
        if route != want or kernels.mcts_resident_bytes(M, Fp, Pp, 0) != smem:
            _fail(f"mcts_search on {name} at {sims} simulations: route {route} (want "
                  f"{want}); resident bytes {smem} in ops.mcts, "
                  f"{kernels.mcts_resident_bytes(M, Fp, Pp, 0)} in the C entry")
        ops_mcts.reset_launches()
        a, b = _search_tree(dm, root), _search_tree(dm, root)
        if ops_mcts.ROUTE_LAUNCHES[route] != 2:
            _fail(f"mcts_search on {name} at {sims} simulations: launches by route "
                  f"{ops_mcts.ROUTE_LAUNCHES}, want 2 {route}")
        t0 = time.perf_counter()
        p = _search_tree(dm, root, plain=True)
        plain_s = time.perf_counter() - t0
        bad, again = _tree_diff(a, p), _tree_diff(a, b)
        if bad or again:
            _fail(f"mcts_search on {name} at {sims} simulations: kernel vs plain "
                  f"differ in {bad}, two kernel runs in {again}")
        out[f"{name} @{sims}"] = case = dict(route=route, resident_bytes=smem,
                                             n_nodes=int(a.n_nodes[0]),
                                             depth=round(_mean_depth(a), 3),
                                             plain_s=round(plain_s, 3))
        if sims < MCTS_SIMS:
            continue
        ops_mcts.reset_launches()
        c = _chunked_tree(dm, root)
        chunks = math.ceil(sims / CHUNK_SIMULATIONS)
        if ops_mcts.ROUTE_LAUNCHES[route] != chunks or _tree_diff(c, p):
            _fail(f"mcts_search on {name} at {sims} simulations in chunks of "
                  f"{CHUNK_SIMULATIONS}: launches by route {ops_mcts.ROUTE_LAUNCHES} (want "
                  f"{chunks} {route}), kernel vs plain differ in {_tree_diff(c, p)}")
        case["chunked_launches"] = chunks
    print("mcts_search vs its plain version on the card (heuristic value; every "
          "tree array bit-equal, two kernel runs bit-equal; at 800 and 2500 "
          "simulations also the plan's chunks against the plain whole search; the "
          "entry each case took): " + json.dumps(out))
    return out


def check_mcts_ptxas() -> dict:
    """The search library's entries as ``ptxas -v`` reported them
    (registers, spills, static shared memory), and the resident entry's
    dynamic shared bytes at the bench bucket (800 simulations, heuristic
    and h = 64); fails if the resident entry spills."""
    from nerrf_tpu_torch.ops import kernels

    lines = _ptxas_lines(kernels.library_path("mcts_search").with_suffix(".log"))
    out = {}
    for short in ("mcts_search_resident_kernel", "mcts_search_kernel", "mcts_value_kernel",
                  "mcts_chain_floor_kernel"):
        found = [k for k in lines if short in k]
        if len(found) != 1:
            _fail(f"ptxas: {len(found)} entries named {short}")
        out[short] = lines[found[0]]
    spilled = sum(int(n) for line in out["mcts_search_resident_kernel"]
                  for n in re.findall(r"(\d+) bytes spill", line))
    if spilled:
        _fail(f"ptxas: the resident search entry spills ({out['mcts_search_resident_kernel']})")
    out["resident_dynamic_shared_bytes"] = {
        f"256f/16p @{MCTS_SIMS} h={h}": kernels.mcts_resident_bytes(MCTS_SIMS + 1, 256, 16, h)
        for h in (0, 64)}
    print("mcts_search library (ptxas -v: registers, spills, static shared bytes; the "
          "resident entry's dynamic shared bytes): " + json.dumps(out))
    return out


def one_launch_ms(dm, root=None, reps: int = 5) -> tuple:
    """CUDA events around one launch of all ``dm.cfg.num_simulations``
    simulations on a fresh tree (made before the events, no host sync
    inside), the median of ``reps`` after a warm one; and the last tree."""
    import statistics

    import torch

    from nerrf_tpu_torch.ops import mcts as ops_mcts

    trees = [dm.init_tree(root) for _ in range(reps + 1)]
    times = []
    for k, tree in enumerate(trees):
        _sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ops_mcts.search_chunk(tree, dm.cfg.num_simulations, dm._ctx, dm._weights)
        end.record()
        end.synchronize()
        if k:
            times.append(start.elapsed_time(end))
    return statistics.median(times), trees[-1]


def select_levels(tree) -> int:
    """Select levels of all the simulations of tree 0: the visits of every
    node but the root (each simulation's backup visits its path)."""
    v = tree.visits[0].long()
    return int(v.sum() - v[0])


def chain_floor_ms(levels: int, A: int):
    """The chain floor of ``levels`` select levels over A actions: the
    device ms of ``mcts_chain_floor`` walking that many dependent one-warp
    argmaxes over rows of a CHAIN_ROWS x A table in shared memory, less the
    same launch with none (CUDA events); None for a package without it."""
    import torch

    from nerrf_tpu_torch.ops import kernels

    if "mcts_chain_floor" not in kernels._ARGTYPES:
        return None
    table = torch.rand(CHAIN_ROWS, A, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    out = torch.zeros(1, dtype=torch.int32, device="cuda")

    def run(n):
        kernels._launch("mcts_chain_floor", table.device, table.data_ptr(), CHAIN_ROWS, A, n,
                        out.data_ptr())

    return cuda_ms(lambda: run(levels), iters=5, warmup=1) - cuda_ms(lambda: run(0), iters=5,
                                                                      warmup=1)


def search_reading(dm, root=None) -> dict:
    """One launch of a whole search on a fresh tree of ``dm``: its events ms
    (:func:`one_launch_ms`), the profiler's device ms for the same launch
    (null unless every launch was caught; read beside the events'), ns a
    simulation and a select level, the mean select depth, the chain floor
    of the tree's levels, the entry, the tree's checksum (n_nodes, Σ
    visits) to tell that two trees ran the same search, and the host's
    enqueue µs of a launch (:func:`host_us`, one simulation a launch on the
    finished tree)."""
    from nerrf_tpu_torch.ops import mcts as ops_mcts

    ms, tree = one_launch_ms(dm, root)
    # an older package timed by --planner ROOT has one entry and no routes
    route = getattr(dm, "route", "global")
    name = search_kernel_name(route) if hasattr(ops_mcts, "ROUTE_ENTRY") \
        else "nerrf::mcts_search_kernel"

    def launch():
        ops_mcts.search_chunk(dm.init_tree(root), dm.cfg.num_simulations, dm._ctx, dm._weights)

    split = device_split(launch, iters=5, warmup=1, launches={name: 1})
    sims, levels = dm.cfg.num_simulations, select_levels(tree)
    seen = dict(levels=levels, depth=round(_mean_depth(tree), 3), n_nodes=int(tree.n_nodes[0]),
                visits_sum=int(tree.visits[0].long().sum()))
    enqueue_us = host_us(lambda: ops_mcts.search_chunk(tree, 1, dm._ctx, dm._weights), iters=50)
    return dict(route=route, ms=ms, device_ms=split.get(name), device_lost=split.lost or None,
                ns_per_sim=ms * 1e6 / sims, ns_per_level=ms * 1e6 / max(levels, 1),
                chain_floor_ms=chain_floor_ms(levels, dm._dims["A"]), host_us=enqueue_us,
                **seen)


def check_value_net(bench) -> dict:
    """The value net on the card: ``fit_to_domain`` on the bench domain as
    ``bench.py`` runs it; the search kernel's own value function on
    VALUE_ROWS seeded feature rows against ``ValueNet.__call__``; the
    kernel's 800-simulation plan against the plain version's (the same
    targets in order and the same rollouts; the tree nodes that differ are
    printed) and two kernel runs bit-equal."""
    import numpy as np
    import torch

    from nerrf_tpu_torch.ops import mcts as ops_mcts
    from nerrf_tpu_torch.ops import plain_ops
    from nerrf_tpu_torch.planner import DeviceMCTS, MCTSConfig
    from nerrf_tpu_torch.planner.value_net import ValueNet

    net = ValueNet.create(device="cuda")
    _sync()
    t0 = time.perf_counter()
    mse = net.fit_to_domain(bench, num_rollouts=256, steps=150)
    _sync()
    fit_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    F, P = bench.F, bench.P
    states = (rng.random((VALUE_ROWS, F + P + 3)) < rng.random((VALUE_ROWS, 1))).astype(np.float32)
    states[:, F + P] = rng.uniform(0.0, 20.0, VALUE_ROWS)
    states[:, F + P + 1] = rng.integers(0, 65, VALUE_ROWS)
    states[:, F + P + 2] = rng.random(VALUE_ROWS) < 0.1
    feats = bench.value_features(states)
    dm = DeviceMCTS(bench, MCTSConfig(num_simulations=MCTS_SIMS), value=net, device="cuda")
    got = ops_mcts.leaf_value(torch.from_numpy(feats).cuda(), dm._ctx.consts, dm._weights)
    want = torch.from_numpy(net(feats)).cuda()
    value_err = float(((got - want).abs() / (1.0 + want.abs())).max())
    if value_err > VALUE_RTOL:
        _fail(f"mcts_search's value net vs ValueNet: |Δ|/(1+|v|) {value_err} > {VALUE_RTOL}")
    kplan = dm.plan()
    with plain_ops():
        pplan = dm.plan()
    key = lambda p: [(a.kind.name, a.target) for a in p.actions]  # noqa: E731
    if key(kplan) != key(pplan) or kplan.rollouts != pplan.rollouts:
        _fail(f"value-net plans differ: kernel {key(kplan)} ({kplan.rollouts}) vs plain "
              f"{key(pplan)} ({pplan.rollouts})")
    a, b, p = _search_tree(dm), _search_tree(dm), _search_tree(dm, plain=True)
    if _tree_diff(a, b):
        _fail(f"value-net search: two kernel runs differ in {_tree_diff(a, b)}")
    out = dict(fit_mse=mse, fit_s=fit_s, value_err=value_err,
               nodes_differ=_nodes_differ(a, p), n_nodes=int(a.n_nodes[0]),
               depth=round(_mean_depth(a), 3), plan_actions=len(kplan.actions))
    print(f"value net on the card: fit_to_domain(bench, 256 rollouts, 150 steps) final "
          f"MSE {mse:.4f} in {fit_s:.3f} s; the kernel's value on {VALUE_ROWS} rows vs "
          f"ValueNet max |Δ|/(1+|v|) {value_err:.2e}; {MCTS_SIMS}-simulation plans kernel vs "
          f"plain equal ({len(kplan.actions)} actions, {kplan.rollouts} rollouts), "
          f"{out['nodes_differ']} of {out['n_nodes']} tree nodes differ; two kernel "
          f"runs bit-equal")
    return dict(out, net=net)


def run_planner_cell(bench, net) -> dict:
    """The planner cell (BASELINE's rollouts/s): the bench domain at 800
    simulations with the fitted net, ``DeviceMCTS`` (the kernel), the host
    ``MCTSPlanner`` (batches of 128, the net on the card) and the plain
    version on the card, in turns (each after one warm plan); the kernel's
    device time per launch (profiler) and per plan (CUDA events), launches
    per plan from the counter, select depth, and the bound: the bytes of the
    tree a plan writes, with its inputs, over the card's HBM rate (a floor
    that the chain of dependent levels, not bandwidth, sets)."""
    import statistics

    from nerrf_tpu_torch.ops import mcts as ops_mcts
    from nerrf_tpu_torch.ops import plain_ops
    from nerrf_tpu_torch.planner import DeviceMCTS, MCTSConfig, MCTSPlanner
    from nerrf_tpu_torch.planner.device_mcts import run_chunks

    cfg = MCTSConfig(num_simulations=MCTS_SIMS)
    dm = DeviceMCTS(bench, cfg, value=net, device="cuda")
    host = MCTSPlanner(bench, net, MCTSConfig(num_simulations=MCTS_SIMS, batch_size=128),
                       device="cuda")

    def plain():
        with plain_ops():
            return dm.plan()

    fns = {"kernel": dm.plan, "host": host.plan, "plain": plain}
    for fn in fns.values():
        fn()
    plans = {k: [] for k in fns}
    for name in [*fns, *reversed(fns)]:
        _sync()
        plans[name].append(fns[name]())
    ops_mcts.reset_launches()
    dm.plan()
    launches = ops_mcts.LAUNCHES["mcts_search"]
    want = math.ceil(MCTS_SIMS / 128)
    if launches != want:
        _fail(f"DeviceMCTS.plan launched mcts_search {launches} times, want {want}")

    def search():
        run_chunks(dm.init_tree(), dm._ctx, dm._weights, cfg, time.perf_counter())

    search_ms = cuda_ms(search, iters=10, warmup=2)
    name = search_kernel_name(dm.route)
    split = device_split(dm.plan, iters=5, warmup=1, launches={name: launches})
    device_plan_ms = split.get(name)
    reading = search_reading(dm)
    tree = _search_tree(dm)
    n, A, D = int(tree.n_nodes[0]), dm._dims["A"], dm._dims["D"]
    node_bytes = 4 * (2 * A + D) + 4 * 4 + 2
    in_bytes = sum(t.numel() * t.element_size() for t in dm._ctx) + \
        dm._weights.flat.numel() * 4
    nbytes = n * node_bytes + in_bytes
    bound, bound_by = bound_ms(nbytes, 0.0)
    res = {}
    for name, ps in plans.items():
        res[name] = dict(
            rollouts_per_s=statistics.mean(p.rollouts_per_sec for p in ps),
            ms_per_plan=statistics.mean(p.planning_seconds for p in ps) * 1e3,
            rollouts=ps[0].rollouts)
    out = dict(cell=res, launches=launches, search_ms=search_ms,
               device_ms=None if device_plan_ms is None else device_plan_ms / launches,
               device_plan_ms=device_plan_ms, depth=round(_mean_depth(tree), 3),
               n_nodes=n, bound_ms=bound, bound_by=bound_by, bytes=nbytes, launch=reading)
    print(f"planner cell (bench 45f/4p, {MCTS_SIMS} simulations, fitted value net; "
          f"in turns, means of 2): " + json.dumps(res) + f"; DeviceMCTS.plan launches "
          f"mcts_search {launches}x ({reading['route']} entry); search {search_ms:.3f} ms "
          f"a plan (CUDA events, with the per-chunk syncs), device {device_plan_ms} ms a "
          f"plan (profiler: {split}); mean select depth {out['depth']} levels; bound "
          f"{bound:.6f} ms ({nbytes} bytes of tree and inputs over "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s); all "
          f"{MCTS_SIMS} simulations in one launch: " + json.dumps(reading))
    return out


def wave_rates(bp, incidents) -> dict:
    """``bp.plan_batch`` of the first B incidents for B in BATCH_SLOTS
    (host clock, a warm wave then 3): incidents/s, rollouts/s, ms a wave."""
    rates = {}
    for B in BATCH_SLOTS:
        bp.plan_batch(incidents[:B])
        _sync()
        t0 = time.perf_counter()
        for _ in range(3):
            bp.plan_batch(incidents[:B])
        _sync()
        dt = (time.perf_counter() - t0) / 3
        rates[B] = dict(incidents_per_s=B / dt, rollouts_per_s=B * MCTS_SIMS / dt,
                        ms_per_wave=dt * 1e3)
    return rates


def run_batched_planner(bench, net) -> dict:
    """``BatchedDeviceMCTS`` with slots (1, 2, 4, 8) warmed through
    ``warmup_for(45, 4)``: its B = 1 tree bit-equal to ``DeviceMCTS``'s and
    its plan equal; a 3-incident wave in slot 4 gives each lane its
    incident's own B = 1 tree; mixed buckets raise; 10 incidents run in
    waves of 8 + 2 (2 × 7 launches); no wave outside the warmed set.
    Reports incidents/s and rollouts/s at B = 1, 2, 4 and 8."""
    import torch

    from nerrf_tpu_torch.observability import MetricsRegistry
    from nerrf_tpu_torch.ops import mcts as ops_mcts
    from nerrf_tpu_torch.planner import DeviceMCTS, MCTSConfig
    from nerrf_tpu_torch.planner.device_mcts import run_chunks
    from nerrf_tpu_torch.respond import BatchedDeviceMCTS
    from nerrf_tpu_torch.respond.planner import _bucket_dims, _pack_batch

    cfg = MCTSConfig(num_simulations=MCTS_SIMS)
    reg = MetricsRegistry()
    bp = BatchedDeviceMCTS(cfg, batch_slots=BATCH_SLOTS, value=net, registry=reg,
                           device="cuda")
    warm_s = bp.warmup_for(45, 4)
    incidents = [bench] + [seeded_domain(45, 4, 20 + i) for i in range(9)]
    F, P, _ = _bucket_dims(bench)

    def wave_tree(ds, B):
        roots, ctx = _pack_batch(ds, F, P, B, cfg.c_puct, "cuda")
        tree = ops_mcts.init_tree(roots, cfg.num_simulations + 1, F, P, ctx.consts)
        run_chunks(tree, ctx, bp._weights, cfg, time.perf_counter())
        return tree

    def solo_tree(d):
        dm = DeviceMCTS(d, cfg, value=net, device="cuda")
        tree = dm.init_tree()
        run_chunks(tree, dm._ctx, dm._weights, cfg, time.perf_counter())
        return tree

    lane = lambda tree, i: type(tree)(*(t[i:i + 1] for t in tree))  # noqa: E731
    if _tree_diff(wave_tree([bench], 1), solo_tree(bench)):
        _fail("BatchedDeviceMCTS B = 1 tree differs from DeviceMCTS's")
    key = lambda p: ([(a.kind.name, a.target) for a in p.actions],  # noqa: E731
                     p.expected_reward, p.rollouts)
    if key(bp.plan_batch([bench])[0]) != key(DeviceMCTS(bench, cfg, value=net,
                                                           device="cuda").plan()):
        _fail("BatchedDeviceMCTS B = 1 plan differs from DeviceMCTS.plan")
    three = wave_tree(incidents[:3], 4)
    for i, d in enumerate(incidents[:3]):
        if _tree_diff(lane(three, i), solo_tree(d)):
            _fail(f"BatchedDeviceMCTS slot 4, lane {i}: not its incident's own tree")
    try:
        bp.plan_batch([bench, seeded_domain(300, 20, 5)])
        _fail("BatchedDeviceMCTS took mixed shape buckets")
    except ValueError:
        pass
    ops_mcts.reset_launches()
    plans = bp.plan_batch(incidents)
    launches = ops_mcts.LAUNCHES["mcts_search"]
    want = 2 * math.ceil(MCTS_SIMS / 128)
    if len(plans) != 10 or launches != want or \
            any(p.rollouts != MCTS_SIMS for p in plans):
        _fail(f"10 incidents: {len(plans)} plans, {launches} launches (want {want})")
    rates = wave_rates(bp, incidents)
    if bp.recompiles != 0 or reg.value("respond_recompiles_total") != 0.0:
        _fail(f"BatchedDeviceMCTS: {bp.recompiles} waves outside the warmed set")
    print(f"BatchedDeviceMCTS (slots {BATCH_SLOTS}, warmup {warm_s:.3f} s): B = 1 tree "
          f"and plan equal to DeviceMCTS's, slot-4 lanes equal their own searches, mixed "
          f"buckets refused, 10 incidents in waves of 8 + 2 ({launches} launches), 0 "
          f"waves outside the warmed set; by batch: " + json.dumps(rates))
    torch.cuda.synchronize()
    return dict(rates=rates, warm_s=warm_s, launches=launches)


def _data_loss(store, manifest, victim, encrypted, report, ransom_ext) -> tuple:
    """run_recovery_bench's KPIs: bytes still missing or modified, and
    restored files the attack never touched."""
    from pathlib import Path

    residual = store.diff(manifest, victim)
    lost = sum(manifest.files[k][1] for k, v in residual.items()
               if v in ("missing", "modified") and k in manifest.files)
    attacked = {e.name[: -len(ransom_ext)] for e in encrypted}
    fp = sum(1 for d in report.details
             if d["result"] == "restored" and Path(d["target"]).name not in attacked)
    return lost, fp


def m1_attacked(tmp) -> tuple:
    """run_recovery_bench's M1 incident (UNDO_FILES) seeded in ``tmp /
    "victim"``, snapshotted into ``tmp / "store"``, then attacked (timed):
    (victim, file config, store, manifest, trace, encrypted files, attack
    seconds).  The undo run and ``--planner``'s undo tree both start here,
    so both search the same problem."""
    from nerrf_tpu_torch.rollback import FileSimConfig, SnapshotStore, run_file_attack
    from nerrf_tpu_torch.rollback.filesim import seed_files

    victim, cfg = tmp / "victim", FileSimConfig(**UNDO_FILES)
    seed_files(victim, cfg)
    store = SnapshotStore(tmp / "store")
    manifest = store.snapshot(victim, "pre-attack")
    t0 = time.perf_counter()
    trace, encrypted = run_file_attack(victim, cfg)
    return victim, cfg, store, manifest, trace, encrypted, time.perf_counter() - t0


def m1_undo_problem(trace, manifest, victim, value) -> tuple:
    """``cmd_undo``'s search problem from the attacked incident:
    ``heuristic_detect`` (timed), ``build_undo_domain``, and
    ``value.fit_to_domain`` with 256 rollouts, horizon 32 and 200 steps:
    (detection, detect seconds, domain, fit MSE)."""
    from nerrf_tpu_torch.pipeline import build_undo_domain, heuristic_detect

    t0 = time.perf_counter()
    detection = heuristic_detect(trace)
    detect_s = time.perf_counter() - t0
    domain = build_undo_domain(detection, manifest, root=str(victim))
    return (detection, detect_s, domain,
            value.fit_to_domain(domain, num_rollouts=256, horizon=32, steps=200))


def m1_undo_domain() -> tuple:
    """The undo run's search problem outside its window: :func:`m1_attacked`
    in a temporary directory, then :func:`m1_undo_problem` with a fresh
    value net; (domain, net)."""
    import tempfile
    from pathlib import Path

    from nerrf_tpu_torch.planner.value_net import ValueNet

    tmp = Path(tempfile.mkdtemp(prefix="nerrf-undo-"))
    try:
        victim, _, _, manifest, trace, _, _ = m1_attacked(tmp)
        net = ValueNet.create(device="cuda")
        _, _, domain, _ = m1_undo_problem(trace, manifest, victim, net)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return domain, net


def planner_times() -> dict:
    """``--planner``'s timings for the package on ``sys.path``, at 800
    simulations: :func:`search_reading` (one launch of the whole search on
    a fresh tree, events and profiler, ns a simulation and a level, the
    chain floor) on the planner cell's tree (bench, the net fit as
    ``check_value_net`` fits it), the heuristic bench and floor-bucket
    trees and the undo run's (M1, its fitted net); the planner cell's plan
    (CUDA events around the 7 launches and their syncs); the undo run's
    ``plan()`` (host seconds, median of 3) and actions; the
    ``BatchedDeviceMCTS`` waves at B = 1, 2, 4 and 8."""
    import statistics

    from nerrf_tpu_torch.observability import MetricsRegistry
    from nerrf_tpu_torch.planner import DeviceMCTS, MCTSConfig
    from nerrf_tpu_torch.planner.device_mcts import run_chunks
    from nerrf_tpu_torch.planner.value_net import ValueNet
    from nerrf_tpu_torch.respond import BatchedDeviceMCTS

    cfg = MCTSConfig(num_simulations=MCTS_SIMS)
    bench = bench_domain()
    net = ValueNet.create(device="cuda")
    net.fit_to_domain(bench, num_rollouts=256, steps=150)
    m1, m1_net = m1_undo_domain()
    cases = {"planner cell": (bench, net), "heuristic bench 45f/4p": (bench, None),
             "heuristic floor bucket 200f/12p": (seeded_domain(200, 12, 11), None),
             "undo M1": (m1, m1_net)}
    out = {name: search_reading(DeviceMCTS(d, cfg, value=v, device="cuda"))
           for name, (d, v) in cases.items()}
    dm = DeviceMCTS(bench, cfg, value=net, device="cuda")
    out["planner cell"]["plan_ms"] = cuda_ms(
        lambda: run_chunks(dm.init_tree(), dm._ctx, dm._weights, cfg, time.perf_counter()),
        iters=10, warmup=2)
    undo = DeviceMCTS(m1, cfg, value=m1_net, device="cuda")
    plans = [undo.plan() for _ in range(4)][1:]
    out["undo M1"].update(plan_s=statistics.median(p.planning_seconds for p in plans),
                          plan_actions=len(plans[0].actions))
    bp = BatchedDeviceMCTS(cfg, batch_slots=BATCH_SLOTS, value=net,
                           registry=MetricsRegistry(), device="cuda")
    bp.warmup_for(45, 4)
    out["waves"] = wave_rates(bp, [bench] + [seeded_domain(45, 4, 20 + i) for i in range(9)])
    print("search timings (800 simulations; ms: CUDA events around one launch of the "
          "whole search on a fresh tree, median of 5; device_ms: profiler, the same "
          "launch; chain_floor_ms: the tree's select levels as one-warp argmaxes; "
          "plan_ms: the planner cell's 7 launches with their syncs, events; plan_s: "
          "the undo run's plan(), host clock; waves: BatchedDeviceMCTS by B): "
          + json.dumps(out))
    return out


def run_undo_path(model_dir: str) -> dict:
    """The undo run, ``run_recovery_bench``'s M1 incident (45 files of 2-5
    MB) in a temporary directory: seed, snapshot, the attack; the device
    planner warmed before the clock (``cmd_undo``'s boot step); then the
    measured window, ``cmd_undo``'s order: ``heuristic_detect``,
    ``build_undo_domain``, ``fit_to_domain`` (256 rollouts, horizon 32, 200
    steps), ``make_planner(kind="auto")`` and ``plan()`` at 800
    simulations, ``SandboxGate.rehearse`` with the trace, and
    ``RollbackExecutor.execute``.  Gates: the counters (from 0 before the
    window) show ⌈800/128⌉ ``mcts_search`` launches and nothing else; the
    gate approved, the restore verified, no byte lost, no clean file
    reverted.  Then the same incident (the attacked tree put back) is
    detected by ``model_detect`` with the experiment's checkpoint and its
    calibration, as ``cmd_undo --model-dir`` does: its launches must be
    28/2/3/2/0 a batch, the batches derived from the windows; the plan and
    the gate's verdict are reported, not gated."""
    import tempfile
    from pathlib import Path

    import torch

    from nerrf_tpu_torch.models import NerrfNet
    from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
    from nerrf_tpu_torch.ops import mcts as ops_mcts
    from nerrf_tpu_torch.pipeline import build_undo_domain, fit_capacity, model_detect
    from nerrf_tpu_torch.planner import DeviceMCTS, MCTSConfig, make_planner
    from nerrf_tpu_torch.planner.value_net import ValueNet
    from nerrf_tpu_torch.rollback import RollbackExecutor, SandboxGate
    from nerrf_tpu_torch.train.checkpoint import load_calibration, load_checkpoint
    from nerrf_tpu_torch.train.data import DatasetConfig, windows_of_trace

    tmp = Path(tempfile.mkdtemp(prefix="nerrf-undo-"))
    try:
        planner_cfg = MCTSConfig(num_simulations=MCTS_SIMS)
        t0 = time.perf_counter()
        value = ValueNet.create(device="cuda")
        DeviceMCTS.warmup_for(1, 1, cfg=planner_cfg, value=value, device="cuda")
        boot_s = time.perf_counter() - t0
        victim, cfg, store, manifest, trace, encrypted, attack_s = m1_attacked(tmp)
        total_bytes = sum(sz for _, sz, _ in manifest.files.values())
        attacked = tmp / "attacked"
        shutil.copytree(victim, attacked)

        # --- the measured window ---------------------------------------------
        _sync()
        reset_launches()
        ops_mcts.reset_launches()
        t0 = time.perf_counter()
        detection, t_detect, domain, fit_mse = m1_undo_problem(trace, manifest, victim,
                                                               value)
        planner = make_planner(domain, value, planner_cfg, kind="auto")
        plan = planner.plan()
        t_plan = time.perf_counter() - t0 - t_detect
        gate = SandboxGate(store, manifest).rehearse(plan, victim, trace=trace)
        t_gate = time.perf_counter() - t0 - t_detect - t_plan
        report = RollbackExecutor(store, manifest, victim).execute(plan)
        mttr = time.perf_counter() - t0
        launches, seg = dict(ops_mcts.LAUNCHES), dict(LAUNCHES)
        routes = dict(ops_mcts.ROUTE_LAUNCHES)
        lost, fp = _data_loss(store, manifest, victim, encrypted, report, cfg.ransom_ext)
        want = math.ceil(MCTS_SIMS / 128)
        if not isinstance(planner, DeviceMCTS) or launches["mcts_search"] != want or \
                any(seg.values()):
            _fail(f"undo run: {type(planner).__name__}, search launches {launches} "
                  f"(want {want}), other kernels {seg}")
        if not gate.approved or not report.verified or lost or fp:
            _fail(f"undo run: gate {gate.approved} ({gate.reason}), verified "
                  f"{report.verified}, {lost} bytes lost, {fp} false-positive undos")
        depth = round(_mean_depth(planner.last_tree), 3)  # the plan's own tree
        heuristic = dict(
            routes=routes, depth=depth,
            mttr_s=mttr, detect_s=t_detect, plan_s=t_plan, gate_s=t_gate,
            execute_s=report.duration_seconds, mb_per_s=report.mb_per_sec,
            files_restored=report.files_restored, total_bytes=total_bytes,
            plan_actions=len(plan.actions), rollouts=plan.rollouts,
            rollouts_per_s=plan.rollouts_per_sec, planning_s=plan.planning_seconds,
            fit_mse=fit_mse, boot_s=boot_s, attack_s=attack_s, launches=launches,
            data_loss_bytes=lost, false_positive_undos=fp, flagged=len(detection.flagged_files()))
        print(f"undo run (M1: {len(encrypted)} files, {total_bytes} bytes; heuristic_detect, "
              f"value net fit, DeviceMCTS {MCTS_SIMS} simulations, gate, execute): "
              f"MTTR {mttr:.3f} s = detect {t_detect:.3f} + plan {t_plan:.3f} (fit and "
              f"search; the search {plan.planning_seconds:.4f} s, "
              f"{plan.rollouts_per_sec:.1f} rollouts/s, mean select depth {depth} "
              f"levels, launches by entry {routes}) + gate {t_gate:.3f} + execute "
              f"{report.duration_seconds:.3f} s ({report.mb_per_sec:.1f} MB/s); "
              f"{len(plan.actions)} actions, gate approved ({gate.reason}), verified, "
              f"0 bytes lost, 0 false-positive undos; launches {launches}; boot "
              f"{boot_s:.3f} s, attack {attack_s:.3f} s (outside the window)")

        # --- the same incident through the experiment's checkpoint -----------
        shutil.rmtree(victim)
        shutil.copytree(attacked, victim)
        state, mcfg = load_checkpoint(model_dir)
        with torch.device("cuda"):
            model = NerrfNet(mcfg)
        model.load_state_dict(state, strict=True)
        model.eval()
        calib = load_calibration(model_dir)
        windows = len(windows_of_trace(trace, fit_capacity(trace, DatasetConfig())))
        batches = math.ceil(windows / 8)
        want = {k: batches * v for k, v in
                fused_forward_launches(mcfg.gnn.num_layers).items()}
        _sync()
        reset_launches()
        t0 = time.perf_counter()
        det = model_detect(trace, model, threshold=calib.get("node_threshold"),
                           device="cuda")
        _sync()
        model_detect_s = time.perf_counter() - t0
        got = dict(LAUNCHES)
        if got != want:
            _fail(f"model-driven undo: detection launches {got} != {want} ({windows} "
                  f"windows, {batches} batches)")
        domain2 = build_undo_domain(det, manifest, root=str(victim))
        value.fit_to_domain(domain2, num_rollouts=256, horizon=32, steps=200)
        plan2 = make_planner(domain2, value, planner_cfg, kind="auto").plan()
        listing = lambda: sorted((p.name, p.stat().st_size) for p in victim.iterdir())  # noqa: E731
        before = listing()
        gate2 = SandboxGate(store, manifest).rehearse(plan2, victim, trace=trace)
        untouched = listing() == before
        model_run = dict(flagged=len(det.flagged_files()), files=len(det.file_scores),
                         plan_actions=len(plan2.actions), approved=gate2.approved,
                         reason=gate2.reason, victim_untouched=untouched,
                         windows=windows, batches=batches, launches=got,
                         detect_s=model_detect_s, threshold=calib.get("node_threshold"))
        print(f"model-driven undo (the experiment's checkpoint, calibration "
              f"{calib or 'none'}): {windows} windows in {batches} batches, launches "
              f"{got}; {model_run['flagged']} of {model_run['files']} files flagged in "
              f"{model_detect_s:.3f} s; plan {len(plan2.actions)} actions; gate "
              f"approved={gate2.approved} ({gate2.reason}); victim untouched by the "
              f"gate: {untouched}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(heuristic=heuristic, model=model_run, trace=trace)


# --- the respond chain: staged families, the wire, serve → router --------------

# the reference bench's corpus (benchmarks/run_respond_bench.py part_corpus,
# full run): 96 simulations a plan, 6 files a staged incident, family seed
# 11, the no-context incident at seed 23; its record's plans restore 6 files
# in 7 actions (benchmarks/results/respond_bench_cpu.json)
RESPOND_SIMS = 96
RESPOND_FILES = 6
RESPOND_REF = {"plan_actions": 7, "files_restored": 6}
NO_CONTEXT = "no snapshot context bound for this stream — cannot replay"


def _router_waves(journal, top: int, skip: int = 0, since_seq=None) -> list:
    """[(incidents, plan_seconds)] of each batch a router planned, from its
    ``plan_emitted`` records after the first ``skip`` (or after the journal's
    sequence number ``since_seq``; one a planned incident, a batch's records
    in a row: one worker plans), and the waves each took (ceil(n / top))."""
    recs = journal.tail(kinds=("plan_emitted",), since_seq=since_seq)[skip:]
    out, i = [], 0
    while i < len(recs):
        n = recs[i].data["batch"]
        out.append((n, recs[i].data["plan_seconds"], math.ceil(n / top)))
        i += n
    return out


def _search_launches(waves: list) -> int:
    """``mcts_search`` launches of the router's waves: ⌈sims/128⌉ chunks a
    wave (one launch covers every tree of the wave)."""
    return sum(w for _, _, w in waves) * math.ceil(RESPOND_SIMS / 128)


def run_respond_chain(model_dir: str, m1) -> dict:
    """The online response chain on the card, three legs, each with the
    counters set to 0 just before it and read just after:

    1. the reference bench's staged families (``stage_incident`` at seed 11,
       ``heuristic_detect``) and one incident without a snapshot context
       (seed 23) submitted to a started ``ResponseRouter``: every family one
       verified plan, the no-context incident rejected with its journaled
       reason, ``drain()`` true, no recompile after ``start()``, and the
       ``mcts_search`` launches derived from the router's waves;
    2. the M1 incident trace (``run_undo_path``'s) served by the port's
       ``TraceReplayServer`` on 127.0.0.1:0, drained by its ``TrackerClient``
       (the native decoder) into a ``TraceStore`` (the native engine) and
       queried back: ``model_detect`` with the experiment's checkpoint on the
       queried trace bit-equal to the original's, 28/2/3/2/0 launches a
       batch.
       The detection cell's 120 s seed-5 trace (15 windows) takes the same
       way, under the same gates: M1's times are one request's, s5's the
       rates;
    3. ``OnlineDetectionService`` with that checkpoint, ``attach_respond`` to
       a second router, ``connect``ed to each server in turn (M1, then s5),
       each run read alone: the result bit-equal to ``model_detect``,
       28/2/3/2/0 launches in every batch, the router's admitted and
       below-``severity_min`` incidents adding up to the sink's alerts, a
       plan result for every admitted incident (rejected with a reason: an
       alert's targets are ``ino:`` pseudo-paths and no snapshot context is
       bound), ``mcts_search`` launches derived from that run's waves, no
       serve or router recompile after warmup.  A third ``connect``, of s5,
       is profiled for the busy share."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from nerrf_tpu_torch.data import Trace
    from nerrf_tpu_torch.flight.journal import EventJournal
    from nerrf_tpu_torch.graph import TraceStore, store_native_available
    from nerrf_tpu_torch.ingest.bridge import native_available
    from nerrf_tpu_torch.ingest.service import TraceReplayServer, TrackerClient
    from nerrf_tpu_torch.models import NerrfNet
    from nerrf_tpu_torch.observability import MetricsRegistry
    from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
    from nerrf_tpu_torch.ops import mcts as ops_mcts
    from nerrf_tpu_torch.pipeline import fit_capacity, heuristic_detect, model_detect
    from nerrf_tpu_torch.respond import (FAMILIES, RespondConfig, ResponseRouter,
                                         stage_incident)
    from nerrf_tpu_torch.serve import ServeConfig, bucket_tag
    from nerrf_tpu_torch.train.checkpoint import load_calibration, load_checkpoint
    from nerrf_tpu_torch.train.data import DatasetConfig, windows_of_trace

    phase_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="nerrf-respond-"))
    srvs = []
    try:
        # --- 1. the staged families through a live router ---------------------
        reg, jr = MetricsRegistry(), EventJournal(registry=MetricsRegistry())
        cfg = RespondConfig(num_simulations=RESPOND_SIMS)
        router = ResponseRouter(cfg, registry=reg, journal=jr, device="cuda")
        router.start()
        # staged and detected first, then submitted back to back: the
        # incidents/s below are the router's (planning and verification)
        families, incidents = {}, []
        for fam in FAMILIES:
            t0 = time.perf_counter()
            staged = stage_incident(tmp, fam, seed=11, files=RESPOND_FILES)
            det = heuristic_detect(staged.trace)
            incidents.append((fam, det, staged.verify_context()))
            families[fam] = {"flagged_files": len(det.flagged_files()),
                             "stage_s": time.perf_counter() - t0}
        lost = stage_incident(tmp, FAMILIES[0], seed=23, files=RESPOND_FILES)
        incidents.append(("no-context", heuristic_detect(lost.trace), None))
        try:
            _sync()
            reset_launches()
            ops_mcts.reset_launches()
            t0 = time.perf_counter()
            for stream, det, ctx in incidents:
                router.submit_detection(stream, det, context=ctx)
            drained = router.drain(timeout=300.0)
            corpus_s = time.perf_counter() - t0
        finally:
            router.stop(timeout=60.0)
        launches, seg = dict(ops_mcts.LAUNCHES), dict(LAUNCHES)
        results, stats = router.results(), router.stats()
        waves = _router_waves(jr, cfg.batch_slots[-1])
        want = _search_launches(waves)
        if not drained or router._thread is not None:
            _fail(f"respond corpus: drained {drained}, worker joined "
                  f"{router._thread is None}")
        if stats["recompiles"] or launches["mcts_search"] != want or any(seg.values()):
            _fail(f"respond corpus: recompiles {stats['recompiles']}, search "
                  f"launches {launches} (want {want} over waves {waves}), other "
                  f"kernels {seg}")
        plan_s = {r.stream: r.data["plan_seconds"]
                  for r in jr.tail(kinds=("plan_emitted",))}
        for fam in FAMILIES:
            vps = [vp for vp in results if vp.incident.stream == fam]
            if len(vps) != 1 or not vps[0].verified:
                _fail(f"respond corpus: {fam}: "
                      f"{[(vp.verified, vp.reason) for vp in vps]}")
            families[fam].update(plan_s=plan_s[fam],
                                 plan_actions=len(vps[0].plan.actions),
                                 files_restored=vps[0].gate.rehearsal.files_restored)
        rejected = [vp for vp in results if vp.incident.stream == "no-context"]
        journaled = [r.data["reason"] for r in jr.tail(kinds=("plan_rejected",))]
        if [(vp.verified, vp.reason) for vp in rejected] != [(False, NO_CONTEXT)] \
                or journaled != [NO_CONTEXT]:
            _fail(f"respond corpus: the no-context incident gave "
                  f"{[(vp.verified, vp.reason) for vp in rejected]}, journaled "
                  f"{journaled}")
        plan_p50 = float(np.percentile([s for _, s, _ in waves], 50))
        corpus = dict(families=families, stats=stats, waves=waves,
                      launches=launches["mcts_search"],
                      incidents_per_s=len(results) / corpus_s,
                      plan_p50_s=plan_p50, warmup_s=router.warmup_seconds)
        print(f"respond corpus (the reference bench's: {RESPOND_SIMS} simulations, "
              f"{RESPOND_FILES} files, seed 11; one ResponseRouter on the card): "
              f"{len(results)} incidents in {stats['batches']} batches, waves "
              f"{[n for n, _, _ in waves]}, {len(results) / corpus_s:.3f} incidents/s "
              f"from the first submit to drained ({corpus_s:.4f} s); "
              f"respond_plan_seconds p50 "
              f"{plan_p50:.4f} s; mcts_search launches {launches['mcts_search']} "
              f"(derived {want}); 0 recompiles after a {router.warmup_seconds:.3f} s "
              f"warmup; per family (plan actions and files restored; the "
              f"reference's record {RESPOND_REF['plan_actions']} and "
              f"{RESPOND_REF['files_restored']}): " + json.dumps(
                  {f: {k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in d.items()} for f, d in families.items()})
              + f"; no-context rejected: {NO_CONTEXT!r}")

        # --- 2. the wire into the store -----------------------------------------
        state, mcfg = load_checkpoint(model_dir)
        with torch.device("cuda"):
            model = NerrfNet(mcfg)
        model.load_state_dict(state, strict=True)
        model.eval()
        threshold = load_calibration(model_dir).get("node_threshold")
        per_batch = fused_forward_launches(mcfg.gnn.num_layers)
        # the native host libraries are built (make, from native/) before
        # the clock
        t0 = time.perf_counter()
        native = (native_available(), store_native_available())
        native_build_s = time.perf_counter() - t0
        # two traces over the wire: M1 (one window: a single request's
        # latency) and the detection cell's 120 s seed-5 trace (15 windows:
        # the rates)
        streams = {"m1": m1, "s5": detect_trace()[0]}
        targets = {}
        for sid, tr in streams.items():
            srvs.append(TraceReplayServer(tr.events, tr.strings, address="127.0.0.1:0"))
            targets[sid] = f"127.0.0.1:{srvs[-1].start()}"
        fields = ("file_scores", "file_window_scores", "proc_scores", "file_bytes",
                  "threshold")
        wire = dict(native_build_s=native_build_s)
        for sid, tr in streams.items():
            client = TrackerClient(targets[sid])
            t0 = time.perf_counter()
            with TraceStore(tmp / f"wire_store_{sid}") as store:
                for block, strings in client.iter_blocks(timeout=120.0):
                    store.append(block, strings)
                store.flush()
                events, strings = store.query(0, 2 ** 63 - 1)
                engines = tuple("native" if x.is_native else "python"
                                for x in (client.bridge, store))
            wire_s = time.perf_counter() - t0
            n_wire = int(events.num_valid)
            if engines != ("native", "native") or n_wire != tr.events.num_valid:
                _fail(f"respond wire {sid}: engines {engines}, {n_wire} of "
                      f"{tr.events.num_valid} events back from the store")
            wired = Trace(events=events, strings=strings, ground_truth=None,
                          labels=None, name=f"{sid}-wire")
            windows = len(windows_of_trace(tr, fit_capacity(tr, DatasetConfig())))
            batches = math.ceil(windows / 8)
            dets = {}
            for name, t in (("original", tr), ("wire", wired)):
                _sync()
                reset_launches()
                dets[name] = model_detect(t, model, threshold=threshold, device="cuda")
                _sync()
                got = dict(LAUNCHES)
                if got != {k: batches * v for k, v in per_batch.items()}:
                    _fail(f"respond wire {sid}: model_detect on the {name} trace "
                          f"launched {got}, want {batches} x {per_batch}")
            differ = [f for f in fields
                      if getattr(dets["wire"], f) != getattr(dets["original"], f)]
            if differ:
                _fail(f"respond wire {sid}: model_detect on the queried trace "
                      f"differs in {differ}")
            wire[sid] = dict(events=n_wire, seconds=wire_s, events_per_s=n_wire / wire_s,
                             windows=windows,
                             flagged=len(dets["wire"].flagged_files()))
            print(f"respond wire {sid} (TraceReplayServer → TrackerClient, "
                  f"{engines[0]} decoder → TraceStore, {engines[1]} engine → "
                  f"query): {n_wire} events ({windows} windows) in {wire_s:.4f} s "
                  f"({n_wire / wire_s:.1f} events/s); model_detect on the queried "
                  f"trace bit-equal to the original's ({', '.join(fields)}), "
                  f"{wire[sid]['flagged']} files flagged at threshold {threshold}")
        print(f"respond wire: the libraries {native} built from native/ in "
              f"{native_build_s:.3f} s before the clock")

        # --- 3. the wire into serve, into a router --------------------------------
        fits = [fit_capacity(tr, DatasetConfig()) for tr in streams.values()]
        bucket = (max(f.graph.max_nodes for f in fits),
                  max(f.graph.max_edges for f in fits),
                  max(f.max_seqs for f in fits))
        scfg = ServeConfig(buckets=(bucket,), batch_size=SERVE_BATCH, threshold=threshold)
        reg2, jr2 = MetricsRegistry(), EventJournal(registry=MetricsRegistry())
        router2 = ResponseRouter(cfg, registry=reg2, journal=jr2, device="cuda").start()
        svc = _counting_service()(model, scfg, registry=reg2, journal=jr2, device="cuda")
        svc.attach_respond(router2)

        def incidents(outcome):
            return reg2.value("respond_incidents_total", labels={"outcome": outcome})

        def connect_leg(sid):
            """One stream connected to its server, the counters set to 0
            just before and every count read just after the router drained."""
            plans0 = len(jr2.tail(kinds=("plan_emitted",)))
            results0, batches0 = len(router2.results()), len(svc.batch_launches)
            admitted0, below0 = incidents("admitted"), incidents("below_min")
            scored0 = _counter_total(reg2, "serve_windows_scored_total")
            _sync()
            reset_launches()
            ops_mcts.reset_launches()
            t0 = time.perf_counter()
            run = svc.connect(sid, targets[sid], timeout=120.0)
            if not run.done.wait(300.0) or run.error is not None:
                _fail(f"respond serve {sid}: connect ended with {run.error!r}")
            serve_s = time.perf_counter() - t0
            if not router2.drain(timeout=300.0):
                _fail(f"respond serve {sid}: the router did not drain")
            chain_s = time.perf_counter() - t0
            _sync()
            launches = dict(LAUNCHES)
            search = ops_mcts.LAUNCHES["mcts_search"]
            waves = _router_waves(jr2, cfg.batch_slots[-1], skip=plans0)
            alerts = svc.sink.drain()
            admitted = incidents("admitted") - admitted0
            below = incidents("below_min") - below0
            results = router2.results()[results0:]
            n_batches = len(svc.batch_launches) - batches0
            windows = int(_counter_total(reg2, "serve_windows_scored_total") - scored0)
            want_admitted = sum(a.severity >= cfg.severity_min for a in alerts)
            if launches != {k: n_batches * v for k, v in per_batch.items()}:
                _fail(f"respond serve {sid}: launched {launches} in {n_batches} "
                      f"batches, want {per_batch} each")
            if admitted + below != len(alerts) or admitted != want_admitted \
                    or len(results) != admitted:
                _fail(f"respond serve {sid}: {len(alerts)} alerts, {want_admitted} at "
                      f"severity >= {cfg.severity_min}; the router admitted "
                      f"{admitted}, {below} below the gate, {len(results)} plan "
                      "results")
            if any(vp.verified or not vp.reason for vp in results) \
                    or search != _search_launches(waves):
                _fail(f"respond serve {sid}: results "
                      f"{[(vp.verified, vp.reason) for vp in results]}, search "
                      f"launches {search} over waves {waves}")
            # alert → plan result: the window scored (the alert leaves the
            # demux right after), the incident queued, the verdict journaled
            queued_t = {r.trace_id: r.t_perf
                        for r in jr2.tail(kinds=("incident_enqueued",))}
            verdict_t = {r.trace_id: r.t_perf
                         for r in jr2.tail(kinds=("plan_rejected", "plan_verified"))}
            answered = [a for a in alerts if a.trace_id in verdict_t]
            lat = [verdict_t[a.trace_id] - a.t_scored for a in answered]
            to_queue = [queued_t[a.trace_id] - a.t_scored for a in answered]
            p50 = lambda xs: float(np.percentile(xs, 50)) * 1e3 if xs else None  # noqa: E731
            events = int(streams[sid].events.num_valid)
            return dict(run=run, windows=windows, batches=n_batches, events=events,
                        alerts=len(alerts), admitted=int(admitted), below=int(below),
                        rejected=len(results), reasons=sorted({vp.reason for vp in results}),
                        serve_s=serve_s, chain_s=chain_s,
                        windows_per_s=windows / serve_s, events_per_s=events / serve_s,
                        alert_to_plan_p50_ms=p50(lat), alert_to_queue_p50_ms=p50(to_queue),
                        answered=len(lat),
                        launches={**launches, "mcts_search": search}, waves=waves)

        legs = {}
        try:
            svc.start()
            if svc.batch_launches != [per_batch]:
                _fail(f"respond serve: warmup launches {svc.batch_launches}")
            for sid in streams:
                legs[sid] = connect_leg(sid)
            # the busy share: s5 again, profiled, over its unprofiled wall time
            busy = device_busy_share(
                "the serve leg (connect, s5)",
                lambda: svc.connect("s5-profiled", targets["s5"],
                                    timeout=120.0).done.wait(300.0),
                legs["s5"]["serve_s"])
            if not router2.drain(timeout=300.0):
                _fail("respond serve: the router did not drain the profiled run")
        finally:
            svc.stop()
            router2.stop(timeout=60.0)
        _serve_gates(reg2, svc, 1, per_batch, "respond serve")
        stats2 = router2.stats()
        if stats2["recompiles"]:
            _fail(f"respond serve: {stats2['recompiles']} router recompiles")
        if not legs["m1"]["alerts"]:
            _fail(f"respond serve: the experiment's checkpoint raised no alert on M1 "
                  f"at its threshold ({threshold}, 0.5 when None)")
        for sid, leg in legs.items():
            want = model_detect(streams[sid], model, ds_cfg=scfg.dataset_config(bucket),
                                auto_capacity=False, batch_size=SERVE_BATCH,
                                threshold=threshold, device="cuda")
            run = leg.pop("run")
            differ = [f for f in fields if getattr(run.result, f) != getattr(want, f)]
            if differ or run.result.detector != "serve[max]":
                _fail(f"respond serve {sid}: {differ or run.result.detector} differ "
                      "from model_detect")
            kind = ("a single request: its latencies, not rates" if sid == "m1"
                    else "the rates")
            print(f"respond serve {sid} ({kind}; OnlineDetectionService "
                  f"{bucket_tag(bucket)} with the experiment's checkpoint, connect "
                  f"to the replay server, attach_respond): {leg['events']} events, "
                  f"{leg['windows']} windows scored in {leg['batches']} batches "
                  f"(launches {per_batch} each) in {leg['serve_s']:.4f} s from "
                  f"connect to the stream's end ({leg['windows_per_s']:.3f} "
                  f"windows/s, {leg['events_per_s']:.1f} events/s), result "
                  f"bit-equal to model_detect; {leg['alerts']} alerts, "
                  f"{leg['admitted']} admitted at severity >= {cfg.severity_min}, "
                  f"{leg['below']} below; {leg['rejected']} plan results, all "
                  f"rejected with a reason ({leg['reasons']}); alert → plan result "
                  f"p50 {leg['alert_to_plan_p50_ms']} ms over {leg['answered']} "
                  f"(scored → queued {leg['alert_to_queue_p50_ms']} ms); mcts_search "
                  f"launches {leg['launches']['mcts_search']} over waves "
                  f"{[n for n, _, _ in leg['waves']]}")
        print(f"respond serve: 0 serve and 0 router recompiles after warmup; busy "
              f"share of the s5 leg {'not measured' if busy is None else f'{busy:.3f}'}")
        serve = dict(bucket=bucket_tag(bucket), legs=legs, busy=busy,
                     launches=legs["m1"]["launches"])
    finally:
        for srv in srvs:
            srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    total = time.perf_counter() - phase_t0
    print(f"respond-chain phase: {total:.1f} s of command time")
    return dict(corpus=corpus, wire=wire, serve=serve, seconds=total)


# --- the command line: the README's commands and every ported subcommand ------

# the README's quick start, as a user types it (the incident directory D is a
# temporary directory)
CLI_README = (("simulate", "--incident", "{D}", "--files", "20", "--seed", "5"),
              ("undo", "--incident", "{D}", "--simulations", "300"),
              ("status", "--incident", "{D}"))
# seconds the `serve` subprocess serves the seed-5 CSV: its start-up (the
# interpreter and the imports, about 10 s) and the ingest (about 1 s) run
# inside them, the README's commands beside them (40 until the smoke's own
# time was cut, ROADMAP B.C1)
CLI_SERVE_SECONDS = 10
# train-detector at the CLI's own defaults (the reference's flags: hidden 48,
# 4 GNN layers and a 1-layer LSTM, 256n/512e/128s windows) but for depth: 50
# steps and 8 traces, 2 held out (the defaults, 300 and 12, until the smoke's
# own time was cut, ROADMAP B.C1; 100 until the device-time phase needed the
# smoke's time), with --ckpt-every 50, which takes train_elastic
CLI_TRAIN_CUT = ("--steps", "50", "--traces", "8")
CLI_CKPT_EVERY = 50
CLI_SERVE_BUCKET = (4096, 4096, 4096)


def _cli_argv(*argv) -> list:
    """``python -m nerrf_tpu_torch.cli ARGV``, run from the repository root
    as a user runs it."""
    return [sys.executable, "-m", "nerrf_tpu_torch.cli", *map(str, argv)]


def _cli_run(*argv) -> tuple:
    """``cli.main(ARGV)`` in this process (so the launch counters can be
    read): (exit code, its standard output, its log)."""
    import contextlib
    import io

    from nerrf_tpu_torch import cli

    out, tee = io.StringIO(), _Tee(sys.stderr)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(tee):
        rc = cli.main([str(a) for a in argv])
    return rc, out.getvalue(), tee.text()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_port(port: int, proc, timeout: float = 120.0) -> float:
    """Seconds until ``port`` accepts a connection (``proc`` still up)."""
    import socket

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if proc.poll() is not None:
            _fail(f"cli serve exited with {proc.returncode} before listening: "
                  f"{proc.stderr.read()[-2000:]}")
        with socket.socket() as s:
            if s.connect_ex(("127.0.0.1", port)) == 0:
                return time.perf_counter() - t0
        time.sleep(0.1)
    _fail(f"cli serve did not listen on {port} within {timeout} s")


def _resolved_columns(events, strings) -> dict:
    """The valid events' columns with every string id replaced by its
    string: equal for two traces whose string tables number alike or not."""
    import numpy as np

    fields = ("ts_ns", "pid", "tid", "syscall", "flags", "ret_val", "bytes",
              "inode", "mode", "uid", "gid")
    v = np.asarray(events.valid, bool)
    out = {f: np.asarray(getattr(events, f))[v].tolist() for f in fields}
    for f in ("comm_id", "path_id", "new_path_id"):
        out[f] = [strings.lookup(int(i)) for i in np.asarray(getattr(events, f))[v]]
    return out


def _launch_counts() -> dict:
    from nerrf_tpu_torch.ops import LAUNCHES
    from nerrf_tpu_torch.ops import mcts as ops_mcts

    return {**dict(LAUNCHES), "mcts_search": ops_mcts.LAUNCHES["mcts_search"]}


def _reset_counts() -> None:
    from nerrf_tpu_torch.ops import mcts as ops_mcts
    from nerrf_tpu_torch.ops import reset_launches

    _sync()
    reset_launches()
    ops_mcts.reset_launches()


def run_cli_path(model_dir: str, undo_mttr_s: float) -> dict:
    """The command line (``python -m nerrf_tpu_torch.cli``) on the card, each
    in-process leg with the counters set to 0 just before it and read just
    after:

    1. ``serve --trace <the detection cell's seed-5 trace as CSV> --duration
       N --metrics-port -1`` as a subprocess, drained by ``ingest --target …
       --store-dir S --metrics-port 0``: every event stored, the store's
       query equal to the trace event for event, and ``model_detect`` on it
       bit-equal to ``model_detect`` on the trace;
    2. the README's three commands (simulate as a subprocess, undo at 300
       simulations and status in this process): exit codes 0, 0, 0, ``"recovered"``,
       ``report.json`` verified, no byte lost, no clean file reverted;
    3. ``undo --model-dir <the experiment's checkpoint> --trace-out`` on the
       Undo cell's M1 incident, staged as ``simulate`` stages one: its
       launches the boot warmup's one 1-simulation ``mcts_search`` plus
       ⌈800/128⌉ for the plan, and the detection's batches (derived from the
       trace's windows) × 28/2/3/2/0; the exit code, plan and gate reported,
       not gated; ``trace --file`` on its trace: exit 0 and a table holding
       ``mcts_plan``;
    4. ``train-detector`` at the CLI's defaults but for CLI_TRAIN_CUT, with
       ``--ckpt-every 100``: exit 0 (its ``edge_auc >= 0.9`` rule), the
       launches its fused steps of a 4-layer model plus the held-out,
       calibration and quality-profile forwards, the
       checkpoint reloaded bit-equal to the trained weights, the
       calibration written or reported unreachable;
    5. ``warmup --model-dir … --buckets 4096x4096x4096``: exit 0, no
       ``planner_error``, one forward and one search launch;
    6. ``serve-detect`` with the checkpoint, the seed-5 trace as JSONL and
       as CSV, ``--out``: each stream's detection bit-equal to
       ``model_detect`` on its trace, 28/2/3/2/0 launches in every forward,
       no recompile after warmup;
    7. ``respond`` at its defaults (four families, 96 simulations): exit 0,
       every family verified, the ``mcts_search`` launches the router's
       warmup (one a batch slot, and the bucket's one) plus its waves."""
    import tempfile
    from pathlib import Path

    import torch

    from nerrf_tpu_torch import cli
    from nerrf_tpu_torch import serve as serve_pkg
    from nerrf_tpu_torch.data import Trace, datasets, make_corpus
    from nerrf_tpu_torch.data.loaders import load_trace_jsonl
    from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL
    from nerrf_tpu_torch.graph import GraphConfig, TraceStore
    from nerrf_tpu_torch.observability import DEFAULT_REGISTRY
    from nerrf_tpu_torch.pipeline import calibration_traces, fit_capacity, model_detect
    from nerrf_tpu_torch.respond import RespondConfig
    from nerrf_tpu_torch.rollback import FileSimConfig, SnapshotStore, run_file_attack
    from nerrf_tpu_torch.rollback.filesim import seed_files
    from nerrf_tpu_torch.schema.events import events_to_jsonl
    from nerrf_tpu_torch.serve import ServeConfig, bucket_tag
    from nerrf_tpu_torch.train import elastic
    from nerrf_tpu_torch.train.checkpoint import load_calibration, load_checkpoint
    from nerrf_tpu_torch.train.data import DatasetConfig, build_dataset, windows_of_trace

    phase_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="nerrf-cli-"))
    dev = torch.device("cuda")
    per_forward = fused_forward_launches(load_checkpoint(model_dir)[1].gnn.num_layers)
    threshold = load_calibration(model_dir).get("node_threshold")
    total = {k: 0 for k in (*per_forward, "mcts_search")}
    out = {}

    def count(leg: dict) -> None:
        for k in total:
            total[k] += leg.get(k, 0)

    s5 = detect_trace()[0]
    (tmp / "s5.jsonl").write_text(events_to_jsonl(s5.events, s5.strings))
    datasets.write_trace_csv(s5, tmp / "s5.csv")
    serve_proc = None
    try:
        # --- 1. serve as a subprocess, ingest against it ----------------------
        port = _free_port()
        serve_proc = subprocess.Popen(
            _cli_argv("serve", "--trace", tmp / "s5.csv", "--address",
                      f"127.0.0.1:{port}", "--duration", CLI_SERVE_SECONDS,
                      "--metrics-port", -1),
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        up_s = _wait_port(port, serve_proc)
        _reset_counts()
        t0 = time.perf_counter()
        rc, text, _ = _cli_run("ingest", "--target", f"127.0.0.1:{port}",
                               "--store-dir", tmp / "store", "--metrics-port", 0)
        ingest_s = time.perf_counter() - t0
        ingested = json.loads(text)
        csv_trace = cli._load_any_trace(str(tmp / "s5.csv"))
        with TraceStore(tmp / "store") as st:
            events, strings = st.query(0, 2 ** 63 - 1)
        queried = Trace(events=events, strings=strings, ground_truth=None,
                        labels=None, name="s5-ingest")
        n = int(csv_trace.events.num_valid)
        if rc != 0 or ingested["events"] != n or ingested["engine"] != "native" or \
                _resolved_columns(events, strings) != \
                _resolved_columns(csv_trace.events, csv_trace.strings):
            _fail(f"cli ingest: exit {rc}, {ingested} of {n} events, the query "
                  f"differs from the served trace")
        if any(_launch_counts().values()):
            _fail(f"cli ingest launched {_launch_counts()}")
        out["ingest"] = dict(events=n, seconds=ingest_s, events_per_s=n / ingest_s,
                             serve_up_s=up_s, segments=ingested["segments_live"])

        # --- 2. the README's three commands: simulate as a subprocess (the
        # entry point as a user types it), undo and status in this process,
        # which saves two interpreters' start-up (B.C1) ---------------------------
        inc = tmp / "D"
        readme = []
        for argv in CLI_README:
            argv = [a.format(D=inc) for a in argv]
            t0 = time.perf_counter()
            if argv[0] != "simulate":
                _reset_counts()
                rc, text, log = _cli_run(*argv)
                got = _launch_counts()
                count(got)
                # the heuristic undo: the boot warmup's one search, then the
                # plan's chunks of 128; status launches nothing
                sims = int(argv[argv.index("--simulations") + 1]) if argv[0] == "undo" else 0
                want = {**{k: 0 for k in per_forward},
                        "mcts_search": 1 + math.ceil(sims / 128) if sims else 0}
                if got != want:
                    _fail(f"cli {argv[0]}: launches {got} != {want}")
            else:
                proc = subprocess.run(_cli_argv(*argv), cwd=ROOT, capture_output=True,
                                      text=True, timeout=600)
                rc, text, log = proc.returncode, proc.stdout, proc.stderr
            readme.append(dict(rc=rc, s=time.perf_counter() - t0, stdout=text, log=log))
        status = json.loads(readme[2]["stdout"]) if readme[2]["rc"] == 0 else {}
        report = json.loads((inc / "report.json").read_text()) \
            if (inc / "report.json").exists() else {}
        store = SnapshotStore(inc / "store")
        manifest = store.load_manifest("pre-attack")
        residual = store.diff(manifest, inc / "victim")
        lost = sum(manifest.files[k][1] for k, v in residual.items()
                   if v in ("missing", "modified") and k in manifest.files)
        ext = FileSimConfig().ransom_ext
        plan = json.loads((inc / "plan.json").read_text())
        reverted = [Path(a["target"]).name for a in plan["actions"]
                    if a["kind"] == "revert_file"]
        fp = sum(1 for name in reverted
                 if name.removesuffix(ext) not in manifest.files)
        meta = json.loads((inc / "incident.json").read_text())
        if [r["rc"] for r in readme] != [0, 0, 0] or status.get("state") != "recovered" \
                or not report.get("verified") or lost or fp or \
                meta["files_encrypted"] != len(manifest.files):
            _fail(f"cli README commands: exit codes {[r['rc'] for r in readme]}, "
                  f"state {status.get('state')}, verified {report.get('verified')}, "
                  f"{lost} bytes lost, {fp} false-positive undos; logs "
                  f"{[r['log'][-1500:] for r in readme]}")
        out["readme"] = dict(seconds=[r["s"] for r in readme],
                             mttr_s=report["mttr_seconds"],
                             files_restored=report["files_restored"],
                             plan_actions=len(plan["actions"]))
        print("cli README undo's log: " + " | ".join(
            ln.strip() for ln in readme[1]["log"].splitlines() if ln.startswith("[nerrf]")))
        serve_rc = serve_proc.wait(timeout=CLI_SERVE_SECONDS + 120)
        serve_log = serve_proc.stderr.read()
        if serve_rc != 0 or f"serving {n} events" not in serve_log:
            _fail(f"cli serve exited {serve_rc}: {serve_log[-2000:]}")

        # --- 3. undo --model-dir on the M1 incident, traced ---------------------
        m1 = tmp / "M1"
        cfg = FileSimConfig(**UNDO_FILES)
        seed_files(m1 / "victim", cfg)
        SnapshotStore(m1 / "store").snapshot(m1 / "victim", snapshot_id="pre-attack")
        trace, encrypted = run_file_attack(m1 / "victim", cfg)
        (m1 / "trace.jsonl").write_text(events_to_jsonl(trace.events, trace.strings))
        (m1 / "incident.json").write_text(json.dumps({
            "created": time.time(), "attack_family": trace.ground_truth.attack_family,
            "target": str(m1 / "victim"), "snapshot_id": "pre-attack",
            "files_encrypted": len(encrypted), "attack_seconds": 0.0}, indent=2))
        loaded = load_trace_jsonl(m1 / "trace.jsonl")
        windows = len(windows_of_trace(loaded, fit_capacity(loaded, DatasetConfig())))
        batches = math.ceil(windows / 8)
        want = {k: batches * v for k, v in per_forward.items()}
        want["mcts_search"] = 1 + math.ceil(MCTS_SIMS / 128)
        _reset_counts()
        t0 = time.perf_counter()
        rc, _, log = _cli_run("undo", "--incident", m1, "--model-dir", model_dir,
                              "--trace-out", tmp / "undo.trace.json")
        undo_s = time.perf_counter() - t0
        got = _launch_counts()
        count(got)
        if got != want:
            _fail(f"cli undo --model-dir: launches {got} != {want} ({windows} "
                  f"windows, {batches} batches; the boot warmup's 1 + the plan's "
                  f"{math.ceil(MCTS_SIMS / 128)} searches)")
        trc, table, _ = _cli_run("trace", "--file", tmp / "undo.trace.json")
        if trc != 0 or "mcts_plan" not in table:
            _fail(f"cli trace: exit {trc}, table {table!r}")
        gate = json.loads((m1 / "gate.json").read_text()) \
            if (m1 / "gate.json").exists() else {}
        m1_report = json.loads((m1 / "report.json").read_text()) \
            if (m1 / "report.json").exists() else {}
        out["undo_model"] = dict(
            rc=rc, seconds=undo_s, windows=windows, batches=batches, launches=got,
            plan_actions=len(json.loads((m1 / "plan.json").read_text())["actions"]),
            approved=gate.get("approved"), reason=gate.get("reason"),
            mttr_s=m1_report.get("mttr_seconds"), verified=m1_report.get("verified"),
            detect_line=next((ln for ln in log.splitlines() if "detect[" in ln), ""),
            stages={ln.split()[0]: float(ln.split()[2]) for ln in table.splitlines()[2:-1]})
        print("cli undo --model-dir (M1, the experiment's checkpoint): exit "
              f"{rc}; {out['undo_model']['detect_line'].strip()}; plan "
              f"{out['undo_model']['plan_actions']} actions; gate "
              f"approved={gate.get('approved')} ({gate.get('reason')}); MTTR "
              f"{m1_report.get('mttr_seconds')} s; launches {got}; `trace` table's "
              f"total ms by stage {out['undo_model']['stages']}")

        # --- 4. train-detector at the CLI's defaults ----------------------------
        td = tmp / "detector"
        flags = vars(cli.build_parser().parse_args(
            ["train-detector", "--model-dir", str(td), *CLI_TRAIN_CUT]))
        train = {k: flags[k] for k in ("traces", "seed", "hidden", "layers", "steps")}
        ds_cfg = DatasetConfig(graph=GraphConfig(max_nodes=256, max_edges=512),
                               seq_len=100, max_seqs=128)
        corpus = make_corpus(train["traces"], attack_fraction=0.5,
                             base_seed=train["seed"], duration_sec=150.0,
                             num_target_files=8, benign_rate_hz=25.0,
                             hard_scenarios=True)
        n_eval = max(2, train["traces"] // 4)
        eval_batches = math.ceil(len(build_dataset(corpus[-n_eval:], ds_cfg)) / 8)
        cal_batches = sum(math.ceil(len(windows_of_trace(
            tr, fit_capacity(tr, DatasetConfig()))) / 8) for tr in calibration_traces())
        step = step_launches("fused", train["layers"])
        fwd = fused_forward_launches(train["layers"])
        want = {k: train["steps"] * step[k] + (eval_batches + cal_batches) * fwd[k]
                for k in step}
        want["mcts_search"] = 0
        kept, real = {}, elastic.train_elastic

        def keeping(*a, **k):
            kept["result"] = real(*a, **k)
            return kept["result"]

        elastic.train_elastic = keeping
        try:
            _reset_counts()
            t0 = time.perf_counter()
            rc, _, log = _cli_run("train-detector", "--model-dir", td, *CLI_TRAIN_CUT,
                                  "--ckpt-every", CLI_CKPT_EVERY)
            train_s = time.perf_counter() - t0
        finally:
            elastic.train_elastic = real
        got = _launch_counts()
        count(got)
        res = kept["result"]
        profiled = shipped_profile_forwards(td)
        want = {k: v + profiled * fwd.get(k, 0) for k, v in want.items()}
        if rc != 0 or got != want:
            _fail(f"cli train-detector: exit {rc} (metrics {res.metrics}), launches "
                  f"{got} != {want} ({train['steps']} steps of {step}, "
                  f"{eval_batches} + {cal_batches} + {profiled} forwards of {fwd})")
        sd, tcfg = load_checkpoint(td)
        trained = res.state.model.state_dict()
        differ = [k for k in trained if not torch.equal(sd[k], trained[k].cpu())]
        if differ or set(sd) != set(trained) or tcfg != res.state.model.cfg:
            _fail(f"cli train-detector: the reloaded checkpoint differs ({differ[:4]})")
        calibration = _check_calibration(td, log, "cli train-detector")
        out["train"] = dict(rc=rc, flags=train, seconds=train_s, steps_per_s=res.steps_per_sec,
                            metrics={k: round(float(res.metrics[k]), 4) for k in HELD_OUT},
                            calibration=calibration, launches=got)
        print(f"cli train-detector ({train}, --ckpt-every {CLI_CKPT_EVERY}, every "
              f"other flag at its default): exit "
              f"{rc} in {train_s:.1f} s, "
              f"{res.steps_per_sec:.3f} steps/s after step 0; held-out "
              f"{json.dumps(out['train']['metrics'])}; {calibration}; launches {got} "
              f"({train['steps']} x {step} + {eval_batches + cal_batches + profiled} x "
              f"{fwd}); the checkpoint reloads bit-equal")

        # --- 5. warmup ------------------------------------------------------------
        tag = "x".join(map(str, CLI_SERVE_BUCKET))
        _reset_counts()
        rc, text, _ = _cli_run("warmup", "--model-dir", model_dir, "--buckets", tag)
        got = _launch_counts()
        count(got)
        warm = json.loads(text) if rc == 0 else {}
        want = {**per_forward, "mcts_search": 1}
        if rc != 0 or "planner_error" in warm or got != want or \
                list(warm.get("detector", {})) != [bucket_tag(CLI_SERVE_BUCKET)]:
            _fail(f"cli warmup: exit {rc}, {warm}, launches {got} != {want}")
        out["warmup"] = warm

        # --- 6. serve-detect, the seed-5 trace as JSONL and as CSV ---------------
        counting = _counting_service()
        services = []

        class Kept(counting):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                services.append(self)

        recompiles = lambda: DEFAULT_REGISTRY.value(  # noqa: E731
            "serve_recompiles_total", labels={"bucket": bucket_tag(CLI_SERVE_BUCKET)})
        before = recompiles()
        real_svc, serve_pkg.OnlineDetectionService = serve_pkg.OnlineDetectionService, Kept
        try:
            _reset_counts()
            t0 = time.perf_counter()
            rc, text, _ = _cli_run(
                "serve-detect", "--model-dir", model_dir, "--trace", tmp / "s5.jsonl",
                "--trace", tmp / "s5.csv", "--buckets", tag, "--out", tmp / "sd",
                "--metrics-port", -1)
            sd_s = time.perf_counter() - t0
        finally:
            serve_pkg.OnlineDetectionService = real_svc
        got = _launch_counts()
        count(got)
        summary = json.loads(text) if rc == 0 else {}
        per = services[0].batch_launches if services else []
        scfg = ServeConfig(buckets=(CLI_SERVE_BUCKET,))
        model = cli._load_model(model_dir, dev)
        dets = {}
        for name, tr in (("trace0:s5", load_trace_jsonl(tmp / "s5.jsonl")),
                         ("trace1:s5", csv_trace)):
            want_det = model_detect(tr, model, ds_cfg=scfg.dataset_config(CLI_SERVE_BUCKET),
                                    auto_capacity=False, batch_size=scfg.batch_size,
                                    threshold=threshold, device="cuda")
            f = tmp / "sd" / f"detect_{name.replace(':', '_')}.json"
            have = json.loads(f.read_text()) if f.exists() else {}
            dets[name] = want_det
            if have.get("file_scores") != want_det.file_scores or \
                    have.get("proc_scores") != {str(k): v for k, v in
                                                want_det.proc_scores.items()} or \
                    have.get("threshold") != want_det.threshold:
                _fail(f"cli serve-detect: stream {name} differs from model_detect")
        if rc != 0 or not per or any(b != {**per_forward} for b in per) or \
                recompiles() != before or summary["recompiles_after_warmup"] != before or \
                any(not e["done"] or e["error"] for e in summary["streams"].values()):
            _fail(f"cli serve-detect: exit {rc}, launches per forward {per}, "
                  f"recompiles {recompiles() - before}, streams {summary.get('streams')}")
        out["serve_detect"] = dict(seconds=sd_s, forwards=len(per), launches=got,
                                   windows=2 * len(windows_of_trace(
                                       csv_trace, scfg.dataset_config(CLI_SERVE_BUCKET))),
                                   alerts=summary["alerts"])
        # the ingest leg's store, in model_detect: bit-equal to the served trace
        again = model_detect(queried, model, ds_cfg=scfg.dataset_config(CLI_SERVE_BUCKET),
                             auto_capacity=False, batch_size=scfg.batch_size,
                             threshold=threshold, device="cuda")
        fields = ("file_scores", "file_window_scores", "proc_scores", "file_bytes",
                  "threshold")
        if any(getattr(again, f) != getattr(dets["trace1:s5"], f) for f in fields):
            _fail("cli ingest: model_detect on the store's query differs from the trace's")

        # --- 7. respond at its defaults -----------------------------------------
        seq0 = DEFAULT_JOURNAL.seq
        _reset_counts()
        t0 = time.perf_counter()
        rc, text, _ = _cli_run("respond", "--work-dir", tmp / "respond")
        respond_s = time.perf_counter() - t0
        got = _launch_counts()
        count(got)
        rep = json.loads(text) if text.strip() else {}
        rcfg = RespondConfig()
        waves = _router_waves(DEFAULT_JOURNAL, rcfg.batch_slots[-1], since_seq=seq0)
        want = {k: 0 for k in per_forward}
        want["mcts_search"] = 1 + len(rcfg.batch_slots) + _search_launches(waves)
        fams = rep.get("families", {})
        if rc != 0 or got != want or len(fams) != 4 or \
                not all(v["verified"] for v in fams.values()):
            _fail(f"cli respond: exit {rc}, launches {got} != {want} (waves {waves}), "
                  f"families {fams}")
        out["respond"] = dict(seconds=respond_s, waves=[w for w, _, _ in waves],
                              stats=rep["stats"])
    finally:
        if serve_proc is not None and serve_proc.poll() is None:
            serve_proc.kill()
            serve_proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = total
    out["seconds"] = time.perf_counter() - phase_t0
    out["undo_cell_mttr_s"] = undo_mttr_s
    print(f"cli phase ({out['seconds']:.1f} s): README commands "
          f"{[round(x, 1) for x in out['readme']['seconds']]} s (exit 0, 0, 0; "
          f"recovered, {out['readme']['files_restored']} files, MTTR "
          f"{out['readme']['mttr_s']} s); undo --model-dir MTTR "
          f"{out['undo_model']['mttr_s']} s beside the Undo cell's {undo_mttr_s:.3f} s; "
          f"train-detector {out['train']['steps_per_s']:.3f} steps/s, edge_auc "
          f"{out['train']['metrics']['edge_auc']}; "
          f"serve up in {out['ingest']['serve_up_s']:.1f} s, ingest "
          f"{out['ingest']['events_per_s']:.1f} events/s; serve-detect "
          f"{out['serve_detect']['windows']} windows over two streams in "
          f"{out['serve_detect']['forwards']} forwards, {out['serve_detect']['seconds']:.1f} "
          f"s; respond waves {out['respond']['waves']} in {out['respond']['seconds']:.1f} s; "
          f"launches {total}")
    return out


# --- the model lifecycle: quality profile, registry, shadow, archive ---------

# the guardrails' evidence floor for the phase's candidates: a verdict after
# 16 shadow windows, the last 8 each under the canary cut (the serve cell's
# four streams give 45 windows a pass)
LIFECYCLE_POLICY = dict(shadow_min_windows=16, canary_windows=8)
# the promotable candidate: the checkpoint's weights moved by seeded noise of
# this fraction of each tensor's standard deviation
LIFECYCLE_NUDGE = 1e-3
# the vetoed candidate: the node head's weights zeroed and its bias set here,
# so every real node scores sigmoid(3) ≈ 0.953
LIFECYCLE_CONST_LOGIT = 3.0
# rounds of the shadow-overhead timing (each: without, with, with, without),
# and scoring calls a turn
LIFECYCLE_TURNS = 1
LIFECYCLE_CALLS = 3


def profile_batches(traces, ds_cfg=None, batch_size: int = 8) -> tuple:
    """(windows, batches) of ``build_reference_profile`` over ``traces``,
    from the host lowering: every window that lowers, packed across traces
    into batches of ``batch_size``."""
    from nerrf_tpu_torch.data import Trace
    from nerrf_tpu_torch.train.data import DatasetConfig, windows_of_trace

    ds_cfg = ds_cfg or DatasetConfig()
    windows = sum(len(windows_of_trace(
        Trace(events=tr.events, strings=tr.strings, ground_truth=None,
              labels=None, name=tr.name), ds_cfg)) for tr in traces)
    return windows, math.ceil(windows / batch_size)


def shipped_profile_forwards(model_dir) -> int:
    """The profile build's forwards that ``calibrate_and_resave`` ran for the
    checkpoint at ``model_dir``: its batches when the calibration was written
    (the build runs at the calibrated cut), else none; a calibrated
    checkpoint must carry the profile."""
    from nerrf_tpu_torch.train.checkpoint import (
        load_calibration, load_quality_profile, profile_traces)

    if not load_calibration(model_dir):
        return 0
    windows, batches = profile_batches(profile_traces())
    shipped = load_quality_profile(model_dir)
    if shipped is None or shipped["windows"] != windows:
        _fail(f"{model_dir}: a calibrated checkpoint without its quality profile "
              f"of {windows} windows ({shipped and shipped['windows']})")
    return batches


def _lifecycle_candidates(state, seed: int = 7) -> dict:
    """The two candidates' state dicts: ``near`` (each tensor moved by
    seeded noise of LIFECYCLE_NUDGE of its standard deviation) and
    ``constant`` (the node head's logits one constant)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    near = {}
    for k, v in state.items():
        if v.is_floating_point() and v.numel() > 1:
            noise = torch.randn(v.shape, generator=gen, dtype=torch.float32)
            near[k] = (v.float() + LIFECYCLE_NUDGE * v.float().std() * noise).to(v.dtype)
        else:
            near[k] = v.clone()
    const = {k: v.clone() for k, v in state.items()}
    const["gnn.node_head.weight"].zero_()
    const["gnn.node_head.bias"].fill_(LIFECYCLE_CONST_LOGIT)
    return {"near": near, "constant": const}


def run_lifecycle_path(model_dir: str) -> dict:
    """The model lifecycle at full width on the checkpoint at ``model_dir``
    (the experiment's), each leg with the counters set to 0 just before it
    and read just after:

    a. ``build_reference_profile`` over ``checkpoint.profile_traces()`` at
       the checkpoint's operating point: its launches the batches derived
       from the host lowering × 28/2/3/2/0; the profile ships in v1's
       checkpoint (bit-equal to the one ``calibrate_and_resave`` shipped,
       where the calibration was written);
    b. v1 published into a temporary registry and promoted; the serve
       scorer booted from LIVE through ``ModelManager`` on the serve cell's
       one-bucket ladder, the archive attached, v1's profile bound;
    c. two candidates published and staged in turn over the serve cell's
       four streams: each batch with a shadow staged launches two forwards
       (56/4/6/4/0), without one a single forward; the near candidate
       promoted by the guardrails, the constant-logit one vetoed;
    d. after the promotion, and after ``models rollback`` (the CLI), every
       stream bit-equal to ``model_detect`` with the serving version;
    e. ``archive verify`` clean on the written segments, ``report``'s
       window count equal to the windows served;
    f. the CLI's ``models``, ``quality``, ``archive`` and ``report`` exit 0
       on these directories.
    The shadow's cost: ms per scoring call with and without a shadow staged,
    in turns; windows/s of the four legs, two with a shadow and two
    without."""
    import statistics
    import tempfile
    from pathlib import Path

    import torch

    from nerrf_tpu_torch import cli
    from nerrf_tpu_torch.archive import (ArchiveConfig, ArchiveWriter, build_report,
                                         verify_archive)
    from nerrf_tpu_torch.data import Trace
    from nerrf_tpu_torch.flight.journal import EventJournal
    from nerrf_tpu_torch.models import NerrfNet
    from nerrf_tpu_torch.observability import MetricsRegistry
    from nerrf_tpu_torch.pipeline import model_detect
    from nerrf_tpu_torch.quality import build_reference_profile
    from nerrf_tpu_torch.registry import ModelManager, ModelRegistry, RegistryConfig
    from nerrf_tpu_torch.serve import ServeConfig
    from nerrf_tpu_torch.train.checkpoint import (
        load_calibration, load_checkpoint, load_quality_profile, profile_traces,
        save_checkpoint)
    from nerrf_tpu_torch.train.data import windows_of_trace

    phase_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="nerrf-lifecycle-"))
    lineage, reg_dir, arc_dir = "lifecycle", tmp / "registry", tmp / "archive"
    out, decisions = {}, []
    state, mcfg = load_checkpoint(model_dir)
    calib = load_calibration(model_dir)
    thr = calib.get("node_threshold")
    per_forward = fused_forward_launches(mcfg.gnn.num_layers)
    per_shadow_batch = {k: 2 * v for k, v in per_forward.items()}
    svc = man = arc = None
    try:
        # --- a. the profile build ---------------------------------------------
        with torch.device("cuda"):
            model = NerrfNet(mcfg)
        model.load_state_dict(state, strict=True)
        model.eval()
        ptraces = profile_traces()
        windows, batches = profile_batches(ptraces)
        want = {**{k: batches * v for k, v in per_forward.items()}, "mcts_search": 0}
        _reset_counts()
        t0 = time.perf_counter()
        profile = build_reference_profile(model, ptraces, threshold=thr)
        profile_s = time.perf_counter() - t0
        got = _launch_counts()
        if got != want or profile.windows != windows:
            _fail(f"lifecycle profile: {profile.windows} windows, launches {got} != "
                  f"{want} ({windows} windows in {batches} batches of 8)")
        shipped = load_quality_profile(model_dir)
        if shipped is not None and shipped != profile.to_dict():
            _fail("lifecycle profile: the one calibrate_and_resave shipped differs "
                  "from the one built again")
        out["profile"] = dict(seconds=profile_s, windows=windows, batches=batches,
                              launches=got, node_scores=profile.node_scores,
                              margin_mass=profile.margin_mass,
                              alert_rate=profile.alert_rate)
        del model
        for name, sd in (("v1", state), *_lifecycle_candidates(state).items()):
            save_checkpoint(tmp / name, sd, mcfg, calibration=calib or None,
                            quality_profile=profile.to_dict() if name == "v1" else None)

        # --- b. the registry boot ---------------------------------------------
        store = ModelRegistry(reg_dir)
        rc, text, err = _cli_run("models", "publish", "--registry", reg_dir,
                                 "--lineage", lineage, "--model-dir", tmp / "v1",
                                 "--promote")
        if rc != 0 or store.live_version(lineage) != 1:
            _fail(f"lifecycle: models publish --promote exit {rc}: {err[-500:]}")
        reg = MetricsRegistry()
        journal = EventJournal(registry=reg)
        man = ModelManager(store, lineage, registry=reg, journal=journal,
                           cfg=RegistryConfig(**LIFECYCLE_POLICY), log=print)
        sd1, cfg1, cal1, version = man.boot()
        with torch.device("cuda"):
            live = NerrfNet(cfg1)
        live.load_state_dict(sd1, strict=True)
        traces = serve_traces()
        bucket = serve_cell_bucket(traces)
        scfg = ServeConfig(buckets=(bucket,), batch_size=SERVE_BATCH,
                           threshold=cal1.get("node_threshold"))
        ds = scfg.dataset_config(bucket)
        served = sum(len(windows_of_trace(tr, ds)) for tr in traces.values())
        svc = _counting_service(per="batch")(live.eval(), scfg, registry=reg,
                                             journal=journal, device="cuda")
        arc = ArchiveWriter(ArchiveConfig(out_dir=str(arc_dir)), registry=reg,
                            journal=journal)
        svc.attach_archive(arc)
        svc.start()
        man.attach(svc)
        if svc.batch_launches != [per_forward] or svc.live_version != 1:
            _fail(f"lifecycle boot: v{svc.live_version}, warmup launches "
                  f"{svc.batch_launches} != [{per_forward}]")

        def leg(tag: str, launches: dict) -> tuple:
            n0 = len(svc.batch_launches)
            _reset_counts()
            dets, wall = replay(svc, traces, suffix=f"-{tag}")
            per = svc.batch_launches[n0:]
            if not per or any(b != launches for b in per):
                _fail(f"lifecycle leg {tag}: launches per batch {per} != {launches}")
            return dets, dict(windows_per_s=served / wall, batches=len(per),
                              launches=_launch_counts(), seconds=wall)

        def offline(dets, tag, sd, detector):
            with torch.device("cuda"):
                m = NerrfNet(mcfg)
            m.load_state_dict(sd, strict=True)
            m.eval()
            fields = ("file_scores", "file_window_scores", "proc_scores",
                      "file_bytes", "threshold")
            for sid, tr in traces.items():
                want_det = model_detect(
                    Trace(events=tr.events, strings=tr.strings, ground_truth=None,
                          labels=None, name=f"{sid}-{tag}"),
                    m, ds_cfg=ds, auto_capacity=False, batch_size=SERVE_BATCH,
                    threshold=svc.cfg.threshold, device="cuda")
                det = dets[f"{sid}-{tag}"]
                differ = [f for f in fields if getattr(det, f) != getattr(want_det, f)]
                if differ or det.detector != detector:
                    _fail(f"lifecycle {tag} {sid}: {differ or det.detector} differ "
                          f"from model_detect ({detector})")

        def step(expect: str) -> dict:
            r = man.poll()
            decisions.append({k: r.get(k) for k in ("action", "live", "shadow",
                                                    "verdict", "reason") if k in r})
            if r["action"] != expect:
                _fail(f"lifecycle: poll {r} (want {expect})")
            return r

        # --- c, d. a promotion, a veto and a rollback -------------------------
        store.publish(lineage, tmp / "near", source="lifecycle: nudged")      # v2
        step("shadow_start")
        if svc.ready()[2] != {"model_version": "v1", "lineage": lineage,
                              "shadow_version": "v2"}:
            _fail(f"lifecycle: readiness {svc.ready()} with v2 staged")
        _, out["shadow_near"] = leg("near", per_shadow_batch)
        if svc.quality_snapshot() is None:
            _fail("lifecycle: no quality snapshot with v1's profile bound")
        step("auto_promote")
        if svc.live_version != 2:
            _fail(f"lifecycle: live v{svc.live_version} after the promotion")
        dets, out["live_v2"] = leg("v2", per_forward)
        offline(dets, "v2", store.load(lineage, 2)[0], "serve[max]@v2")
        store.publish(lineage, tmp / "constant", source="lifecycle: constant")  # v3
        step("shadow_start")
        _, out["shadow_constant"] = leg("constant", per_shadow_batch)
        step("veto")
        rc, text, err = _cli_run("models", "rollback", "--registry", reg_dir,
                                 "--lineage", lineage)
        if rc != 0 or json.loads(text)["live"]["version"] != 1:
            _fail(f"lifecycle: models rollback exit {rc}: {text} {err[-500:]}")
        step("swap")
        dets, out["live_v1"] = leg("v1", per_forward)
        offline(dets, "v1", state, "serve[max]@v1")

        # the shadow's cost on one full batch, in turns
        batch = next(iter(_full_batches(traces, ds)))
        near_sd = store.load(lineage, 2)[0]
        turns = {"without": [], "with": []}
        for _ in range(LIFECYCLE_TURNS):
            for staged in ("without", "with", "with", "without"):
                if staged == "with":
                    svc.start_shadow(near_sd, 99)   # a version the manager ignores
                t0 = time.perf_counter()
                for _ in range(LIFECYCLE_CALLS):
                    svc._score_fn(batch)
                turns[staged].append((time.perf_counter() - t0) / LIFECYCLE_CALLS * 1e3)
                svc.stop_shadow()
        out["score_ms"] = {k: [round(v, 3) for v in vs] for k, vs in turns.items()}
        svc.stop()
        man.close()
        arc.close()
        svc = man = arc = None

        # --- e. the archive -----------------------------------------------------
        scored = reg.value("serve_windows_scored_total")
        if scored != 4 * served:
            _fail(f"lifecycle: {scored} windows scored, want 4 legs × {served}")
        check = verify_archive(arc_dir)
        report = build_report([str(arc_dir)])
        if not check["ok"] or report["slo"]["windows_scored"] != scored:
            _fail(f"lifecycle archive: verify ok={check['ok']}, report counts "
                  f"{report['slo']['windows_scored']} windows of {scored}")
        out["archive"] = dict(bytes=check["bytes"], records=check["records"],
                              segments=len(check["segments"]))

        # --- f. the command line over these directories -------------------------
        for argv in (("models", "list", "--registry", reg_dir),
                     ("models", "status", "--registry", reg_dir, "--lineage", lineage),
                     ("quality", "show", tmp / "v1"),
                     ("quality", "compare", tmp / "v1", reg_dir / "lineages" / lineage / "v1"),
                     ("archive", "ls", arc_dir), ("archive", "verify", arc_dir),
                     ("report", arc_dir)):
            rc, _, err = _cli_run(*argv)
            if rc != 0:
                _fail(f"lifecycle: {' '.join(map(str, argv[:2]))} exit {rc}: {err[-500:]}")
        out["decisions"] = decisions
    finally:
        for closer in (svc and svc.stop, man and man.close, arc and arc.close):
            if closer:
                closer()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - phase_t0
    ms = {k: statistics.median(v) for k, v in out["score_ms"].items()}
    p = out["profile"]
    print(f"lifecycle ({out['seconds']:.1f} s): profile {p['seconds']:.3f} s "
          f"({p['windows']} windows in {p['batches']} batches, launches "
          f"{p['launches']}); shadow overhead: {ms['with']:.3f} ms a batch with a "
          f"shadow staged vs {ms['without']:.3f} without (medians of "
          f"{json.dumps(out['score_ms'])}, in turns); windows/s with a shadow "
          f"{out['shadow_near']['windows_per_s']:.3f} and "
          f"{out['shadow_constant']['windows_per_s']:.3f}, without "
          f"{out['live_v2']['windows_per_s']:.3f} and "
          f"{out['live_v1']['windows_per_s']:.3f} (legs in turns: near shadow, v2, "
          f"constant shadow, v1); decisions {json.dumps(decisions)}; archive "
          f"{out['archive']['bytes']} bytes in {out['archive']['records']} records, "
          f"{out['archive']['segments']} segments; serve bit-equal to model_detect "
          f"after the promotion and after the rollback; {served} windows a leg")
    out["launches"] = {"profile": p["launches"], "shadow_batch": per_shadow_batch,
                       "batch": per_forward}
    return out


def _full_batches(traces, ds):
    """Padded batches of SERVE_BATCH windows of ``traces`` lowered at ``ds``."""
    from nerrf_tpu_torch.pipeline import pad_batch
    from nerrf_tpu_torch.train.data import windows_of_trace

    samples = [s for tr in traces.values() for s in windows_of_trace(tr, ds)]
    for i in range(0, len(samples) - SERVE_BATCH + 1, SERVE_BATCH):
        yield pad_batch(samples[i:i + SERVE_BATCH], SERVE_BATCH)


# --- the continuous-learning loop: drift → retrain → publish → promotion ----

# benchmarks/run_learn_bench.py's settings (:52-60, :194-258): the traffic's
# shift, the recovery tolerance, the guardrails opened wide (the loop's
# plumbing is under test, not the guardrails' thresholds), the quality
# monitor's cadence, and the retrain's shape
LEARN_DRIFT = 0.8
LEARN_AUC_TOL = 0.10
LEARN_STREAMS = 3
LEARN_SIM_SECONDS = 120.0
LEARN_POLICY = dict(shadow_min_windows=8, canary_windows=4,
                    max_disagreement_rate=1.0, max_score_drift=10.0,
                    canary_max_disagreement=1.0)
# the retrain's depth: the reference bench's 60 steps cut to 30 to keep the
# phase near 150 s (the retrain at the serve rung runs about 0.42 steps/s;
# at 20, v2's shifted edge AUC read 0.4571 on the H100, under the gate)
LEARN_STEPS = 30
# the reference bench's batch: RetrainConfig's default of 8 ran the card out
# of its 80 GB at the serve rung (4096 sequences a window) beside the scorer
LEARN_BATCH = 4
LEARN_PROMOTE_LEGS = 3
LEARN_DIVERGE = dict(num_steps=20, save_every=2, learning_rate=1e12, seed=3,
                     batch_size=4, replay_limit=8, synth_traces=2,
                     synth_seed=7700, synth_duration_sec=60.0,
                     synth_num_target_files=4, synth_benign_rate_hz=6.0)


def _console(*args) -> None:
    """Print to the process's own standard output: the supervisor and the
    model manager log from their threads, while ``_cli_run`` may have
    redirected ``sys.stdout`` to capture a command's output."""
    print(*args, file=sys.__stdout__, flush=True)


def learn_sim(seed: int, drift: float, attack: bool):
    """The reference bench's traffic (``sim``, run_learn_bench.py:130-134)."""
    from nerrf_tpu_torch.data import SimConfig

    return SimConfig(duration_sec=LEARN_SIM_SECONDS, attack=attack,
                     attack_start_sec=LEARN_SIM_SECONDS / 3, num_target_files=4,
                     benign_rate_hz=6.0, seed=seed, drift=drift)


def serve_cell_bucket(traces: dict) -> tuple:
    """The serve cell's one-bucket ladder: the rung ``fit_capacity`` gives
    over ``traces`` (the serve cell's four streams)."""
    from nerrf_tpu_torch.pipeline import fit_capacity
    from nerrf_tpu_torch.train.data import DatasetConfig

    fits = [fit_capacity(tr, DatasetConfig()) for tr in traces.values()]
    return (max(f.graph.max_nodes for f in fits), max(f.graph.max_edges for f in fits),
            max(f.max_seqs for f in fits))


def _pcts(lat: list) -> tuple:
    """(p50, p99) of ``lat`` seconds, in ms (nearest rank)."""
    s = sorted(lat)
    return (1e3 * s[len(s) // 2], 1e3 * s[min(int(0.99 * len(s)), len(s) - 1)]) \
        if s else (None, None)


def run_learn_path(model_dir: str) -> dict:
    """The continuous-learning loop at full width (benchmarks/
    run_learn_bench.py's flow with the port's modules), v1 being the
    checkpoint at ``model_dir``:

    a. v1's edge AUC on held-out unshifted and shifted sets; its quality
       profile over four unshifted traces (their batches × 28/2/3/2/0),
       shipped with v1 into a fresh registry, promoted; the scorer booted
       from LIVE through ``ModelManager`` on the serve cell's ladder, with
       the quality monitor, a ``ReplayWriter`` (``attach_learn``), a
       ``FlightRecorder`` (``attach_flight``) and a ``RetrainSupervisor``
       whose retrain runs on its own CUDA stream;
    b. leg A (three unshifted streams over the wire, ``connect``); oracle
       tp dispositions on its alerted replay windows (one through ``alerts
       label``); leg B at ``drift=0.8``: the drift bundle fires during it
       and the supervisor retrains once (replay + shifted synth, 30 steps)
       while serve goes on; the leg and the retrain gated together on the
       sum of their launches; ``archive export --replay`` joins the labels;
    c. v2 published with its provenance, staged by ``poll()``, promoted by
       the guardrails after shifted legs with a shadow (56/4/6/4/0 a
       batch); a parity stream bit-equal to ``model_detect`` under v2;
       v2's shifted edge AUC within LEARN_AUC_TOL of v1's unshifted;
    d. ``doctor`` on the drift bundle and on a bundle dumped after the
       promotion (its learn section names the retrain);
    e. a second supervisor at a learning rate of 1e12 aborts under the
       health monitor and publishes nothing.
    Each leg's launches are read with the counters set to 0 before it."""
    import math
    import tempfile
    import threading
    from pathlib import Path

    import torch

    from nerrf_tpu_torch.data import Trace, simulate_trace
    from nerrf_tpu_torch.flight import EventJournal, FlightConfig, FlightRecorder
    from nerrf_tpu_torch.ingest.service import TraceReplayServer, TrackerClient
    from nerrf_tpu_torch.learn import (ReplayConfig, ReplayWriter, RetrainConfig,
                                       RetrainSupervisor, append_disposition,
                                       iter_replay, replay_stats)
    from nerrf_tpu_torch.models import NerrfNet
    from nerrf_tpu_torch.observability import MetricsRegistry
    from nerrf_tpu_torch.pipeline import make_eval_fn, model_detect
    from nerrf_tpu_torch.quality import (QualityConfig, QualityMonitor,
                                         build_reference_profile)
    from nerrf_tpu_torch.registry import ModelManager, ModelRegistry, RegistryConfig
    from nerrf_tpu_torch.serve import ServeConfig
    from nerrf_tpu_torch.train.checkpoint import (load_calibration, load_checkpoint,
                                                  save_checkpoint)
    from nerrf_tpu_torch.train.data import build_dataset
    from nerrf_tpu_torch.train.loop import evaluate
    from nerrf_tpu_torch.trainwatch import TrainHealthConfig

    phase_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="nerrf-learn-"))
    lineage = "default"
    out, part_s = {}, {}
    state, mcfg = load_checkpoint(model_dir)
    thr = load_calibration(model_dir).get("node_threshold")
    per_forward = fused_forward_launches(mcfg.gnn.num_layers)
    per_shadow = {k: 2 * v for k, v in per_forward.items()}
    per_step = step_launches("fused", mcfg.gnn.num_layers)
    bucket = serve_cell_bucket(serve_traces())
    scfg = ServeConfig(buckets=(bucket,), batch_size=SERVE_BATCH, batch_close_sec=0.1,
                       window_sec=15.0, stride_sec=5.0, stream_queue_slots=512,
                       alert_queue_slots=4096, window_deadline_sec=2.0, threshold=thr)
    ds = scfg.dataset_config(bucket)
    wpl = int((LEARN_SIM_SECONDS - scfg.window_sec) / scfg.stride_sec) + 1
    servers, svc, man, flight, sup, replay_w = [], None, None, None, None, None

    def model_of(sd):
        with torch.device("cuda"):
            m = NerrfNet(mcfg)
        m.load_state_dict(sd, strict=True)
        return m.eval()

    def auc(model, dset) -> float:
        return float(evaluate(make_eval_fn(model), dset, SERVE_BATCH)["edge_auc"])

    def want(launches: dict, n: int) -> dict:
        return {k: n * v for k, v in launches.items()}

    try:
        # --- a. v1, its profile, the registry and the serve planes ------------
        t0 = time.perf_counter()
        v1 = model_of(state)
        eval_unshifted = build_dataset(
            [simulate_trace(learn_sim(9100 + i, 0.0, True)) for i in range(2)], ds)
        eval_shifted = build_dataset(
            [simulate_trace(learn_sim(9200 + i, LEARN_DRIFT, True)) for i in range(2)], ds)
        out["v1_unshifted_auc"] = auc(v1, eval_unshifted)
        out["v1_shifted_auc"] = auc(v1, eval_shifted)
        ptraces = [simulate_trace(learn_sim(500 + i, 0.0, i % 2 == 0)) for i in range(4)]
        windows, batches = profile_batches(ptraces, ds)
        _reset_counts()
        profile = build_reference_profile(v1, ptraces, ds_cfg=ds,
                                          threshold=thr if thr is not None else 0.5)
        got = _launch_counts()
        if got != {**want(per_forward, batches), "mcts_search": 0} \
                or profile.windows != windows:
            _fail(f"learn profile: {profile.windows} windows, launches {got} != "
                  f"{batches} batches × {per_forward}")
        del v1
        save_checkpoint(tmp / "v1", state, mcfg, calibration={"node_threshold": thr}
                        if thr is not None else None, quality_profile=profile.to_dict())
        reg = MetricsRegistry(namespace="lsmoke")
        journal = EventJournal(capacity=16384, registry=reg)
        store = ModelRegistry(tmp / "registry", journal=journal)
        store.publish(lineage, tmp / "v1", source="learn smoke v1")
        store.promote(lineage, 1)
        part_s["v1_auc_and_profile"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        man = ModelManager(store, lineage, cfg=RegistryConfig(**LEARN_POLICY),
                           registry=reg, journal=journal, log=_console)
        sd1, cfg1, _cal, _v = man.boot()
        monitor = QualityMonitor(
            QualityConfig(min_windows=10, min_scores=150, journal_every=4,
                          trailing_windows=wpl, feature_trailing_windows=1024),
            registry=reg, journal=journal)
        window_log = []

        class LearnService(_counting_service(per="batch")):
            """Counts forwards too (the scorer thread's, a shadow's
            included): while the retrain launches from its own thread, a
            batch's counter deltas are not its own."""
            forwards = 0

            def _run_eval(self, eval_fn, batch):
                self.forwards += 1
                return super()._run_eval(eval_fn, batch)

        svc = LearnService(model_of(sd1), scfg, registry=reg, journal=journal,
                           quality_monitor=monitor, window_log=window_log,
                           device="cuda")
        svc.start()
        man.attach(svc)     # binds v1's shipped profile to the monitor
        if svc.live_version != 1 or svc.batch_launches != [per_forward]:
            _fail(f"learn boot: v{svc.live_version}, warmup {svc.batch_launches}")
        replay_dir = tmp / "replay"
        replay_w = ReplayWriter(ReplayConfig(out_dir=str(replay_dir),
                                             per_stream_quota=48, seed=0), registry=reg)
        svc.attach_learn(replay_w)
        flight = FlightRecorder(
            FlightConfig(out_dir=str(tmp / "flight"), quality_psi_breach=0.25,
                         quality_min_windows=int(LEARN_STREAMS * wpl * 1.3),
                         quality_breach_records=2, min_interval_sec=3600.0,
                         drop_burst_n=10 ** 6, p99_breach_sec=None),
            registry=reg, journal=journal, slo=svc.slo, info=svc.flight_info,
            quality=svc.quality_snapshot)
        svc.attach_flight(flight)
        sup = RetrainSupervisor(
            store, mcfg, cfg=RetrainConfig(
                lineage=lineage, replay_dir=str(replay_dir), out_dir=str(tmp / "retrain"),
                debounce_triggers=1, cooldown_sec=1e9, num_steps=LEARN_STEPS,
                batch_size=LEARN_BATCH, seed=2, save_every=LEARN_STEPS,
                replay_limit=64, synth_traces=4, synth_seed=4200,
                synth_duration_sec=LEARN_SIM_SECONDS, synth_drift=LEARN_DRIFT,
                synth_num_target_files=4, synth_benign_rate_hz=6.0),
            ds_cfg=ds, registry=reg, journal=journal, log=_console,
            monitor_cfg=TrainHealthConfig(journal_every=8, stall_after_sec=3600.0),
            device="cuda")
        part_s["warmup"] = time.perf_counter() - t0

        def leg(name: str, drift: float, seed_base: int,
                n: int = LEARN_STREAMS) -> dict:
            """n streams, one trace each, over the wire; the counters from 0."""
            targets = []
            for i in range(n):
                tr = simulate_trace(learn_sim(seed_base + 97 * i, drift, i % 2 == 0))
                srv = TraceReplayServer(tr.events, tr.strings, batch_size=256)
                targets.append(f"127.0.0.1:{srv.start()}")
                servers.append(srv)
            n_log, n_batch, n_fwd = len(window_log), len(svc.batch_launches), svc.forwards
            _reset_counts()
            t0 = time.perf_counter()
            runs = [svc.connect(f"s{i}", targets[i], timeout=300.0) for i in range(n)]
            for r in runs:
                r.done.wait(timeout=600.0)
            wall = time.perf_counter() - t0
            errors = {r.stream: repr(r.error) for r in runs if r.error or not r.done.is_set()}
            if errors:
                _fail(f"learn leg {name}: stream errors {errors}")
            log = window_log[n_log:]
            p50, p99 = _pcts([e[2] for e in log])
            part_s[f"leg_{name}"] = wall
            return dict(name=name, t0=t0, seconds=wall, windows=len(log),
                        windows_per_s=len(log) / wall, p50_ms=p50, p99_ms=p99,
                        batches=svc.batch_launches[n_batch:],
                        forwards=svc.forwards - n_fwd)

        def gate_batches(lg: dict, per_batch: dict) -> dict:
            got = _launch_counts()
            if not lg["batches"] or any(b != per_batch for b in lg["batches"]) \
                    or got != {**want(per_batch, len(lg["batches"])), "mcts_search": 0}:
                _fail(f"learn leg {lg['name']}: launches {got}, per batch "
                      f"{lg['batches']} != {per_batch}")
            return got

        def summary(lg: dict, launches: dict) -> dict:
            return {k: lg[k] for k in ("seconds", "windows", "windows_per_s", "p50_ms",
                                       "p99_ms", "forwards")} | {"launches": launches}

        # --- b. leg A, dispositions, leg B with the retrain ---------------------
        leg_a = leg("A", 0.0, 1000)
        out["leg_A"] = summary(leg_a, gate_batches(leg_a, per_forward))
        replay_w.flush()
        alerted = [r for r in iter_replay(replay_dir)
                   if r.get("max_prob") is not None and r["max_prob"] >= 0.5][:8]
        first = next(iter_replay(replay_dir))
        cli_label = "tp" if first in alerted else "fp"
        rc, text, err = _cli_run("alerts", "label", first["trace_id"], cli_label,
                                 "--note", "smoke oracle", "--replay-dir", replay_dir)
        if rc != 0 or json.loads(text)["label"] != cli_label:
            _fail(f"learn: alerts label exit {rc}: {err[-500:]}")
        for r in alerted:
            if r is not first:
                append_disposition(replay_dir, r["trace_id"], "tp",
                                   note="smoke oracle: alerted window")
        tp_ids = {r["trace_id"] for r in alerted}

        leg_b = leg("B", LEARN_DRIFT, 5000)
        replay_w.flush()
        export_t0 = time.perf_counter()
        rc, text, err = _cli_run("archive", "export", replay_dir, "--replay",
                                 "--batch-size", SERVE_BATCH)
        doc = json.loads(text) if rc == 0 else {}
        if rc != 0 or doc["dataset"]["labeled_tp"] != len(tp_ids) \
                or doc["stats"]["dispositions"] != len(tp_ids | {first["trace_id"]}) \
                or doc["dataset"]["windows"] != doc["stats"]["windows"]:
            _fail(f"learn: archive export --replay exit {rc}, {doc.get('dataset')}, "
                  f"{len(tp_ids)} tp labels: {err[-500:]}")
        part_s["export_replay"] = time.perf_counter() - export_t0
        if not sup.wait(timeout=900):
            _fail("learn: the retrain did not finish in 900 s")
        if sup.launches != 1 or sup.last_outcome != "published":
            _fail(f"learn: {sup.launches} retrain launches, outcome {sup.last_outcome}")
        bundles = journal.tail(kinds=("bundle",))
        if [b.data["trigger"] for b in bundles] != ["quality_drift"]:
            _fail(f"learn: bundles {[b.data for b in bundles]}, want one quality_drift")
        drift_bundle = bundles[0]
        [trig] = journal.tail(kinds=("retrain_triggered",))
        [done] = journal.tail(kinds=("retrain_done",))
        prov = json.loads((store.version_dir(lineage, 2) / "model_config.json")
                          .read_text()).get("provenance") or {}
        if not (prov.get("trigger") == "quality_drift"
                and prov.get("trigger_seq") == drift_bundle.seq
                and prov.get("parent_version") == 1 and prov.get("replay_fingerprint")
                and 0 < prov.get("replay_windows", 0) <= 64
                and prov.get("synth_windows", 0) > 0
                and prov.get("steps") == LEARN_STEPS and prov.get("seed") == 2):
            _fail(f"learn: v2's provenance {prov}")
        train_windows = prov["replay_windows"] + prov["synth_windows"]
        eval_fwd = math.ceil(train_windows / LEARN_BATCH)
        got = _launch_counts()
        expect = {k: leg_b["forwards"] * per_forward[k] + LEARN_STEPS * per_step[k]
                  + eval_fwd * per_forward[k] for k in per_forward}
        if got != {**expect, "mcts_search": 0} or leg_b["forwards"] != len(leg_b["batches"]):
            _fail(f"learn leg B with the retrain: launches {got} != {expect} "
                  f"({leg_b['forwards']} forwards, {LEARN_STEPS} steps, {eval_fwd} "
                  f"evaluation forwards)")
        out["leg_B"] = summary(leg_b, got)
        out["retrain"] = dict(
            trigger_to_launch_s=trig.t_perf - drift_bundle.t_perf,
            seconds=done.data["wall_sec"], steps_per_s=done.data["steps_per_sec"],
            edge_auc_train=done.data["edge_auc"], train_windows=train_windows,
            eval_forwards=eval_fwd, provenance=prov,
            bundle_into_leg_B_s=drift_bundle.t_perf - leg_b["t0"])

        # --- c. the promotion through the guardrails, parity, recovery ----------
        decisions = [man.poll()]
        if decisions[0]["action"] != "shadow_start":
            _fail(f"learn: poll {decisions[0]} after the publish (want shadow_start)")
        t_stage = time.perf_counter()
        promote_legs = []
        while svc.live_version != 2 and len(promote_legs) < LEARN_PROMOTE_LEGS:
            lg = leg(f"promote{len(promote_legs) + 1}", LEARN_DRIFT,
                     6000 + 500 * (len(promote_legs) + 1))
            promote_legs.append(summary(lg, gate_batches(lg, per_shadow)))
            decisions.append(man.poll())
        if svc.live_version != 2 or store.live_version(lineage) != 2:
            _fail(f"learn: live v{svc.live_version} after {len(promote_legs)} "
                  f"shifted legs; decisions {decisions}")
        [pub2] = [r for r in journal.tail(kinds=("registry_publish",))
                  if r.data.get("version") == 2]
        [promo] = journal.tail(kinds=("registry_promote",))
        out["promote_legs"] = promote_legs
        out["publish_to_promotion_s"] = promo.t_perf - pub2.t_perf
        out["staged_to_promotion_s"] = time.perf_counter() - t_stage

        tr = simulate_trace(learn_sim(9900, LEARN_DRIFT, True))
        srv = TraceReplayServer(tr.events, tr.strings, batch_size=256)
        target = f"127.0.0.1:{srv.start()}"
        servers.append(srv)
        n_batch = len(svc.batch_launches)
        _reset_counts()
        prun = svc.connect("parity0", target, timeout=300.0)
        prun.done.wait(timeout=600.0)
        plg = dict(name="parity", batches=svc.batch_launches[n_batch:])
        parity_launches = gate_batches(plg, per_forward)
        ev, strings = TrackerClient(target).stream(timeout=60.0)
        sd2, _c, _cal2, _v2 = store.load(lineage, 2)
        v2 = model_of(sd2)
        offline = model_detect(Trace(events=ev, strings=strings, ground_truth=None,
                                     labels=None, name="parity0"),
                               v2, ds_cfg=ds, auto_capacity=False, batch_size=SERVE_BATCH,
                               threshold=svc.cfg.threshold, device="cuda")
        served = prun.result
        fields = ("file_scores", "file_window_scores", "proc_scores", "threshold")
        differ = [f for f in fields
                  if served is None or getattr(served, f) != getattr(offline, f)]
        if differ or served.detector != "serve[max]@v2":
            _fail(f"learn parity under v2: {differ or served.detector} differ")
        out["v2_shifted_auc"] = auc(v2, eval_shifted)
        if out["v2_shifted_auc"] < out["v1_unshifted_auc"] - LEARN_AUC_TOL:
            _fail(f"learn: v2's shifted edge AUC {out['v2_shifted_auc']:.4f} < v1's "
                  f"unshifted {out['v1_unshifted_auc']:.4f} - {LEARN_AUC_TOL}")
        del v2
        seen2, flip_clean = False, True
        for entry in window_log:
            seen2 = seen2 or entry[4] == 2
            flip_clean = flip_clean and not (seen2 and entry[4] == 1)
        recompiles = _counter_total(reg, "serve_recompiles_total")
        if not flip_clean or recompiles:
            _fail(f"learn: a v1 window after v2 ({not flip_clean}), {recompiles} "
                  f"recompiles")
        out["parity"] = dict(batches=len(plg["batches"]), launches=parity_launches)

        # --- d. the doctor ------------------------------------------------------
        drift_path = drift_bundle.data["path"]
        rc, text, err = _cli_run("doctor", drift_path)
        if rc != 0 or "trigger=quality_drift" not in text \
                or "detection quality (drift" not in text:
            _fail(f"learn: doctor on the drift bundle exit {rc}: {err[-500:]}")
        # the drift bundle's journal tail ends at its own dump, before the
        # retrain it arms: a bundle dumped now holds the retrain
        later = flight.trigger("learn_snapshot", "after the promotion of v2")
        rc, text, err = _cli_run("doctor", later)
        if rc != 0 or "1 triggered → 1 published, 0 aborted" not in text \
                or "v1 → v2" not in text:
            _fail(f"learn: doctor's learn section exit {rc}: {text[-800:]}")
        out["bundle_bytes"] = sum(p.stat().st_size for p in Path(drift_path).iterdir())
        stats = replay_stats(replay_dir)
        out["replay"] = {k: stats[k] for k in ("windows", "disk_bytes", "dispositions")}
        slo = svc.slo.snapshot()["per_stream"]
        out["slo_p99_ms"] = {s: v["p99_ms"] for s, v in sorted(slo.items())}
        out["window_log_p99_ms"] = {
            s: _pcts([e[2] for e in window_log if e[0] == s][-256:])[1]
            for s in sorted(slo)}
        out["decisions"] = [{k: d.get(k) for k in ("action", "live", "shadow", "verdict",
                                                   "reason") if k in d} for d in decisions]
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        for closer in (flight and flight.close, sup and sup.close,
                       replay_w and replay_w.close, man and man.close, svc and svc.stop):
            if closer:
                closer()
        for srv in servers:
            srv.stop()

    # --- e. the divergence leg: nothing published -------------------------------
    try:
        t0 = time.perf_counter()
        reg2 = MetricsRegistry(namespace="lsmoke2")
        journal2 = EventJournal(capacity=4096, registry=reg2)
        store2 = ModelRegistry(tmp / "registry-div", journal=journal2)
        store2.publish(lineage, tmp / "v1", source="learn smoke v1")
        store2.promote(lineage, 1)
        sup2 = RetrainSupervisor(
            store2, mcfg, cfg=RetrainConfig(
                lineage=lineage, replay_dir=str(tmp / "no-replay"),
                out_dir=str(tmp / "retrain-div"), debounce_triggers=1, cooldown_sec=1e9,
                **LEARN_DIVERGE),
            ds_cfg=ds, registry=reg2, journal=journal2, log=_console,
            monitor_cfg=TrainHealthConfig(journal_every=2, stall_after_sec=3600.0),
            device="cuda")
        _reset_counts()
        journal2.record("bundle", trigger="quality_drift", path="injected")
        ok = sup2.wait(timeout=600)
        sup2.close()
        aborted = journal2.tail(kinds=("retrain_aborted",))
        versions = [v["version"] for v in store2.status(lineage)["versions"]]
        if not ok or sup2.last_outcome != "aborted" or len(aborted) != 1 \
                or versions != [1] or reg2.value(
                    "retrain_runs_total", labels={"outcome": "aborted"}) != 1:
            _fail(f"learn divergence: outcome {sup2.last_outcome}, aborted "
                  f"{[a.data for a in aborted]}, versions {versions}")
        steps_run = aborted[0].data["step"] + 1
        got = _launch_counts()
        if got != {**want(per_step, steps_run), "mcts_search": 0}:
            _fail(f"learn divergence: launches {got} != {steps_run} steps × {per_step}")
        out["divergence"] = dict(reason=aborted[0].data["reason"], steps=steps_run,
                                 launches=got)
        part_s["divergence"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - phase_t0
    out["parts_s"] = part_s
    a, b = out["leg_A"], out["leg_B"]
    r = out["retrain"]
    print(f"learn ({out['seconds']:.1f} s; parts {json.dumps({k: round(v, 2) for k, v in part_s.items()})}): "
          f"v1 edge AUC unshifted {out['v1_unshifted_auc']:.4f}, shifted "
          f"{out['v1_shifted_auc']:.4f}; one quality_drift bundle "
          f"({out['bundle_bytes']} bytes), the retrain launched "
          f"{r['trigger_to_launch_s']:.4f} s after it, {LEARN_STEPS} steps at batch "
          f"{LEARN_BATCH} at {r['steps_per_s']} steps/s, {r['seconds']} s, over "
          f"{r['train_windows']} windows; published → promoted in "
          f"{out['publish_to_promotion_s']:.2f} s ({len(out['promote_legs'])} shifted "
          f"legs with a shadow); v2 shifted edge AUC {out['v2_shifted_auc']:.4f}; "
          f"serve leg A {a['windows_per_s']:.3f} windows/s, p50 {a['p50_ms']:.1f} ms, "
          f"p99 {a['p99_ms']:.1f} ms; leg B with the retrain {b['windows_per_s']:.3f} "
          f"windows/s, p50 {b['p50_ms']:.1f} ms, p99 {b['p99_ms']:.1f} ms (admit→"
          f"scored, window_log); SLO p99 (admit→demux) {json.dumps(out['slo_p99_ms'])} "
          f"vs window_log {json.dumps({k: round(v, 1) for k, v in out['window_log_p99_ms'].items() if v is not None})}; "
          f"replay {out['replay']['windows']} windows, {out['replay']['disk_bytes']} "
          f"bytes; divergence aborted at step {out['divergence']['steps'] - 1} "
          f"({out['divergence']['reason']}); peak {out['peak_gb']:.1f} GB; parity "
          f"bit-equal under v2; on {_smi()}")
    out["launches"] = {"serve_batch": per_forward, "shadow_batch": per_shadow,
                       "retrain_step": per_step}
    return out


# --- StreamNet (ROADMAP A.5): the attention kernels, bench.py's stream leg
# and run_stream_eval.py's quality probe -----------------------------------

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W): the
# attention's bound, its inputs being bf16 (the kernels run on the CUDA
# cores; the bound is what the card could do)
# bench.py's stream leg (bench.py:131-134, :347-378): its corpus's first 6
# traces as 4096-event segments, step 0 timed apart, then
# min(50, max(3, 200 // 4)) steps (200 is bench.py's default step count);
# BENCH_r01.json's activations read bf16[12,4096,128]
STREAM_CORPUS = dict(n_traces=12, attack_fraction=0.5, base_seed=42,
                     duration_sec=180.0, num_target_files=24, benign_rate_hz=40.0)
STREAM_LEG_TRACES, STREAM_LEG_LEN, STREAM_LEG_B = 6, 4096, 12
STREAM_LEG_STEPS = min(50, max(3, 200 // 4))
# benchmarks/run_stream_eval.py at its defaults: 16 traces a split from
# _traces' scenario rotation (seeds 500, +3571, +7919; 120 s, 16 files,
# 30 Hz), segments of 1024 events, batches of 8, 300 steps; its exit
# condition is held-out event AUC >= 0.90 (run_stream_eval.py:242).  The
# reference's record of that run (a CPU's) gives the counts gated here
PROBE_SPLITS = (("train", 0), ("calib", 3571), ("eval", 7919))
PROBE_TRACES, PROBE_SEED, PROBE_LEN, PROBE_STEPS, PROBE_BATCH = 16, 500, 1024, 300, 8
PROBE_AUC_MIN = 0.90
PROBE_INIT_SEED = 1  # the script's init key (jax.random.PRNGKey(1))
PROBE_RECORD = os.path.join(ROOT, "benchmarks", "results", "stream_probe_cpu.json")
# the attention kernels against the plain version, (B, T, H, D), causal,
# dtype: the stream leg's and the probe's shapes (the leg's T in float32 too,
# at the tight bound), a ragged T with two 16-wide heads (the tests'
# config), the other two head widths, and ragged cases of bf16 at D = 64
# and 128, the widths of the tensor-core route (kernels.attention_route)
ATTENTION_CASES = (
    ((12, 4096, 1, 128), True, "bfloat16"),
    ((2, 4096, 1, 128), True, "float32"),
    ((8, 1024, 1, 128), True, "bfloat16"),
    ((8, 1024, 1, 128), True, "float32"),
    ((8, 1024, 1, 128), False, "bfloat16"),
    ((2, 1100, 2, 16), True, "float32"),
    ((2, 1100, 2, 16), False, "float32"),
    ((2, 1100, 2, 16), True, "bfloat16"),
    ((2, 777, 2, 32), True, "float32"),
    ((2, 777, 2, 32), False, "bfloat16"),
    ((3, 640, 2, 64), True, "float32"),
    ((3, 640, 2, 64), False, "bfloat16"),
    # the tensor-core route's widths at a ragged T: past a 128-row tile, a
    # 64-row box and the 128-key tile, and T below one tile
    ((2, 1100, 2, 128), True, "bfloat16"),
    ((3, 777, 2, 64), True, "bfloat16"),
    ((2, 100, 1, 128), True, "bfloat16"),
)


# the tensor-core attention entries (kernels.ATTENTION_TMA_ENTRIES at
# kernels.ATTENTION_TMA_HEAD_DIMS) must hold wgmma (HGMMA) and TMA loads
# (UTMALDG) in their SASS
SASS_REQUIRED = ("HGMMA", "UTMALDG")
SASS_SYMBOL = {"attention_fwd": "attention_fwd_sm90",
               "attention_bwd_dq": "attention_bwd_dq_sm90",
               "attention_bwd_dkdv": "attention_bwd_dkdv_sm90"}


def _cuda_tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which(name)
    if found is None and CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", name)):
        found = os.path.join(CUDA_HOME, "bin", name)
    if found is None:
        _fail(f"{name} not found")
    return found


def _ptxas_lines(log_path) -> dict:
    """{mangled entry: its ptxas -v lines on registers, spills and shared
    memory} from a library's build log."""
    out, entry = {}, None
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            out[entry] = []
        elif entry and any(w in line for w in ("registers", "spill", "smem")):
            out[entry].append(line.split("info    :")[-1].strip())
    return out


def check_attention_sass() -> dict:
    """The built flash_attention library read back: ``cuobjdump -sass``
    counts each tensor-core entry's HGMMA (wgmma), UTMALDG (TMA load) and
    UTMASTG (TMA store) instructions and fails if HGMMA or UTMALDG is 0;
    beside them the entry's ``ptxas -v`` lines from the build log (fails on
    a spill at D = 128) and the dynamic shared memory a launch asks for."""
    from nerrf_tpu_torch.ops import kernels

    lib = kernels.library_path("flash_attention")
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_REQUIRED + ("UTMASTG",), 0)
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += op in line
    ptxas = _ptxas_lines(lib.with_suffix(".log"))
    out = {}
    for name in kernels.ATTENTION_TMA_ENTRIES:
        for D in kernels.ATTENTION_TMA_HEAD_DIMS:
            found = [f for f in counts if SASS_SYMBOL[name] in f and f"ILi{D}E" in f]
            if len(found) != 1:
                _fail(f"attention SASS: {len(found)} functions for {name} at D = {D}")
            entry = found[0]
            c = counts[entry]
            if not all(c[op] for op in SASS_REQUIRED):
                _fail(f"attention SASS: {name} at D = {D} has {c}")
            lines = ptxas.get(entry, [])
            spilled = sum(int(n) for line in lines
                          for n in re.findall(r"(\d+) bytes spill", line))
            if D == 128 and spilled:
                _fail(f"attention SASS: {name} at D = 128 spills ({lines})")
            out[f"{name} D={D}"] = {**c, "ptxas": lines,
                                    "dynamic_shared_bytes": kernels.attention_smem(name, D)}
    print("attention tensor-core entries (SASS instruction counts from cuobjdump -sass; "
          "ptxas -v lines: registers a thread at launch, before setmaxnreg, and spills; "
          "the dynamic shared memory of a launch): " + json.dumps(out))
    return out


def _attention_scales(q, k, v, do, causal):
    """Σ|terms| of each element of O, dQ, dK and dV (the TOL form's scale),
    from the plain version's probabilities P: P·|V|; scale·A·|K| and
    scale·Aᵀ·|Q| with A = P∘(|dO|·|V|ᵀ + |Δ|), Δ = rowsum(dO∘O); Pᵀ·|dO|."""
    import torch

    q, k, v, do = (x.float() for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full((), -1e30, device=s.device))
    p = torch.softmax(s, dim=-1)
    del s
    delta = (do * torch.einsum("bhqk,bkhd->bqhd", p, v)).sum(-1)      # [B, T, H]
    a = p * (torch.einsum("bqhd,bkhd->bhqk", do.abs(), v.abs())
             + delta.abs().permute(0, 2, 1)[..., None])
    return (torch.einsum("bhqk,bkhd->bqhd", p, v.abs()),
            scale * torch.einsum("bhqk,bkhd->bqhd", a, k.abs()),
            scale * torch.einsum("bhqk,bqhd->bkhd", a, q.abs()),
            torch.einsum("bhqk,bqhd->bkhd", p, do.abs()))


def _attention_inputs(shape, dtype, seed):
    """q, k, v as StreamNet gives them (views of one [B, T, 3, H, D]
    projection, a leaf that takes the gradients) and a cotangent dO."""
    import torch

    B, T, H, D = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, T, 3, H, D, generator=gen, device="cuda").to(dtype)
    do = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
    return qkv.requires_grad_(), do


def check_attention() -> dict:
    """Each attention kernel against the plain version on the card
    (ATTENTION_CASES): O, and dQ, dK and dV against the plain version's
    autograd, within TOL·(1 + Σ|terms|); two kernel runs bit-equal.  Each
    case's tag names the route of the forward, dQ and dK/dV ("wgmma": tensor
    cores on TMA tiles, "fma": CUDA cores)."""
    import torch

    from nerrf_tpu_torch.ops import attention, kernels, plain_ops

    errors = {name: {} for name in attention.LAUNCHES}
    for i, (shape, causal, dtn) in enumerate(ATTENTION_CASES):
        qkv, do = _attention_inputs(shape, getattr(torch, dtn), 100 + i)

        def run():
            qkv.grad = None
            o = attention.causal_attention(*qkv.unbind(2), causal)
            o.backward(do)
            _sync()
            return o.detach(), qkv.grad

        got, again = run(), run()
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            _fail(f"attention {shape} causal={causal} {dtn}: two kernel runs differ")
        with plain_ops():
            want = run()
        scales = _attention_scales(*qkv.detach().unbind(2), do, causal)
        route = "/".join(kernels.attention_route(name, qkv.dtype, shape[-1])
                         for name in attention.LAUNCHES)
        tag = f"{'x'.join(map(str, shape))}{' causal' if causal else ''} {dtn} [{route}]"
        errors["attention_fwd"][tag] = _close(f"attention_fwd {tag}", got[0], want[0],
                                              dtn, scales[0])
        errors["attention_bwd_dq"][tag] = _close(
            f"attention_bwd_dq {tag}", got[1][:, :, 0], want[1][:, :, 0], dtn, scales[1])
        for j, part in ((1, "dK"), (2, "dV")):
            errors["attention_bwd_dkdv"][f"{tag} {part}"] = _close(
                f"attention_bwd_dkdv {tag} {part}", got[1][:, :, j], want[1][:, :, j],
                dtn, scales[j + 1])
        del qkv, do, got, again, want, scales
        torch.cuda.empty_cache()
    print("attention kernels vs plain version, max |Δ| by case [route of the forward/"
          "dQ/dK-dV]: " + json.dumps(errors))
    return errors


def attention_work(B, T, H, D, causal, itemsize=2) -> dict:
    """Operations and bytes of each entry point on [B, T, H, D] inputs: the
    visible (query, key) pairs (T(T+1)/2 a head when causal) times 2·D per
    product; the forward's two products (q·k, p·v), dQ's three (q·k, dO·v,
    dS·k), dK/dV's four (q·k, dO·v, Pᵀ·dO, dSᵀ·q).  Bytes: each input read
    once, each output written once (lse and its reads in f32)."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    x = B * T * H * D * itemsize
    lse = B * H * T * 4
    return {"attention_fwd": (2 * 2 * D * pairs, 3 * x + x + lse),
            "attention_bwd_dq": (3 * 2 * D * pairs, 5 * x + lse + x),
            "attention_bwd_dkdv": (4 * 2 * D * pairs, 5 * x + lse + 2 * x)}


def time_attention(shape, causal: bool = True) -> dict:
    """Each entry point at ``shape`` in bf16, causal: ms a call (CUDA events)
    and device ms a launch (profiler, 5 calls after 1, each call one launch
    of the port's kernel; null where every trace lost launches, the counts
    in ``device_lost``), beside the plain version's autograd for the same
    outputs, the library's attention (``scaled_dot_product_attention``: its
    forward for attention_fwd, its whole backward, dQ, dK and dV together,
    for the two backward entry points; never called by the port) and the
    bound (the larger of the operations over the bf16 tensor-core peak and
    the bytes over HBM)."""
    import torch
    import torch.nn.functional as F

    from nerrf_tpu_torch.ops import attention, kernels

    B, T, H, D = shape
    qkv, do = _attention_inputs(shape, torch.bfloat16, 7)
    q, k, v = (x.detach() for x in qkv.unbind(2))
    scale = D ** -0.5
    o = torch.empty(B, T, H, D, dtype=q.dtype, device="cuda")
    lse = torch.empty(B, H, T, dtype=torch.float32, device="cuda")
    dq, dk, dv = (torch.empty_like(o) for _ in range(3))
    rows = dict(o=o, dout=do, lse=lse, delta=torch.empty_like(lse))
    kernel = {
        "attention_fwd": lambda: kernels.launch_attention(
            "attention_fwd", q, k, v, causal, scale, o, lse),
        "attention_bwd_dq": lambda: kernels.launch_attention(
            "attention_bwd_dq", q, k, v, causal, scale, dq, **rows),
        "attention_bwd_dkdv": lambda: kernels.launch_attention(
            "attention_bwd_dkdv", q, k, v, causal, scale, dk, dv, **rows)}
    kernel["attention_fwd"]()
    kernel["attention_bwd_dq"]()  # Δ, which the tensor-core dK/dV reads
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out_plain = attention.attention_dense(*leaves, causal)
    plain = {
        "attention_fwd": lambda: attention.attention_dense(q, k, v, causal),
        "attention_bwd_dq": lambda: torch.autograd.grad(out_plain, leaves[:1], do,
                                                        retain_graph=True),
        "attention_bwd_dkdv": lambda: torch.autograd.grad(out_plain, leaves[1:], do,
                                                          retain_graph=True)}
    lib_in = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    sdpa = lambda: F.scaled_dot_product_attention(*lib_in, is_causal=causal)
    out_lib = sdpa()
    lib_bwd = lambda: torch.autograd.grad(out_lib, lib_in, do.transpose(1, 2),
                                          retain_graph=True)
    library = {"attention_fwd": sdpa, "attention_bwd_dq": lib_bwd,
               "attention_bwd_dkdv": lib_bwd}
    work = attention_work(B, T, H, D, causal)
    out = {}
    with torch.no_grad():
        for name in attention.LAUNCHES:
            ops, nbytes = work[name]
            t_ops, t_bytes = ops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            ms = cuda_ms(kernel[name], iters=10, warmup=2)
            split = device_split(kernel[name], iters=5, warmup=1, launches={"nerrf::": 1})
            out[name] = {
                "ms": ms, "device_ms": port_kernel_ms(split), "device_lost": split.lost,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "gflop": ops / 1e9, "tflops": ops / ms / 1e9,
                "library_ms": None, "library_device_ms": None}
            with torch.enable_grad():
                out[name]["plain_ms"] = cuda_ms(plain[name], iters=3, warmup=1)
                out[name]["library_ms"] = cuda_ms(library[name], iters=10, warmup=2)
                split = device_split(library[name], iters=5, warmup=1)
                out[name]["library_device_ms"] = split_ms(split)
                out[name]["library_device_lost"] = split.lost
    del out_plain, out_lib
    torch.cuda.empty_cache()
    return out


def stream_step_launches(model) -> dict:
    """Attention launches of one StreamNet training step, from the model:
    each block's attention forward, again in the backward's recompute when
    the blocks are rematerialised, and its backward's two kernels."""
    from nerrf_tpu_torch.models.stream import _Block

    layers = sum(isinstance(m, _Block) for m in model.modules())
    return {"attention_fwd": layers * (2 if model.cfg.remat else 1),
            "attention_bwd_dq": layers, "attention_bwd_dkdv": layers}


def _attention_counts() -> dict:
    from nerrf_tpu_torch.ops import attention

    return dict(attention.LAUNCHES)


def _reset_attention_counts() -> None:
    from nerrf_tpu_torch.ops import attention

    _sync()
    attention.reset_launches()


def run_stream_leg() -> dict:
    """bench.py's stream leg on the card: ``StreamNet(StreamConfig())`` at
    full width (dim 128, one 128-wide head, 4 layers, bf16, remat, dropout
    0.1) over its corpus's first 6 traces as 4096-event segments, through
    ``make_stream_train_step``; step 0 timed apart, then 50 steps, with the
    attention counters from 0.  Gates: B × T = 12 × 4096; finite losses; the
    launches derived from the model (:func:`stream_step_launches`); two
    gradients from one state at dropout 0 bit-equal."""
    import dataclasses

    import torch

    from nerrf_tpu_torch.data import build_streams, make_corpus
    from nerrf_tpu_torch.models import StreamConfig, StreamNet
    from nerrf_tpu_torch.models.stream import stream_loss
    from nerrf_tpu_torch.parallel import make_stream_train_step

    t0 = time.perf_counter()
    sb = build_streams(make_corpus(**STREAM_CORPUS)[:STREAM_LEG_TRACES],
                       max_len=STREAM_LEG_LEN)
    data_s = time.perf_counter() - t0
    B, T = sb.feat.shape[:2]
    if (B, T) != (STREAM_LEG_B, STREAM_LEG_LEN):
        _fail(f"stream leg: {B} x {T} segments; bench.py's record has "
              f"{STREAM_LEG_B} x {STREAM_LEG_LEN}")
    cfg = StreamConfig()
    model = StreamNet(cfg).cuda()
    init_fn, step_fn, place = make_stream_train_step(model)
    placed = place(sb.arrays())
    state = init_fn(2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    per_step = stream_step_launches(model)
    torch.cuda.reset_peak_memory_stats()
    _reset_attention_counts()
    t = time.perf_counter()
    state, loss, gen = step_fn(state, placed, gen)
    loss0 = float(loss)
    step0_s = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(STREAM_LEG_STEPS):
        state, loss, gen = step_fn(state, placed, gen)
    loss_last = float(loss)
    wall_s = time.perf_counter() - t
    launches = _attention_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: n * (STREAM_LEG_STEPS + 1) for k, n in per_step.items()}
    if launches != want:
        _fail(f"stream leg: attention launches {launches}, derived {want}")
    if not (math.isfinite(loss0) and math.isfinite(loss_last)):
        _fail(f"stream leg: losses {loss0}, {loss_last}")
    steps = lambda: [step_fn(state, placed, gen) for _ in range(2)]
    steps()
    _sync()
    t = time.perf_counter()
    steps()
    _sync()
    busy = device_busy_share("2 stream-leg steps", steps, time.perf_counter() - t)
    # two gradients from one state at dropout 0
    twin = StreamNet(dataclasses.replace(cfg, dropout=0.0)).cuda()
    twin.load_state_dict(model.state_dict())

    def grads():
        twin.zero_grad(set_to_none=True)
        out = twin(placed["feat"], placed["mask"])
        stream_loss(out, placed["label"], placed["mask"]).backward()
        _sync()
        return [p.grad.clone() for p in twin.parameters()]

    g1, g2 = grads(), grads()
    if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
        _fail("stream leg: two gradients from one state differ")
    res = {"B": B, "T": T, "data_s": data_s, "step0_s": step0_s,
           "steps": STREAM_LEG_STEPS, "wall_s": wall_s,
           "ms_per_step": wall_s / STREAM_LEG_STEPS * 1e3,
           "events_per_s": B * T * STREAM_LEG_STEPS / wall_s,
           "loss0": loss0, "loss": loss_last, "busy": busy, "per_step": per_step,
           "launches": launches, "peak_allocated_bytes": peak,
           "valid_events": int(sb.mask.sum())}
    print(f"stream leg (bench.py): {B} x {T} events a step ({res['valid_events']} "
          f"real), step 0 {step0_s:.3f} s, {STREAM_LEG_STEPS} steps in {wall_s:.3f} s: "
          f"{res['ms_per_step']:.2f} ms a step, {res['events_per_s']:.1f} events/s; "
          f"busy share {'not measured' if busy is None else round(busy, 3)}; "
          f"loss {loss0:.4f} -> {loss_last:.4f}; launches {launches} "
          f"({per_step} a step); two dropout-0 gradients bit-equal; peak "
          f"allocated {peak} bytes; data {data_s:.1f} s")
    del state, model, twin, placed
    torch.cuda.empty_cache()
    return res


def _probe_traces(n: int, base_seed: int):
    """run_stream_eval.py's ``_traces(n, base_seed, 120.0, 16, 30.0)``:
    attack traces at even i over the attack families, benign ones at odd i
    over the background and the hard negatives."""
    from nerrf_tpu_torch.data import SimConfig, simulate_trace

    atk = ("standard", "inplace-stealth", "slow-drip", "partial-encrypt",
           "multi-process", "interleaved-backup", "benign-comm", "exfil-encrypt")
    ben = ("standard", "benign-mass-rename", "benign-atomic-rewrite")
    out = []
    for i in range(n):
        attack = i % 2 == 0
        scenario = atk[(i // 2) % len(atk)] if attack else ben[(i // 2) % len(ben)]
        out.append(simulate_trace(SimConfig(
            duration_sec=120.0, num_target_files=16, benign_rate_hz=30.0,
            attack=attack, scenario=scenario, seed=base_seed + 101 * i,
            attack_start_sec=120.0 * 0.35),
            name=f"stream-{'atk' if attack else 'ben'}-{i}"))
    return out


def _score_split(model, sb, place):
    """Masked per-event logits of every segment, in batches of PROBE_BATCH
    (the tail wrapped to a full batch, as the script does)."""
    import numpy as np
    import torch

    arrs = sb.arrays()
    scores, labels = [], []
    with torch.inference_mode():
        for i in range(0, len(sb), PROBE_BATCH):
            idx = np.arange(i, min(i + PROBE_BATCH, len(sb)))
            batch = place({k: v[np.resize(idx, PROBE_BATCH)] for k, v in arrs.items()})
            logits = model(batch["feat"], batch["mask"])["event_logits"].float().cpu().numpy()
            for j in range(len(idx)):
                m = arrs["mask"][idx[j]]
                scores.append(logits[j][m])
                labels.append(arrs["label"][idx[j]][m])
    return np.concatenate(scores), np.concatenate(labels)


def run_stream_probe(init_seed: int = PROBE_INIT_SEED) -> dict:
    """run_stream_eval.py on the card at its defaults: train
    ``StreamNet(StreamConfig())`` 300 steps on 16 traces' 1024-event
    segments (batches of 8 drawn as the script draws them), calibrate the
    best-F1 per-event cut on 16 more traces in logit space, report held-out
    event AUC and F1 at that cut on 16 more; save the stream checkpoint and
    reload it.  Gates: the segment and event counts of the reference's
    record; the launches derived from the model; the reloaded model's
    held-out logits bit-equal (the caller gates the held-out event AUC).
    ``init_seed`` seeds the params; the batch order and the dropout stream
    stay the script's."""
    import tempfile

    import numpy as np
    import torch

    from nerrf_tpu_torch.data import build_streams
    from nerrf_tpu_torch.models import StreamConfig, StreamNet
    from nerrf_tpu_torch.parallel import make_stream_train_step
    from nerrf_tpu_torch.train.checkpoint import load_stream_checkpoint, save_stream_checkpoint
    from nerrf_tpu_torch.train.metrics import best_f1, f1_at_threshold, roc_auc

    with open(PROBE_RECORD) as f:
        record = json.load(f)
    t0 = time.perf_counter()
    sb = {name: build_streams(_probe_traces(PROBE_TRACES, PROBE_SEED + off),
                              max_len=PROBE_LEN) for name, off in PROBE_SPLITS}
    data_s = time.perf_counter() - t0
    counts = {"train_segments": len(sb["train"]), "eval_segments": len(sb["eval"]),
              "calib_events": int(sb["calib"].mask.sum()),
              "eval_events": int(sb["eval"].mask.sum())}
    want = {"train_segments": record["train"]["segments"],
            "eval_segments": record["eval"]["segments"],
            "calib_events": record["calibration"]["events"],
            "eval_events": record["eval"]["events"]}
    if counts != want:
        _fail(f"stream probe: {counts}, the reference's record {want}")

    cfg = StreamConfig()
    model = StreamNet(cfg).cuda()
    init_fn, step_fn, place = make_stream_train_step(model)
    arrays, n = sb["train"].arrays(), len(sb["train"])
    order = np.random.default_rng(PROBE_SEED)

    def draw():
        # one draw of PROBE_BATCH segments a step, as the script draws them
        idx = order.choice(n, size=PROBE_BATCH, replace=n < PROBE_BATCH)
        return place({k: v[idx] for k, v in arrays.items()})

    draw()  # the script draws its first batch for init_fn before the loop
    state = init_fn(init_seed)
    gen = torch.Generator(device="cuda").manual_seed(PROBE_SEED)
    _reset_attention_counts()
    t = time.perf_counter()
    for _ in range(PROBE_STEPS):
        state, loss, gen = step_fn(state, draw(), gen)
    final_loss = float(loss)
    train_s = time.perf_counter() - t
    model.eval()
    cs, cl = _score_split(model, sb["calib"], place)
    s, l = _score_split(model, sb["eval"], place)
    calib_f1, t_cal = best_f1(cl, cs)
    auc = roc_auc(l, s)
    at_cal = f1_at_threshold(l, s, t_cal)
    calibration = {"stream_event_threshold": round(float(t_cal), 4),
                   "stream_event_threshold_kind": "calib-split-best-f1",
                   "calib_f1": round(float(calib_f1), 4)}
    ckpt = tempfile.mkdtemp(prefix="nerrf-stream-probe-")
    try:
        t = time.perf_counter()
        save_stream_checkpoint(os.path.join(ckpt, "stream"), model.state_dict(), cfg,
                               calibration=calibration)
        save_s = time.perf_counter() - t
        sd, cfg2, cal2 = load_stream_checkpoint(os.path.join(ckpt, "stream"))
        params_bytes = os.path.getsize(os.path.join(ckpt, "stream", "params.pt"))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if cfg2 != cfg or cal2.get("stream_event_threshold_space") != "logit":
        _fail(f"stream probe: reloaded {cfg2}, calibration {cal2}")
    reloaded = StreamNet(cfg2).cuda().eval()
    reloaded.load_state_dict(sd)
    s2, _ = _score_split(reloaded, sb["eval"], place)
    launches = _attention_counts()
    if not np.array_equal(s2, s):
        _fail("stream probe: the reloaded checkpoint's held-out logits differ")
    # each step's launches, then one attention_fwd a layer in every scoring
    # forward: the calibration split, the held-out split, and the held-out
    # split again on the reloaded model
    batches = lambda split: -(-len(sb[split]) // PROBE_BATCH)
    per_step = stream_step_launches(model)
    want_launches = {k: n * PROBE_STEPS for k, n in per_step.items()}
    want_launches["attention_fwd"] += (
        (batches("calib") + 2 * batches("eval")) * per_step["attention_bwd_dq"])
    if launches != want_launches:
        _fail(f"stream probe: attention launches {launches}, derived {want_launches}")
    res = {"init_seed": init_seed, "counts": counts, "train_s": train_s,
           "steps_per_s": PROBE_STEPS / train_s, "final_loss": final_loss,
           "event_auc": auc, "event_f1_at_threshold": at_cal["f1"],
           "event_precision_at_threshold": at_cal["precision"],
           "event_recall_at_threshold": at_cal["recall"],
           "event_best_f1": best_f1(l, s)[0], "stream_event_threshold": t_cal,
           "calib_f1": calib_f1, "positive_rate": float(l.mean()), "launches": launches,
           "params_bytes": params_bytes, "save_s": save_s, "data_s": data_s,
           "record": record["metrics"] | {
               "stream_event_threshold": record["calibration"]["stream_event_threshold"],
               "calib_f1": record["calibration"]["calib_f1"]}}
    print(f"stream probe (run_stream_eval.py defaults, init seed {init_seed}): "
          f"{counts}; {PROBE_STEPS} steps "
          f"in {train_s:.3f} s ({res['steps_per_s']:.3f} steps/s), loss {final_loss:.4f}; "
          f"held-out event_auc {auc:.4f}, event_f1_at_threshold {at_cal['f1']:.4f} "
          f"(precision {at_cal['precision']:.4f}, recall {at_cal['recall']:.4f}, "
          f"best {res['event_best_f1']:.4f}), threshold {t_cal:.4f} (logit), calib_f1 "
          f"{calib_f1:.4f}; the reference's record (a CPU run) "
          f"{json.dumps(res['record'])}; checkpoint {params_bytes} bytes saved in "
          f"{save_s:.3f} s, reloaded bit-equal; launches {launches}; data {data_s:.1f} s")
    del model, reloaded, state
    torch.cuda.empty_cache()
    return res


def run_stream_path() -> dict:
    """The StreamNet phase: the attention kernels against the plain version
    and timed at the leg's and the probe's shapes, then the stream leg and
    the quality probe, each with the counters from 0."""
    t0 = time.perf_counter()
    errors = check_attention()
    timing = {"leg": time_attention((STREAM_LEG_B, STREAM_LEG_LEN, 1, 128)),
              "probe": time_attention((PROBE_BATCH, PROBE_LEN, 1, 128))}
    for tag, tm in timing.items():
        print(f"attention kernel times at the {tag} shape (bf16, causal; ms: CUDA "
              f"events, device_ms: profiler; plain_ms: the plain version's autograd "
              f"for the same outputs; library_ms: scaled_dot_product_attention's "
              f"forward, or its whole backward): " + json.dumps(tm))
    leg = run_stream_leg()
    probe = run_stream_probe()
    if not probe["event_auc"] >= PROBE_AUC_MIN:
        _fail(f"stream probe: held-out event AUC {probe['event_auc']:.4f} < {PROBE_AUC_MIN}")
    seconds = time.perf_counter() - t0
    print(f"stream phase: {seconds:.1f} s of command time")
    return {"errors": errors, "timing": timing, "leg": leg, "probe": probe,
            "seconds": seconds}


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


def lstm_times(iters: int = 10) -> dict:
    """The LSTM tower's forward on the detection cell's first batch (8
    windows of the 4096n/4096e/4096s rung: 32768 sequences of 100 steps, the
    full-width 2x256 BiLSTM in bfloat16, random weights from seed 0) for the
    package on ``sys.path``: ms a forward (CUDA events, after 2 warm-up
    forwards), the peak of allocated device memory during the forwards, and
    a checksum of ``seq_logit``."""
    import torch

    from nerrf_tpu_torch.models import JointConfig, build_nerrfnet
    from nerrf_tpu_torch.pipeline import pad_batch
    from nerrf_tpu_torch.train.data import windows_of_trace

    model = build_nerrfnet(JointConfig(), seed=0, device="cuda")
    trace, ds = detect_trace()
    batch = pad_batch(windows_of_trace(trace, ds)[:8], 8)
    feat = torch.as_tensor(batch["seq_feat"], device="cuda")
    mask = torch.as_tensor(batch["seq_mask"], device="cuda")
    with torch.inference_mode():
        logit = model.lstm(feat, mask)["seq_logit"].float()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: model.lstm(feat, mask), iters=iters, warmup=2)
        peak = torch.cuda.max_memory_allocated()
    return {"lstm_forward_ms": ms, "peak_allocated_bytes": peak,
            "sequences": int(feat.shape[0] * feat.shape[1]),
            "seq_logit_sum": float(logit.sum()), "seq_logit_abs_sum": float(logit.abs().sum())}


# --- the device-time plane: costs, MFU, headroom, capture, shedding ----------

# the phase's legs: serve windows/s with the plane on and off in turns, two
# of the serve cell's streams a leg (s5, s6), then one profiled leg for the
# busy share and one for the p99 capture.  One turn each (two each until the
# fleet phase needed the smoke's time: their spread, ±10% between turns,
# was wider than the plane's cost, so the second pair resolved nothing)
DEVTIME_TURNS = ("on", "off")
DEVTIME_STREAMS = ("s5", "s6")
# the p99 leg's breach threshold (the serve cell's admit→demux p50 is about
# 2.5 s) and its capture's seconds
DEVTIME_P99_SEC = 0.25
DEVTIME_CAPTURE_SEC = 1.0
# the serve-detect subprocess's seconds of resident streams, and the
# --target capture's, pulled as soon as its capture server is up: the
# warmup forward and the first sessions' batches (a session scores its
# windows in under a second, then reconnects)
DEVTIME_TARGET_SEC = 3
DEVTIME_PULL_SEC = 4
# the shedding leg: per-stream queue slots (no fewer than the 3 windows a
# leave's flush closes at once, 15 s windows at a 5 s stride), the burner's
# feed rate as a multiple of the
# windows/s a stream of the plane-on legs sustained (a stream's rate: one
# feeder lowers a 4096-rung window in about 60-70 ms of host, so three
# times the service's whole rate is out of one feeder's reach)
SHED_SLOTS = 3
SHED_HEALTHY = 3
# a healthy stream's opening windows, fed one at a time, each after the
# last was scored: its trailing device-stage burn starts from its steady
# state (three feeders lowering at once slowed the scorer's first small
# batches until a healthy stream outranked the burner, on the H100)
SHED_OPENING = 4
SHED_RATE_X = 3.0
SHED_LEG_MAX_S = 60.0
# the port's kernels as the profiler names them (#1-#5: the chunked sums'
# and the gathers' templates)
PORT_KERNEL_EVENTS = ("nerrf::segment_chunks_kernel", "nerrf::gather_packs_kernel")


def serve_flops_closed_form(cfg, batch: int, bucket) -> int:
    """One serve forward's matmul FLOPs (2·M·N·K a product) of ``batch``
    windows at ``bucket`` (N nodes, E edges, S sequences), in the ``fused``
    and ``segment`` modes, from ``cfg``'s widths and the dataset's sequence
    length T (R = batch·S sequences, BN = batch·N, BE = batch·E):

    * BiLSTM (hidden H, L layers): the input projection R·T·12·H; a layer
      each direction's input products over all T, R·T·H·4H, its recurrent
      products, R·H·4H a step over T, and the merge R·T·2H·H; the head R·H;
    * the fusion: R·H·24 (the node features' width);
    * GraphSAGE-T (hidden G, its layers): the node encoder BN·24·G, the
      edge encoder BE·13·G; a layer's message BN·G·G and update BN·2G·G;
      the node head BN·G; the edge head BE·4G·G + BE·G.
    """
    from nerrf_tpu_torch.data.sequences import SEQ_FEATURE_DIM
    from nerrf_tpu_torch.graph.builder import EDGE_FEATURE_DIM, NODE_FEATURE_DIM
    from nerrf_tpu_torch.train.data import DatasetConfig

    n, e, s = bucket
    T = DatasetConfig().seq_len
    H, L = cfg.lstm.hidden, cfg.lstm.num_layers
    G, LG = cfg.gnn.hidden, cfg.gnn.num_layers
    R, BN, BE = batch * s, batch * n, batch * e
    lstm = R * T * SEQ_FEATURE_DIM * H + L * 2 * (
        R * T * H * 4 * H + T * R * H * 4 * H) + L * R * T * 2 * H * H + R * H
    fusion = R * H * NODE_FEATURE_DIM if cfg.fuse else 0
    gnn = (BN * NODE_FEATURE_DIM * G + BE * EDGE_FEATURE_DIM * G
           + LG * (BN * G * G + BN * 2 * G * G) + BN * G + BE * 4 * G * G + BE * G)
    return 2 * (lstm + fusion + gnn)


def trace_kernel_events(trace_dir) -> dict:
    """{port kernel name: events} in the Chrome traces under ``trace_dir``:
    the card's kernel events whose names hold one of PORT_KERNEL_EVENTS."""
    counts = {k: 0 for k in PORT_KERNEL_EVENTS}
    for root, _dirs, names in os.walk(trace_dir):
        for name in names:
            if not name.endswith(".json"):
                continue
            with open(os.path.join(root, name)) as f:
                events = json.load(f).get("traceEvents", [])
            for ev in events:
                if ev.get("cat") != "kernel":
                    continue
                for k in PORT_KERNEL_EVENTS:
                    if k in str(ev.get("name", "")):
                        counts[k] += 1
    return counts


def _gate_kernel_events(what: str, trace_dir) -> dict:
    got = trace_kernel_events(trace_dir)
    if not sum(got.values()):
        _fail(f"{what}: no port kernel event in the trace under {trace_dir} ({got})")
    return got


def _gauge_present(reg, name: str, **labels) -> bool:
    key = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return key in reg.snapshot()["gauges"].get(name, {})


def run_devtime_path(model_dir: str, train_mfu=None) -> dict:
    """The device-time plane at full width on the checkpoint at
    ``model_dir`` (the Detection model's widths):

    a. the card's peaks from ``devtime.peaks``; the serve cell rung's cost
       traced on meta tensors with the counters from 0 (no launch), its
       FLOPs equal to :func:`serve_flops_closed_form`; the train step's cost
       at the training rung, cold and memoized;
    b. the serve cell's ladder and four streams on two services, the plane
       on and off, legs in turns (windows/s); every leg gated 28/2/3/2/0 a
       batch, no drop, the on-legs' streams bit-equal to ``model_detect``;
       the cost thread launches nothing; after the on-legs the MFU,
       utilization, useful-FLOPs and headroom gauges; one profiled on-leg:
       ``util_fraction`` beside the profiler's busy share;
    c. a leg with ``FlightConfig(profile_on_p99_sec=1.0)`` and a breached
       deadline: one ``p99_breach`` bundle whose ``torch_trace/`` holds the
       scorer's kernel events, and ``doctor`` on it;
    d. ``profile costs --measure 5 --cross-check`` (every row's measured
       MFU, mfu × peak × seconds_per_call = flops), ``profile capture``
       locally, and ``profile capture --target`` against a ``serve-detect
       --profiler-port`` subprocess: kernel events in each trace;
    e. SLO-aware shedding: three healthy streams on a small rung at the
       service's pace, and a burner on the serve cell's rung fed at
       SHED_RATE_X × a stream's windows/s in the on-legs:
       ``capacity_saturation`` journaled, every ``fleet_shed`` victim the
       burner, the counter equal to the records, the healthy streams
       bit-equal to ``model_detect``;
    f. the train MFU gauge (``program="train_step"``) of the last training
       run (``train_mfu``, else a 5-step run here)."""
    import dataclasses
    import tempfile
    import threading
    from pathlib import Path

    import numpy as np
    import torch

    from nerrf_tpu_torch import cli
    from nerrf_tpu_torch.devtime import chip_peaks, costmodel, serve_program_costs
    from nerrf_tpu_torch.flight import EventJournal, FlightConfig, FlightRecorder
    from nerrf_tpu_torch.observability import MetricsRegistry
    from nerrf_tpu_torch.pipeline import model_detect, warmup_trace
    from nerrf_tpu_torch.schema.events import events_to_jsonl
    from nerrf_tpu_torch.serve import ServeConfig, bucket_tag
    from nerrf_tpu_torch.train.data import DatasetConfig, windows_of_trace
    from nerrf_tpu_torch.train.loop import TrainConfig

    phase_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="nerrf-devtime-"))
    out, part_s = {}, {}
    dev = torch.device("cuda")
    smi = _smi()
    services, serve_proc = [], None
    try:
        # --- a. peaks and the cost model ---------------------------------------
        t0 = time.perf_counter()
        peaks = chip_peaks(dev)
        name = torch.cuda.get_device_name(dev)
        if peaks is None or peaks.kind != name.strip().lower():
            _fail(f"devtime: no peak row for {name!r} ({peaks})")
        print(f"devtime peaks: {peaks} for {name!r}; nvidia-smi: {smi}")
        out["peaks"] = dataclasses.asdict(peaks)
        model = cli._load_model(model_dir, dev)
        mcfg = model.cfg
        per_forward = fused_forward_launches(mcfg.gnn.num_layers)
        traces = serve_traces()
        rung = serve_cell_bucket(traces)
        tag = bucket_tag(rung)
        cfg_on = ServeConfig(buckets=(rung,), batch_size=SERVE_BATCH)
        costmodel._COSTS.clear()  # cold: the services and the CLI reuse it
        _reset_counts()
        t1 = time.perf_counter()
        costs = serve_program_costs(model, cfg_on)
        out["cost_trace_s"] = time.perf_counter() - t1
        if any(_launch_counts().values()):
            _fail(f"devtime: the cost trace launched {_launch_counts()}")
        closed = serve_flops_closed_form(mcfg, SERVE_BATCH, rung)
        if set(costs) != {tag} or costs[tag].flops != closed:
            _fail(f"devtime: the {tag} cost {costs.get(tag)} != the closed form {closed}")
        out["serve_cost"] = costs[tag].to_dict()
        # the train step's cost at the training rung: cold, then memoized
        ds_train = DatasetConfig(graph=dataclasses.replace(
            DatasetConfig().graph, max_nodes=TRAIN_RUNG[0], max_edges=TRAIN_RUNG[1]),
            seq_len=TRAIN_RUNG[3], max_seqs=TRAIN_RUNG[2])
        samples = windows_of_trace(warmup_trace("devtime-train"), ds_train)
        arrays = {k: np.stack([s[k] for s in samples] * SERVE_BATCH) for k in samples[0]}
        tcfg = TrainConfig(model=mcfg, batch_size=SERVE_BATCH)
        t1 = time.perf_counter()
        tc = costmodel.train_step_cost(model, tcfg, arrays)
        cold = time.perf_counter() - t1
        t1 = time.perf_counter()
        again = costmodel.train_step_cost(model, tcfg, arrays)
        warm = time.perf_counter() - t1
        if tc is None or again is not tc:
            _fail(f"devtime: train step cost {tc}, memoized {again}")
        out["train_cost"] = dict(tc.to_dict(), trace_s=cold, memo_s=warm)
        part_s["costs"] = time.perf_counter() - t0
        print(f"devtime part costs: {part_s['costs']:.1f} s", flush=True)

        # --- b. the plane on and off, in turns ------------------------------------
        t0 = time.perf_counter()
        CountingService = _counting_service(per="batch")
        svcs = {}
        for turn, on in (("on", True), ("off", False)):
            reg = MetricsRegistry(namespace=f"devtime_{turn}")
            journal = EventJournal(capacity=16384, registry=reg)
            cfg = dataclasses.replace(cfg_on, devtime_accounting=on)
            _reset_counts()
            svc = CountingService(cli._load_model(model_dir, dev), cfg, registry=reg,
                                  journal=journal, device="cuda")
            services.append(svc)
            svc.start()
            if on:
                # the cost thread: done, its cost registered, and it launched
                # nothing beyond the warmup forward (read below)
                svc._devtime_thread.join(timeout=120.0)
                if svc._devtime_thread.is_alive() or \
                        f"serve_eval[{tag}]" not in svc.devtime._costs:
                    _fail("devtime: the serve cost did not register")
            got = _launch_counts()
            if got != {**per_forward, "mcts_search": 0}:
                _fail(f"devtime {turn}: warmup and cost thread launched {got}")
            svcs[turn] = (svc, reg, journal)
        part_s["boot"] = time.perf_counter() - t0
        print(f"devtime part boot: {part_s['boot']:.1f} s", flush=True)
        traces = {sid: traces[sid] for sid in DEVTIME_STREAMS}
        refs = {sid: model_detect(tr, model, ds_cfg=cfg_on.dataset_config(rung),
                                  auto_capacity=False, batch_size=SERVE_BATCH,
                                  device="cuda").file_scores
                for sid, tr in traces.items()}
        legs = []
        for i, turn in enumerate(DEVTIME_TURNS):
            svc, reg, _journal = svcs[turn]
            n_batch = len(svc.batch_launches)
            w0 = _counter_total(reg, "serve_windows_scored_total")
            dets, wall = replay(svc, traces)
            _serve_gates(reg, svc, n_batch, per_forward, f"devtime leg {i} ({turn})")
            windows = _counter_total(reg, "serve_windows_scored_total") - w0
            if any(dets[sid].file_scores != refs[sid] for sid in traces):
                _fail(f"devtime leg {i} ({turn}): a stream differs from model_detect")
            legs.append(dict(turn=turn, seconds=wall, windows=windows,
                             batches=len(svc.batch_launches) - n_batch,
                             windows_per_s=windows / wall))
        out["turns"] = legs
        svc, reg, journal = svcs["on"]
        tprog = f"serve_eval[{tag}]"
        missing = [g for g, lab in (("device_mfu", {"program": tprog}),
                                    ("device_util_fraction", {}),
                                    ("capacity_headroom_streams", {}),
                                    ("device_useful_flops_fraction", {"bucket": tag}),
                                    ("device_roofline_ridge", {}),
                                    ("device_roofline_intensity", {"program": tprog}))
                   if not _gauge_present(reg, g, **lab)]
        useful = reg.value("device_useful_flops_fraction", labels={"bucket": tag})
        if missing or not 0 < useful <= 1:
            _fail(f"devtime: gauges missing {missing}, useful fraction {useful}")
        if _gauge_present(svcs["off"][1], "device_util_fraction"):
            _fail("devtime: the plane-off service exported device gauges")
        out["gauges"] = {
            "device_mfu": reg.value("device_mfu", labels={"program": tprog}),
            "device_util_fraction": reg.value("device_util_fraction"),
            "capacity_headroom_streams": reg.value("capacity_headroom_streams"),
            "device_useful_flops_fraction": useful,
            "capacity_saturation_records": len(journal.tail(kinds=("capacity_saturation",)))}
        # one profiled on-leg: the plane's utilization beside the busy share
        n_batch = len(svc.batch_launches)
        box = {}

        def profiled_leg():
            box["dets"], box["wall"] = replay(svc, traces)

        busy = device_busy_share("devtime's plane-on leg", profiled_leg,
                                 lambda: box["wall"])
        _serve_gates(reg, svc, n_batch, per_forward, "devtime busy leg")
        snap = svc.devtime.snapshot()
        out["busy_leg"] = dict(seconds=box["wall"], busy_share=busy,
                               util_fraction=snap["util_fraction"],
                               mfu=snap["programs"][tprog]["mfu"],
                               headroom=snap["headroom"])
        print(f"devtime busy leg: util_fraction {snap['util_fraction']} (the synced "
              f"scoring calls' host wall over the trailing window) beside the "
              f"profiler's busy share {busy} (kernel time over the leg's wall); "
              f"snapshot {json.dumps(snap)}")
        part_s["turns"] = time.perf_counter() - t0
        print(f"devtime part turns: {part_s['turns']:.1f} s", flush=True)

        # --- c. the p99 bundle with a torch.profiler capture ---------------------
        t0 = time.perf_counter()
        rec = FlightRecorder(
            FlightConfig(out_dir=str(tmp / "flight"), p99_breach_sec=DEVTIME_P99_SEC,
                         p99_min_count=4, profile_on_p99_sec=DEVTIME_CAPTURE_SEC,
                         min_interval_sec=3600.0, drop_burst_n=10 ** 6),
            registry=reg, journal=journal, slo=svc.slo, info=svc.flight_info,
            quality=svc.quality_snapshot)
        svc.attach_flight(rec)
        n_batch = len(svc.batch_launches)
        try:
            replay(svc, traces)
        finally:
            svc.attach_flight(None)
            rec.close()
        _serve_gates(reg, svc, n_batch, per_forward, "devtime p99 leg")
        bundles = sorted((tmp / "flight").glob("bundle-*"))
        if len(bundles) != 1 or not bundles[0].name.endswith("p99_breach"):
            _fail(f"devtime: p99 bundles {[b.name for b in bundles]}")
        man = json.loads((bundles[0] / "manifest.json").read_text())
        if (man.get("profile") or {}).get("dir") != "torch_trace":
            _fail(f"devtime: the p99 bundle's profile {man.get('profile')}")
        p99_events = _gate_kernel_events("the p99 bundle", bundles[0] / "torch_trace")
        rc, text, _ = _cli_run("doctor", bundles[0])
        if rc != 0 or "profiler trace:" not in text or "torch_trace/" not in text:
            _fail(f"devtime: doctor on the p99 bundle exit {rc}: {text[-800:]}")
        out["p99_bundle"] = dict(profile=man["profile"], kernel_events=p99_events,
                                 bytes=sum(f.stat().st_size for f in bundles[0].rglob("*")
                                           if f.is_file()))
        part_s["p99"] = time.perf_counter() - t0
        print(f"devtime part p99: {part_s['p99']:.1f} s", flush=True)
        for s in services:
            s.stop()
        services.clear()
        del svcs, svc
        torch.cuda.empty_cache()

        # --- d. profile costs, profile capture, --target -------------------------
        t0 = time.perf_counter()
        ladder = ["x".join(map(str, rung))]
        rc, text, log = _cli_run("profile", "costs", "--measure", 5, "--cross-check",
                                 "--no-train", "--json", "--model-dir", model_dir,
                                 "--buckets", *ladder)
        if rc != 0:
            _fail(f"devtime: profile costs exit {rc}: {log[-1500:]}")
        doc = json.loads(text)
        bad = {}
        for prog, row in doc["programs"].items():
            m = row.get("measured") or {}
            if m.get("mfu") is None or abs(
                    m["mfu"] * peaks.tflops_bf16 * 1e12 * m["seconds_per_call"]
                    - row["flops"]) > 1e-6 * row["flops"]:
                bad[prog] = m
        if bad or len(doc["programs"]) != len(ladder) or \
                doc["programs"][tprog]["flops"] != closed or \
                doc["peaks"]["tflops_bf16"] != peaks.tflops_bf16:
            _fail(f"devtime: profile costs rows {bad}, {len(doc['programs'])} programs, "
                  f"peaks {doc['peaks']}")
        out["profile_costs"] = {p: dict(flops=r["flops"], mfu=r["measured"]["mfu"],
                                        seconds_per_call=r["measured"]["seconds_per_call"],
                                        profiler_flops=r["profiler_flops"],
                                        profiler_device_sec=r["profiler_device_sec"],
                                        intensity=r["intensity_flops_per_byte"])
                                for p, r in doc["programs"].items()}
        rc, text, log = _cli_run("profile", "capture", "--seconds", 2, "--model-dir",
                                 model_dir, "--buckets", ladder[-1], "--out",
                                 tmp / "capture")
        if rc != 0:
            _fail(f"devtime: profile capture exit {rc}: {log[-1500:]}")
        out["capture_events"] = _gate_kernel_events("profile capture", tmp / "capture")
        part_s["profile"] = time.perf_counter() - t0
        print(f"devtime part profile: {part_s['profile']:.1f} s", flush=True)

        t0 = time.perf_counter()
        for sid in ("s5", "s6"):
            tr = traces[sid]
            (tmp / f"{sid}.jsonl").write_text(events_to_jsonl(tr.events, tr.strings))
        lines = []
        # resident streams (--follow: each replays its trace again at its
        # end) for DEVTIME_TARGET_SEC after the warmup
        serve_proc = subprocess.Popen(
            _cli_argv("serve-detect", "--model-dir", model_dir, "--trace", tmp / "s5.jsonl",
                      "--trace", tmp / "s6.jsonl", "--buckets", ladder[-1],
                      "--metrics-port", -1, "--profiler-port", 0, "--follow",
                      "--duration", DEVTIME_TARGET_SEC),
            cwd=sys.path[0], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        reader = threading.Thread(target=lambda: lines.extend(serve_proc.stderr),
                                  daemon=True)
        reader.start()
        port, deadline = None, time.monotonic() + 300.0
        while time.monotonic() < deadline and serve_proc.poll() is None:
            text = "".join(lines)
            m = re.search(r"profiler server on :(\d+)", text)
            if m:
                port = int(m.group(1))
                break
            time.sleep(0.05)
        if port is None:
            _fail(f"devtime: serve-detect --profiler-port never served "
                  f"(exit {serve_proc.poll()}): {''.join(lines)[-1500:]}")
        t1 = time.perf_counter()
        rc, text, log = _cli_run("profile", "capture", "--target", f"127.0.0.1:{port}",
                                 "--seconds", DEVTIME_PULL_SEC, "--out", tmp / "target")
        pulled_s = time.perf_counter() - t1
        events = trace_kernel_events(tmp / "target")
        if rc != 0 or not sum(events.values()):
            _fail(f"devtime: profile capture --target exit {rc} in {pulled_s:.1f} s, "
                  f"kernel events {events}: {log[-800:]}; serve-detect: "
                  f"{''.join(lines)[-1500:]}")
        out["target_events"] = dict(events, pulled_s=pulled_s)
        stdout, _ = serve_proc.communicate(timeout=300)
        reader.join(timeout=10)
        if serve_proc.returncode != 0:
            _fail(f"devtime: serve-detect exit {serve_proc.returncode}: "
                  f"{''.join(lines)[-1500:]}")
        out["target_serve"] = json.loads(stdout)["windows_scored"]
        serve_proc = None
        part_s["target"] = time.perf_counter() - t0
        print(f"devtime part target: {part_s['target']:.1f} s", flush=True)

        # --- e. SLO-aware shedding ---------------------------------------------------
        t0 = time.perf_counter()
        per_stream = max(lg["windows_per_s"] for lg in legs
                         if lg["turn"] == "on") / len(traces)
        out["shed"] = run_shed_leg(model_dir, model, rung, per_forward,
                                   rate=SHED_RATE_X * per_stream)
        part_s["shed"] = time.perf_counter() - t0
        print(f"devtime part shed: {part_s['shed']:.1f} s", flush=True)

        # --- f. the train MFU gauge ---------------------------------------------------
        if train_mfu is None:
            train_mfu = devtime_train_probe()
        if not train_mfu or train_mfu.get("mfu") is None:
            _fail(f"devtime: no train MFU gauge ({train_mfu})")
        out["train_mfu"] = train_mfu
    finally:
        for s in services:
            s.stop()
        if serve_proc is not None:
            serve_proc.kill()
            serve_proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out["part_s"] = part_s
    out["seconds"] = time.perf_counter() - phase_t0
    print("devtime: " + json.dumps(out))
    return out


def _window_blocks(trace, window_sec: float, stride_sec: float):
    """``trace``'s events cut where a window closes (at the first window's
    end, then every stride): fed in turn, each block after the first closes
    one window (the healthy traces' events are never 5 s apart)."""
    import dataclasses

    import numpy as np

    ev = trace.events
    ts = np.asarray(ev.ts_ns)
    valid = np.flatnonzero(np.asarray(ev.valid))
    t0, t1 = int(ts[valid].min()), int(ts[valid].max())
    ends = np.arange(t0 + int(window_sec * 1e9), t1 + 1, int(stride_sec * 1e9))
    cuts = [0, *valid[np.searchsorted(ts[valid], ends)].tolist(), len(ev)]
    for lo, hi in zip(cuts, cuts[1:]):
        if hi > lo:
            yield type(ev)(**{f.name: getattr(ev, f.name)[lo:hi]
                              for f in dataclasses.fields(ev)})


def _shifted(block, offset_ns: int):
    """``block`` with its timestamps ``offset_ns`` later."""
    import dataclasses

    return type(block)(**{f.name: getattr(block, f.name) + offset_ns
                          if f.name == "ts_ns" else getattr(block, f.name)
                          for f in dataclasses.fields(block)})


def run_shed_leg(model_dir: str, model, burner_rung: tuple, per_forward: dict,
                 rate: float) -> dict:
    """SLO-aware shedding under a burner.  Three healthy streams
    (run_learn_bench's traffic: 120 s at 6 Hz, 4 files) on the small rung
    that fits them, each fed one window's events a block at the service's
    pace: with SHED_SLOTS windows outstanding, its next window
    (which overflows the stream's queue) is fed once the earlier ones are
    all in batches, so under pressure it sheds the burner, and it never
    drops one of its own; one burner (the serve cell's benign recipe,
    looped with its timestamps shifted) on ``burner_rung``, fed at ``rate``
    windows/s until the healthy streams are done; the learn cell's
    windowing (15 s, stride 5 s), SHED_SLOTS queue slots a stream.  The
    healthy feeders start once the headroom predictor reads pressure and
    the burner's windows have burned device time.  Gates: ``capacity_saturation`` journaled; every fleet_shed
    victim the burner, and every victim any overflow ranked; the counter
    equal to the records and to the shed drops; no healthy window dropped;
    each healthy stream bit-equal to ``model_detect``; every batch
    28/2/3/2/0; the burner fed at ``rate``.  A shed needs the burner to hold
    a queued window when a healthy queue overflows, which the card's runs
    found in 1 of 3-6 overflows: the count is reported, not gated."""
    import threading

    from nerrf_tpu_torch import cli
    from nerrf_tpu_torch.data import simulate_trace
    from nerrf_tpu_torch.flight import EventJournal
    from nerrf_tpu_torch.observability import MetricsRegistry
    from nerrf_tpu_torch.pipeline import model_detect
    from nerrf_tpu_torch.serve import ServeConfig

    healthy = {f"h{i}": simulate_trace(learn_sim(700 + i, 0.0, i == 0))
               for i in range(SHED_HEALTHY)}
    burner = serve_traces()["s8"]
    small = fit_rung(healthy, 15.0, 5.0)
    cfg = ServeConfig(buckets=(small, burner_rung), batch_size=SERVE_BATCH,
                      window_sec=15.0, stride_sec=5.0, stream_queue_slots=SHED_SLOTS)
    landed = {name: rungs_of(tr, cfg) for name, tr in (*healthy.items(), ("burner", burner))}
    if any(set(landed[sid]) != {small} for sid in healthy) \
            or landed["burner"].get(burner_rung, 0) < 0.9 * sum(landed["burner"].values()):
        _fail(f"devtime shed leg: windows by rung {landed} (small {small}, burner "
              f"{burner_rung})")
    reg = MetricsRegistry(namespace="devtime_shed")
    journal = EventJournal(capacity=65536, registry=reg)
    window_log = []
    svc = _counting_service(per="batch")(cli._load_model(model_dir, "cuda"), cfg,
                                         registry=reg, journal=journal, device="cuda",
                                         window_log=window_log)
    svc.start()
    # what each stream's queue overflows met, by feeder: the pressure
    # gate's answer, the victim ranked (the burner, or another), a window
    # shed (read from the service's own calls)
    seen = {}
    pressure_of, victim_of, shed_of = (svc._shed_pressure, svc._select_shed_victim,
                                       svc._shed_one)

    def tally(key, hit=True):
        name = threading.current_thread().name.removeprefix("feeder-")
        per = seen.setdefault(name, {"overflows": 0, "pressure": 0, "victim": 0,
                                     "victim_other": 0, "shed": 0})
        per[key] += bool(hit)
        return hit

    def shed_pressure():
        tally("overflows")
        return tally("pressure", pressure_of())

    def select_victim(base):
        picked = victim_of(base)
        if picked is not None:
            tally("victim" if picked[0].id == "burner" else "victim_other")
        return picked

    svc._shed_pressure = shed_pressure
    svc._select_shed_victim = select_victim
    svc._shed_one = lambda base: tally("shed", shed_of(base))
    refs = {sid: model_detect(tr, model, ds_cfg=cfg.dataset_config(small),
                              auto_capacity=False, batch_size=SERVE_BATCH,
                              device="cuda").file_scores for sid, tr in healthy.items()}
    dets, errors, stop = {}, [], threading.Event()
    fed = {"windows": 0, "seconds": 0.0, "loops": 0}
    span_ns = int(burner.events.ts_ns.max() - burner.events.ts_ns.min()) + 10 ** 9 \
        * int(cfg.window_sec)

    def burn():
        try:
            svc.join("burner")
            t0 = time.perf_counter()
            while not stop.is_set():
                for block in _blocks(burner, size=SERVE_BLOCK):
                    if stop.is_set():
                        break
                    fed["windows"] += svc.feed(
                        "burner", _shifted(block, fed["loops"] * span_ns), burner.strings)
                    # hold the offered rate at `rate` windows/s
                    ahead = fed["windows"] / rate - (time.perf_counter() - t0)
                    if ahead > 0:
                        time.sleep(ahead)
                fed["loops"] += 1
            fed["seconds"] = time.perf_counter() - t0
            svc.leave("burner", flush=False, timeout=120.0)
        except Exception as e:  # noqa: BLE001 — raised below, on the caller
            errors.append(e)

    paced = {}

    def heal(sid, trace):
        try:
            svc.join(sid)
            h = svc._streams[sid]
            tm = paced.setdefault(sid, {"feed_s": 0.0, "wait_s": 0.0, "max_live": 0})
            for i, block in enumerate(_window_blocks(trace, cfg.window_sec,
                                                     cfg.stride_sec)):
                t1 = time.perf_counter()
                with h.cond:
                    # the first windows one at a time (a stream's steady
                    # state, not three feeders' joint cold start), then
                    # at the service's pace
                    while (i <= SHED_OPENING and h.live) or (
                            len(h.live) >= SHED_SLOTS
                            and any(not r.inflight for r in h.live.values())):
                        h.cond.wait(timeout=0.005)
                t2 = time.perf_counter()
                svc.feed(sid, block, trace.strings)
                tm["wait_s"] += t2 - t1
                tm["feed_s"] += time.perf_counter() - t2
                tm["max_live"] = max(tm["max_live"], len(h.live))
            with h.cond:  # the leave's flush closes up to 3 windows at once
                while h.live:
                    h.cond.wait(timeout=0.25)
            dets[sid] = svc.leave(sid, timeout=300.0)
        except Exception as e:  # noqa: BLE001 — raised below, on the caller
            errors.append(e)

    t0 = time.perf_counter()
    n_batch = len(svc.batch_launches)
    bt = threading.Thread(target=burn, name="feeder-burner")
    bt.start()
    pressure_s = None
    try:
        while time.perf_counter() - t0 < SHED_LEG_MAX_S and not errors:
            est = svc.devtime.last_estimate
            burns = svc.slo.snapshot()["per_stream"].get("burner", {})
            if est is not None and est.headroom_streams < cfg.shed_headroom_margin \
                    and (burns.get("budget_burn") or {}).get("device"):
                pressure_s = time.perf_counter() - t0
                break
            time.sleep(0.05)
        if pressure_s is None:
            _fail(f"devtime shed leg: no pressure in {SHED_LEG_MAX_S} s "
                  f"(estimate {svc.devtime.last_estimate}, burner fed {fed})")
        hts = [threading.Thread(target=heal, args=(sid, tr), name=f"feeder-{sid}")
               for sid, tr in healthy.items()]
        for t in hts:
            t.start()
        for t in hts:
            t.join(timeout=max(SHED_LEG_MAX_S - (time.perf_counter() - t0), 1.0))
    finally:
        stop.set()
        bt.join(timeout=180.0)
        wall = time.perf_counter() - t0
        svc.stop()
    if errors:
        raise errors[0]
    sheds = journal.tail(kinds=("fleet_shed",))
    drops = {r: _counter_total(reg, "serve_admission_dropped_total", reason=r)
             for r in ("backpressure", "shed", "oversize", "quarantined", "closed",
                       "leave")}
    healthy_drops = [r.to_dict() for r in journal.tail(kinds=("admission_drop",))
                     if r.stream in healthy]
    sat = journal.tail(kinds=("capacity_saturation",))
    per_batch = svc.batch_launches[n_batch:]
    counted = _counter_total(reg, "fleet_shed_total")
    differs = [sid for sid in healthy if dets.get(sid) is None
               or dets[sid].file_scores != refs[sid]]
    burner_rate = fed["windows"] / max(fed["seconds"], 1e-9)
    if not sat or any(r.stream != "burner" for r in sheds) \
            or any(v["victim_other"] for v in seen.values()) \
            or counted != len(sheds) or drops["shed"] != len(sheds) \
            or healthy_drops or differs or wall > SHED_LEG_MAX_S + 30 \
            or any(b != per_forward for b in per_batch) or burner_rate < 0.95 * rate:
        _fail(f"devtime shed leg: {len(sat)} capacity_saturation, {len(sheds)} "
              f"fleet_shed (victims {sorted({r.stream for r in sheds})}), counter "
              f"{counted}, drops {drops}, healthy drops {healthy_drops[:3]}, "
              f"differ {differs}, {wall:.1f} s, burner fed {fed} ({burner_rate:.2f} "
              f"windows/s of {rate:.2f}), overflows {seen}, paced {paced}, latency "
              f"{ {sid: _pcts([e[2] for e in window_log if e[0] == sid]) for sid in healthy} }")
    return dict(seconds=wall, pressure_s=pressure_s, rate=rate, burner_rate=burner_rate,
                burner_fed=fed["windows"], burner_feed_s=fed["seconds"],
                sheds=len(sheds), overflows=seen, paced=paced,
                healthy_latency_ms={sid: _pcts([e[2] for e in window_log if e[0] == sid])
                                    for sid in healthy},
                drops=drops,
                saturation_records=len(sat),
                healthy_windows={sid: len(d.file_scores) for sid, d in dets.items()},
                rankings=[r.data["ranking"][:2] for r in sheds[:3]],
                small_rung=list(small), batches=len(per_batch),
                headroom=svc.devtime.last_estimate.to_dict()
                if svc.devtime.last_estimate else None)


def fit_rung(traces: dict, window_sec: float, stride_sec: float) -> tuple:
    """The least rung ``fit_capacity`` gives over ``traces`` at this
    windowing (grown from 16 nodes and edges and 8 sequences)."""
    from nerrf_tpu_torch.graph import GraphConfig
    from nerrf_tpu_torch.pipeline import fit_capacity
    from nerrf_tpu_torch.train.data import DatasetConfig

    ds = DatasetConfig(graph=GraphConfig(window_sec=window_sec, stride_sec=stride_sec,
                                         max_nodes=16, max_edges=16), max_seqs=8)
    fits = [fit_capacity(tr, ds) for tr in traces.values()]
    return (max(f.graph.max_nodes for f in fits), max(f.graph.max_edges for f in fits),
            max(f.max_seqs for f in fits))


def rungs_of(trace, cfg) -> dict:
    """{rung: windows} of ``trace``'s windows as serve's admission selects
    them (``select_bucket`` over ``cfg``'s ladder)."""
    import numpy as np

    from nerrf_tpu_torch.graph.builder import measure_window, snapshot_windows
    from nerrf_tpu_torch.serve.config import select_bucket

    ev = trace.events
    ts = ev.ts_ns[ev.valid]
    out = {}
    graph = cfg.dataset_config(cfg.buckets[0]).graph
    for lo, hi in snapshot_windows(int(ts.min()), int(ts.max()), graph):
        n, e = measure_window(ev, lo, hi)
        sel = ev.valid & (ev.ts_ns >= lo) & (ev.ts_ns < hi)
        files = len(np.unique(ev.inode[sel & (ev.inode > 0)]))
        b = select_bucket(n, e, files, cfg.buckets)
        out[b] = out.get(b, 0) + 1
    return out


def devtime_train_probe() -> dict:
    """A 5-step ``train_nerrfnet`` at the training rung: its train MFU gauge
    (``device_mfu{program="train_step"}``) and steps/s."""
    import dataclasses

    from nerrf_tpu_torch.train.loop import train_nerrfnet

    _traces, ds, cfg = train_rung()
    res = train_nerrfnet(ds, cfg=dataclasses.replace(cfg, num_steps=5), device="cuda")
    return train_mfu_reading(res.steps_per_sec)


def train_mfu_reading(steps_per_sec: float) -> dict:
    """The train MFU gauge of the last ``train_nerrfnet`` run, beside its
    steps/s (None where the gauge is absent)."""
    from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

    labels = {"program": "train_step"}
    present = _gauge_present(DEFAULT_REGISTRY, "device_mfu", **labels)
    return dict(mfu=DEFAULT_REGISTRY.value("device_mfu", labels=labels) if present else None,
                intensity=DEFAULT_REGISTRY.value("device_roofline_intensity", labels=labels),
                steps_per_sec=steps_per_sec)

# --- the chaos plane and the ladder tuner (ROADMAP A.6) ----------------------------

CHAOS_STREAMS = 3               # run_chaos_bench.py --smoke: 3 streams + the drain
CHAOS_SIM_SECONDS = 25.0
CHAOS_DEADLINE_SEC = 2.0
CHAOS_SLO_X = 6                 # worst stream p99 within the deadline x 6
CHAOS_POISON_STREAM, CHAOS_WIRE_STREAM = "s1", "w0"
CHAOS_BURST = (3, 30.0)         # drop-burst trigger: records, seconds
# the plane disarmed and armed with an empty plan, after one warm turn (on
# the card the first replay after the baseline's connects read half the
# others' windows/s)
CHAOS_TURNS = ("warm", "off", "on", "off", "on")
CHAOS_NAN_AT = 3                # the train.nonfinite_grad leg's armed step
CHAOS_RECORD = os.path.join(ROOT, "benchmarks", "results", "chaos_bench_cpu.json")
TUNE_RECORD = os.path.join(ROOT, "benchmarks", "results", "tune_bench_cpu.json")
TUNE_STATIC = ((1024, 2048, 128), (4096, 8192, 256))   # run_tune_bench.py's
TUNE_STREAMS, TUNE_SIM_SECONDS = 2, 30.0               # its --smoke
TUNE_MAX_RUNGS = 3
# the three-mode boot: one rung per mode, each with one stream landing on it
TUNE_MODES = (((256, 512, 64), "dense_adj"), ((1024, 2048, 128), "segment"),
              ((4096, 8192, 256), "fused"))


def chaos_plan(wire_target: str):
    """run_chaos_bench.py's ``build_plan`` (seed 42, the full run's 0.2 s
    latency) less its ``compilecache.corrupt_payload`` spec, which waits
    for the compile cache (ROADMAP A.7)."""
    from nerrf_tpu_torch import chaos

    return chaos.FaultPlan(seed=42, faults=(
        chaos.FaultSpec(site="serve.poison_window", prob=0.4,
                        match={"stream": CHAOS_POISON_STREAM}),
        chaos.FaultSpec(site="ingest.wire_error", every=5,
                        match={"target": wire_target}),
        chaos.FaultSpec(site="serve.device_latency", mode="stall", every=4,
                        delay_sec=0.2),
        chaos.FaultSpec(site="alerts.slow_consumer", mode="stall", at=1,
                        delay_sec=0.3),
        chaos.FaultSpec(site="flight.disk_full", at=1, max_fires=1),
    ))


def match_recoveries(records) -> dict:
    """run_chaos_bench.py's join of every injected fault to its recovery
    record in the same journal, per site: the poison to a terminal
    ``device_batch_failed`` of its trace ID, a wire error to a later
    ``reconnect`` (the final session's may have none), the disk-full dump to
    a later ``bundle``, a stall to any later progress record."""
    by_kind: dict = {}
    for r in records:
        by_kind.setdefault(r.kind, []).append(r)
    fault_recs = by_kind.get("fault_injected", [])

    def later_progress(seq):
        return any(r.seq > seq for k in ("batch_close", "readiness", "chaos_disarmed")
                   for r in by_kind.get(k, []))

    out = {}
    for rec in fault_recs:
        site = rec.data.get("site")
        entry = out.setdefault(site, {"injected": 0, "recovered": 0, "unmatched": []})
        entry["injected"] += 1
        ok = False
        if site == "serve.poison_window":
            ok = any(d.trace_id == rec.trace_id
                     for d in by_kind.get("device_batch_failed", []))
        elif site == "ingest.wire_error":
            ok = any(r.seq > rec.seq for r in by_kind.get("reconnect", []))
        elif site == "flight.disk_full":
            ok = any(r.seq > rec.seq for r in by_kind.get("bundle", []))
        elif site in ("serve.device_latency", "alerts.slow_consumer",
                      "ingest.wire_stall", "serve.device_error"):
            ok = later_progress(rec.seq)
        if ok:
            entry["recovered"] += 1
        else:
            entry["unmatched"].append({"seq": rec.seq, "trace_id": rec.trace_id,
                                       "stream": rec.stream})
    wire = out.get("ingest.wire_error")
    if wire and len(wire["unmatched"]) == 1 and wire["unmatched"][0]["seq"] == max(
            (r.seq for r in fault_recs if r.data.get("site") == "ingest.wire_error"),
            default=-1):
        wire["recovered"] += 1
        wire["final_session_allowance"] = wire["unmatched"].pop()
    out["all_recovered"] = all(v["recovered"] >= v["injected"]
                               for v in out.values() if isinstance(v, dict))
    return out


def drop_bursts(records, n: int, window_sec: float) -> int:
    """run_chaos_bench.py's count of distinct drop bursts (at least ``n``
    loss records inside a sliding window of ``window_sec``)."""
    from nerrf_tpu_torch.flight.recorder import DROP_KINDS

    times = sorted(r.t_perf for r in records if r.kind in DROP_KINDS)
    bursts, i, last_end = 0, 0, None
    for j in range(len(times)):
        while times[j] - times[i] > window_sec:
            i += 1
        if j - i + 1 >= n:
            if last_end is None or times[i] > last_end:
                bursts += 1
            last_end = times[j]
    return bursts


def forward_launches(mode: str, num_layers: int) -> dict:
    """Kernel launches of one forward of a batch in ``mode``, derived from the
    model.  ``fused``: :func:`fused_forward_launches`.  ``dense_adj``: the same
    precompute (four sums) and the dense adjacency's run sums (one more
    ``segment_sum_sorted``), each layer one matmul and no kernel, the fusion
    and the edge head as ``fused``.  ``segment``: per layer 2 ``gather_rows``
    and 2 weighted banded segment means (2 ``segment_sum_sorted`` each), the
    edge head's 2 ``gather_rows``, the fusion's ``segment_sum``, no
    precompute (:func:`train_launches`'s forward)."""
    if mode == "fused":
        return fused_forward_launches(num_layers)
    if mode == "dense_adj":
        return {"sage_aggregate": 0, "gather_rows": 2, "segment_sum": 3,
                "segment_sum_sorted": 3, "gather_rows_sorted": 0}
    return train_launches(num_layers, 0, 1)


@contextlib.contextmanager
def forwards_recorded():
    """Every serve forward's node rung and kernel launches while the block
    runs, as [(nodes, launches)]: ``OnlineDetectionService._run_eval`` wrapped
    on the class, so services the CLI builds are counted too (one thread
    launches at a time: ``start()``'s warmup, then the scorer)."""
    from nerrf_tpu_torch.ops import LAUNCHES
    from nerrf_tpu_torch.serve import OnlineDetectionService

    real, seen = OnlineDetectionService._run_eval, []

    def counted(self, eval_fn, batch):
        before = dict(LAUNCHES)
        out = real(self, eval_fn, batch)
        seen.append((int(batch["node_mask"].shape[1]),
                     {k: LAUNCHES[k] - before[k] for k in LAUNCHES}))
        return out

    OnlineDetectionService._run_eval = counted
    try:
        yield seen
    finally:
        OnlineDetectionService._run_eval = real


def _chaos_traces():
    """run_chaos_bench.py's streams at its --smoke size: CHAOS_STREAMS of
    CHAOS_SIM_SECONDS (attack on the even ones, 4 files, 6 Hz) and the
    resident drain's half-length benign trace."""
    from nerrf_tpu_torch.data import SimConfig, simulate_trace

    traces = {f"s{i}": simulate_trace(SimConfig(
        duration_sec=CHAOS_SIM_SECONDS, attack=(i % 2 == 0),
        attack_start_sec=CHAOS_SIM_SECONDS / 3, num_target_files=4,
        benign_rate_hz=6.0, seed=2000 + 131 * i)) for i in range(CHAOS_STREAMS)}
    wire = simulate_trace(SimConfig(duration_sec=CHAOS_SIM_SECONDS / 2, attack=False,
                                    benign_rate_hz=6.0, seed=9999))
    return traces, wire


def _chaos_accounting(records, ctl, reg, tag) -> dict:
    """The faulted leg's figures and its launch gate: the scoring attempts
    (each closed batch once, each bisection's two halves, each confirm
    re-run of an isolated window: the ``device_batch_failed`` records marked
    poison) less the failed ones (``batch_failed``: every fault in the plan
    raises before the forward) are the forwards that ran."""
    kinds = {}
    for r in records:
        kinds.setdefault(r.kind, []).append(r)
    n = {k: len(kinds.get(k, [])) for k in ("batch_close", "batch_bisect",
                                             "batch_failed", "device_batch_failed")}
    confirms = sum(1 for r in kinds.get("device_batch_failed", [])
                   if r.data.get("poison"))
    attempts = n["batch_close"] + 2 * n["batch_bisect"] + confirms
    forwards = attempts - n["batch_failed"]
    fired = {}
    for site, _, _ in ctl.fired:
        fired[site] = fired.get(site, 0) + 1
    return dict(counts=n, confirms=confirms, attempts=attempts, forwards=forwards,
                faults_injected=fired,
                poisoned=sorted({k for s, k, _ in ctl.fired
                                 if s == "serve.poison_window"}),
                isolated=sorted({r.trace_id for r in kinds.get("device_batch_failed", [])}),
                foreign_failed=sorted({r.stream for r in kinds.get("device_batch_failed", [])
                                       if r.stream != CHAOS_POISON_STREAM}),
                bisections=int(reg.value("serve_poison_bisections_total",
                                         labels={"bucket": tag})),
                reconnects=int(reg.value("serve_reconnects_total",
                                         labels={"stream": CHAOS_WIRE_STREAM})),
                recompiles=int(reg.value("serve_recompiles_total", labels={"bucket": tag})))


def _worst_p99(svc):
    per = (svc.slo.snapshot().get("per_stream") or {}).values()
    return max((s["p99_ms"] for s in per if s.get("p99_ms") is not None), default=None)


def run_chaos_path(ds, cfg) -> dict:
    """run_chaos_bench.py's --smoke on the card, less the compile-cache leg
    (A.7): the full-width seeded model at the serve rung, CHAOS_STREAMS
    streams over the wire and a resident (follow-mode) drain, first
    unfaulted (the p99 of reference, then the plane disarmed and armed with
    an empty plan in turns), then under the seeded plan with a flight
    recorder; every survival gate of the reference's ``gates()`` but its
    zero-recompile one, which the launch gate replaces; then the
    ``train.nonfinite_grad`` leg (:func:`run_nonfinite_leg`)."""
    import tempfile

    from nerrf_tpu_torch import chaos
    from nerrf_tpu_torch.data import Trace
    from nerrf_tpu_torch.flight import FlightConfig, FlightRecorder
    from nerrf_tpu_torch.flight.journal import EventJournal
    from nerrf_tpu_torch.ingest.service import TraceReplayServer, TrackerClient
    from nerrf_tpu_torch.models import JointConfig, build_nerrfnet
    from nerrf_tpu_torch.observability import MetricsRegistry
    from nerrf_tpu_torch.pipeline import model_detect
    from nerrf_tpu_torch.serve import ServeConfig, bucket_tag

    t_phase = time.perf_counter()
    model_cfg = JointConfig()
    L = model_cfg.gnn.num_layers
    model = build_nerrfnet(model_cfg, seed=0, device="cuda")
    bucket = (MAIN_N, MAIN_E, SEQ_S)
    tag = bucket_tag(bucket)
    per_forward = fused_forward_launches(L)
    cfg_serve = ServeConfig(
        buckets=(bucket,), batch_size=SERVE_BATCH, batch_close_sec=0.25,
        window_sec=15.0, stride_sec=5.0, stream_queue_slots=512,
        alert_queue_slots=2, window_deadline_sec=CHAOS_DEADLINE_SEC,
        bisect_failed_batches=True, quarantine_strikes=16, scorer_wedge_sec=60.0)
    traces, wire_tr = _chaos_traces()
    servers = {sid: TraceReplayServer(tr.events, tr.strings, batch_size=64)
               for sid, tr in traces.items()}
    servers[CHAOS_WIRE_STREAM] = TraceReplayServer(wire_tr.events, wire_tr.strings,
                                                   batch_size=32)
    targets = {sid: f"127.0.0.1:{srv.start()}" for sid, srv in servers.items()}
    flight_dir = tempfile.mkdtemp(prefix="nerrf-chaos-flight-")
    if chaos.armed():
        _fail("chaos: a plan is armed before the chaos phase")
    try:
        # -- unfaulted: the baseline p99, then disarmed / empty plan in turns
        base_reg = MetricsRegistry(namespace="chaosbase")
        base = _counting_service()(model, cfg_serve, registry=base_reg,
                                   journal=EventJournal(capacity=8192, registry=base_reg),
                                   device="cuda")
        base.start()
        runs = [base.connect(sid, targets[sid], timeout=300.0) for sid in traces]
        for r in runs:
            r.done.wait(timeout=600.0)
        if any(r.error for r in runs):
            _fail(f"chaos baseline: stream errors {[repr(r.error) for r in runs]}")
        baseline_p99 = _worst_p99(base)
        turns = []
        for i, turn in enumerate(CHAOS_TURNS):
            before = _counter_total(base_reg, "serve_windows_scored_total")
            if turn == "on":
                chaos.arm(chaos.FaultPlan(seed=0, faults=()), registry=base_reg)
            try:
                _, wall = replay(base, traces, suffix=f"-{i}")
            finally:
                chaos.disarm()
            windows = _counter_total(base_reg, "serve_windows_scored_total") - before
            turns.append({"turn": turn, "windows": int(windows), "wall_s": wall,
                          "windows_per_s": windows / wall})
        base.stop()
        turns = turns[1:]
        if any(b != per_forward for b in base.batch_launches):
            _fail(f"chaos baseline: launches per forward {base.batch_launches} != "
                  f"{per_forward} (disarmed and empty-plan turns)")
        print(f"chaos baseline ({len(traces)} streams at {tag}, unfaulted): worst "
              f"p99 {baseline_p99} ms; windows/s disarmed / armed with an empty "
              f"plan in turns {json.dumps(turns)}; {len(base.batch_launches)} "
              f"forwards, each {per_forward}")

        # -- the faulted leg
        reg = MetricsRegistry(namespace="chaosbench")
        journal = EventJournal(capacity=16384, registry=reg)
        svc = _counting_service()(model, cfg_serve, registry=reg, journal=journal,
                                  device="cuda")
        svc.start()
        recorder = FlightRecorder(
            FlightConfig(out_dir=flight_dir, p99_breach_sec=None,
                         drop_burst_n=CHAOS_BURST[0], drop_burst_sec=CHAOS_BURST[1],
                         min_interval_sec=300.0),
            registry=reg, journal=journal, slo=svc.slo, info=svc.flight_info)
        svc.attach_flight(recorder)
        plan = chaos_plan(targets[CHAOS_WIRE_STREAM])
        _sync()
        ctl = chaos.arm(plan, registry=reg, journal=journal)
        t0 = time.perf_counter()
        try:
            runs = {sid: svc.connect(sid, targets[sid], timeout=300.0) for sid in traces}
            wire_run = svc.connect(CHAOS_WIRE_STREAM, targets[CHAOS_WIRE_STREAM],
                                   timeout=300.0, follow=True, reconnect_sec=0.05,
                                   reconnect_max_sec=1.0)
            for r in runs.values():
                r.done.wait(timeout=600.0)
            # the operator console drains the alert sink once, slowly
            drained = len(svc.sink.drain())
            svc.stop(drain=True)
            wire_run.done.wait(timeout=60.0)
        finally:
            chaos.disarm()
            recorder.close()
            svc.stop(drain=False)
        wall = time.perf_counter() - t0
        records = journal.tail()
        acc = _chaos_accounting(records, ctl, reg, tag)
        recoveries = match_recoveries(records)
        bursts = drop_bursts(records, *CHAOS_BURST)
        bundles = sorted(p for p in os.listdir(flight_dir)
                         if p.startswith("bundle-") and not p.endswith(".tmp"))
        worst = _worst_p99(svc)
        errors = {sid: repr(r.error) for sid, r in runs.items() if r.error}
        forwards_run = svc.batch_launches[1:]

        # parity of an unfaulted stream with model_detect, on the wire's events
        ref_events, ref_strings = TrackerClient(targets["s0"]).stream(timeout=60.0)
        offline = model_detect(Trace(events=ref_events, strings=ref_strings,
                                     ground_truth=None, labels=None, name="s0"),
                               model, ds_cfg=cfg_serve.dataset_config(bucket),
                               auto_capacity=False, batch_size=SERVE_BATCH,
                               device="cuda")
        served = runs["s0"].result
        fields = ("file_scores", "file_window_scores", "proc_scores", "threshold")
        parity = served is not None and all(
            getattr(served, f) == getattr(offline, f) for f in fields)
    finally:
        for srv in servers.values():
            srv.stop()
        shutil.rmtree(flight_dir, ignore_errors=True)
    limit_ms = CHAOS_DEADLINE_SEC * CHAOS_SLO_X * 1e3
    gates = {
        "no_crash": not errors,
        "windows_scored": _counter_total(reg, "serve_windows_scored_total") > 0,
        "poison_injected": bool(acc["poisoned"]),
        "bisection_isolated_exactly_injected": acc["isolated"] == acc["poisoned"],
        "unfaulted_streams_lost_nothing": acc["foreign_failed"] == [],
        "unfaulted_parity_bit_identical": parity,
        "slo_bounded": worst is not None and worst <= limit_ms,
        "reconnects_happened": acc["reconnects"] > 0,
        "bundle_per_drop_burst": bursts > 0 and len(bundles) >= 1,
        "disk_full_survived": acc["faults_injected"].get("flight.disk_full", 0) == 1
        and len(bundles) >= 1,
        "all_faults_recovered": recoveries["all_recovered"],
        "zero_unwarmed_shapes": acc["recompiles"] == 0,
        "launch_gate": len(forwards_run) == acc["forwards"]
        and all(b == per_forward for b in forwards_run),
        "every_failed_attempt_injected": acc["counts"]["batch_failed"]
        == acc["faults_injected"].get("serve.poison_window", 0),
    }
    with open(CHAOS_RECORD) as f:
        record = json.load(f)
    out = dict(
        streams=len(traces) + 1, wall_s=wall, drained_alerts=drained,
        faults_injected=acc["faults_injected"],
        recoveries={k: v for k, v in recoveries.items() if k != "all_recovered"},
        bisections=acc["bisections"], isolated=len(acc["isolated"]),
        reconnects=acc["reconnects"], bundles=bundles, drop_bursts=bursts,
        slo={"worst_stream_p99_ms": worst, "baseline_unfaulted_p99_ms": baseline_p99,
             "degradation_x": (round(worst / baseline_p99, 2)
                               if worst and baseline_p99 else None),
             "limit_ms": limit_ms},
        forwards=acc["forwards"], attempts=acc["attempts"], counts=acc["counts"],
        launches={k: sum(b[k] for b in forwards_run) for k in per_forward},
        turns=turns, gates=gates,
        record={k: record[k] for k in ("faults_injected", "reconnects")}
        | {"bisections": record["bisection"]["bisections"],
           "degradation_x": record["slo"]["degradation_x"]})
    print(f"chaos leg ({len(traces)} streams + the resident drain at {tag}, "
          f"{wall:.1f} s): faults injected {json.dumps(acc['faults_injected'])}, "
          f"recoveries {json.dumps(out['recoveries'])}; {acc['bisections']} "
          f"bisections isolated {len(acc['isolated'])} windows (injected "
          f"{len(acc['poisoned'])}); {acc['reconnects']} reconnects; bundles "
          f"{bundles} for {bursts} drop bursts; worst p99 {worst} ms against the "
          f"unfaulted {baseline_p99} ms (limit {limit_ms:.0f}); forwards "
          f"{acc['forwards']} = attempts {acc['attempts']} ({json.dumps(acc['counts'])}, "
          f"{acc['confirms']} confirms) less failed, each {per_forward}; beside the "
          f"record {json.dumps(out['record'])}; gates {json.dumps(gates)}")
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        _fail(f"chaos leg: gates {bad} failed: {json.dumps(out, default=str)}")
    out["nonfinite"] = run_nonfinite_leg(ds, cfg)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def run_nonfinite_leg(ds, cfg) -> dict:
    """``train.nonfinite_grad`` on the card: armed at step CHAOS_NAN_AT of a
    streamed ``fused`` ``train_nerrfnet`` of the training rung with a
    ``TrainHealthMonitor`` and a flight recorder: one ``train_divergence``
    bundle, the halt at that step, the metrics empty, and the steps run x
    :func:`step_launches` (no evaluation after a halt)."""
    import dataclasses
    import tempfile

    from nerrf_tpu_torch import chaos
    from nerrf_tpu_torch.flight import FlightConfig, FlightRecorder
    from nerrf_tpu_torch.ops import LAUNCHES
    from nerrf_tpu_torch.train.loop import train_nerrfnet
    from nerrf_tpu_torch.trainwatch import TrainHealthMonitor

    fused = dataclasses.replace(cfg.model, gnn=dataclasses.replace(
        cfg.model.gnn, aggregation="fused"))
    ncfg = dataclasses.replace(cfg, model=fused, num_steps=NAN_STEPS, eval_every=1,
                               telemetry=True)
    out_dir = tempfile.mkdtemp(prefix="nerrf-chaos-nan-")
    logs = []
    monitor = TrainHealthMonitor(log=logs.append)
    recorder = FlightRecorder(FlightConfig(out_dir=out_dir, p99_breach_sec=None))
    monitor.attach_flight(recorder)
    prev = os.environ.get("NERRF_RESIDENT_MAX_BYTES")
    os.environ["NERRF_RESIDENT_MAX_BYTES"] = "0"   # the streamed flavor
    try:
        ctl = chaos.arm(chaos.FaultPlan(seed=0, faults=(chaos.FaultSpec(
            site="train.nonfinite_grad", mode="corrupt",
            match={"step": CHAOS_NAN_AT}),)))
        _reset_counts()
        res = train_nerrfnet(ds, cfg=ncfg, device="cuda", monitor=monitor,
                             log=logs.append)
        _sync()
        launches = {k: LAUNCHES[k] for k in LAUNCHES}
    finally:
        chaos.disarm()
        recorder.close()
        if prev is None:
            os.environ.pop("NERRF_RESIDENT_MAX_BYTES", None)
        else:
            os.environ["NERRF_RESIDENT_MAX_BYTES"] = prev
    bundles = sorted(os.listdir(out_dir))
    shutil.rmtree(out_dir, ignore_errors=True)
    steps = len(res.history)
    want = {k: (CHAOS_NAN_AT + 1) * v
            for k, v in step_launches("fused", fused.gnn.num_layers).items()}
    print(f"chaos train.nonfinite_grad: armed at step {CHAOS_NAN_AT}, fired "
          f"{[(s, k) for s, k, _ in ctl.fired]}; halted after {steps} steps "
          f"({monitor.diverged}); bundles {bundles}; launches {launches} (derived "
          f"{want})")
    if ([h["step"] for h in res.history] != list(range(CHAOS_NAN_AT + 1))
            or res.metrics != {} or monitor.diverged is None
            or monitor.diverged[0] != CHAOS_NAN_AT or len(bundles) != 1
            or not bundles[0].endswith("train_divergence") or launches != want
            or len(ctl.fired) != 1):
        _fail(f"chaos train.nonfinite_grad: history {res.history}, metrics "
              f"{res.metrics}, diverged {monitor.diverged}, bundles {bundles}, "
              f"launches {launches} != {want}, fired {ctl.fired}")
    return dict(step=CHAOS_NAN_AT, steps=steps, bundles=bundles, launches=launches)


def _tune_mix():
    """run_tune_bench.py's skewed mix at its --smoke size: TUNE_STREAMS small
    streams (4-24 Hz, 3-11 files), and its parity stream (1.5 Hz, 3 files)."""
    from nerrf_tpu_torch.data import SimConfig, simulate_trace

    mix = {f"p{i}": simulate_trace(SimConfig(
        duration_sec=TUNE_SIM_SECONDS, attack=(i % 2 == 0),
        attack_start_sec=TUNE_SIM_SECONDS / 3, num_target_files=3 + 4 * (i % 3),
        benign_rate_hz=4.0 + 10.0 * (i % 3), seed=2000 + 131 * i))
        for i in range(TUNE_STREAMS)}
    parity = simulate_trace(SimConfig(duration_sec=min(TUNE_SIM_SECONDS, 45.0),
                                      attack=False, num_target_files=3,
                                      benign_rate_hz=1.5, seed=7))
    return mix, parity


def _stream_on_rung(rung, ladder, cfg, tried: list):
    """A simulated stream every window of which serve's admission puts on
    ``rung`` of ``ladder`` (:func:`rungs_of`), from a fixed list of rates
    and file counts, so a served stream's windows share model_detect's
    bucket."""
    from nerrf_tpu_torch.data import SimConfig, simulate_trace
    from nerrf_tpu_torch.serve import ServeConfig, bucket_tag

    for rate, files in ((1.5, 3), (6.0, 4), (20.0, 8), (40.0, 12), (80.0, 16),
                        (120.0, 24), (200.0, 48), (300.0, 48), (450.0, 48)):
        tr = simulate_trace(SimConfig(duration_sec=TUNE_SIM_SECONDS, attack=False,
                                      num_target_files=files, benign_rate_hz=rate,
                                      seed=11))
        got = rungs_of(tr, ServeConfig(buckets=ladder, window_sec=cfg.window_sec,
                                       stride_sec=cfg.stride_sec))
        tried.append((rate, files, {bucket_tag(b) if b else None: n
                                    for b, n in got.items()}))
        if set(got) == {tuple(rung)}:
            return tr
    return None


def _served_equals_model_detect(out_dir, stream_file, model, ds_cfg, threshold):
    """The CLI's detection of ``stream_file`` (``serve-detect --out``) against
    ``model_detect`` of the same file at ``ds_cfg``: file and process scores
    and the threshold, bit for bit."""
    from nerrf_tpu_torch.data.loaders import load_trace_jsonl
    from nerrf_tpu_torch.pipeline import model_detect

    want = model_detect(load_trace_jsonl(stream_file), model, ds_cfg=ds_cfg,
                        auto_capacity=False, batch_size=SERVE_BATCH,
                        threshold=threshold, device="cuda")
    [got] = [json.loads(p.read_text()) for p in out_dir.glob("detect_*.json")
             if p.stem.endswith(stream_file.stem)]
    return (got["file_scores"] == want.file_scores
            and got["proc_scores"] == {str(k): v for k, v in want.proc_scores.items()}
            and got["threshold"] == want.threshold)


def _routed_model(model_dir, art):
    """The checkpoint under ``art``'s routing, as ``serve-detect --tuned``
    builds it."""
    import torch

    from nerrf_tpu_torch import cli
    from nerrf_tpu_torch.models import NerrfNet
    from nerrf_tpu_torch.tune import apply_to_model_config

    base = cli._load_model(model_dir, torch.device("cuda"))
    with torch.device("cuda"):
        routed = NerrfNet(apply_to_model_config(art, base.cfg))
    routed.load_state_dict(base.state_dict(), strict=True)
    return routed.eval()


def _gate_forwards(what, seen, model_cfg, ladder) -> dict:
    """Every recorded forward launched its routed mode's derived counts, and
    the warmup ran one forward a rung of ``ladder``; returns {rung nodes:
    forwards}."""
    by = {}
    for nodes, got in seen:
        mode = model_cfg.gnn.resolved_aggregation(nodes)
        want = forward_launches(mode, model_cfg.gnn.num_layers)
        if got != want:
            _fail(f"{what}: a forward at {nodes} nodes ({mode}) launched {got} != {want}")
        by[nodes] = by.get(nodes, 0) + 1
    if sorted(n for n, _ in seen[:len(ladder)]) != sorted(b[0] for b in ladder):
        _fail(f"{what}: warmup forwards at {[n for n, _ in seen]} for rungs {ladder}")
    return by


def run_tune_path(model_dir: str) -> dict:
    """run_tune_bench.py --smoke through the port's command line on the card:
    measure (serve-detect on the coarse static ladder with --archive-dir),
    fit (archive export --tune, tune --model-dir, no kernel bench), re-serve
    (serve-detect --tuned, every tuned rung warmed, the parity stream bit-equal
    to model_detect under the tuned routing), and the three-mode boot (a fixed
    artifact routing 256 / 1024 / 4096 nodes to dense_adj / segment / fused, one
    stream a rung, each bit-equal to model_detect at its rung).  Every forward's
    launches are derived from its routed mode and gated."""
    import pathlib
    import tempfile

    from nerrf_tpu_torch.devtime import serve_program_costs
    from nerrf_tpu_torch.schema.events import events_to_jsonl
    from nerrf_tpu_torch.serve import ServeConfig, bucket_tag
    from nerrf_tpu_torch.train.checkpoint import load_calibration, load_checkpoint
    from nerrf_tpu_torch.tune import build_artifact, load_artifact, save_artifact, tune

    t_phase = time.perf_counter()
    root = pathlib.Path(tempfile.mkdtemp(prefix="nerrf-tune-"))
    _, model_cfg = load_checkpoint(model_dir)
    threshold = load_calibration(model_dir).get("node_threshold")
    L = model_cfg.gnn.num_layers
    mix, parity_tr = _tune_mix()
    files = {}
    for sid, tr in {**mix, "parity": parity_tr}.items():
        files[sid] = root / f"{sid}.jsonl"
        files[sid].write_text(events_to_jsonl(tr.events, tr.strings))
    try:
        # 1. measure: the skewed mix on the coarse static ladder, archived
        with forwards_recorded() as seen:
            rc, out, log = _cli_run(
                "serve-detect", "--model-dir", model_dir,
                *[a for sid in mix for a in ("--trace", files[sid])],
                "--buckets", *["x".join(map(str, b)) for b in TUNE_STATIC],
                "--batch-size", SERVE_BATCH, "--close-ms", 100, "--deadline-sec", 5,
                "--metrics-port", -1, "--archive-dir", root / "archive")
        if rc != 0 or not json.loads(out)["windows_scored"]:
            _fail(f"tune measure: serve-detect exit {rc}: {out[-2000:]} {log[-2000:]}")
        measured = _gate_forwards("tune measure", seen, model_cfg, TUNE_STATIC)
        # 2. fit: the corpus, then the tool, no kernel bench
        rc, _, log = _cli_run("archive", "export", root / "archive", "--tune",
                              "--out", root / "corpus.json")
        if rc != 0:
            _fail(f"tune: archive export --tune exit {rc}: {log[-2000:]}")
        corpus = json.loads((root / "corpus.json").read_text())
        t0 = time.perf_counter()
        rc, _, log = _cli_run("tune", root / "corpus.json", "--model-dir", model_dir,
                              "--max-rungs", TUNE_MAX_RUNGS, "--out", root / "tuned.json")
        fit_s = time.perf_counter() - t0
        if rc != 0:
            _fail(f"tune: exit {rc}: {log[-2000:]}")
        art = load_artifact(root / "tuned.json")
        # the same fit against the coarse static ladder it measured (the
        # reference bench's comparison; the analytic surface is memoized)
        import torch

        from nerrf_tpu_torch.models import NerrfNet

        with torch.device("meta"):
            analytic = {t: c.flops for t, c in serve_program_costs(
                NerrfNet(model_cfg), ServeConfig()).items()}
        vs_static = tune(corpus, model_cfg=model_cfg, analytic=analytic,
                         max_rungs=TUNE_MAX_RUNGS, static_buckets=TUNE_STATIC)
        exp, exp_s = art["expected"], vs_static["expected"]
        if not (exp_s["tuned_device_seconds_per_window"]
                < exp_s["static_device_seconds_per_window"]) \
                or exp["improvement"] < 0:
            _fail(f"tune: the tuned ladder does not beat the static one: {exp_s}, "
                  f"against the default ladder {exp}")
        # 3. re-serve on the tool's artifact
        tuned = tuple(tuple(b) for b in art["buckets"])
        routed = _routed_model(model_dir, art)
        cfg_t = ServeConfig(buckets=tuned)
        # the parity stream: the first whose windows all land on one tuned
        # rung (model_detect pads every window to one bucket)
        landing = {sid: rungs_of(tr, cfg_t) for sid, tr in
                   (("parity", parity_tr), *mix.items())}
        single = [sid for sid, got in landing.items()
                  if len(got) == 1 and None not in got]
        if not single:
            _fail(f"tune re-serve: no stream lands on one tuned rung: {landing}")
        parity_sid = single[0]
        [parity_rung] = landing[parity_sid]
        serve_sids = ["p0"] + ([parity_sid] if parity_sid != "p0" else [])
        with forwards_recorded() as seen:
            rc, out, log = _cli_run(
                "serve-detect", "--model-dir", model_dir, "--tuned", root / "tuned.json",
                *[a for sid in serve_sids for a in ("--trace", files[sid])],
                "--batch-size", SERVE_BATCH, "--metrics-port", -1,
                "--out", root / "reserve")
        if rc != 0 or not json.loads(out)["windows_scored"]:
            _fail(f"tune re-serve: serve-detect exit {rc}: {out[-2000:]} {log[-2000:]}")
        reserved = _gate_forwards("tune re-serve", seen, routed.cfg, tuned)
        if not _served_equals_model_detect(root / "reserve", files[parity_sid], routed,
                                           cfg_t.dataset_config(parity_rung), threshold):
            _fail(f"tune re-serve: stream {parity_sid} differs from model_detect")
        # 4. the three-mode boot
        ladder = tuple(b for b, _ in TUNE_MODES)
        art3 = build_artifact(ladder, tuple((b[0], m) for b, m in TUNE_MODES), {}, {})
        save_artifact(root / "modes.json", art3)
        routed3 = _routed_model(model_dir, art3)
        cfg3 = ServeConfig(buckets=ladder)
        tried, streams = [], {}
        for rung, mode in TUNE_MODES:
            tr = _stream_on_rung(rung, ladder, cfg3, tried)
            if tr is None:
                _fail(f"tune three-mode boot: no stream lands on {bucket_tag(rung)} "
                      f"alone: {tried}")
            streams[mode] = root / f"mode-{mode}.jsonl"
            streams[mode].write_text(events_to_jsonl(tr.events, tr.strings))
        with forwards_recorded() as seen:
            rc, out, log = _cli_run(
                "serve-detect", "--model-dir", model_dir, "--tuned", root / "modes.json",
                *[a for f in streams.values() for a in ("--trace", f)],
                "--batch-size", SERVE_BATCH, "--metrics-port", -1,
                "--out", root / "modes")
        if rc != 0:
            _fail(f"tune three-mode boot: serve-detect exit {rc}: {log[-2000:]}")
        modes = _gate_forwards("tune three-mode boot", seen, routed3.cfg, ladder)
        if sorted(modes) != sorted(b[0] for b in ladder) or any(
                modes[b[0]] < 2 for b in ladder):
            _fail(f"tune three-mode boot: forwards by rung {modes}")
        for rung, mode in TUNE_MODES:
            if not _served_equals_model_detect(root / "modes", streams[mode], routed3,
                                               cfg3.dataset_config(rung), threshold):
                _fail(f"tune three-mode boot: the {mode} stream differs from "
                      f"model_detect at {bucket_tag(rung)}")
        # the rung gate's verdict on every rung that launched here
        from nerrf_tpu_torch.graph.builder import NODE_FEATURE_DIM
        from nerrf_tpu_torch.ops.kernels import rung_limits

        width = max(model_cfg.gnn.hidden, NODE_FEATURE_DIM)
        refused = {bucket_tag(b): rung_limits(b[0], b[1], width, SERVE_BATCH)
                   for b in {*TUNE_STATIC, *tuned, *ladder}}
        refused = {t: v["refusals"] for t, v in refused.items() if not v["ok"]}
        if refused:
            _fail(f"tune: the rung gate refuses rungs that launched: {refused}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    with open(TUNE_RECORD) as f:
        record = json.load(f)
    per_rung = {tag: {k: row.get(k) for k in ("windows", "batches",
                                             "device_seconds_mean",
                                             "device_seconds_p99")}
                for tag, row in (corpus.get("bucket_cost") or {}).items()}
    out = dict(
        seconds=time.perf_counter() - t_phase, fit_s=fit_s,
        windows_measured=corpus.get("windows_observed"), bucket_cost=per_rung,
        fit={k: art["fit"][k] for k in ("alpha", "beta", "dense_gamma",
                                        "analytic_alpha", "measured_points",
                                        "demand_points", "candidates_scored")},
        tuned_ladder=[bucket_tag(b) for b in tuned], routing=art["routing"],
        expected=exp, vs_static={"static_ladder": [bucket_tag(b) for b in TUNE_STATIC],
                                 "tuned_ladder": vs_static["buckets"],
                                 "routing": vs_static["routing"], "expected": exp_s},
        forwards={"measure": measured, "reserve": reserved, "modes": modes},
        parity=(parity_sid, bucket_tag(parity_rung)),
        mode_launches={m: forward_launches(m, L) for _, m in TUNE_MODES},
        record={k: record[k] for k in ("static_ladder", "tuned_ladder", "routing",
                                       "expected")} | {"fit": {
                                           k: record["fit"][k] for k in (
                                               "alpha", "beta", "dense_gamma")}})
    print(f"tune leg ({out['seconds']:.1f} s): measured {out['windows_measured']} "
          f"windows on {[bucket_tag(b) for b in TUNE_STATIC]}, device seconds by "
          f"rung {json.dumps(per_rung)}; fit {json.dumps(out['fit'])} in {fit_s:.1f} s; "
          f"tuned ladder {out['tuned_ladder']} routing {art['routing']}, expected "
          f"{json.dumps(exp)} against the default ladder, {json.dumps(exp_s)} against "
          f"the static one (tuned {vs_static['buckets']}, routing "
          f"{vs_static['routing']}); forwards by rung {json.dumps(out['forwards'])}, "
          f"launches a forward by mode {json.dumps(out['mode_launches'])}; {parity_sid} "
          f"at {out['parity'][1]} and each mode's stream on its rung bit-equal to "
          f"model_detect; beside the record "
          f"{json.dumps(out['record'])}")
    return out


# --- the fleet control plane (run_fleet_bench.py --smoke on the card) -----------

FLEET_COST = 0.05               # run_fleet_bench.py's known-cost leg: 0.05 s a window,
FLEET_RATE = 6.0                # 6 Hz a stream: analytic saturation 1/(6 x 0.05) = 3.33
FLEET_DEVTIME_WINDOW = 8.0
FLEET_BUCKET = "256x512x64"
FLEET_PROBE_SEC = 5.0           # its --smoke probes and soaks
FLEET_SHED_SEC = 10.0
FLEET_ARCHIVE_SEC = 8.0
FLEET_MAX_STREAMS = 6
FLEET_DAEMON = ("--duration-sec", "8", "--synthetic-cost", "0.02", "--stream", "a=1")
FLEET_REAL_LAYERS = 4           # JointConfig().small, the fleet replicas' fixed model


class _FleetBoots:
    """The fleet phase's children: ``boot(name, **spec)`` starts a replica
    (``python -m nerrf_tpu_torch.fleet.replica`` on the card) in the
    background, ``take(name)`` waits for it, ``stop_later(rep)`` drains and
    stops one in the background; every child's final stats (its ``stop``
    reply) are kept in ``finals``.  The daemon (`fleet_daemon_start`) is
    started with the first boots.  ``close()`` stops whatever is still up."""

    def __init__(self):
        import pathlib
        import tempfile
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=16, thread_name_prefix="fleet")
        self._futures = {}
        self._stops = []
        self.reps = []
        self.finals = {}
        self.boot_s = {}
        self.work = pathlib.Path(tempfile.mkdtemp(prefix="nerrf-fleet-"))
        self.daemon = None

    def _boot(self, name, spec):
        import threading

        from nerrf_tpu_torch.fleet import ReplicaProcess, replica_args

        spec = {"buckets": FLEET_BUCKET, "devtime_window_sec": FLEET_DEVTIME_WINDOW, **spec}
        t0 = time.perf_counter()
        rep = ReplicaProcess(name, args=replica_args(device="cuda", **spec), log=_console)
        self.boot_s[name] = round(time.perf_counter() - t0, 2)
        stop, once = rep.stop, threading.Lock()

        def kept_stop(*a, **kw):
            with once:  # a second caller waits and gets the same reply
                if name not in self.finals:
                    self.finals[name] = stop(*a, **kw)
            return self.finals[name]

        rep.stop = kept_stop
        self.reps.append(rep)
        return rep

    def boot(self, name, **spec):
        self._futures[name] = self._pool.submit(self._boot, name, spec)

    def take(self, name):
        return self._futures[name].result(timeout=300)

    def submit(self, fn, *args):
        return self._pool.submit(fn, *args)

    def stop_later(self, stop):
        """Run ``stop()`` (a replica's, a set's) in the background."""
        self._stops.append(self._pool.submit(stop))

    def join_stops(self):
        for fut in self._stops:
            fut.result(timeout=300)

    def close(self):
        for fut in list(self._futures.values()) + self._stops:
            try:
                fut.result(timeout=300)
            except Exception:  # noqa: BLE001 — a failed boot has nothing to stop
                pass
        for rep in self.reps:
            if rep.proc.poll() is None:
                rep.stop()
        if self.daemon is not None:
            fleet_daemon_close(self.daemon)
        self._pool.shutdown(wait=True)
        shutil.rmtree(self.work, ignore_errors=True)


def _scored(stats: dict) -> int:
    return int(stats.get("windows_scored") or 0)


def _scraped_total(text: str, name: str) -> float:
    """A counter summed over its label series, from a /metrics scrape."""
    total = 0.0
    for line in (text or "").splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            total += float(line.rsplit(" ", 1)[1])
    return total


def _card_free_gib() -> float:
    import torch

    free, _total = torch.cuda.mem_get_info()
    return round(free / 2 ** 30, 2)


FLEET_KNOWN = dict(synthetic_cost=FLEET_COST, queue_slots=64, deadline_sec=2.0)


def fleet_preboot() -> _FleetBoots:
    """Start the first legs' replicas (A's, B's two, C's) and the daemon; the
    full smoke calls this before the tune phase, so that they boot while it
    runs."""
    boots = _FleetBoots()
    boots.boot("sat", **FLEET_KNOWN)
    boots.boot("b-r0", **FLEET_KNOWN)
    boots.boot("b-r1", **FLEET_KNOWN)
    boots.boot("shed", synthetic_cost=FLEET_COST, queue_slots=4, deadline_sec=1.0,
               shed_margin=1.0, buckets="160x320x64,1024x2048x64")
    boots.daemon = fleet_daemon_start(boots.work)
    return boots


def fleet_leg_a(boots) -> dict:
    """Measured saturation: one known-cost replica, 6 Hz streams added until
    the delivered/offered ratio falls under 0.85."""
    rep = boots.take("sat")
    ratios, k_star = [], None
    try:
        for k in range(1, FLEET_MAX_STREAMS + 1):
            rep.cmd("assign", stream=f"probe{k}", rate_hz=FLEET_RATE)
            time.sleep(2.0)  # settle: feeder up, first windows closing
            before = _scored(rep.cmd("stats"))
            time.sleep(FLEET_PROBE_SEC)
            delivered = _scored(rep.cmd("stats")) - before
            ratio = delivered / (k * FLEET_RATE * FLEET_PROBE_SEC)
            ratios.append(round(ratio, 3))
            _console(f"fleet A: k={k} {delivered} windows ({ratio:.3f})")
            if ratio < 0.85:
                k_star = k
                break
    finally:
        boots.stop_later(rep.stop)
    if k_star is None:
        _fail(f"fleet A: no saturation up to {FLEET_MAX_STREAMS} streams: {ratios}")
    return {"delivered_ratio_by_streams": ratios,
            "analytic_saturation_streams": round(1.0 / (FLEET_RATE * FLEET_COST), 2),
            "measured_saturation_streams": k_star}


def fleet_leg_b(boots, k_star: int) -> dict:
    """Two 6 Hz streams under the real controller over a ReplicaSet (both
    replicas booted ahead, so a scale-out adopts a warm one): out strictly
    below k*, a rebalance whose moved stream keeps scoring on its new
    replica, in on sustained slack."""
    from nerrf_tpu_torch.fleet import FleetConfig, FleetController, ReplicaSet
    from nerrf_tpu_torch.flight.journal import EventJournal
    from nerrf_tpu_torch.observability import MetricsRegistry

    reg = MetricsRegistry()
    jrn = EventJournal(registry=reg)
    rs = ReplicaSet(lambda name: boots.take(f"b-{name}"), max_replicas=2, log=_console)
    rs.scale_out()
    ctl = FleetController(
        rs, FleetConfig(poll_sec=0.5, scale_out_below=1.5, scale_in_above=4.0,
                        scale_out_sustain=2, scale_in_sustain=4, cooldown_sec=4.0,
                        max_replicas=2),
        registry=reg, journal=jrn, log=_console)
    out = {"streams_at_scale_out": None, "scale_in": False, "rebalance_moved": [],
           "moved_stream_scoring": False}
    t0 = time.perf_counter()

    def scale_events(direction):
        return [d for d in ctl.decisions
                if d["kind"] == "fleet_scale" and d["direction"] == direction]

    def rebalances():
        return [d for d in ctl.decisions if d["kind"] == "fleet_rebalance"]

    rs.add_stream("load0", FLEET_RATE)
    rs.add_stream("load1", FLEET_RATE)
    ctl.poll_once()  # manual reconciliation: place both on r0
    ctl.start()
    try:
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not scale_events("out"):
            time.sleep(0.25)
        if scale_events("out"):
            out["streams_at_scale_out"] = 2
            out["scale_out_s"] = round(time.perf_counter() - t0, 2)
        deadline = time.monotonic() + 12.0
        while time.monotonic() < deadline and not rebalances():
            time.sleep(0.25)
        if rebalances():
            out["rebalance_moved"] = rebalances()[-1]["moved"]
        if out["rebalance_moved"]:
            moved = out["rebalance_moved"][0]
            rep = rs.replicas().get(rebalances()[-1]["slots"][moved])
            if rep is not None:
                def moved_count():
                    stats = rep.cmd("stats")
                    out["moved_to_launches"] = stats["launches"]
                    per = stats["slo"].get("per_stream") or {}
                    return sum(v.get("count", 0) for k, v in per.items()
                               if k.split("#", 1)[0] == moved)

                base = moved_count()
                deadline = time.monotonic() + 20.0
                while time.monotonic() < deadline:
                    if moved_count() > base:
                        out["moved_stream_scoring"] = True
                        break
                    time.sleep(0.5)
        # slack: drop the load, keep a trickle on r0; r1 goes idle (its
        # stale gauge read as slack) and must be retired
        rs.remove_stream("load0")
        rs.remove_stream("load1")
        rs.add_stream("cool", 1.0)
        t_in = time.perf_counter()
        deadline = time.monotonic() + 45.0
        while time.monotonic() < deadline and not scale_events("in"):
            time.sleep(0.5)
        if scale_events("in"):
            out["scale_in"] = True
            out["scale_in_s"] = round(time.perf_counter() - t_in, 2)
    finally:
        ctl.stop()
        boots.stop_later(rs.stop_all)
    out["decisions"] = [{k: v for k, v in d.items() if k != "evidence"}
                        for d in ctl.decisions if d["kind"] == "fleet_scale"]
    out["scale_out_evidence"] = next(
        (d["evidence"] for d in ctl.decisions if d["kind"] == "fleet_scale"), None)
    n_out = out["streams_at_scale_out"]
    if n_out is None or not n_out < k_star:
        _fail(f"fleet B: scale-out at {n_out} streams, not strictly below k* = {k_star}")
    if not out["rebalance_moved"] or not out["moved_stream_scoring"]:
        _fail(f"fleet B: rebalance {out['rebalance_moved']}, moved stream scoring "
              f"{out['moved_stream_scoring']}")
    if not out["scale_in"]:
        _fail(f"fleet B: no scale-in on sustained slack: {out['decisions']}")
    return out


def fleet_leg_c(boots) -> dict:
    """A 30 Hz dense burner (120 events/s, on the 1024 rung: 4x the device
    cost a window) beside an 8 Hz healthy stream on an overloaded replica:
    every shed victim the burner, every ranking topped by it, the healthy
    stream still scoring."""
    rep = boots.take("shed")
    try:
        rep.cmd("assign", stream="burn", rate_hz=30.0, events_hz=120.0)
        rep.cmd("assign", stream="heal", rate_hz=8.0)
        time.sleep(FLEET_SHED_SEC)
        stats = rep.cmd("stats")
    finally:
        boots.stop_later(rep.stop)
    sheds = stats.get("shed_records") or []
    victims = sorted({r["stream"].split("#", 1)[0] for r in sheds})
    tops = sorted({(r["data"].get("ranking") or [["?"]])[0][0] for r in sheds})
    per = stats["slo"].get("per_stream") or {}
    heal = sum(v.get("count", 0) for k, v in per.items() if k.split("#", 1)[0] == "heal")
    out = {"shed_records": len(sheds), "victims": victims, "ranking_tops": tops,
           "healthy_windows_scored": int(heal), "dropped": stats.get("dropped"),
           "windows_scored": _scored(stats)}
    _console(f"fleet C: {json.dumps(out)}")
    if not sheds or victims != ["burn"] or tops != ["burn"] or heal <= 0:
        _fail(f"fleet C: shedding {out}")
    return out


def fleet_leg_d(boots) -> dict:
    """Two real-model replicas (JointConfig().small on the card, fused),
    booted at once: each replica's parity reply bit-equal to model_detect,
    zero recompiles after warmup, every bucket warmed live, and its kernel
    launches = (warmup forwards + served batches + model_detect's batches)
    x one fused forward's."""
    from nerrf_tpu_torch.fleet.replica import parity_trace
    from nerrf_tpu_torch.serve import ServeConfig
    from nerrf_tpu_torch.train.data import windows_of_trace

    bucket = tuple(int(x) for x in FLEET_BUCKET.split("x"))
    cfg = ServeConfig(buckets=(bucket,), batch_size=8, window_sec=15.0, stride_sec=5.0)
    offline_batches = math.ceil(
        len(windows_of_trace(parity_trace(), cfg.dataset_config(bucket))) / cfg.batch_size)
    per_forward = fused_forward_launches(FLEET_REAL_LAYERS)
    out = {}
    reps = {name: boots.take(name) for name in ("d-r0", "d-r1")}
    replies = {name: boots.submit(rep.cmd, "parity", 300.0) for name, rep in reps.items()}
    for name, rep in reps.items():
        try:
            parity = replies[name].result(timeout=330)
            stats = rep.cmd("stats")
            served = int(_scraped_total(rep.scrape(), "nerrf_serve_batches_total"))
        finally:
            boots.stop_later(rep.stop)
        forwards = len(stats["warmup_source"]) + served + offline_batches
        want = {k: forwards * v for k, v in per_forward.items()}
        out[name] = {"parity": parity.get("parity"), "parity_windows": parity.get("windows"),
                     "recompiles_after_warmup": stats["recompiles_after_warmup"],
                     "warmup_source": stats["warmup_source"],
                     "forwards": {"warmup": len(stats["warmup_source"]), "served": served,
                                  "model_detect": offline_batches},
                     "launches": stats["launches"], "boot_s": boots.boot_s[name]}
        if parity.get("parity") is not True:
            _fail(f"fleet D {name}: parity reply {parity}")
        if stats["recompiles_after_warmup"] != 0:
            _fail(f"fleet D {name}: {stats['recompiles_after_warmup']} recompiles")
        if not stats["warmup_source"] or set(stats["warmup_source"].values()) != {"live"}:
            _fail(f"fleet D {name}: warmup source {stats['warmup_source']}")
        if stats["launches"] != want:
            _fail(f"fleet D {name}: launches {stats['launches']} != {forwards} forwards "
                  f"x {per_forward}")
    out["per_forward"] = per_forward
    out["warm_boot_from_cache"] = "left out: waits for the compile cache (ROADMAP A.7)"
    return out


def fleet_leg_e_start(boots) -> tuple:
    """Two archived known-cost runs (0.02 and 0.06 s a window): two 5 Hz
    streams each, from now until `fleet_leg_e_finish`."""
    reps = {name: boots.take(f"e-{name}") for name in ("base", "cand")}
    for rep in reps.values():
        rep.cmd("assign", stream="a0", rate_hz=5.0)
        rep.cmd("assign", stream="a1", rate_hz=5.0)
    return reps, time.perf_counter()


def fleet_leg_e_finish(boots, started) -> dict:
    """After FLEET_ARCHIVE_SEC of soak, both replicas stopped (their archives
    closed): `report --compare --gate` exits 1 on the regression, 0 on
    self-compare, 0 with --cost-ratio 10 --p99-ratio 10."""
    reps, t0 = started
    time.sleep(max(0.0, FLEET_ARCHIVE_SEC - (time.perf_counter() - t0)))
    for rep in reps.values():
        rep.stop()
    base, cand = str(boots.work / "archive_base"), str(boots.work / "archive_cand")
    rcs = {"soak_s": round(time.perf_counter() - t0, 2),
           "rc_regression": _cli_run("report", cand, "--compare", base, cand, "--gate")[0],
           "rc_self_compare": _cli_run("report", base, "--compare", base, base, "--gate")[0],
           "rc_loose_knobs": _cli_run("report", cand, "--compare", base, cand, "--gate",
                                      "--cost-ratio", "10", "--p99-ratio", "10")[0]}
    if (rcs["rc_regression"], rcs["rc_self_compare"], rcs["rc_loose_knobs"]) != (1, 0, 0):
        _fail(f"fleet E: compare gate exit codes {rcs}, want 1/0/0")
    return rcs


def fleet_daemon_start(work) -> dict:
    """Start the daemon and a thread that scrapes its /metrics while it runs
    (``seen``: the nerrf_fleet_* names of the first scrape that has any)."""
    import threading
    import urllib.request

    port = _free_port()
    log = open(work / "daemon.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nerrf_tpu_torch.fleet.controller", *FLEET_DAEMON,
         "--metrics-port", str(port)], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    daemon = {"proc": proc, "log": log, "t0": time.perf_counter(), "seen": None,
              "seen_s": None}

    def watch():
        while proc.poll() is None and daemon["seen"] is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                            timeout=5) as resp:
                    text = resp.read().decode()
                names = sorted({ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                                if ln.startswith("nerrf_fleet_")})
                if names:
                    daemon["seen"] = names
                    daemon["seen_s"] = round(time.perf_counter() - daemon["t0"], 2)
            except OSError:
                pass
            time.sleep(0.25)

    daemon["watch"] = threading.Thread(target=watch, name="fleet-daemon-watch")
    daemon["watch"].start()
    return daemon


def fleet_daemon_close(daemon) -> None:
    proc = daemon["proc"]
    try:
        daemon["rc"] = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        daemon["watch"].join(timeout=30)
        daemon["log"].close()


def fleet_daemon_finish(boots) -> dict:
    """While the daemon ran its /metrics carried nerrf_fleet_*; it exits 0."""
    daemon, boots.daemon = boots.daemon, None
    fleet_daemon_close(daemon)
    rc = daemon["rc"]
    tail = (boots.work / "daemon.log").read_text()[-2000:]
    if rc != 0 or not daemon["seen"]:
        _fail(f"fleet daemon: exit {rc}, nerrf_fleet_* seen {daemon['seen']}: {tail}")
    return {"rc": rc, "fleet_metrics": daemon["seen"], "seen_s": daemon["seen_s"],
            "seconds": round(time.perf_counter() - daemon["t0"], 2)}


def run_fleet_path(boots=None) -> dict:
    """run_fleet_bench.py --smoke against the port's replicas on the card
    (every child ``--device cuda``; the bench's constants: 0.05 s a window,
    6 Hz a stream, an 8 s devtime window, the 256x512x64 bucket).  Legs:
    A saturation alone; B autoscale and C shedding at once; D two
    real-model replicas and E's two archived runs at once, then E's compare
    gate; the daemon (``python -m nerrf_tpu_torch.fleet.controller``)
    started with the first boots (`fleet_preboot`, which the full smoke
    calls before the tune phase).  D's and E's replicas boot while A
    measures.  Every known-cost replica launches no kernel."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    boots = boots or fleet_preboot()
    out = {"card": _smi(), "card_free_gib": {"start": _card_free_gib()}, "legs_s": {}}
    try:
        t = time.perf_counter()
        boots.take("sat")
        out["wait_for_A"] = round(time.perf_counter() - t, 2)
        for name in ("d-r0", "d-r1"):
            boots.boot(name, synthetic_cost=0.0, queue_slots=64, deadline_sec=5.0)
        for name, cost in (("base", 0.02), ("cand", 0.06)):
            boots.boot(f"e-{name}", synthetic_cost=cost, queue_slots=64, deadline_sec=2.0,
                       archive_dir=str(boots.work / f"archive_{name}"), snapshot_sec=1.0)
        t = time.perf_counter()
        out["saturation"] = fleet_leg_a(boots)
        out["legs_s"]["A"] = round(time.perf_counter() - t, 2)
        out["card_free_gib"]["A"] = _card_free_gib()
        t = time.perf_counter()
        shed = boots.submit(fleet_leg_c, boots)
        out["autoscale"] = fleet_leg_b(boots, out["saturation"]["measured_saturation_streams"])
        out["shed"] = shed.result(timeout=300)
        out["legs_s"]["B_C"] = round(time.perf_counter() - t, 2)
        out["card_free_gib"]["B_C"] = _card_free_gib()
        t = time.perf_counter()
        e_run = fleet_leg_e_start(boots)
        out["real_model"] = fleet_leg_d(boots)
        out["compare_gate"] = fleet_leg_e_finish(boots, e_run)
        out["legs_s"]["D_E"] = round(time.perf_counter() - t, 2)
        out["card_free_gib"]["D_E"] = _card_free_gib()
        t = time.perf_counter()
        out["daemon"] = fleet_daemon_finish(boots)
        boots.join_stops()
        out["legs_s"]["daemon_and_stops"] = round(time.perf_counter() - t, 2)
        out["card_free_gib"]["end"] = _card_free_gib()
    finally:
        boots.close()
    zero = {k: 0 for k in fused_forward_launches(FLEET_REAL_LAYERS)}
    known_names = [n for n in boots.finals if not n.startswith("d-")]
    out["known_cost_launches"] = {n: boots.finals[n]["launches"] for n in known_names}
    if len(known_names) != 6 or any(
            boots.finals[n]["launches"] != zero for n in known_names):
        _fail(f"fleet: known-cost replicas launched kernels: {out['known_cost_launches']}")
    moved = out["autoscale"].get("moved_to_launches")
    if moved != zero:
        _fail(f"fleet B: the moved-to replica launched {moved}")
    out["boot_s"] = boots.boot_s
    out["seconds"] = round(time.perf_counter() - t_phase, 2)
    print("fleet " + json.dumps(out))
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
    # --kernel-times ROOT (or --lstm-times ROOT, --stream-leg ROOT): only the
    # kernel times (or the LSTM tower's forward, the stream leg) of the
    # package under ROOT (another tree of this repository), to hold two trees
    # against each other in one call, in turns
    mode = sys.argv[1] if sys.argv[1:2] in (
        ["--kernel-times"], ["--lstm-times"], ["--stream-leg"], ["--planner"],
        ["--learn"], ["--devtime"]) else None
    times_of = sys.argv[2] if mode and len(sys.argv) > 2 else None
    if mode and mode not in ("--planner", "--learn", "--devtime") and times_of is None:
        print(f"chip_smoke: {mode} takes the root of a tree", file=sys.stderr)
        return 2
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
    peaks = set_peaks()
    if peaks is None:
        print(f"chip_smoke: no peak row for {torch.cuda.get_device_name(0)!r} in "
              f"nerrf_tpu_torch/devtime/peaks.py; the bounds need the card's "
              f"published peaks", file=sys.stderr)
        return 1
    print(f"peaks ({smi}): {peaks}")
    if mode == "--planner":
        # only the search: with no ROOT its ptxas lines, check_mcts on both
        # entries and check_value_net first; then the timings of the
        # package under ROOT (this tree by default), to run in turns
        kernels.build()
        out = {"root": times_of or here, "card": smi}
        if times_of is None:
            out["ptxas"] = check_mcts_ptxas()
            out["check_mcts"] = check_mcts()
            out["value_err"] = check_value_net(bench_domain())["value_err"]
        out["times"] = planner_times()
        print(json.dumps(out))
        return 0
    if mode == "--devtime":
        # only the device-time phase, for the package under ROOT (this tree
        # by default), on a seeded full-width checkpoint
        import tempfile

        from nerrf_tpu_torch.models import JointConfig, build_nerrfnet
        from nerrf_tpu_torch.train.checkpoint import save_checkpoint

        kernels.build()
        model_dir = tempfile.mkdtemp(prefix="nerrf-devtime-model-")
        try:
            model = build_nerrfnet(JointConfig(), seed=0, device="cuda")
            save_checkpoint(model_dir, model.state_dict(), model.cfg)
            del model
            devtime = run_devtime_path(model_dir)
        finally:
            shutil.rmtree(model_dir, ignore_errors=True)
        print(json.dumps({"root": times_of or here, "card": smi, "devtime": devtime}))
        return 0
    if mode == "--learn":
        # only the learn phase, for the package under ROOT (this tree by
        # default), on a seeded full-width checkpoint
        import tempfile

        from nerrf_tpu_torch.models import JointConfig, build_nerrfnet
        from nerrf_tpu_torch.train.checkpoint import save_checkpoint

        kernels.build()
        model_dir = tempfile.mkdtemp(prefix="nerrf-learn-model-")
        try:
            model = build_nerrfnet(JointConfig(), seed=0, device="cuda")
            save_checkpoint(model_dir, model.state_dict(), model.cfg)
            del model
            learn = run_learn_path(model_dir)
        finally:
            shutil.rmtree(model_dir, ignore_errors=True)
        print(json.dumps({"root": times_of or here, "card": smi, "learn": learn}))
        return 0
    if times_of:
        if mode == "--stream-leg":
            kernels.build()
            leg = run_stream_leg()
            times = {k: leg[k] for k in ("ms_per_step", "events_per_s", "busy", "steps",
                                         "loss", "launches")}
        else:
            times = kernel_times() if mode == "--kernel-times" else lstm_times()
        print(json.dumps({"root": times_of, "card": smi, **times}))
        return 0
    if sys.argv[1:2] == ["--attention"]:
        # only the attention kernels: the SASS gate, every case against the
        # plain version, the times at the leg's and the probe's shapes
        kernels.build()
        sass = check_attention_sass()
        check_attention()
        timing = {tag: time_attention(shape) for tag, shape in (
            ("leg", (STREAM_LEG_B, STREAM_LEG_LEN, 1, 128)),
            ("probe", (PROBE_BATCH, PROBE_LEN, 1, 128)))}
        print(json.dumps({"card": smi, "sass": sass, "timing": timing}))
        return 0
    if sys.argv[1:2] == ["--lifecycle"]:
        # only the lifecycle phase, on a seeded full-width checkpoint
        import tempfile

        from nerrf_tpu_torch.models import JointConfig, build_nerrfnet
        from nerrf_tpu_torch.train.checkpoint import save_checkpoint

        kernels.build()
        model_dir = tempfile.mkdtemp(prefix="nerrf-lifecycle-model-")
        try:
            model = build_nerrfnet(JointConfig(), seed=0, device="cuda")
            save_checkpoint(model_dir, model.state_dict(), model.cfg)
            del model
            lifecycle = run_lifecycle_path(model_dir)
        finally:
            shutil.rmtree(model_dir, ignore_errors=True)
        print(json.dumps({"card": smi, "lifecycle": {
            k: lifecycle[k] for k in ("seconds", "profile", "score_ms", "decisions",
                                      "archive", "launches")}}))
        return 0
    if sys.argv[1:2] in (["--chaos"], ["--tune"]):
        # only the chaos phase (the training rung's dataset for its
        # train.nonfinite_grad leg) or the tune phase (on a seeded
        # full-width checkpoint)
        import tempfile

        from nerrf_tpu_torch.models import JointConfig, build_nerrfnet
        from nerrf_tpu_torch.train.checkpoint import save_checkpoint

        kernels.build()
        if sys.argv[1] == "--chaos":
            _, ds, cfg = train_rung()
            res = run_chaos_path(ds, cfg)
        else:
            model_dir = tempfile.mkdtemp(prefix="nerrf-tune-model-")
            try:
                model = build_nerrfnet(JointConfig(), seed=0, device="cuda")
                save_checkpoint(model_dir, model.state_dict(), model.cfg)
                del model
                res = run_tune_path(model_dir)
            finally:
                shutil.rmtree(model_dir, ignore_errors=True)
        print(json.dumps({"card": smi, sys.argv[1][2:]: res}, default=str))
        return 0
    if sys.argv[1:2] == ["--fleet"]:
        # only the fleet phase: its replicas load the kernels built here
        kernels.build()
        res = run_fleet_path()
        print(json.dumps({"card": smi, "fleet": {
            k: res[k] for k in ("seconds", "legs_s", "saturation", "real_model")}}))
        return 0
    if sys.argv[1:2] == ["--stream-probe"]:
        kernels.build()
        keep = ("init_seed", "event_auc", "event_f1_at_threshold",
                "stream_event_threshold", "calib_f1", "final_loss", "steps_per_s")
        probes = [run_stream_probe(int(seed)) for seed in sys.argv[2:]]
        print(json.dumps({"card": smi, "stream_probe": [
            {k: probe[k] for k in keep} for probe in probes]}))
        return 0
    run_t0 = time.perf_counter()
    fleet_pre = None
    try:
        t0 = time.perf_counter()
        built = kernels.build()
        PHASE_SECONDS["build"] = time.perf_counter() - t0
        print(f"built {sorted(built)} in {PHASE_SECONDS['build']:.1f} s "
              f"(per source: {built})")
        for name in kernels.KERNELS:
            log = kernels.library_path(name).with_suffix(".log")
            if log.exists():
                for line in log.read_text().splitlines():
                    if "entry function" in line or "registers" in line \
                            or "spill" in line:
                        print(f"ptxas {name}: {line.strip()}")
        P = _timed
        sass = P("check_attention_sass", check_attention_sass)
        errors = P("check_kernels", check_kernels)
        errors.update(P("check_banded_kernels", check_banded_kernels))
        errors.update(gather_rows={}, gather_rows_sorted={})
        P("check_gathers", check_gathers, errors)
        P("check_long_bands", check_long_bands, errors)
        P("check_backward", check_backward, errors)
        P("check_plans", check_plans)
        main_path = P("main_path", run_main_path)
        detect_timing = P("time_kernels_detect", time_kernels, main_path["batch"], errors,
                          "detect")
        small_err = P("check_small_detect", check_small_detect)
        serve = P("serve", run_serve_path, (MAIN_N, MAIN_E, SEQ_S))
        traces, train_ds, train_cfg = P("train_rung", train_rung)
        train = P("train", run_train_path, traces, train_ds, train_cfg)
        grads = P("check_step_grads", check_step_grads, train_ds, train_cfg)
        small_train_err = P("check_small_train", check_small_train)
        resident = P("resident", run_resident_paths, train_ds, train_cfg)
        elastic = P("elastic", run_elastic_path, train_ds, train_cfg)
        watch = P("trainwatch", run_trainwatch_path, train_ds, train_cfg)
        experiment = P("experiment", run_experiment_path)
        # the experiment run's train MFU gauge, read before later runs set it
        train_mfu = train_mfu_reading(experiment["report"]["steps_per_sec"])
        small_experiment = P("check_small_experiment", check_small_experiment)
        corpus = P("disk_corpus", run_disk_corpus_path)
        try:
            mcts_ptxas = P("check_mcts_ptxas", check_mcts_ptxas)
            mcts_check = P("check_mcts", check_mcts)
            bench = bench_domain()
            value = P("check_value_net", check_value_net, bench)
            planner = P("planner_cell", run_planner_cell, bench, value["net"])
            batched = P("batched_planner", run_batched_planner, bench, value["net"])
            undo = P("undo", run_undo_path, experiment["model_dir"])
            respond = P("respond_chain", run_respond_chain, experiment["model_dir"],
                        undo["trace"])
            cli_phase = P("cli", run_cli_path, experiment["model_dir"],
                          undo["heuristic"]["mttr_s"])
            lifecycle = P("lifecycle", run_lifecycle_path, experiment["model_dir"])
            learn = P("learn", run_learn_path, experiment["model_dir"])
            devtime = P("devtime", run_devtime_path, experiment["model_dir"], train_mfu)
            chaos_leg = P("chaos", run_chaos_path, train_ds, train_cfg)
            # the fleet phase's first replicas and its daemon boot during tune
            fleet_pre = fleet_preboot()
            tune_leg = P("tune", run_tune_path, experiment["model_dir"])
            fleet = P("fleet", run_fleet_path, fleet_pre)
        finally:
            shutil.rmtree(experiment["model_dir"], ignore_errors=True)
        stream = P("stream", run_stream_path)
        errors.update(stream["errors"])
        errors["mcts_search"] = {case: 0.0 for case in mcts_check}
        timing = P("time_kernels_train", time_kernels, train["batch"], errors, "train")
        split = P("gather_host_split", gather_host_split, train["batch"])
    except Exception as e:  # any failed phase fails the smoke
        import traceback

        traceback.print_exc()
        if fleet_pre is not None:
            fleet_pre.close()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        print("phase seconds so far: " + json.dumps(
            {k: round(v, 1) for k, v in PHASE_SECONDS.items()}), file=sys.stderr)
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
    from nerrf_tpu_torch.ops import LAUNCHES

    segment_kernels = tuple(LAUNCHES)
    path = {name: "model_detect" if name == "sage_aggregate" else "train_nerrfnet"
            for name in segment_kernels}
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
         "experiment_launches": experiment["launches"][name],
         "corpus_launches": corpus["launches"][name],
         "respond_serve_launches": respond["serve"]["launches"][name],
         "cli_launches": cli_phase["launches"][name],
         "lifecycle_profile_launches": lifecycle["launches"]["profile"][name],
         "lifecycle_shadow_batch_launches": lifecycle["launches"]["shadow_batch"][name],
         "lifecycle_batch_launches": lifecycle["launches"]["batch"][name],
         "learn_serve_batch_launches": learn["launches"]["serve_batch"][name],
         "learn_shadow_batch_launches": learn["launches"]["shadow_batch"][name],
         "learn_retrain_step_launches": learn["launches"]["retrain_step"][name],
         "learn_leg_b_with_retrain_launches": learn["leg_B"]["launches"][name],
         "chaos_serve_launches": chaos_leg["launches"][name],
         "chaos_nonfinite_train_launches": chaos_leg["nonfinite"]["launches"][name],
         "tune_forward_launches_by_mode": {
             m: v[name] for m, v in tune_leg["mode_launches"].items()},
         "fleet": {"real_model_replica_launches": {
             r: fleet["real_model"][r]["launches"][name] for r in ("d-r0", "d-r1")},
             "per_forward": fleet["real_model"]["per_forward"][name],
             "known_cost_replica_launches": sorted(
                 {v[name] for v in fleet["known_cost_launches"].values()})}}
        for name in segment_kernels]}
    # the search: per plan of 800 simulations (ms: CUDA events around the
    # plan's launches and syncs; plain_ms: the plain version's plan on the
    # card; device_ms: the profiler's time a launch); no library call
    # computes it
    line["kernels"].append({
        "name": "mcts_search", "route": "cuda",
        "source": "nerrf_tpu_torch/ops/csrc/mcts_search.cu",
        "replaces": "nerrf_tpu/planner/device_mcts.py:205",
        "path": "DeviceMCTS.plan",
        "launches": undo["heuristic"]["launches"]["mcts_search"],
        "launches_by_route": undo["heuristic"]["routes"],
        "check_routes": {case: r["route"] for case, r in mcts_check.items()},
        "max_abs_err": max(errors["mcts_search"].values()),
        "ms": planner["search_ms"], "plain_ms": planner["cell"]["plain"]["ms_per_plan"],
        "bound_ms": planner["bound_ms"], "bound_by": planner["bound_by"],
        "library_ms": None, "device_ms": planner["device_ms"],
        "device_plan_ms": planner["device_plan_ms"], "per": "plan",
        "rollouts_per_s": planner["cell"]["kernel"]["rollouts_per_s"],
        "mean_select_depth": planner["depth"],
        "one_launch": {k: planner["launch"][k] for k in (
            "route", "ms", "device_ms", "ns_per_level", "levels", "chain_floor_ms", "host_us")},
        "resident_shared_bytes": mcts_ptxas["resident_dynamic_shared_bytes"],
        "ptxas": {k: v for k, v in mcts_ptxas.items() if k.endswith("_kernel")},
        "respond_corpus_launches": respond["corpus"]["launches"],
        "respond_serve_launches": respond["serve"]["launches"]["mcts_search"],
        "cli_launches": cli_phase["launches"]["mcts_search"],
        "value_net_max_rel_err": value["value_err"]})
    # the attention kernels on StreamNet's training step: launches from the
    # stream leg's run (step 0 and 50 steps), times at its shape
    # (12 x 4096 x 1 x 128, bf16, causal); the probe's launches and times
    # (8 x 1024) beside them; the core route at that shape, and for the
    # tensor-core entries their SASS counts of wgmma and TMA instructions
    for name in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv"):
        leg_t, probe_t = stream["timing"]["leg"][name], stream["timing"]["probe"][name]
        ops = sass.get(f"{name} D=128", {})
        line["kernels"].append({
            "name": name, "route": "cuda",
            "core_route": kernels.attention_route(name, torch.bfloat16, 128),
            **{f"sass_{op}": ops[op] for op in ("HGMMA", "UTMALDG", "UTMASTG") if op in ops},
            "source": "nerrf_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "nerrf_tpu/parallel/ring.py:58",
            "path": "StreamNet training step (bench.py's stream leg)",
            "launches": stream["leg"]["launches"][name],
            "max_abs_err": max(errors[name].values()),
            **{k: leg_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "library_device_ms", "device_ms",
                                     "device_lost", "tflops")},
            "probe_launches": stream["probe"]["launches"][name],
            "probe_ms": probe_t["ms"], "probe_device_ms": probe_t["device_ms"],
            "probe_bound_ms": probe_t["bound_ms"],
            "probe_library_ms": probe_t["library_ms"]})
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
    print(f"training paths on the Training cell ({RESIDENT_STEPS} steps, segment): "
          f"steps/s in turns {json.dumps(resident['steps_per_s'])}, busy share "
          f"{json.dumps(resident['busy'])}, streamed = "
          f"scheduled = superstep bit for bit, {resident['per_step']} launches a step; "
          f"upload {json.dumps({k: round(v, 3) for k, v in resident['upload_gbps'].items()})} "
          f"GB/s; elastic {ELASTIC_STEPS} steps at {elastic['steps_per_sec']:.3f} steps/s, "
          f"resume bit-equal, a checkpoint {elastic['state_bytes']} bytes saved in "
          f"{elastic['save_s'][0]:.3f}-{elastic['save_s'][1]:.3f} s; telemetry step "
          f"{watch['step_ms']['on']:.1f} ms vs {watch['step_ms']['off']:.1f} ms without, "
          f"grad_norm relative error {watch['grad_norm_err']:.2e}; NaN halt at step "
          f"{watch['nan_step']}; on {smi}")
    r = corpus["report"]
    print(f"disk corpus joint-100h (cut: {CORPUS_HOURS} h, {CORPUS_SHARD_WINDOWS} "
          f"windows a shard, {CORPUS_STEPS} steps, ckpt_every {CORPUS_CKPT_EVERY}) "
          f"through run_experiment, fused mode: {r['steps_per_sec']} steps/s after "
          f"step 0; {corpus['shards']} shards trained; data wait "
          f"{corpus['data_wait_s']:.3f} s; upload {corpus['upload_gbps']} GB/s; "
          f"{corpus['wall_s']:.1f} s, split "
          f"{json.dumps({k: round(v, 3) for k, v in corpus['split'].items()})}; held-out "
          f"{json.dumps({k: r['metrics'][k] for k in HELD_OUT})}; calibration "
          f"{corpus['calibration']}; gates {r['gates']}; launches {corpus['launches']}; "
          f"on {smi}")
    rc, rs = respond["corpus"], respond["serve"]
    m1s, s5s = rs["legs"]["m1"], rs["legs"]["s5"]
    print(f"respond chain ({respond['seconds']:.1f} s): staged families "
          f"{json.dumps({f: [round(d['stage_s'], 3), d['plan_s']] for f, d in rc['families'].items()})} "
          f"(stage s, plan s), each verified; router {rc['stats']['batches']} "
          f"batches, {rc['incidents_per_s']:.3f} incidents/s, respond_plan_seconds "
          f"p50 {rc['plan_p50_s']:.4f} s; wire (s5) "
          f"{respond['wire']['s5']['events_per_s']:.1f} events/s through client → "
          f"store; serve over connect (s5) {s5s['windows_per_s']:.3f} windows/s, "
          f"{s5s['events_per_s']:.1f} events/s, {s5s['alerts']} alerts, alert → plan "
          f"result p50 {s5s['alert_to_plan_p50_ms']} ms, busy share "
          f"{'not measured' if rs['busy'] is None else round(rs['busy'], 3)}; M1 as "
          f"one request: wire {respond['wire']['m1']['seconds']:.4f} s, connect "
          f"{m1s['serve_s']:.4f} s, {m1s['alerts']} alerts, alert → plan result "
          f"p50 {m1s['alert_to_plan_p50_ms']} ms; on {smi}")
    dt, turns = devtime, devtime["turns"]
    print(f"devtime ({devtime['seconds']:.1f} s): serve cost {dt['serve_cost']['flops']:.0f} "
          f"FLOPs a batch at {serve['bucket']} (the closed form), traced in "
          f"{dt['cost_trace_s']:.3f} s; train step {dt['train_cost']['flops']:.0f} FLOPs, "
          f"traced {dt['train_cost']['trace_s']:.3f} s, memoized "
          f"{dt['train_cost']['memo_s'] * 1e3:.3f} ms; windows/s plane "
          f"{' / '.join(f'{lg['turn']} {lg['windows_per_s']:.3f}' for lg in turns)}; "
          f"serve MFU {dt['gauges']['device_mfu']:.5f}, util "
          f"{dt['busy_leg']['util_fraction']} beside busy share "
          f"{dt['busy_leg']['busy_share']}, headroom "
          f"{dt['gauges']['capacity_headroom_streams']:.3f} streams; profile costs "
          f"{json.dumps(dt['profile_costs'])}; train MFU {json.dumps(dt['train_mfu'])}; "
          f"captures p99 {dt['p99_bundle']['kernel_events']}, local "
          f"{dt['capture_events']}, --target {dt['target_events']}; shed "
          f"{json.dumps(dt['shed'])}; on {smi}")
    ch, tn = chaos_leg, tune_leg
    print(f"chaos ({ch['seconds']:.1f} s): {ch['streams']} streams, faults injected "
          f"{json.dumps(ch['faults_injected'])}, {ch['bisections']} bisections isolating "
          f"{ch['isolated']} windows, {ch['reconnects']} reconnects, {len(ch['bundles'])} "
          f"bundle(s), worst p99 {ch['slo']['worst_stream_p99_ms']} ms (unfaulted "
          f"{ch['slo']['baseline_unfaulted_p99_ms']}, x{ch['slo']['degradation_x']}, limit "
          f"{ch['slo']['limit_ms']:.0f}); {ch['forwards']} forwards of "
          f"{ch['attempts']} attempts; windows/s disarmed / empty plan "
          f"{' / '.join(f'{t['turn']} {t['windows_per_s']:.3f}' for t in ch['turns'])}; "
          f"train.nonfinite_grad halt at step {ch['nonfinite']['step']}, bundle "
          f"{ch['nonfinite']['bundles']}; the record {json.dumps(ch['record'])}; on {smi}")
    print(f"tune ({tn['seconds']:.1f} s): device seconds by rung "
          f"{json.dumps(tn['bucket_cost'])}; fit {json.dumps(tn['fit'])}; tuned "
          f"{tn['tuned_ladder']} routing {tn['routing']}, expected "
          f"{json.dumps(tn['expected'])}; against the static ladder "
          f"{json.dumps(tn['vs_static'])}; forwards {json.dumps(tn['forwards'])}; "
          f"the record {json.dumps(tn['record'])}; on {smi}")
    fa, fb, fc, fd = fleet["saturation"], fleet["autoscale"], fleet["shed"], fleet["real_model"]
    print(f"fleet ({fleet['seconds']:.1f} s, legs {json.dumps(fleet['legs_s'])}): k* "
          f"{fa['measured_saturation_streams']} (analytic {fa['analytic_saturation_streams']}, "
          f"ratios {fa['delivered_ratio_by_streams']}); scale-out at "
          f"{fb['streams_at_scale_out']} streams after {fb.get('scale_out_s')} s, moved "
          f"{fb['rebalance_moved']} still scoring, scale-in after {fb.get('scale_in_s')} s; "
          f"shed {fc['shed_records']} (victims {fc['victims']}, healthy scored "
          f"{fc['healthy_windows_scored']}, dropped {json.dumps(fc['dropped'])}); real-model "
          f"replicas parity {[fd[r]['parity'] for r in ('d-r0', 'd-r1')]}, forwards "
          f"{json.dumps({r: fd[r]['forwards'] for r in ('d-r0', 'd-r1')})}; compare gate "
          f"{json.dumps(fleet['compare_gate'])}; daemon exit {fleet['daemon']['rc']}; card "
          f"free GiB {json.dumps(fleet['card_free_gib'])}; on {smi}")
    leg, probe = stream["leg"], stream["probe"]
    print(f"stream ({stream['seconds']:.1f} s): bench.py's leg {leg['B']} x {leg['T']}, "
          f"{leg['ms_per_step']:.2f} ms a step, {leg['events_per_s']:.1f} events/s, "
          f"busy share {'not measured' if leg['busy'] is None else round(leg['busy'], 3)}, "
          f"{leg['per_step']} launches a step; the probe {probe['steps_per_s']:.3f} "
          f"steps/s, held-out event_auc {probe['event_auc']:.4f}, "
          f"event_f1_at_threshold {probe['event_f1_at_threshold']:.4f}, threshold "
          f"{probe['stream_event_threshold']:.4f} (logit) beside the reference's record "
          f"{json.dumps(probe['record'])}; on {smi}")
    phases = {k: round(v, 1) for k, v in PHASE_SECONDS.items()}
    print(f"phase seconds ({time.perf_counter() - run_t0:.1f} s in all, the build "
          f"included): " + json.dumps(phases))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
