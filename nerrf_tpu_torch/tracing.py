"""Pipeline-wide span tracing: where did the time go?

The port of ``nerrf_tpu/tracing.py``, the same host code: ``span()`` is a
thread-safe context manager that records host-side spans into a bounded
ring buffer and **dual-writes** every span into the metrics registry as a
``stage_latency_seconds{stage=...}`` histogram, so Prometheus and traces
agree by construction.  Exports are Chrome trace-event JSON
(``{"traceEvents": [{"ph": "X", ...}]}``, loadable in Perfetto or
``chrome://tracing``), and the trace-file readers below are the engine of
the CLI's ``trace`` subcommand.

Device-side mirroring: ``span(..., device=True)`` and
:func:`device_annotation` open a ``torch.profiler.record_function`` region
of the same name (the reference opens a ``jax.profiler.TraceAnnotation``),
so a host stage and the kernels it launched line up by name in a profiler
trace.

Span naming scheme (dot-separated, coarse → fine):

    ingest_decode      EventBatch frame → native decode (ingest client)
    graph_lower        one window of events → padded GraphBatch (builder)
    store_compact      trace-store delta → bucket segments
    store_query        trace-store window read
    bucket_pad         trace → capacity-bucketed padded window samples
    calibrate          held-out file-threshold calibration
    data_wait          host blocked waiting for input data
    device_step        one train step, synced (dispatch + blocked)
    eval               held-out evaluation pass
    checkpoint         full-state checkpoint save
    mcts_plan          one planner search; mcts_leaf_eval = device batch
    serve_admit        one stream window measured/lowered/enqueued (serve)
    serve_batch_close  a bucket's shared batch assembled (occupancy/deadline)
    serve_device_score one shared padded batch through the eval program
    serve_demux        scored batch fanned back to streams + alert sink

The ring buffer records unconditionally (bounded memory, ~µs overhead);
``DEFAULT_TRACER.enabled`` (:func:`enabled`) additionally opts hot loops
into per-step *synced* spans (the training loops synchronize the card
inside ``device_step``) — off by default because the sync defeats step
pipelining.  Enable via ``NERRF_TRACE=1`` or the CLI's ``--trace-out``.

Unlike the reference, a span's ``t0`` is the absolute
``time.perf_counter()`` at its start (callers compare it with a
``perf_counter`` taken before a run); the Chrome export is relative to the
tracer's epoch, as the reference's.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

# The one histogram every span dual-writes into (per-stage label).
STAGE_HISTOGRAM = "stage_latency_seconds"
_STAGE_HELP = "host-side span latency per pipeline stage"

# Latency buckets sized for the pipeline's spread: µs-scale decodes up to
# multi-minute compiles/evals.
STAGE_BUCKETS = (0.0005, 0.002, 0.01, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0)


class Span:
    """One recorded host-side region: ``t0`` (``perf_counter`` seconds) and
    ``dur``; ``args`` is the mutable attribute dict the ``with`` body may
    extend (exported verbatim into the Chrome event's ``args``)."""

    __slots__ = ("name", "t0", "dur", "tid", "args")

    def __init__(self, name: str, args: Dict) -> None:
        self.name = name
        self.t0 = 0.0
        self.dur = 0.0
        self.tid = threading.get_ident()
        self.args = args


class Tracer:
    """Thread-safe ring-buffered span recorder with Chrome-trace export."""

    def __init__(self, capacity: int = 65536, registry=None) -> None:
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self._registry = registry
        self._thread_names: Dict[int, str] = {}
        # perf_counter origin of the export; the wall-clock anchor travels
        # in it so traces from different processes can be aligned offline
        self._t0_perf = time.perf_counter()
        self._t0_epoch = time.time()
        self.enabled = os.environ.get("NERRF_TRACE") == "1"

    # -- recording -----------------------------------------------------------

    def _reg(self):
        if self._registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            self._registry = DEFAULT_REGISTRY
        return self._registry

    @contextlib.contextmanager
    def span(self, stage: str, device: bool = False, **args):
        """Record a host-side span named ``stage`` (ring buffer and the
        ``stage_latency_seconds`` histogram); the yielded :class:`Span`
        exposes ``args`` for attributes the body learns mid-flight.
        ``device=True`` also opens a ``torch.profiler.record_function``
        region of the same name."""
        sp = Span(stage, args)
        ann = contextlib.nullcontext()
        if device:
            import torch

            ann = torch.profiler.record_function(stage)
        sp.t0 = time.perf_counter()
        try:
            with ann:
                yield sp
        finally:
            sp.dur = time.perf_counter() - sp.t0
            with self._lock:
                self._spans.append(sp)
                # latest name wins: CPython recycles thread idents, so a
                # cached dead thread's name must not label a new thread
                self._thread_names[sp.tid] = threading.current_thread().name
            self._reg().histogram_observe(
                STAGE_HISTOGRAM, sp.dur, buckets=STAGE_BUCKETS,
                labels={"stage": stage}, help=_STAGE_HELP)

    # -- inspection / export -------------------------------------------------

    def records(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (Perfetto / chrome://tracing)."""
        pid = os.getpid()
        with self._lock:
            spans = list(self._spans)
            names = dict(self._thread_names)
        events: List[dict] = [{
            "ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": "nerrf host"},
        }]
        for tid, tname in names.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": tname}})
        for s in spans:
            ev = {
                "name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
                "ts": round((s.t0 - self._t0_perf) * 1e6, 3),  # µs, epoch origin
                "dur": round(s.dur * 1e6, 3),
            }
            if s.args:
                ev["args"] = dict(s.args)
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "nerrf_tpu_torch.tracing",
                "epoch_anchor_unix_sec": self._t0_epoch,
            },
        }

    def write(self, path) -> str:
        """Write the Chrome-trace JSON to ``path`` (returns the path)."""
        path = os.fspath(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# The process-wide tracer every pipeline component records into (the span
# analogue of observability.DEFAULT_REGISTRY).
DEFAULT_TRACER = Tracer()


def span(stage: str, device: bool = False, **args):
    """``DEFAULT_TRACER.span`` — the one-import instrumentation point."""
    return DEFAULT_TRACER.span(stage, device=device, **args)


def records() -> List[Span]:
    """``DEFAULT_TRACER``'s recorded spans, oldest first."""
    return DEFAULT_TRACER.records()


def enabled() -> bool:
    """Whether hot loops open their per-step synced spans."""
    return DEFAULT_TRACER.enabled


def set_enabled(on: bool = True) -> None:
    """Opt hot loops into per-step synced attribution spans (see module
    docstring); the CLI's ``--trace-out`` calls this before the command."""
    DEFAULT_TRACER.enabled = bool(on)


@contextlib.contextmanager
def device_annotation(name: str):
    """A ``torch.profiler.record_function`` region named ``name``, for host
    regions that launch device work outside a recorded span."""
    import torch

    with torch.profiler.record_function(name):
        yield


# -- trace-file analysis (the `trace` subcommand's engine) ------------------


def load_chrome_trace(path) -> List[dict]:
    """Complete ("X") events from a Chrome-trace JSON file — accepts both
    the object form ({"traceEvents": [...]}) and a bare event list."""
    with open(os.fspath(path)) as f:
        data = json.load(f)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    if not isinstance(events, list):
        return []
    return [e for e in events if isinstance(e, dict) and e.get("ph") == "X"]


def stage_summary(events: Iterable[dict]) -> Dict[str, dict]:
    """Per-stage latency stats from "X" events: count, total/mean/p50/max ms."""
    by_name: Dict[str, List[float]] = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(float(e.get("dur", 0.0)))
    out: Dict[str, dict] = {}
    for name, durs in by_name.items():
        durs.sort()
        n = len(durs)
        out[name] = {
            "count": n,
            "total_ms": sum(durs) / 1e3,
            "mean_ms": sum(durs) / n / 1e3,
            "p50_ms": durs[n // 2] / 1e3,
            "max_ms": durs[-1] / 1e3,
        }
    return out


def wall_clock_us(events: Iterable[dict]) -> float:
    """Trace extent: max(ts+dur) − min(ts) over the "X" events, in µs."""
    lo, hi = None, None
    for e in events:
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        lo = t0 if lo is None else min(lo, t0)
        hi = t1 if hi is None else max(hi, t1)
    return 0.0 if lo is None else hi - lo


def coverage(events: Iterable[dict],
             lo_us: Optional[float] = None,
             hi_us: Optional[float] = None) -> float:
    """Fraction of [lo, hi] covered by the union of span intervals (nested
    and overlapping spans count once).  Defaults to the trace's own extent —
    the acceptance check "spans cover ≥ X% of wall-clock"."""
    ivals = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        for e in events
    )
    if not ivals:
        return 0.0
    if lo_us is None:
        lo_us = ivals[0][0]
    if hi_us is None:
        hi_us = max(b for _, b in ivals)
    if hi_us <= lo_us:
        return 0.0
    covered = 0.0
    cur_a, cur_b = None, None
    for a, b in ivals:
        a, b = max(a, lo_us), min(b, hi_us)
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                covered += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        covered += cur_b - cur_a
    return covered / (hi_us - lo_us)


def format_stage_table(events: Iterable[dict]) -> str:
    """Human-readable per-stage latency table (sorted by total time)."""
    events = list(events)
    summary = stage_summary(events)
    wall_ms = wall_clock_us(events) / 1e3
    header = (f"{'stage':<24} {'count':>7} {'total_ms':>10} {'mean_ms':>9} "
              f"{'p50_ms':>9} {'max_ms':>9} {'%wall':>6}")
    lines = [header, "-" * len(header)]
    for name, s in sorted(summary.items(), key=lambda kv: -kv[1]["total_ms"]):
        pct = 100.0 * s["total_ms"] / wall_ms if wall_ms > 0 else 0.0
        lines.append(
            f"{name:<24} {s['count']:>7} {s['total_ms']:>10.2f} "
            f"{s['mean_ms']:>9.3f} {s['p50_ms']:>9.3f} {s['max_ms']:>9.2f} "
            f"{pct:>5.1f}%")
    lines.append(f"wall: {wall_ms:.2f} ms, span coverage: "
                 f"{100.0 * coverage(events):.1f}%")
    return "\n".join(lines)
