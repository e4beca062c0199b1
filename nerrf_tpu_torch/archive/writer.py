"""Continuous telemetry archiving: journal + metrics + workload sketches.

A host copy of ``nerrf_tpu/archive/writer.py``, kept identical.

`ArchiveWriter` is the live half of the archive plane.  It feeds the
segmented spool (`archive.spool`) from three sources, all off the hot
path:

  * **journal records** — a listener on the `EventJournal` enqueues every
    record onto a bounded queue; a dedicated writer thread drains it to
    disk.  The serving/training planes pay one queue put per record —
    never file IO — and a wedged disk costs counted drops, not latency;
  * **metrics snapshots** — on a cadence, the full `MetricsRegistry`
    state (`metrics_snapshot` records), so gauge trajectories survive
    the process without a scrape stack;
  * **workload sketches** — mergeable fixed-bin `quality.Sketch`
    histograms of the observed workload: window node/edge/file sizes,
    per-bucket batch occupancy, per-stage latencies, device seconds per
    program, train step cadence.  Cumulative per run and stamped with a
    ``run`` id, so cross-host/cross-run aggregation is exact count
    addition (the pod-scale substrate), and `nerrf archive export
    --tune` reads the observed window-size distribution + per-bucket
    cost table straight out of the last sketch record.

Everything is fail-open and bounded: the queue drops (counted) under
backlog, the spool drops (counted) on disk errors, and
``nerrf_archive_writer_lag_seconds`` reports how far the writer trails
the producers.
"""

from __future__ import annotations

import dataclasses
import os
import platform
import queue
import threading
import time
from typing import Dict, Optional

from nerrf_tpu_torch.archive.spool import ArchiveSpool, SpoolConfig
from nerrf_tpu_torch.flight.journal import SCHEMA_VERSION, JournalRecord

# sketch ladders (the quality plane's COUNT_EDGES covers sizes; latencies
# get a decade ladder from 1 ms to a minute — device seconds and stage
# budgets both live inside it)
LATENCY_EDGES = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0, 15.0, 60.0)


@dataclasses.dataclass(frozen=True)
class ArchiveConfig:
    """Spool knobs + the writer's own cadence/backlog bounds."""

    out_dir: str = "telemetry-archive"
    segment_max_bytes: int = 4 * 1024 * 1024
    segment_max_age_sec: float = 300.0
    max_total_bytes: int = 256 * 1024 * 1024
    fsync_on_seal: bool = False
    # metrics_snapshot + workload_sketch cadence
    snapshot_every_sec: float = 30.0
    # bounded hand-off queue between producers and the writer thread
    queue_slots: int = 8192

    def spool_config(self) -> SpoolConfig:
        return SpoolConfig(
            out_dir=self.out_dir,
            segment_max_bytes=self.segment_max_bytes,
            segment_max_age_sec=self.segment_max_age_sec,
            max_total_bytes=self.max_total_bytes,
            fsync_on_seal=self.fsync_on_seal)


class ArchiveWriter:
    """Journal listener + cadence thread + sketch accumulator."""

    def __init__(self, cfg: ArchiveConfig, registry=None, journal=None,
                 log=None) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        if journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            journal = DEFAULT_JOURNAL
        self.cfg = cfg
        self._reg = registry
        self._journal = journal
        self._log = log or (lambda msg: None)
        self._spool = ArchiveSpool(cfg.spool_config(), registry=registry,
                                   log=self._log)
        # run identity: sketch/metrics records are CUMULATIVE per run, so
        # offline merging needs to know which increments belong together.
        # The random suffix matters: two writers in one process (bench
        # legs, tests) must never alias into one run
        self.run_id = (f"{platform.node()}-{os.getpid()}-"
                       f"{os.urandom(4).hex()}")
        self._q: "queue.Queue" = queue.Queue(maxsize=max(cfg.queue_slots, 1))
        # workload sketches (under _sketch_lock): name → Sketch, plus
        # exact running totals (count/sum) for the per-bucket cost table —
        # quantiles come from the sketch, means from the totals
        self._sketch_lock = threading.Lock()
        self._sketches: Dict[str, object] = {}
        self._totals: Dict[str, list] = {}
        # bundle→archive pointer state (written only by the writer
        # thread): the active segment + the journal seq range it holds
        self._pos_lock = threading.Lock()
        self._pos_segment: Optional[str] = None
        self._pos_lo: Optional[int] = None
        self._pos_hi: Optional[int] = None
        self._stop = threading.Event()
        # DAEMON on purpose (and jax-free, so the daemon-thread segfault
        # class does not apply): a boot failure between construction and
        # the owner's finally must never hang interpreter exit on this
        # loop, and the segment format tolerates an abandoned tail by
        # design — that IS the kill -9 contract.  Clean shutdowns still
        # drain and seal via the bounded join in close()
        self._thread = threading.Thread(target=self._drain_loop,
                                        daemon=True,
                                        name="nerrf-archive-writer")
        self._emit("archive_meta", {
            "schema": f"{SCHEMA_VERSION[0]}.{SCHEMA_VERSION[1]}",
            "hostname": platform.node(), "pid": os.getpid(),
            "snapshot_every_sec": cfg.snapshot_every_sec,
            "segment_max_bytes": cfg.segment_max_bytes,
            "max_total_bytes": cfg.max_total_bytes})
        self._thread.start()
        self._journal.subscribe(self._on_record)

    # -- producer-side intake (hot paths: enqueue / sketch only) --------------

    def _on_record(self, rec: JournalRecord) -> None:
        self._enqueue(rec.to_dict(), t_enq=time.monotonic())
        # journal-derived sketches: cheap single-value observes
        if rec.kind == "batch_close":
            occ = rec.data.get("occupancy")
            bucket = rec.data.get("bucket")
            if occ is not None and bucket is not None:
                self.observe_named(f"bucket_occupancy[{bucket}]",
                                   float(occ), ladder="count")
                self._total(f"occupancy[{bucket}]", float(occ))
        elif rec.kind == "train_health":
            sps = rec.data.get("steps_per_sec")
            if sps:
                self.observe_named("train_step_seconds",
                                   1.0 / float(sps), ladder="latency")
                self._total("train_steps", 1.0)

    def _enqueue(self, obj: dict, t_enq: float) -> None:
        try:
            self._q.put_nowait((t_enq, obj))
        except queue.Full:
            self._reg.counter_inc(
                "archive_dropped_total", labels={"reason": "queue_full"},
                help="telemetry records the archive could not persist, by "
                     "cause (queue_full = writer backlog, io_error = disk)")

    def observe_window(self, bucket: str, nodes: int, edges: int,
                       files: int, stages: Dict[str, float],
                       e2e_sec: float) -> None:
        """One scored window's measured structure + stage stamps (the
        serve demux boundary feeds this — same seam as the SLO and
        quality planes).  O(sketch bins) per call, no IO."""
        self.observe_named("window_nodes", float(nodes), ladder="count")
        self.observe_named("window_edges", float(edges), ladder="count")
        self.observe_named("window_files", float(files), ladder="count")
        self.observe_named("e2e_latency_seconds", float(e2e_sec),
                           ladder="latency")
        for stage, sec in stages.items():
            self.observe_named(f"stage_seconds[{stage}]",
                               max(float(sec), 0.0), ladder="latency")
        dev = stages.get("device")
        if dev is not None:
            self.observe_named(f"device_seconds[{bucket}]",
                               max(float(dev), 0.0), ladder="latency")
            self._total(f"device_seconds[{bucket}]", max(float(dev), 0.0))
        self._total(f"windows[{bucket}]", 1.0)

    def observe_rejected(self, nodes: int, edges: int, files: int) -> None:
        """One window admission REJECTED for size (no rung fits) — the
        demand beyond the top rung.  Recording its structure (not just a
        count) is what lets the `nerrf tune` corpus see the traffic a
        ladder extension would capture; same sketch plane, separate
        names, so the admitted distribution stays uncontaminated."""
        self.observe_named("rejected_window_nodes", float(nodes),
                           ladder="count")
        self.observe_named("rejected_window_edges", float(edges),
                           ladder="count")
        self.observe_named("rejected_window_files", float(files),
                           ladder="count")
        self._total("rejected_windows", 1.0)

    def observe_named(self, name: str, value: float,
                      ladder: str = "latency") -> None:
        """Feed one value into the named workload sketch (train loops and
        embedders use this directly; ladders: "count" = powers of two,
        "latency" = the decade ladder)."""
        from nerrf_tpu_torch.quality.sketch import COUNT_EDGES, Sketch

        edges = COUNT_EDGES if ladder == "count" else LATENCY_EDGES
        with self._sketch_lock:
            sk = self._sketches.get(name)
            if sk is None:
                sk = self._sketches[name] = Sketch.empty(edges)
            sk.observe([value])

    def _total(self, name: str, value: float) -> None:
        with self._sketch_lock:
            # nerrflint: ok[bounded-growth] keyed by the fixed stage/sketch name set the observe calls hard-code — cardinality is code-constant, not traffic-driven
            t = self._totals.setdefault(name, [0, 0.0])
            t[0] += 1
            t[1] += value

    # -- writer thread --------------------------------------------------------

    def _drain_loop(self) -> None:
        last_flush = time.monotonic()
        while True:
            try:
                t_enq, obj = self._q.get(timeout=0.25)
            except queue.Empty:
                t_enq, obj = None, None
            if obj is not None:
                self._write(obj)
                self._reg.gauge_set(
                    "archive_writer_lag_seconds",
                    max(time.monotonic() - t_enq, 0.0),
                    help="how far the archive writer trails its "
                         "producers (enqueue→disk for the newest record)")
            now = time.monotonic()
            if now - last_flush >= self.cfg.snapshot_every_sec:
                self._flush_snapshots()
                last_flush = now
            if self._stop.is_set() and self._q.empty():
                return

    def _write(self, obj: dict) -> None:
        self._spool.append(obj)
        seq = obj.get("seq")
        if seq is not None:
            seg = self._spool.active_segment
            with self._pos_lock:
                if seg != self._pos_segment:
                    self._pos_segment, self._pos_lo = seg, seq
                self._pos_hi = seq

    def _flush_snapshots(self) -> None:
        """Cut one metrics_snapshot + one workload_sketch record (the
        cadence, and the final flush at close)."""
        try:
            snap = self._reg.snapshot()
        except Exception as e:  # noqa: BLE001 — snapshots are advisory
            self._log(f"archive: metrics snapshot failed "
                      f"({type(e).__name__}: {e})")
            snap = None
        if snap is not None:
            self._emit("metrics_snapshot", snap, direct=True)
        with self._sketch_lock:
            sketches = {n: sk.to_dict() for n, sk in self._sketches.items()}
            totals = {n: {"count": t[0], "sum": t[1]}
                      for n, t in self._totals.items()}
        if sketches or totals:
            self._emit("workload_sketch",
                       {"cumulative": True, "sketches": sketches,
                        "totals": totals}, direct=True)

    def _emit(self, kind: str, data: dict, direct: bool = False) -> None:
        rec = {"v": f"{SCHEMA_VERSION[0]}.{SCHEMA_VERSION[1]}",
               "kind": kind, "t_wall": time.time(), "run": self.run_id,
               "data": data}
        if direct:
            self._write(rec)  # already on the writer thread
        else:
            self._enqueue(rec, t_enq=time.monotonic())

    # -- bundle pointer -------------------------------------------------------

    def position(self) -> Optional[dict]:
        """Where the archive is right now: the active segment and the
        journal seq range it holds — embedded in every flight bundle's
        manifest so `nerrf doctor` can point from a bundle to the
        surrounding archived context."""
        with self._pos_lock:
            if self._pos_segment is None:
                return {"dir": self.cfg.out_dir, "segment": None,
                        "journal_seq": None}
            return {"dir": self.cfg.out_dir,
                    "segment": self._pos_segment,
                    "journal_seq": {"lo": self._pos_lo,
                                    "hi": self._pos_hi}}

    # -- lifecycle ------------------------------------------------------------

    def close(self, timeout: float = 30.0) -> None:
        """Unsubscribe, drain the backlog, cut the final snapshot pair,
        seal the tail.  Idempotent."""
        if self._stop.is_set():
            return
        self._journal.unsubscribe(self._on_record)
        self._stop.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            # the drain did not finish in time (wedged disk, huge
            # backlog): do NOT flush/seal concurrently with a thread
            # that may still be appending — leave the tail unsealed,
            # which is exactly the crash shape every reader tolerates
            # and the next boot adopts
            self._log("archive: writer thread still draining at close; "
                      "leaving the tail unsealed (crash shape)")
            return
        self._flush_snapshots()
        self._spool.close()

    def __enter__(self) -> "ArchiveWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
