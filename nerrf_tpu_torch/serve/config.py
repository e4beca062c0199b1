"""Serving configuration: capacity-bucket ladder, batch-close policy,
backpressure knobs.

The port of ``nerrf_tpu/serve/config.py``.  The online service admits
windows from many streams and packs those that land in the same capacity
bucket into one shared padded batch, so the knobs here trade latency
(batch-close deadline) against occupancy (windows per forward) against
memory (queue bounds).  Every field keeps the reference's name and
default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from nerrf_tpu_torch.graph import GraphConfig
from nerrf_tpu_torch.train.data import DatasetConfig

# (max_nodes, max_edges, max_seqs) capacity bucket.
Bucket = Tuple[int, int, int]


def _default_buckets() -> Tuple[Bucket, ...]:
    """Default serving ladder: the warmup cross-product ladder
    (pipeline.DETECTOR_WARMUP_BUCKETS) prefixed with the corpus-fitted
    training bucket.  Every bucket of the configured set is warmed at
    service start; a window that fits none of them is rejected at
    admission (counted), never scored at a new shape."""
    from nerrf_tpu_torch.pipeline import DETECTOR_WARMUP_BUCKETS

    return ((256, 512, 128),) + tuple(DETECTOR_WARMUP_BUCKETS)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the online detection service (one forward shape per
    capacity bucket, shared across streams)."""

    # capacity buckets warmed at start; admission rejects windows that fit
    # none of them (no new shapes after warmup, ever)
    buckets: Tuple[Bucket, ...] = dataclasses.field(
        default_factory=_default_buckets)
    # padded batch shape: every forward is exactly this many window slots
    # (short batches are zero-padded, as offline model_detect pads them)
    batch_size: int = 8
    # close a bucket's batch when this many windows are pending (0: use
    # batch_size)...
    target_occupancy: int = 0
    # ...or when the oldest pending window has waited this long, whichever
    # first (the deadline half of the batch-close policy)
    batch_close_sec: float = 0.05
    # per-window end-to-end budget (admit → demux); windows scored after it
    # still deliver, but count into serve_late_windows_total
    window_deadline_sec: float = 2.0
    # per-stream bounded admission queue; overflowing drops that stream's
    # OLDEST pending window (newest evidence wins under sustained overload)
    stream_queue_slots: int = 64
    # bounded alert fan-out queue; a slow alert consumer drops (counted),
    # never blocks the demux thread
    alert_queue_slots: int = 256
    # closed-but-not-demuxed batches allowed per bucket; bounds queueing on
    # the scorer so one hot bucket cannot monopolize it
    max_inflight_batches: int = 2
    # windowing (mirrors GraphConfig defaults; serving must window exactly
    # like the offline path or parity dies)
    window_sec: float = 45.0
    stride_sec: float = 15.0
    seq_len: int = 100
    min_events: int = 4
    # detection operating point
    agg: str = "max"
    threshold: Optional[float] = None
    # warm every configured bucket at start() (readiness gates on it)
    warmup_on_start: bool = True
    # poison-batch bisection: a failed shared batch is split and retried to
    # isolate the offending window(s) instead of dropping every cohabiting
    # stream's windows; False fails the whole cohort
    bisect_failed_batches: bool = True
    # quarantine: after this many of one stream's windows are PROVEN batch
    # poison (bisection pinned the failure to the window while a sibling
    # scored), admission drops the stream's windows (reason="quarantined");
    # 0 disables stream quarantine
    quarantine_strikes: int = 8
    # a quarantined stream is released (strikes reset, journaled) after
    # this long; 0 makes quarantine permanent for the stream's lifetime
    quarantine_release_sec: float = 300.0
    # scorer watchdog: a single scoring call stuck longer than this marks
    # the batcher wedged: readiness fails and leave() stops waiting;
    # 0 disables
    scorer_wedge_sec: float = 60.0
    # detection-quality plane (quality/): trailing score/feature drift
    # sketches compared against the live version's reference profile,
    # exported as nerrf_quality_* gauges and cadenced quality_stats journal
    # records.  Host-side numpy at the demux boundary only; one None check
    # per window until a version with a profile is serving; False drops
    # the plane
    quality_monitoring: bool = True
    # SLO-aware shedding: when a stream's bounded queue overflows AND the
    # capacity-headroom predictor says the whole service is under pressure
    # (headroom below shed_headroom_margin), the victim window comes from
    # the stream burning the most SLO budget on the device (flight/slo)
    # instead of from the admitting stream: budget-burners lose evidence
    # first, healthy streams keep bit-parity.  Drop-oldest stays as the
    # intra-stream bound (and as the whole policy when this is False or
    # headroom shows slack)
    slo_aware_shedding: bool = True
    # predicted headroom (in streams) below which shedding goes SLO-ranked;
    # requires devtime_accounting (the headroom predictor)
    shed_headroom_margin: float = 1.0
    # trailing window of the devtime accountant's rate/cost/utilization
    # state (seconds): the headroom prediction follows traffic shifts at
    # this horizon
    devtime_window_sec: float = 60.0
    # device-efficiency plane (devtime/): live per-program MFU /
    # utilization / useful-FLOPs gauges and the capacity-headroom
    # predictor, fed from the scorer's measured seconds, with each bucket's
    # analytic cost traced on meta tensors on a background thread.  No
    # extra device work; False drops the plane
    devtime_accounting: bool = True

    @property
    def occupancy(self) -> int:
        return self.target_occupancy or self.batch_size

    def dataset_config(self, bucket: Bucket) -> DatasetConfig:
        """The DatasetConfig a window lowered into ``bucket`` uses: the
        shape authority.  Warmup, admission lowering and the offline parity
        reference (model_detect with auto_capacity=False) all build through
        here."""
        n, e, s = bucket
        return DatasetConfig(
            graph=GraphConfig(window_sec=self.window_sec,
                              stride_sec=self.stride_sec,
                              max_nodes=n, max_edges=e),
            seq_len=self.seq_len, max_seqs=s, min_events=self.min_events)


def bucket_tag(bucket: Bucket) -> str:
    """Human/metric label for a bucket, matching warmup_detector's tags."""
    return f"{bucket[0]}n/{bucket[1]}e/{bucket[2]}s"


def select_bucket(need_nodes: int, need_edges: int, need_seqs: int,
                  buckets: Tuple[Bucket, ...]) -> Optional[Bucket]:
    """Smallest configured bucket covering the window's exact needs
    (GraphConfig.fit's power-of-two rungs ARE the ladder entries, so
    first-fit on the capacity-sorted ladder lands on the bucket fit would,
    without ever making a shape outside the warmed set).

    Node/edge overflow is a hard miss (lowering would silently drop
    events), so a window whose graph fits NO configured bucket returns None
    and the caller must reject it, never resize.  Sequence overflow is
    soft: the lowering keeps the ``max_seqs`` densest per-file sequences,
    exactly like the offline path at a fixed DatasetConfig, so when no
    bucket covers the file count the smallest graph-fitting rung still
    wins, taking the most sequence slots available within that rung."""
    fits_graph = [b for b in sorted(buckets)
                  if b[0] >= need_nodes and b[1] >= need_edges]
    if not fits_graph:
        return None
    for b in fits_graph:
        if b[2] >= need_seqs:
            return b
    rung = fits_graph[0][:2]
    return max((b for b in fits_graph if b[:2] == rung),
               key=lambda b: b[2])
