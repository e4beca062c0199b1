"""Structured event journal: the serve path's bounded decision log.

A host copy of the reference's ``nerrf_tpu/flight/journal.py`` (stdlib
only), kept identical but for the registry it counts into.
`EventJournal` is a thread-safe ring of typed `JournalRecord`s, the "what
happened" companion to the span ring's "where did the time go".  Every
record carries a process-monotonic sequence number, wall-clock and
perf-counter timestamps (the perf stamp aligns with span times), a record
``kind``, and the stream/window/trace IDs it touched.

Record kinds the port writes (producers in parentheses):

    batch_close       a bucket's shared batch assembled (serve/batcher)
    batch_failed      a device batch's scoring raised (serve/batcher)
    batch_bisect      a failed batch split to isolate poison (serve/batcher)
    device_batch_failed  a window's terminal device failure, post-bisection
                      (serve/service)
    stream_quarantined   a stream hit its poison-strike limit (serve/service)
    stream_released   a quarantined stream's timed release (serve/service)
    scorer_wedged     the scorer watchdog tripped / recovered
    scorer_recovered  (serve/batcher; readiness fails while wedged)
    admission_drop    window dropped at admission, with reason (serve/service)
    demux_drop        alert evicted from the full sink, or lost to a
                      raising one (serve/alerts, serve/service)
    readiness         admission opened/closed (serve/service)
    config            serve config fingerprint at start (serve/service)
    registry_swap     live weights hot-swapped (serve/service)
    reconnect         a followed stream's wire session restarted
                      (serve/service connect)
    incident_enqueued an incident admitted or evicted (respond/incidents)
    plan_emitted      a batched plan left the planner (respond/router)
    plan_verified     a plan passed the sandbox gate (respond/verify)
    plan_rejected     a plan quarantined, with its reason (respond/verify)
    exception         a router wave raised; the loop went on (respond/router)

``KNOWN_KINDS`` keeps the reference's full list, so records the two
packages write stay readable by the same readers.  The ring records
unconditionally: an append is a lock, a deque append and a counter
increment, bounded memory by construction.  Listeners run OUTSIDE the
journal lock, so a slow listener never blocks producers.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

# Journal jsonl schema version, stamped on every serialized record as
# ``"v": "<major>.<minor>"``.  Archived segments and flight bundles
# outlive the process that wrote them, so readers apply the usual
# compatibility ladder: a MINOR bump adds fields (old readers ignore
# them, new readers tolerate their absence); a MAJOR bump changes the
# meaning of existing fields, and an older reader must refuse rather
# than misreport evidence.  Bump the minor when adding record fields,
# the major only when a field's meaning changes.
SCHEMA_VERSION = (1, 0)

#: Every record kind a journal producer emits today (producers in the
#: module docstring above, plus compile/profile/capacity records from
#: compilecache/, devtime/ and the archive plane).  The schema roundtrip
#: test iterates this tuple — a new kind that is not registered here is
#: a kind the archive/doctor readers have never been proven against.
KNOWN_KINDS = (
    "batch_close", "batch_failed", "batch_bisect", "device_batch_failed",
    "stream_quarantined", "stream_released", "scorer_wedged",
    "scorer_recovered", "reconnect", "admission_drop", "demux_drop",
    "readiness", "config", "slo_breach", "fault_injected", "chaos_armed",
    "chaos_disarmed", "registry_publish", "registry_shadow",
    "registry_promote", "registry_veto", "registry_swap",
    "registry_shadow_stats", "quality_reference", "quality_stats",
    "capacity_saturation", "compile", "compile_cache_prune",
    "profile_capture", "profile_failed", "train_start", "train_done",
    "train_health", "fleet_scale", "fleet_rebalance", "fleet_shed",
    "incident_enqueued", "plan_emitted", "plan_verified", "plan_rejected",
    "rollback_step_failed",
    "alert_disposition", "retrain_triggered", "retrain_done",
    "retrain_aborted",
    "archive_meta", "metrics_snapshot", "workload_sketch", "replay_window",
    "exception", "bundle",
)


class SchemaVersionError(ValueError):
    """A serialized record's schema MAJOR is newer than this reader."""


def _format_version(v: tuple) -> str:
    return f"{v[0]}.{v[1]}"


def check_schema_version(v, what: str = "journal record") -> None:
    """Reader-side gate: tolerate same/older majors and newer minors
    (additive fields), refuse a newer MAJOR with a one-line error —
    misreading re-defined fields is worse than not reading at all.
    ``None`` (a record written before versioning) passes."""
    if v is None:
        return
    try:
        major = int(str(v).split(".", 1)[0])
    except (TypeError, ValueError):
        raise SchemaVersionError(
            f"{what} carries an unparseable schema version {v!r}") from None
    if major > SCHEMA_VERSION[0]:
        raise SchemaVersionError(
            f"{what} schema v{v} is newer than this reader's "
            f"v{_format_version(SCHEMA_VERSION)} — upgrade nerrf_tpu_torch to "
            f"read it")


def make_trace_id(stream: str, window_idx: int, lo_ns: int) -> str:
    """Deterministic per-window trace ID: the same (stream, window, epoch)
    always maps to the same ID, so journal records, spans, alerts and
    offline reprocessing join on it without coordination."""
    h = hashlib.blake2s(f"{stream}:{window_idx}:{lo_ns}".encode(),
                        digest_size=6).hexdigest()
    return f"w-{h}"


def fingerprint(obj) -> str:
    """Short stable fingerprint of a config/params-identity object (repr
    based — for dataclass configs repr is canonical and total)."""
    return hashlib.blake2s(repr(obj).encode(), digest_size=6).hexdigest()


@dataclasses.dataclass
class JournalRecord:
    """One journal entry.  ``data`` is the kind-specific payload (bucket,
    occupancy, reason, version, …) — JSON-serializable by contract."""

    seq: int
    t_wall: float           # unix seconds (human timeline)
    t_perf: float           # perf-counter seconds (joins with span ts)
    kind: str
    stream: Optional[str] = None
    window_id: Optional[int] = None
    trace_id: Optional[str] = None
    data: Dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"v": _format_version(SCHEMA_VERSION), "seq": self.seq,
             "t_wall": self.t_wall, "t_perf": self.t_perf,
             "kind": self.kind}
        if self.stream is not None:
            d["stream"] = self.stream
        if self.window_id is not None:
            d["window_id"] = self.window_id
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.data:
            d["data"] = self.data
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "JournalRecord":
        check_schema_version(d.get("v"))
        return cls(seq=int(d["seq"]), t_wall=float(d["t_wall"]),
                   t_perf=float(d.get("t_perf", 0.0)), kind=str(d["kind"]),
                   stream=d.get("stream"), window_id=d.get("window_id"),
                   trace_id=d.get("trace_id"), data=dict(d.get("data") or {}))


class EventJournal:
    """Bounded, thread-safe, listener-fanning record ring."""

    def __init__(self, capacity: int = 4096, registry=None) -> None:
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=max(capacity, 1))
        self._seq = 0
        self._registry = registry
        self._listeners: List[Callable[[JournalRecord], None]] = []

    def _reg(self):
        if self._registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            self._registry = DEFAULT_REGISTRY
        return self._registry

    # -- producing -----------------------------------------------------------

    def record(self, kind: str, stream: Optional[str] = None,
               window_id: Optional[int] = None,
               trace_id: Optional[str] = None, **data) -> JournalRecord:
        with self._lock:
            self._seq += 1
            rec = JournalRecord(
                seq=self._seq, t_wall=time.time(),
                t_perf=time.perf_counter(), kind=kind, stream=stream,
                window_id=window_id, trace_id=trace_id, data=data)
            self._records.append(rec)
            listeners = list(self._listeners)
        self._reg().counter_inc(
            "flight_journal_records_total", labels={"kind": kind},
            help="structured journal records appended, by record kind")
        # listeners run OUTSIDE the lock: a trigger evaluating (or a bundle
        # dumping) must never serialize unrelated producers
        for fn in listeners:
            try:
                fn(rec)
            except Exception:  # noqa: BLE001 — observers are advisory
                pass
        return rec

    def subscribe(self, fn: Callable[[JournalRecord], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def unsubscribe(self, fn: Callable[[JournalRecord], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    # -- reading -------------------------------------------------------------

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def tail(self, n: Optional[int] = None,
             kinds: Optional[tuple] = None,
             since_seq: Optional[int] = None) -> List[JournalRecord]:
        """Newest-last slice of the ring: at most ``n`` records, optionally
        filtered by kind and/or a minimum (exclusive) sequence number."""
        with self._lock:
            recs = list(self._records)
        if kinds is not None:
            recs = [r for r in recs if r.kind in kinds]
        if since_seq is not None:
            recs = [r for r in recs if r.seq > since_seq]
        return recs[-n:] if n is not None else recs

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def to_jsonl(self, n: Optional[int] = None) -> str:
        return "".join(json.dumps(r.to_dict()) + "\n" for r in self.tail(n))

    def write(self, path, n: Optional[int] = None) -> str:
        path = os.fspath(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_jsonl(n))
        return path


def load_journal(path) -> List[JournalRecord]:
    """Parse a journal.jsonl back into records (the doctor's reader).
    Malformed lines are skipped, not fatal — a bundle written mid-crash is
    still evidence.  A NEWER-MAJOR schema stamp is NOT malformed: it
    propagates (`SchemaVersionError`) so the doctor/report can refuse
    with one line instead of silently misreading re-defined fields."""
    out: List[JournalRecord] = []
    with open(os.fspath(path)) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(JournalRecord.from_dict(json.loads(line)))
            except SchemaVersionError:
                raise
            except (ValueError, KeyError, TypeError):
                continue
    return out


# The process-wide journal every pipeline component records into (the
# decision-log analogue of observability.DEFAULT_REGISTRY and
# tracing.DEFAULT_TRACER).
DEFAULT_JOURNAL = EventJournal()
