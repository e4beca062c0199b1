"""Segmented on-disk telemetry spool: append-only jsonl, crash-safe.

A host copy of ``nerrf_tpu/archive/spool.py``, kept identical.

The archive plane's storage primitive.  One spool is one directory of
**segments**:

    <dir>/seg-00000001-20260801T120000.jsonl        sealed (immutable)
    <dir>/seg-00000002-20260801T120500.jsonl        sealed
    <dir>/seg-00000003-20260801T121000.jsonl.open   active (append tail)

Invariants the readers and `verify_archive` rely on:

  * one JSON object per line; the writer appends and flushes per record,
    never rewrites — a ``kill -9`` can truncate at most the final line
    of the active segment, and every *sealed* segment is immutable;
  * sealing is ``os.replace`` of the ``.open`` name onto the final name:
    a reader listing the directory either sees the sealed file or the
    open one, never a torn rename;
  * segment names embed a monotonic sequence number, so lexicographic
    order IS chronological order and retention-by-name ("delete the
    oldest") can never be a naming accident (the flight recorder's
    bundle-retention lesson);
  * a leftover ``.open`` segment from a crashed process is ADOPTED at
    the next boot — sealed as-is, partial tail and all — so no record
    that reached the disk is ever discarded by a restart.

Rotation is by bytes OR age (whichever first), retention is a total-byte
bound over the directory.  Everything is fail-open: an unwritable disk
costs records (counted in ``nerrf_archive_dropped_total``), never an
exception into the producer.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
from typing import Iterable, List, Optional, Tuple

SEGMENT_RE = re.compile(r"^seg-(\d{8})-(\d{8}T\d{6})\.jsonl$")
OPEN_SUFFIX = ".open"


@dataclasses.dataclass(frozen=True)
class SpoolConfig:
    """Rotation + retention knobs (the docs/archive.md defaults)."""

    out_dir: str = "telemetry-archive"
    # rotate the active segment past this many bytes…
    segment_max_bytes: int = 4 * 1024 * 1024
    # …or past this age (whichever first): a quiet service still seals
    # its evidence on a bounded cadence, so a crash loses minutes, not
    # a day of accumulated tail
    segment_max_age_sec: float = 300.0
    # retention: delete oldest sealed segments beyond this TOTAL size
    max_total_bytes: int = 256 * 1024 * 1024
    # fsync per seal (not per record — per-record fsync would put a disk
    # round-trip on the writer thread's drain loop)
    fsync_on_seal: bool = False


class ArchiveSpool:
    """The writer side: append dicts as jsonl lines, rotate, prune."""

    def __init__(self, cfg: SpoolConfig, registry=None,
                 log=None) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        self.cfg = cfg
        self._reg = registry
        self._log = log or (lambda msg: None)
        self._lock = threading.Lock()
        self._fh = None
        self._active_path: Optional[str] = None
        self._active_bytes = 0
        self._active_opened = 0.0
        self._seg_n = 0
        self.sealed = 0          # segments sealed by this process
        self.pruned = 0          # segments deleted by retention
        self.records = 0         # records appended by this process
        self._broken = False     # last append failed (retry each time)
        try:
            os.makedirs(cfg.out_dir, exist_ok=True)
            self._adopt_leftovers()
        except OSError as e:
            # fail-open from the first breath: an uncreatable archive dir
            # downgrades every append to a counted drop
            self._log(f"archive: cannot prepare {cfg.out_dir} "
                      f"({type(e).__name__}: {e}); spooling disabled")
            self._broken = True

    # -- writing --------------------------------------------------------------

    def append(self, obj: dict) -> bool:
        """Serialize one record and append it to the active segment.
        Returns False (and counts a drop) instead of raising — the spool
        must never take its producer down with it."""
        try:
            line = json.dumps(obj, separators=(",", ":")) + "\n"
        except Exception as e:  # noqa: BLE001 — fail-open by contract:
            # whatever the encoder throws (hostile __repr__, recursion,
            # not just TypeError/ValueError) costs one counted record,
            # never the producer thread
            self._drop("unserializable")
            self._log(f"archive: unserializable record dropped "
                      f"({type(e).__name__}: {e})")
            return False
        data = line.encode()
        ok = True
        fail_msg = None
        with self._lock:
            try:
                self._rotate_if_due_locked()
                fh = self._ensure_open_locked()
                fh.write(data)
                fh.flush()
                self._active_bytes += len(data)
                self.records += 1
                self._broken = False
            except Exception as e:  # noqa: BLE001 — fail-open: a
                # non-OSError out of rotate/open/write is a spool bug,
                # but it still must cost a counted drop, not the
                # producer; the segment is closed and re-opened on the
                # next append either way
                self._close_locked()
                ok = False
                if not self._broken:
                    fail_msg = (f"archive: append failed "
                                f"({type(e).__name__}: {e}); dropping "
                                f"until the spool recovers")
                self._broken = True
        if not ok:
            if fail_msg is not None:
                self._log(fail_msg)
            self._drop("io_error")
            return False
        self._reg.counter_inc(
            "archive_records_total",
            help="records appended to the telemetry archive spool")
        self._reg.counter_inc(
            "archive_bytes_total", float(len(data)),
            help="bytes appended to the telemetry archive spool")
        return True

    def rotate(self) -> None:
        """Seal the active segment now (close/flush/rename) and enforce
        retention.  Idempotent when nothing is open."""
        fail_msg = None
        with self._lock:
            try:
                self._seal_locked()
                self._prune_locked()
            except OSError as e:
                fail_msg = (f"archive: rotate failed "
                            f"({type(e).__name__}: {e})")
        if fail_msg is not None:
            self._log(fail_msg)

    def close(self) -> None:
        """Seal whatever is open — a clean shutdown leaves no ``.open``
        tail behind (only a crash does, and adoption covers that)."""
        self.rotate()

    @property
    def active_segment(self) -> Optional[str]:
        """Basename of the segment the next append lands in (the sealed
        name the ``.open`` file will take), or None when nothing is
        open — the flight bundle's archive-context pointer."""
        with self._lock:
            if self._active_path is None:
                return None
            return os.path.basename(self._active_path[:-len(OPEN_SUFFIX)])

    # -- internals (all under self._lock) -------------------------------------

    def _adopt_leftovers(self) -> None:
        """Seal any ``.open`` segment a crashed predecessor left behind
        (its partial tail is tolerated by every reader) and resume the
        sequence numbering after the highest existing segment."""
        for name in sorted(os.listdir(self.cfg.out_dir)):
            if name.endswith(OPEN_SUFFIX) and SEGMENT_RE.match(
                    name[:-len(OPEN_SUFFIX)]):
                src = os.path.join(self.cfg.out_dir, name)
                os.replace(src, src[:-len(OPEN_SUFFIX)])
                self._log(f"archive: adopted crashed segment {name}")
            m = SEGMENT_RE.match(name[:-len(OPEN_SUFFIX)]
                                 if name.endswith(OPEN_SUFFIX) else name)
            if m:
                # nerrflint: ok[lock-discipline] __init__-only: runs before the spool is published to any other thread, so the counter is still single-owner here
                self._seg_n = max(self._seg_n, int(m.group(1)))

    def _ensure_open_locked(self):
        if self._fh is None:
            self._seg_n += 1
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            name = f"seg-{self._seg_n:08d}-{stamp}.jsonl{OPEN_SUFFIX}"
            self._active_path = os.path.join(self.cfg.out_dir, name)
            # nerrflint: ok[blocking-under-lock] segment open is part of the serialized append path (see append)
            self._fh = open(self._active_path, "ab")
            self._active_bytes = 0
            self._active_opened = time.monotonic()
        return self._fh

    def _rotate_if_due_locked(self) -> None:
        if self._fh is None:
            return
        due = (self._active_bytes >= self.cfg.segment_max_bytes
               or (time.monotonic() - self._active_opened
                   >= self.cfg.segment_max_age_sec))
        if due:
            self._seal_locked()
            self._prune_locked()

    def _seal_locked(self) -> None:
        if self._fh is None:
            return
        if self.cfg.fsync_on_seal:
            self._fh.flush()
            # nerrflint: ok[blocking-under-lock] seal (flush/fsync/rename) must be atomic wrt concurrent appends — serializing it under the spool lock is the design
            os.fsync(self._fh.fileno())
        self._fh.close()
        final = self._active_path[:-len(OPEN_SUFFIX)]
        os.replace(self._active_path, final)
        self._fh = None
        self._active_path = None
        self._active_bytes = 0
        self.sealed += 1

    def _close_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        self._fh = None
        # keep _active_path: a later successful open mints a NEW segment,
        # and adoption at the next boot seals whatever this one holds
        self._active_path = None
        self._active_bytes = 0

    def _prune_locked(self) -> None:
        # nerrflint: ok[blocking-under-lock] retention deletes must never race a concurrent seal's os.replace on the same directory — same contract as the flight recorder's dump lock
        sealed = sorted(n for n in os.listdir(self.cfg.out_dir)
                        if SEGMENT_RE.match(n))
        sizes = {}
        for n in sealed:
            try:
                sizes[n] = os.path.getsize(
                    os.path.join(self.cfg.out_dir, n))
            except OSError:
                sizes[n] = 0
        total = sum(sizes.values()) + self._active_bytes
        for n in sealed:
            if total <= self.cfg.max_total_bytes:
                break
            try:
                os.remove(os.path.join(self.cfg.out_dir, n))
                total -= sizes[n]
                self.pruned += 1
                self._reg.counter_inc(
                    "archive_segments_pruned_total",
                    help="sealed archive segments deleted by the "
                         "retention bound (oldest first)")
            except OSError:
                continue

    def _drop(self, reason: str) -> None:
        self._reg.counter_inc(
            "archive_dropped_total", labels={"reason": reason},
            help="telemetry records the archive could not persist, by "
                 "cause (queue_full = writer backlog, io_error = disk)")


# -- reading ------------------------------------------------------------------


def list_segments(path) -> List[str]:
    """Segment basenames of an archive directory, oldest first; the
    active ``.open`` tail (if any) last.  Raises FileNotFoundError when
    the directory does not exist (callers print their own one-liner)."""
    names = os.listdir(os.fspath(path))
    sealed = sorted(n for n in names if SEGMENT_RE.match(n))
    live = sorted(n for n in names if n.endswith(OPEN_SUFFIX)
                  and SEGMENT_RE.match(n[:-len(OPEN_SUFFIX)]))
    return sealed + live


def is_archive_dir(path) -> bool:
    """Whether ``path`` looks like a telemetry archive (the doctor's
    bundle-vs-archive dispatch)."""
    try:
        return bool(list_segments(path))
    except OSError:
        return False


def read_segment(path) -> Tuple[List[dict], bool, int]:
    """Parse one segment → ``(records, partial_tail, corrupt_lines)``.

    A final line that does not parse (or is unterminated) is the
    *partial tail* a kill -9 legitimately leaves — tolerated, flagged.
    A malformed line anywhere ELSE is corruption and is counted.  A
    newer-MAJOR schema stamp propagates (`SchemaVersionError`) instead
    of being mistaken for corruption."""
    from nerrf_tpu_torch.flight.journal import check_schema_version

    records: List[dict] = []
    corrupt = 0
    partial = False
    with open(os.fspath(path), "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    terminated = raw.endswith(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    for i, line in enumerate(lines):
        last = i == len(lines) - 1
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("not an object")
        except ValueError:
            if last and not terminated:
                partial = True
            elif last:
                partial = True  # terminated but unparseable final line:
                # still the torn-write shape (power loss mid-flush)
            else:
                corrupt += 1
            continue
        check_schema_version(rec.get("v"), what=f"archive record "
                             f"({os.path.basename(os.fspath(path))})")
        records.append(rec)
    return records, partial, corrupt


def iter_records(paths, since: Optional[float] = None,
                 until: Optional[float] = None,
                 kinds: Optional[Iterable[str]] = None):
    """Yield records from one or more archive directories in segment
    order, optionally filtered by ``t_wall`` range and record kind."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    kinds = set(kinds) if kinds is not None else None
    for root in paths:
        root = os.fspath(root)
        for name in list_segments(root):
            records, _partial, _corrupt = read_segment(
                os.path.join(root, name))
            for rec in records:
                t = rec.get("t_wall")
                if since is not None and (t is None or t < since):
                    continue
                if until is not None and (t is None or t > until):
                    continue
                if kinds is not None and rec.get("kind") not in kinds:
                    continue
                yield rec


def verify_archive(path) -> dict:
    """Integrity report over one archive directory.  A partial tail
    (torn LAST line) keeps ``ok`` True on any segment — every crash
    tears at most the final line of the segment it abandoned, and an
    adopted crash segment stays in the middle of the directory for the
    rest of its life.  Mid-segment corruption or an unreadable segment
    flips ``ok`` False: that is rewritten history, not a crash."""
    root = os.fspath(path)
    names = list_segments(root)
    segments = []
    ok = True
    total_records = 0
    total_bytes = 0
    for name in names:
        p = os.path.join(root, name)
        entry = {"segment": name, "bytes": 0, "records": 0,
                 "partial_tail": False, "corrupt_lines": 0, "error": None}
        try:
            entry["bytes"] = os.path.getsize(p)
            records, partial, corrupt = read_segment(p)
            entry["records"] = len(records)
            entry["partial_tail"] = partial
            entry["corrupt_lines"] = corrupt
            if corrupt:
                ok = False
        except OSError as e:
            entry["error"] = f"{type(e).__name__}: {e}"
            ok = False
        total_records += entry["records"]
        total_bytes += entry["bytes"]
        segments.append(entry)
    return {"dir": root, "ok": ok, "segments": segments,
            "records": total_records, "bytes": total_bytes}


def prune_archive(path, max_total_bytes: int) -> dict:
    """Out-of-band retention (`nerrf archive prune`): delete the oldest
    SEALED segments until the directory fits ``max_total_bytes``.  Never
    opens a spool and never touches a ``.open`` tail — the directory may
    belong to a LIVE writer, whose active segment must stay its own
    (adopting it mid-flight would seal a file the writer still appends
    to and break the sealed-segments-are-immutable invariant)."""
    root = os.fspath(path)
    names = os.listdir(root)
    sealed = sorted(n for n in names if SEGMENT_RE.match(n))
    live = [n for n in names if n.endswith(OPEN_SUFFIX)
            and SEGMENT_RE.match(n[:-len(OPEN_SUFFIX)])]

    def size(n: str) -> int:
        try:
            return os.path.getsize(os.path.join(root, n))
        except OSError:
            return 0

    total = sum(size(n) for n in sealed + live)
    pruned = 0
    for n in sealed:
        if total <= max_total_bytes:
            break
        try:
            sz = size(n)
            os.remove(os.path.join(root, n))
            total -= sz
            pruned += 1
        except OSError:
            continue
    return {"dir": root, "pruned": pruned, "bytes": total,
            "max_bytes": max_total_bytes, "live_segments": len(live)}


def merge_archives(sources, out_dir, registry=None, log=None) -> dict:
    """Merge N archive directories into a fresh one at ``out_dir`` —
    the cross-host aggregation substrate.  Records are interleaved by
    wall time (journal ``seq`` breaks ties within one source) and each
    gains a ``src`` stamp naming the archive it came from, so per-run
    sketch/metrics records stay attributable (the report merges sketches
    across ``src`` values by count addition, which is exact)."""
    import heapq

    def stream(root):
        # one source's records are append-ordered by a single writer, so
        # its t_wall sequence is (near-)monotone — a k-way heap merge
        # over per-source generators keeps memory at O(segment), not
        # O(fleet): N pods × 256 MiB of retention must not have to fit
        # in the operator box's RAM
        root = os.fspath(root)
        src = os.path.basename(os.path.normpath(root)) or root
        for i, rec in enumerate(iter_records(root)):
            rec = dict(rec)
            rec.setdefault("src", src)
            yield ((rec.get("t_wall") or 0.0, src,
                    rec.get("seq") or i), rec)

    merged = heapq.merge(*(stream(root) for root in sources),
                         key=lambda e: e[0])
    spool = ArchiveSpool(
        SpoolConfig(out_dir=os.fspath(out_dir),
                    # merge output is an analysis artifact: no age churn,
                    # no retention surprise — one bound, caller-owned
                    segment_max_age_sec=float("inf"),
                    max_total_bytes=1 << 62),
        registry=registry, log=log)
    written = 0
    for _key, rec in merged:
        if spool.append(rec):
            written += 1
    spool.close()
    return {"sources": [os.fspath(s) for s in sources],
            "out": os.fspath(out_dir), "records": written,
            "segments": len(list_segments(out_dir))}
