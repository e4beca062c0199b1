"""Time-bucketed trace store: ctypes binding + format-compatible fallback.

The port of ``nerrf_tpu/graph/store.py``; ``libnerrf_tracestore.so`` is
built from the repository's ``native/`` sources into the port's own
``ops/_build/native/`` (`ingest.bridge.load_native_lib`).

The persistence layer the reference specified as "RocksDB with 30 s delta
compaction" for its trace/graph data (the upstream NERRF `README.md:113`,
`ROADMAP.md:58`) but never implemented.  Here it is an embedded store whose
compaction unit *is* the graph constructor's time bucket, so the sliding
window of `architecture.mdx:32-43` reads only the segments it overlaps.

Two interchangeable engines over one on-disk format (byte-compatible, see
native/include/nerrf/tracestore.h):

  * native C++ (`libnerrf_tracestore.so`, built on demand) — the production
    path, keeping hot appends/queries off the Python heap;
  * pure-Python fallback — same files, used when no toolchain is available
    (or asked for: ``use_native=False``).

A store written by one engine opens under the other; tests assert this.
"""

from __future__ import annotations

import ctypes
import re
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from nerrf_tpu_torch.ingest.bridge import (_Columns, _alloc_columns,
                                           load_native_lib)
from nerrf_tpu_torch.schema.events import EventArrays, StringTable
from nerrf_tpu_torch.tracing import span as trace_span

_LIB_NAME = "libnerrf_tracestore.so"

DEFAULT_BUCKET_NS = 30 * 10**9
AUTO_FLUSH_ROWS = 1 << 18  # keep in sync with tracestore.cc kAutoFlushRows
_MAGIC = b"NRRFSEG1"

RECORD_DTYPE = np.dtype([
    ("ts_ns", "<i8"), ("pid", "<i4"), ("tid", "<i4"), ("comm_id", "<i4"),
    ("syscall", "<i4"), ("path_id", "<i4"), ("new_path_id", "<i4"),
    ("flags", "<i4"), ("ret_val", "<i8"), ("bytes", "<i8"), ("inode", "<i8"),
    ("mode", "<i4"), ("uid", "<i4"), ("gid", "<i4"),
])
assert RECORD_DTYPE.itemsize == 72


def _load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    lib = load_native_lib(_LIB_NAME, build)
    if lib is None:
        return None
    lib.nerrf_store_open.restype = ctypes.c_void_p
    lib.nerrf_store_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.nerrf_store_close.argtypes = [ctypes.c_void_p]
    lib.nerrf_store_append.restype = ctypes.c_int64
    lib.nerrf_store_append.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_Columns), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_size_t,
    ]
    for name in ("flush", "num_strings", "num_segments", "delta_rows",
                 "total_rows"):
        fn = getattr(lib, f"nerrf_store_{name}")
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.nerrf_store_query_count.restype = ctypes.c_int64
    lib.nerrf_store_query_count.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.nerrf_store_query.restype = ctypes.c_int64
    lib.nerrf_store_query.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(_Columns), ctypes.c_size_t,
    ]
    lib.nerrf_store_string.restype = ctypes.c_char_p
    lib.nerrf_store_string.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    return lib


_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def store_native_available() -> bool:
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        _LIB = _load_library()
    return _LIB is not None


def _events_as_columns(events: EventArrays) -> Tuple[_Columns, list]:
    """EventArrays → a _Columns view (keeps the backing arrays alive)."""
    keep = []

    def ptr(arr, ctyp):
        arr = np.ascontiguousarray(arr)
        keep.append(arr)
        return arr.ctypes.data_as(ctypes.POINTER(ctyp))

    cols = _Columns(
        ts_ns=ptr(events.ts_ns, ctypes.c_int64),
        pid=ptr(events.pid, ctypes.c_int32),
        tid=ptr(events.tid, ctypes.c_int32),
        comm_id=ptr(events.comm_id, ctypes.c_int32),
        syscall_id=ptr(events.syscall, ctypes.c_int32),
        path_id=ptr(events.path_id, ctypes.c_int32),
        new_path_id=ptr(events.new_path_id, ctypes.c_int32),
        flags=ptr(events.flags, ctypes.c_int32),
        ret_val=ptr(events.ret_val, ctypes.c_int64),
        bytes=ptr(events.bytes, ctypes.c_int64),
        inode=ptr(events.inode, ctypes.c_int64),
        mode=ptr(events.mode, ctypes.c_int32),
        uid=ptr(events.uid, ctypes.c_int32),
        gid=ptr(events.gid, ctypes.c_int32),
        valid=ptr(events.valid.astype(np.uint8), ctypes.c_uint8),
    )
    return cols, keep


class TraceStore:
    """One store directory; see module docstring for the engine contract."""

    def __init__(self, root: str | Path, bucket_sec: float = 30.0,
                 use_native: Optional[bool] = None) -> None:
        self.root = Path(root)
        self.bucket_ns = int(bucket_sec * 1e9)
        # a stored BUCKET wins: bucket math must match the on-disk segments.
        # Tolerate a corrupt/empty file (crash mid-create) like the native
        # engine does — fall back to the caller's value.
        bpath = self.root / "BUCKET"
        if bpath.exists():
            try:
                stored = int(bpath.read_text().strip())
            except ValueError:
                stored = 0
            if stored > 0:
                self.bucket_ns = stored
        else:
            self.root.mkdir(parents=True, exist_ok=True)
            tmp = self.root / ".BUCKET.tmp"
            tmp.write_text(f"{self.bucket_ns}\n")
            tmp.rename(bpath)
        if use_native is None:
            use_native = store_native_available()
        elif use_native and not store_native_available():
            raise RuntimeError(f"native store library {_LIB_NAME} not available")
        self._native = bool(use_native)
        if self._native:
            handle = _LIB.nerrf_store_open(str(self.root).encode(), self.bucket_ns)
            if not handle:
                raise OSError(f"nerrf_store_open failed for {self.root}")
            self._handle = ctypes.c_void_p(handle)
        else:
            self._py = _PyStore(self.root, self.bucket_ns)
        # pool view handed to query() callers; the pool is append-only and ids
        # are stable, so the table is extended incrementally, never rebuilt
        self._pool_view = StringTable()

    # --- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        if self._native:
            if self._handle:
                _LIB.nerrf_store_close(self._handle)
                self._handle = None
        else:
            self._py.close()

    def __enter__(self) -> "TraceStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def is_native(self) -> bool:
        return self._native

    # --- writes -------------------------------------------------------------

    def append(self, events: EventArrays, strings: StringTable) -> int:
        if self._native:
            cols, keep = _events_as_columns(events)
            pool = [s.encode() for s in strings.strings()]
            arr = (ctypes.c_char_p * len(pool))(*pool)
            got = _LIB.nerrf_store_append(
                self._handle, ctypes.byref(cols), len(events), arr, len(pool)
            )
            del keep
            if got < 0:
                raise OSError("nerrf_store_append failed")
            return int(got)
        return self._py.append(events, strings)

    def flush(self) -> int:
        with trace_span("store_compact") as sp:
            if self._native:
                got = _LIB.nerrf_store_flush(self._handle)
                if got < 0:
                    raise OSError("nerrf_store_flush failed")
                got = int(got)
            else:
                got = self._py.flush()
            sp.args["segments"] = got
        from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

        DEFAULT_REGISTRY.counter_inc(
            "store_compactions_total", got,
            help="bucket segments written by delta compaction")
        DEFAULT_REGISTRY.gauge_set(
            "store_segments", self.num_segments,
            help="live segment files in the trace store")
        return got

    # --- reads --------------------------------------------------------------

    def query_count(self, start_ns: int, end_ns: int) -> int:
        if self._native:
            return int(_LIB.nerrf_store_query_count(self._handle, start_ns, end_ns))
        return self._py.query_count(start_ns, end_ns)

    def query(self, start_ns: int, end_ns: int) -> Tuple[EventArrays, StringTable]:
        """Events in [start_ns, end_ns) sorted by time, with a StringTable
        whose ids match the returned columns (identity view of the pool)."""
        with trace_span("store_query"):
            return self._query(start_ns, end_ns)

    def _query(self, start_ns: int, end_ns: int) -> Tuple[EventArrays, StringTable]:
        if self._native:
            # start with a window-sized guess; on -(needed)-1 retry with the
            # exact size.  Bounded by total rows so allocation never exceeds
            # the store; typical window queries never retry more than once.
            cap = min(int(_LIB.nerrf_store_total_rows(self._handle)), 1 << 16)
            while True:
                arrs, cols = _alloc_columns(cap)
                got = _LIB.nerrf_store_query(
                    self._handle, start_ns, end_ns, ctypes.byref(cols), cap
                )
                if got >= 0:
                    break
                if got == -1:
                    raise OSError("nerrf_store_query failed")
                cap = -int(got) - 1  # needed size reported by the store
            n = int(got)
            arrs = {k: v[:n] for k, v in arrs.items()}
            events = EventArrays(
                ts_ns=arrs["ts_ns"], pid=arrs["pid"], tid=arrs["tid"],
                comm_id=arrs["comm_id"], syscall=arrs["syscall_id"],
                path_id=arrs["path_id"], new_path_id=arrs["new_path_id"],
                flags=arrs["flags"], ret_val=arrs["ret_val"],
                bytes=arrs["bytes"], inode=arrs["inode"], mode=arrs["mode"],
                uid=arrs["uid"], gid=arrs["gid"],
                valid=arrs["valid"].astype(np.bool_),
            )
        else:
            events = self._py.query_events(start_ns, end_ns)
        return events, self._pool_table()

    def _pool_table(self) -> StringTable:
        """Extend the cached pool view up to the current pool size."""
        start = len(self._pool_view)
        if self._native:
            total = int(_LIB.nerrf_store_num_strings(self._handle))
            for i in range(start, total):
                s = _LIB.nerrf_store_string(self._handle, i)
                self._pool_view.intern(
                    s.decode("utf-8", "replace") if s is not None else "")
        else:
            for s in self._py.strings[start:]:
                self._pool_view.intern(s)
        return self._pool_view

    # --- observability ------------------------------------------------------

    @property
    def num_segments(self) -> int:
        if self._native:
            return int(_LIB.nerrf_store_num_segments(self._handle))
        return self._py.num_segments

    @property
    def delta_rows(self) -> int:
        if self._native:
            return int(_LIB.nerrf_store_delta_rows(self._handle))
        return sum(len(r) for r in self._py.delta)

    @property
    def num_strings(self) -> int:
        if self._native:
            return int(_LIB.nerrf_store_num_strings(self._handle))
        return len(self._py.strings)


# --------------------------------------------------------------------------
# pure-Python engine (same format)
# --------------------------------------------------------------------------

class _PyStore:
    def __init__(self, root: Path, bucket_ns: int) -> None:
        self.root = root
        self.bucket_ns = bucket_ns
        self.segdir = root / "segments"
        self.segdir.mkdir(parents=True, exist_ok=True)
        self.delta: list[np.ndarray] = []  # RECORD_DTYPE rows
        self.strings: list[str] = [""]
        self.index: dict[str, int] = {"": 0}
        self.next_seq = 0
        self.segments: dict[int, tuple[int, Path]] = {}  # bucket -> (seq, path)

        slog = root / "strings.log"
        if slog.exists():
            data = slog.read_bytes()
            off, good, pool = 0, 0, []
            while off + 4 <= len(data):
                (ln,) = struct.unpack_from("<I", data, off)
                if off + 4 + ln > len(data):
                    break  # truncated tail
                pool.append(data[off + 4:off + 4 + ln].decode("utf-8", "replace"))
                off += 4 + ln
                good = off
            for s in pool:
                if s not in self.index:
                    self.index[s] = len(self.strings)
                    self.strings.append(s)
            if good < len(data):
                # drop the torn bytes so appends land on a record boundary
                with open(slog, "r+b") as f:
                    f.truncate(good)
        self._slog = open(slog, "ab")
        if self._slog.tell() == 0:
            for s in self.strings:
                b = s.encode()
                self._slog.write(struct.pack("<I", len(b)) + b)

        stale = []
        # segment names are "<mn>-<mx>-<seq>.seg" where mn/mx may be negative
        # (bucket < 0 for pre-epoch ts_ns) — split from the right so leading
        # minus signs parse, matching the native engine's sscanf
        seg_re = re.compile(r"^(-?\d+)-(-?\d+)-(\d+)$")
        for p in sorted(self.segdir.glob("*.seg")):
            m = seg_re.match(p.stem)
            if not m:
                continue
            mn, mx, seq = (int(x) for x in m.groups())
            self.next_seq = max(self.next_seq, seq + 1)
            cur = self.segments.get(mn)
            if cur is None or seq > cur[0]:
                if cur is not None:
                    stale.append(cur[1])
                self.segments[mn] = (seq, p, mx)
            else:
                stale.append(p)
        for p in stale:
            p.unlink(missing_ok=True)

    def close(self) -> None:
        self.flush()
        self._slog.close()

    def _intern(self, s: str) -> int:
        got = self.index.get(s)
        if got is not None:
            return got
        idx = len(self.strings)
        self.index[s] = idx
        self.strings.append(s)
        b = s.encode()
        self._slog.write(struct.pack("<I", len(b)) + b)
        return idx

    def append(self, events: EventArrays, strings: StringTable) -> int:
        remap = np.array([self._intern(s) for s in strings.strings()], np.int32)

        def mapped(ids):
            ids = np.asarray(ids, np.int64)
            ok = (ids >= 0) & (ids < len(remap))
            return np.where(ok, remap[np.clip(ids, 0, len(remap) - 1)], 0)

        mask = events.valid.astype(bool)
        n = int(mask.sum())
        rec = np.zeros(n, RECORD_DTYPE)
        rec["ts_ns"] = events.ts_ns[mask]
        rec["pid"] = events.pid[mask]
        rec["tid"] = events.tid[mask]
        rec["comm_id"] = mapped(events.comm_id[mask])
        rec["syscall"] = events.syscall[mask]
        rec["path_id"] = mapped(events.path_id[mask])
        rec["new_path_id"] = mapped(events.new_path_id[mask])
        rec["flags"] = events.flags[mask]
        rec["ret_val"] = events.ret_val[mask]
        rec["bytes"] = events.bytes[mask]
        rec["inode"] = events.inode[mask]
        rec["mode"] = events.mode[mask]
        rec["uid"] = events.uid[mask]
        rec["gid"] = events.gid[mask]
        self.delta.append(rec)
        if sum(len(r) for r in self.delta) >= AUTO_FLUSH_ROWS:
            self.flush()
        return n

    def _read_segment(self, path: Path) -> np.ndarray:
        data = path.read_bytes()
        if len(data) < 16 or data[:8] != _MAGIC:
            return np.zeros(0, RECORD_DTYPE)
        (count,) = struct.unpack_from("<Q", data, 8)
        return np.frombuffer(
            data, RECORD_DTYPE, count=count, offset=16
        ).copy()

    def _write_segment(self, bucket: int, rec: np.ndarray) -> None:
        seq = self.next_seq
        self.next_seq += 1
        name = f"{bucket}-{bucket + self.bucket_ns - 1}-{seq}.seg"
        final = self.segdir / name
        tmp = final.with_suffix(".seg.tmp")
        with open(tmp, "wb") as f:
            f.write(_MAGIC + struct.pack("<Q", len(rec)) + rec.tobytes())
        tmp.rename(final)
        old = self.segments.get(bucket)
        if old is not None:
            old[1].unlink(missing_ok=True)
        self.segments[bucket] = (seq, final, bucket + self.bucket_ns - 1)

    def flush(self) -> int:
        if not self.delta:
            return 0
        self._slog.flush()
        rec = np.concatenate(self.delta)
        rec = rec[np.argsort(rec["ts_ns"], kind="stable")]
        buckets = rec["ts_ns"] - (rec["ts_ns"] % self.bucket_ns)
        written = 0
        for bucket in np.unique(buckets):
            merged = rec[buckets == bucket]
            old = self.segments.get(int(bucket))
            if old is not None:
                merged = np.concatenate([self._read_segment(old[1]), merged])
                merged = merged[np.argsort(merged["ts_ns"], kind="stable")]
            self._write_segment(int(bucket), merged)
            written += 1
        self.delta.clear()
        return written

    def _collect(self, start_ns: int, end_ns: int) -> np.ndarray:
        parts = []
        for bucket, (_, path, max_ts) in self.segments.items():
            # skip by the segment's own stored bounds, not current bucket_ns
            if max_ts < start_ns or bucket >= end_ns:
                continue
            rec = self._read_segment(path)
            parts.append(rec[(rec["ts_ns"] >= start_ns) & (rec["ts_ns"] < end_ns)])
        for rec in self.delta:
            parts.append(rec[(rec["ts_ns"] >= start_ns) & (rec["ts_ns"] < end_ns)])
        if not parts:
            return np.zeros(0, RECORD_DTYPE)
        out = np.concatenate(parts)
        return out[np.argsort(out["ts_ns"], kind="stable")]

    def query_count(self, start_ns: int, end_ns: int) -> int:
        return len(self._collect(start_ns, end_ns))

    def query_events(self, start_ns: int, end_ns: int) -> EventArrays:
        rec = self._collect(start_ns, end_ns)
        return EventArrays(
            ts_ns=rec["ts_ns"].copy(), pid=rec["pid"].copy(),
            tid=rec["tid"].copy(), comm_id=rec["comm_id"].copy(),
            syscall=rec["syscall"].copy(), path_id=rec["path_id"].copy(),
            new_path_id=rec["new_path_id"].copy(), flags=rec["flags"].copy(),
            ret_val=rec["ret_val"].copy(), bytes=rec["bytes"].copy(),
            inode=rec["inode"].copy(), mode=rec["mode"].copy(),
            uid=rec["uid"].copy(), gid=rec["gid"].copy(),
            valid=np.ones(len(rec), np.bool_),
        )

    @property
    def num_segments(self) -> int:
        return len(self.segments)
