"""ctypes bindings for the native ingest bridge (libnerrf_ingest.so).

The port of ``nerrf_tpu/ingest/bridge.py``.  The library is built by
``make`` from the repository's own ``native/`` sources into the port's
git-ignored ``ops/_build/native/`` (never into ``native/build/``, which the
reference builds into), under a file lock, so processes that build at once
never hand each other a half-written library.  ``IngestBridge.is_native``
says which decoder a bridge runs.

The hot host-side path of the pipeline: raw eBPF ring bytes or protobuf
``EventBatch`` frames become `EventArrays` columns in one native call, with
paths/comms interned to dense ids in C++.  It replaces upstream NERRF's
per-event Go decode loop (`tracker/cmd/tracker/main.go:219-267`), which
parses one 568-byte record into one protobuf message at a time; the native
bridge decodes a whole buffer in one call.

Falls back to a pure-Python decoder (numpy structured dtype / protobuf stubs)
when the shared library cannot be built — same results, library optional;
``IngestBridge(use_native=False)`` asks for that decoder, ``True`` raises
without the library.
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from nerrf_tpu_torch.schema import EventArrays, StringTable

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
NATIVE_BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "_build" / "native"
_LIB_PATH = NATIVE_BUILD_DIR / "libnerrf_ingest.so"

RECORD_SIZE = 568
COMM_LEN = 16
PATH_LEN = 256

# numpy view of struct nerrf_event_record (native/include/nerrf/event_record.h)
RECORD_DTYPE = np.dtype(
    {
        "names": [
            "ts_ns", "pid", "tid", "comm", "syscall_id", "_pad",
            "ret_val", "bytes", "path", "new_path",
        ],
        "formats": [
            np.uint64, np.uint32, np.uint32, f"S{COMM_LEN}", np.uint32,
            np.uint32, np.int64, np.uint64, f"S{PATH_LEN}", f"S{PATH_LEN}",
        ],
        "offsets": [0, 8, 12, 16, 32, 36, 40, 48, 56, 312],
        "itemsize": RECORD_SIZE,
    }
)


class _Columns(ctypes.Structure):
    _fields_ = [
        ("ts_ns", ctypes.POINTER(ctypes.c_int64)),
        ("pid", ctypes.POINTER(ctypes.c_int32)),
        ("tid", ctypes.POINTER(ctypes.c_int32)),
        ("comm_id", ctypes.POINTER(ctypes.c_int32)),
        ("syscall_id", ctypes.POINTER(ctypes.c_int32)),
        ("path_id", ctypes.POINTER(ctypes.c_int32)),
        ("new_path_id", ctypes.POINTER(ctypes.c_int32)),
        ("flags", ctypes.POINTER(ctypes.c_int32)),
        ("ret_val", ctypes.POINTER(ctypes.c_int64)),
        ("bytes", ctypes.POINTER(ctypes.c_int64)),
        ("inode", ctypes.POINTER(ctypes.c_int64)),
        ("mode", ctypes.POINTER(ctypes.c_int32)),
        ("uid", ctypes.POINTER(ctypes.c_int32)),
        ("gid", ctypes.POINTER(ctypes.c_int32)),
        ("valid", ctypes.POINTER(ctypes.c_uint8)),
    ]


def load_native_lib(lib_filename: str, build: bool = True) -> Optional[ctypes.CDLL]:
    """Load ``ops/_build/native/<lib_filename>``, first bringing it up to
    date with ``make -C native BUILD=<that directory>`` (best-effort;
    callers fall back to their Python engines on None).  The build and the
    load hold an exclusive lock on ``<that directory>/.lock``."""
    lib_path = NATIVE_BUILD_DIR / lib_filename
    NATIVE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(NATIVE_BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if build:
            try:
                subprocess.run(
                    ["make", "-s", "-C", str(_NATIVE_DIR),
                     f"BUILD={NATIVE_BUILD_DIR}", str(lib_path)],
                    capture_output=True, timeout=120, check=False,
                )
            except (OSError, subprocess.TimeoutExpired):
                pass
        if not lib_path.exists():
            return None
        return ctypes.CDLL(str(lib_path))


def _load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    lib = load_native_lib("libnerrf_ingest.so", build)
    if lib is None:
        return None
    lib.nerrf_ingest_new.restype = ctypes.c_void_p
    lib.nerrf_ingest_free.argtypes = [ctypes.c_void_p]
    lib.nerrf_decode_ring.restype = ctypes.c_int64
    lib.nerrf_decode_ring.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
        ctypes.POINTER(_Columns), ctypes.c_size_t,
    ]
    lib.nerrf_decode_batch.restype = ctypes.c_int64
    lib.nerrf_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(_Columns), ctypes.c_size_t,
    ]
    lib.nerrf_pool_size.restype = ctypes.c_int64
    lib.nerrf_pool_size.argtypes = [ctypes.c_void_p]
    lib.nerrf_pool_bytes.restype = ctypes.c_int64
    lib.nerrf_pool_bytes.argtypes = [ctypes.c_void_p]
    lib.nerrf_pool_dump.restype = ctypes.c_int64
    lib.nerrf_pool_dump.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t,
    ]
    return lib


_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def native_available() -> bool:
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        _LIB = _load_library()
    return _LIB is not None


def _alloc_columns(n: int):
    arrs = {
        "ts_ns": np.zeros(n, np.int64),
        "pid": np.zeros(n, np.int32),
        "tid": np.zeros(n, np.int32),
        "comm_id": np.zeros(n, np.int32),
        "syscall_id": np.zeros(n, np.int32),
        "path_id": np.zeros(n, np.int32),
        "new_path_id": np.zeros(n, np.int32),
        "flags": np.zeros(n, np.int32),
        "ret_val": np.zeros(n, np.int64),
        "bytes": np.zeros(n, np.int64),
        "inode": np.zeros(n, np.int64),
        "mode": np.zeros(n, np.int32),
        "uid": np.zeros(n, np.int32),
        "gid": np.zeros(n, np.int32),
        "valid": np.zeros(n, np.uint8),
    }
    cols = _Columns(
        **{
            name: arr.ctypes.data_as(ctypes.POINTER(ctyp))
            for (name, ctyp), arr in zip(
                (
                    ("ts_ns", ctypes.c_int64), ("pid", ctypes.c_int32),
                    ("tid", ctypes.c_int32), ("comm_id", ctypes.c_int32),
                    ("syscall_id", ctypes.c_int32), ("path_id", ctypes.c_int32),
                    ("new_path_id", ctypes.c_int32), ("flags", ctypes.c_int32),
                    ("ret_val", ctypes.c_int64), ("bytes", ctypes.c_int64),
                    ("inode", ctypes.c_int64), ("mode", ctypes.c_int32),
                    ("uid", ctypes.c_int32), ("gid", ctypes.c_int32),
                    ("valid", ctypes.c_uint8),
                ),
                arrs.values(),
            )
        }
    )
    return arrs, cols


class IngestBridge:
    """Stateful decoder: its intern pool persists across calls, so string ids
    are stable for the bridge's lifetime (one bridge per stream session)."""

    def __init__(self, use_native: Optional[bool] = None) -> None:
        if use_native is None:
            use_native = native_available()
        elif use_native and not native_available():
            raise RuntimeError(f"native ingest library not available at {_LIB_PATH}")
        self._native = bool(use_native)
        if self._native:
            self._handle = ctypes.c_void_p(_LIB.nerrf_ingest_new())
        else:
            self._strings = StringTable()

    def close(self) -> None:
        if self._native and self._handle:
            _LIB.nerrf_ingest_free(self._handle)
            self._handle = None

    def __enter__(self) -> "IngestBridge":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def is_native(self) -> bool:
        return self._native

    # --- decoding ------------------------------------------------------------

    def decode_ring(self, buf: bytes, boot_epoch_ns: int = 0) -> EventArrays:
        """Concatenated 568-byte ring records → EventArrays."""
        if len(buf) % RECORD_SIZE:
            raise ValueError(f"ring buffer length {len(buf)} not a multiple of {RECORD_SIZE}")
        n = len(buf) // RECORD_SIZE
        if self._native:
            arrs, cols = _alloc_columns(n)
            got = _LIB.nerrf_decode_ring(
                self._handle, buf, len(buf), boot_epoch_ns, ctypes.byref(cols), n
            )
            if got != n:
                raise ValueError(f"native ring decode failed: {got}")
            return self._to_events(arrs)

        rec = np.frombuffer(buf, dtype=RECORD_DTYPE)
        out = EventArrays.empty(n)
        out.ts_ns[:] = rec["ts_ns"].astype(np.int64) + boot_epoch_ns
        out.pid[:] = rec["pid"]
        out.tid[:] = rec["tid"]
        out.syscall[:] = rec["syscall_id"]
        out.ret_val[:] = rec["ret_val"]
        out.bytes[:] = rec["bytes"].astype(np.int64)
        for i in range(n):
            out.comm_id[i] = self._strings.intern(_cstr(rec["comm"][i]))
            out.path_id[i] = self._strings.intern(_cstr(rec["path"][i]))
            out.new_path_id[i] = self._strings.intern(_cstr(rec["new_path"][i]))
        out.valid[:] = True
        return out

    def decode_batch(self, frame: bytes, max_events: int = 4096) -> EventArrays:
        """One serialized nerrf.trace.EventBatch frame → EventArrays."""
        if self._native:
            arrs, cols = _alloc_columns(max_events)
            got = _LIB.nerrf_decode_batch(
                self._handle, frame, len(frame), ctypes.byref(cols), max_events
            )
            if got < 0:
                raise ValueError("native batch decode failed (malformed frame or > max_events)")
            # copy: a [:got] view would pin the full max_events allocation
            # behind every decoded block for the life of the stream
            arrs = {k: v[:got].copy() for k, v in arrs.items()}
            return self._to_events(arrs)

        from nerrf_tpu_torch.ingest import trace_pb2

        batch = trace_pb2.EventBatch.FromString(frame)
        records = []
        for ev in batch.events:
            records.append(
                {
                    "ts_ns": ev.ts.seconds * 1_000_000_000 + ev.ts.nanos,
                    "pid": ev.pid,
                    "tid": ev.tid or ev.pid,
                    "comm": ev.comm,
                    "syscall": ev.syscall,
                    "path": ev.path,
                    "new_path": ev.new_path,
                    "flags": ev.flags,
                    "ret_val": ev.ret_val,
                    "bytes": ev.bytes,
                    "inode": int(ev.inode) if ev.inode.isdigit() else 0,
                    "mode": ev.mode,
                    "uid": ev.uid,
                    "gid": ev.gid,
                }
            )
        return EventArrays.from_records(records, self._strings)

    # --- string pool ---------------------------------------------------------

    def string_table(self) -> StringTable:
        """The intern pool as a StringTable (ids preserved).  The pool is
        append-only, so the table is cached and extended incrementally —
        per-frame callers (iter_blocks) pay only for new strings."""
        if not self._native:
            return self._strings
        size = _LIB.nerrf_pool_size(self._handle)
        table = getattr(self, "_table_cache", None)
        if table is None:
            table = StringTable()
            self._table_cache = table
        if len(table) < size:
            nbytes = _LIB.nerrf_pool_bytes(self._handle)
            data = ctypes.create_string_buffer(max(nbytes, 1))
            offsets = (ctypes.c_int64 * (size + 1))()
            got = _LIB.nerrf_pool_dump(self._handle, data, nbytes, offsets, size + 1)
            if got != size:
                raise RuntimeError("pool dump failed")
            raw = data.raw[:nbytes]
            for i in range(len(table), size):
                s = raw[offsets[i] : offsets[i + 1]].decode("utf-8", "replace")
                if table.intern(s) != i:
                    raise RuntimeError(f"non-contiguous intern pool at id {i}")
        return table

    def _to_events(self, arrs: dict) -> EventArrays:
        return EventArrays(
            ts_ns=arrs["ts_ns"], pid=arrs["pid"], tid=arrs["tid"],
            comm_id=arrs["comm_id"], syscall=arrs["syscall_id"],
            path_id=arrs["path_id"], new_path_id=arrs["new_path_id"],
            flags=arrs["flags"], ret_val=arrs["ret_val"], bytes=arrs["bytes"],
            inode=arrs["inode"], mode=arrs["mode"], uid=arrs["uid"],
            gid=arrs["gid"], valid=arrs["valid"].astype(np.bool_),
        )


def _cstr(b: bytes) -> str:
    return b.split(b"\0", 1)[0].decode("utf-8", "replace")


def encode_ring_records(events: EventArrays, strings: StringTable) -> bytes:
    """EventArrays → concatenated 568-byte ring records (test/replay helper —
    the inverse of decode_ring for fields the binary record carries)."""
    n = len(events)
    rec = np.zeros(n, dtype=RECORD_DTYPE)
    rec["ts_ns"] = events.ts_ns.astype(np.uint64)
    rec["pid"] = events.pid.astype(np.uint32)
    rec["tid"] = events.tid.astype(np.uint32)
    rec["syscall_id"] = events.syscall.astype(np.uint32)
    rec["ret_val"] = events.ret_val
    rec["bytes"] = events.bytes.astype(np.uint64)
    for i in range(n):
        rec["comm"][i] = strings.lookup(int(events.comm_id[i])).encode()[: COMM_LEN - 1]
        rec["path"][i] = strings.lookup(int(events.path_id[i])).encode()[: PATH_LEN - 1]
        rec["new_path"][i] = strings.lookup(int(events.new_path_id[i])).encode()[: PATH_LEN - 1]
    return rec.tobytes()


def events_to_batch_frames(
    events: EventArrays, strings: StringTable, batch_size: int = 64
) -> list[bytes]:
    """EventArrays → serialized EventBatch frames (the replay service's wire
    encoder; actually batches, unlike the reference daemon — see trace.proto)."""
    from nerrf_tpu_torch.ingest import trace_pb2

    frames = []
    batch = trace_pb2.EventBatch()
    for rec in events.iter_records(strings):
        ev = batch.events.add()
        ns = rec["ts_ns"]
        ev.ts.seconds, ev.ts.nanos = divmod(ns, 1_000_000_000)
        ev.pid = rec["pid"]
        ev.tid = rec["tid"]
        ev.comm = rec["comm"]
        ev.syscall = rec["syscall"]
        ev.path = rec["path"]
        ev.new_path = rec["new_path"]
        ev.flags = min(rec["flags"], 2)
        ev.ret_val = rec["ret_val"]
        ev.bytes = rec["bytes"]
        ev.inode = str(rec["inode"]) if rec["inode"] else ""
        ev.mode = rec["mode"]
        ev.uid = rec["uid"]
        ev.gid = rec["gid"]
        if len(batch.events) >= batch_size:
            frames.append(batch.SerializeToString())
            batch = trace_pb2.EventBatch()
    if batch.events:
        frames.append(batch.SerializeToString())
    return frames
