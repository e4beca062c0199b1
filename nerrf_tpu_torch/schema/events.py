"""Typed syscall-event records as structure-of-arrays.

(Copied from ``nerrf_tpu/schema/events.py`` so the port needs nothing of the JAX
package; keep the two identical: the parity tests compare their arrays.)

This is the TPU-native equivalent of the reference wire schema
(upstream NERRF `proto/trace.proto:11-53`, message ``Event`` with
ts/pid/tid/comm/syscall/path/new_path/flags/ret_val/bytes/inode/mode/uid/gid).
Where the reference keeps events as individual protobuf messages and streams
them one per batch (`tracker/cmd/tracker/main.go:238-252`), we keep them as a
structure-of-arrays (`EventArrays`) from the moment they leave the ingest
bridge: every field is a fixed-dtype numpy column, strings are interned into a
`StringTable`, and the whole block can be moved to device memory with a single
transfer. Static shapes + dense columns are what XLA wants; per-event Python
objects are what it cannot use.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from datetime import datetime, timezone
from typing import Iterable, Iterator, Mapping, Sequence

import numpy as np


class Syscall(enum.IntEnum):
    """Syscall identity, densely coded for embedding lookups.

    The reference tracker captures openat/write/rename
    (`tracker/bpf/tracepoints.c:43-81`) and reserves room for more
    (`proto/trace.proto:20`: "openat", "write", "rename", "unlink").  We code a
    slightly wider set so benign background workloads are expressible; unknown
    names map to OTHER rather than failing.
    """

    OPENAT = 0
    WRITE = 1
    RENAME = 2
    READ = 3
    UNLINK = 4
    CLOSE = 5
    EXEC = 6
    CONNECT = 7
    STAT = 8
    MKDIR = 9
    CHMOD = 10
    FSYNC = 11
    MARKER = 12  # simulator/bench phase markers (not a kernel syscall)
    OTHER = 13

    @classmethod
    def parse(cls, name: str) -> "Syscall":
        try:
            return cls[name.upper()]
        except KeyError:
            return cls.OTHER


# Syscalls that change file CONTENT/existence — the only events that can
# create an undo obligation (reads/opens/stats observe; they never need
# rolling back).  ONE definition, shared by the detector's undo-candidacy
# gate (pipeline.model_detect) and the adversarial eval's FP-undo ground
# truth (benchmarks/run_adversarial_eval.py) — those two must never drift,
# or the KPI silently changes meaning.  CHMOD/MKDIR are excluded because
# the rollback executor restores content, not metadata/dir trees
# (rollback/sandbox.py's replay dispatch).
MUTATING_SYSCALLS = frozenset(
    (int(Syscall.WRITE), int(Syscall.RENAME), int(Syscall.UNLINK)))


class OpenFlags(enum.IntEnum):
    """Access mode for openat, mirroring `proto/trace.proto:25-29`."""

    O_RDONLY = 0
    O_WRONLY = 1
    O_RDWR = 2


# Ransomware-style extensions the detectors treat as a strong indicator
# ("Extension pattern (.lockbit, .locked)" — reference
# docs/content/docs/architecture.mdx:118 detection-indicator table).
SUSPICIOUS_EXTENSIONS = (
    ".lockbit",
    ".lockbit3",
    ".locked",
    ".encrypted",
    ".enc",
    ".crypt",
    ".crypted",
    ".pay",
    ".ransom",
)

# Benign extensions get stable small ids; everything else hashes into a bucket.
_KNOWN_EXTENSIONS = (
    ".dat",
    ".txt",
    ".log",
    ".csv",
    ".json",
    ".db",
    ".bak",
    ".tmp",
    ".html",
    ".png",
    ".pdf",
) + SUSPICIOUS_EXTENSIONS

_EXT_INDEX = {e: i + 1 for i, e in enumerate(_KNOWN_EXTENSIONS)}
_EXT_HASH_BUCKETS = 32
EXT_VOCAB = 1 + len(_KNOWN_EXTENSIONS) + _EXT_HASH_BUCKETS

PATH_FEATURE_DIM = 8


def _stable_hash(s: str) -> int:
    """FNV-1a 64-bit — deterministic across processes (unlike hash())."""
    h = np.uint64(0xCBF29CE484222325)
    for b in s.encode("utf-8", "surrogatepass"):
        h = np.uint64((int(h) ^ b) * 0x100000001B3 % (1 << 64))
    return int(h)


def extension_id(path: str) -> int:
    dot = path.rfind(".")
    if dot <= 0 or dot < path.rfind("/"):
        return 0
    ext = path[dot:].lower()
    if ext in _EXT_INDEX:
        return _EXT_INDEX[ext]
    return 1 + len(_KNOWN_EXTENSIONS) + _stable_hash(ext) % _EXT_HASH_BUCKETS


def is_suspicious_extension(path: str) -> bool:
    dot = path.rfind(".")
    return dot > 0 and path[dot:].lower() in SUSPICIOUS_EXTENSIONS


def path_features(path: str) -> np.ndarray:
    """Static per-path indicator features, float32 [PATH_FEATURE_DIM].

    Encodes the detection indicators from the reference threat model
    (`docs/content/docs/threat-model.mdx:176-189`: extension pattern, /proc
    reads, target-directory membership) as dense features.
    """
    depth = path.count("/")
    return np.array(
        [
            1.0 if path.startswith("/proc") else 0.0,
            1.0 if path.startswith("/tmp") else 0.0,
            1.0 if path.startswith("/etc") or path.startswith("/usr") else 0.0,
            1.0 if "/uploads" in path or "/app" in path else 0.0,
            1.0 if is_suspicious_extension(path) else 0.0,
            1.0 if path.rsplit("/", 1)[-1].upper().startswith("README") else 0.0,
            min(depth, 8) / 8.0,
            min(len(path), 256) / 256.0,
        ],
        dtype=np.float32,
    )


class InodeTable:
    """Stable synthetic inode assignment for traces that lack inode fields.

    One path ⇒ one inode, and a rename carries the inode to the destination
    path — the invariant behind the reference's "node merging (inode
    deduplication)" (`architecture.mdx:39`).  Shared by the trace loaders and
    the synthetic generator so the policy cannot drift between them.

    Synthetic ids live in a range (≥ 2^48) that real filesystem inodes do not
    reach in practice, so mixed traces (some records carrying real inodes,
    some not) cannot collide two distinct files onto one id.
    """

    SYNTHETIC_BASE = 1 << 48

    def __init__(self) -> None:
        self._of: dict[str, int] = {}
        self._next = self.SYNTHETIC_BASE

    def get(self, path: str) -> int:
        if not path:
            return 0
        got = self._of.get(path)
        if got is None:
            got = self._of[path] = self._next
            self._next += 1
        return got

    def carry_rename(self, src: str, dst: str) -> int:
        """Record src→dst rename; returns the carried inode.  The src name
        is invalidated (POSIX: it no longer refers to any file), so a later
        open of the old name allocates a fresh inode — without this, benign
        re-touches of a renamed path would alias the renamed file's node and
        steal its identity in inode→path maps (pipeline attribution bug)."""
        ino = self.get(src)
        if dst:
            self._of[dst] = ino
            # src != dst guard: rename(a, a) is a legal no-op — deleting the
            # mapping would split one file into two synthetic identities
            if src != dst and src in self._of:
                del self._of[src]
        return ino

    def register(self, path: str, inode: int, new_path: str = "") -> None:
        """Pin a real (externally supplied) inode to path(s), so later
        inode-less records for the same file resolve consistently."""
        if inode:
            if path:
                self._of[path] = inode
            if new_path:
                self._of[new_path] = inode


class StringTable:
    """Interns strings to dense int32 ids; id 0 is always the empty string.

    Plays the role of the reference's raw string fields (path/new_path/comm,
    `proto/trace.proto:21-23`) in array form: device code only ever sees ids
    and precomputed per-string feature rows.
    """

    def __init__(self) -> None:
        self._index: dict[str, int] = {"": 0}
        self._strings: list[str] = [""]
        self._feat_rows: list[np.ndarray] = [np.zeros(PATH_FEATURE_DIM, np.float32)]

    def __len__(self) -> int:
        return len(self._strings)

    def intern(self, s: str) -> int:
        got = self._index.get(s)
        if got is not None:
            return got
        idx = len(self._strings)
        self._index[s] = idx
        self._strings.append(s)
        self._feat_rows.append(path_features(s))
        return idx

    def lookup(self, idx: int) -> str:
        return self._strings[idx]

    def features(self) -> np.ndarray:
        """[num_strings, PATH_FEATURE_DIM] float32 feature matrix."""
        return np.stack(self._feat_rows, axis=0)

    def extension_ids(self) -> np.ndarray:
        return np.array([extension_id(s) for s in self._strings], dtype=np.int32)

    def strings(self) -> Sequence[str]:
        return tuple(self._strings)


_COLUMNS: tuple[tuple[str, np.dtype], ...] = (
    ("ts_ns", np.dtype(np.int64)),
    ("pid", np.dtype(np.int32)),
    ("tid", np.dtype(np.int32)),
    ("comm_id", np.dtype(np.int32)),
    ("syscall", np.dtype(np.int32)),
    ("path_id", np.dtype(np.int32)),
    ("new_path_id", np.dtype(np.int32)),
    ("flags", np.dtype(np.int32)),
    ("ret_val", np.dtype(np.int64)),
    ("bytes", np.dtype(np.int64)),
    ("inode", np.dtype(np.int64)),
    ("mode", np.dtype(np.int32)),
    ("uid", np.dtype(np.int32)),
    ("gid", np.dtype(np.int32)),
)


@dataclasses.dataclass
class EventArrays:
    """A block of N events as aligned columns (one per proto Event field).

    `valid` marks real rows; padded rows are zero.  All transforms preserve
    column dtypes so a block can be shipped to device without conversion.
    """

    ts_ns: np.ndarray
    pid: np.ndarray
    tid: np.ndarray
    comm_id: np.ndarray
    syscall: np.ndarray
    path_id: np.ndarray
    new_path_id: np.ndarray
    flags: np.ndarray
    ret_val: np.ndarray
    bytes: np.ndarray
    inode: np.ndarray
    mode: np.ndarray
    uid: np.ndarray
    gid: np.ndarray
    valid: np.ndarray  # bool [N]

    def __post_init__(self) -> None:
        n = len(self.ts_ns)
        for name, dtype in _COLUMNS:
            col = getattr(self, name)
            if len(col) != n:
                raise ValueError(f"column {name} has length {len(col)} != {n}")
            if col.dtype != dtype:
                object.__setattr__(self, name, col.astype(dtype))
        if len(self.valid) != n:
            raise ValueError(f"column valid has length {len(self.valid)} != {n}")
        if self.valid.dtype != np.bool_:
            self.valid = self.valid.astype(np.bool_)

    def __len__(self) -> int:
        return int(len(self.ts_ns))

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())

    @classmethod
    def empty(cls, n: int = 0) -> "EventArrays":
        cols = {name: np.zeros(n, dtype) for name, dtype in _COLUMNS}
        return cls(valid=np.zeros(n, np.bool_), **cols)

    @classmethod
    def from_records(
        cls, records: Iterable[Mapping[str, object]], strings: StringTable
    ) -> "EventArrays":
        """Build from an iterable of dict records (see `record()` for the
        inverse).  Unknown keys are ignored; missing keys default to zero."""
        rows = list(records)
        out = cls.empty(len(rows))
        for i, r in enumerate(rows):
            out.ts_ns[i] = int(r.get("ts_ns", 0))
            out.pid[i] = int(r.get("pid", 0))
            out.tid[i] = int(r.get("tid", r.get("pid", 0)))
            out.comm_id[i] = strings.intern(str(r.get("comm", "")))
            sc = r.get("syscall", Syscall.OTHER)
            out.syscall[i] = Syscall.parse(sc) if isinstance(sc, str) else int(sc)
            out.path_id[i] = strings.intern(str(r.get("path", "")))
            out.new_path_id[i] = strings.intern(str(r.get("new_path", "")))
            out.flags[i] = int(r.get("flags", 0))
            out.ret_val[i] = int(r.get("ret_val", 0))
            out.bytes[i] = int(r.get("bytes", 0))
            out.inode[i] = int(r.get("inode", 0))
            out.mode[i] = int(r.get("mode", 0))
            out.uid[i] = int(r.get("uid", 0))
            out.gid[i] = int(r.get("gid", 0))
            out.valid[i] = True
        return out

    def record(self, i: int, strings: StringTable) -> dict:
        try:
            syscall_name = Syscall(int(self.syscall[i])).name.lower()
        except ValueError:  # raw codes outside the enum ingest as OTHER
            syscall_name = Syscall.OTHER.name.lower()
        return {
            "ts_ns": int(self.ts_ns[i]),
            "pid": int(self.pid[i]),
            "tid": int(self.tid[i]),
            "comm": strings.lookup(int(self.comm_id[i])),
            "syscall": syscall_name,
            "path": strings.lookup(int(self.path_id[i])),
            "new_path": strings.lookup(int(self.new_path_id[i])),
            "flags": int(self.flags[i]),
            "ret_val": int(self.ret_val[i]),
            "bytes": int(self.bytes[i]),
            "inode": int(self.inode[i]),
            "mode": int(self.mode[i]),
            "uid": int(self.uid[i]),
            "gid": int(self.gid[i]),
        }

    def iter_records(self, strings: StringTable) -> Iterator[dict]:
        for i in range(len(self)):
            if self.valid[i]:
                yield self.record(i, strings)

    def take(self, idx: np.ndarray) -> "EventArrays":
        cols = {name: getattr(self, name)[idx] for name, _ in _COLUMNS}
        return EventArrays(valid=self.valid[idx], **cols)

    def slice(self, start: int, stop: int) -> "EventArrays":
        return self.take(np.arange(start, stop))

    def pad_to(self, n: int) -> "EventArrays":
        cur = len(self)
        if cur > n:
            raise ValueError(f"cannot pad {cur} events down to {n}")
        if cur == n:
            return self
        pad = n - cur
        cols = {
            name: np.concatenate([getattr(self, name), np.zeros(pad, dtype)])
            for name, dtype in _COLUMNS
        }
        return EventArrays(
            valid=np.concatenate([self.valid, np.zeros(pad, np.bool_)]), **cols
        )

    @classmethod
    def concatenate(cls, blocks: Sequence["EventArrays"]) -> "EventArrays":
        if not blocks:
            return cls.empty(0)
        cols = {
            name: np.concatenate([getattr(b, name) for b in blocks])
            for name, _ in _COLUMNS
        }
        return cls(valid=np.concatenate([b.valid for b in blocks]), **cols)

    def sort_by_time(self) -> "EventArrays":
        order = np.argsort(self.ts_ns, kind="stable")
        return self.take(order)

    def columns(self) -> dict[str, np.ndarray]:
        out = {name: getattr(self, name) for name, _ in _COLUMNS}
        out["valid"] = self.valid
        return out


def parse_iso_timestamp(ts: str) -> int:
    """ISO-8601 (with or without Z / offset) → epoch nanoseconds.

    Integer arithmetic throughout: float64 epoch seconds only carry ~128 ns at
    current epochs, which would wobble exact window-boundary comparisons.
    """
    s = ts.strip()
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    # split off the fractional-second digits ourselves: fromisoformat only
    # understands up to 6, real eBPF timestamps carry 9
    frac_ns = 0
    dot = s.find(".")
    if dot != -1:
        end = dot + 1
        while end < len(s) and s[end].isdigit():
            end += 1
        digits = s[dot + 1 : end]
        frac_ns = int(digits.ljust(9, "0")[:9])
        s = s[:dot] + s[end:]
    dt = datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return int(dt.timestamp()) * 1_000_000_000 + frac_ns


def format_ns(ts_ns: int) -> str:
    sec, frac_ns = divmod(int(ts_ns), 1_000_000_000)
    dt = datetime.fromtimestamp(sec, tz=timezone.utc)
    base = dt.strftime("%Y-%m-%dT%H:%M:%S")
    if frac_ns % 1000 == 0:  # μs-granular: reference-identical 6-digit form
        return base + f".{frac_ns // 1000:06d}Z"
    return base + f".{frac_ns:09d}Z"


def events_to_jsonl(events: EventArrays, strings: StringTable) -> str:
    """Serialize to ND-JSON, one event per line (the reference's trace format —
    `benchmarks/m1/results/m1_trace.jsonl`)."""
    lines = []
    for rec in events.iter_records(strings):
        rec["timestamp"] = format_ns(rec.pop("ts_ns"))
        lines.append(json.dumps(rec, sort_keys=True))
    return "\n".join(lines) + ("\n" if lines else "")
