"""Loaders for trace artifacts in the reference's on-disk formats.

(Copied from ``nerrf_tpu/data/loaders.py`` so the port needs nothing of the JAX
package; keep the two identical: the parity tests compare their arrays.)

Reads the ND-JSON traces and ground-truth CSVs that the reference benchmark
harness produces (upstream NERRF `benchmarks/m1/scripts/m1_minikube_bootstrap.sh:227-278`
writes `m1_trace.jsonl` + `m1_ground_truth.csv`), so checked-in reference
artifacts can be fed straight into this framework.  The simulator's high-level
event names (`sim_lockbit_m1.py:24-33` — file_created, file_encrypt_start, …)
are lowered onto syscall identities here, mirroring how a real eBPF capture of
the same run would present (`docs/content/docs/threat-model.mdx:141-160`).
"""

from __future__ import annotations

import csv
import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np

from nerrf_tpu_torch.schema.events import (
    EventArrays,
    InodeTable,
    OpenFlags,
    StringTable,
    Syscall,
    parse_iso_timestamp,
)


@dataclasses.dataclass(frozen=True)
class GroundTruth:
    """Attack window ground truth (reference format:
    `benchmarks/m1/results/m1_ground_truth.csv` — start_ts,end_ts,...,target_path)."""

    start_ns: int
    end_ns: int
    attack_family: str
    target_path: str
    platform: str = ""
    scale: str = ""

    @property
    def duration_sec(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def contains(self, ts_ns: np.ndarray) -> np.ndarray:
        return (ts_ns >= self.start_ns) & (ts_ns <= self.end_ns)


@dataclasses.dataclass
class Trace:
    """One captured run: events + string table + optional labels/ground truth."""

    events: EventArrays
    strings: StringTable
    ground_truth: Optional[GroundTruth] = None
    labels: Optional[np.ndarray] = None  # float32 [N], 1.0 = attack event
    name: str = ""
    # Exact file-level ground truth (synthetic traces only): the inode-
    # canonical final paths of files whose CONTENT the attack destroyed.
    # Rename-style attacks leave a `.lockbit3` suffix that labels alone can
    # recover, but in-place/partial encryption mutates a file without ever
    # renaming it — and a later *benign* rename (interleaved-backup) can move
    # the victim to a name no attack event ever mentions.  Only the simulator
    # knows the truth then; None means "derive from labels" (loaders of real
    # traces, pipeline.attack_touched_files fallback).
    victim_paths: Optional[frozenset] = None


def load_ground_truth_csv(path: str | Path) -> GroundTruth:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"empty ground truth csv: {path}")
    r = rows[0]
    if "start_iso" in r and r.get("start_iso"):
        start = parse_iso_timestamp(r["start_iso"])
        end = parse_iso_timestamp(r["end_iso"])
    else:
        start = int(float(r["start_ts"]) * 1e9)
        end = int(float(r["end_ts"]) * 1e9)
    return GroundTruth(
        start_ns=start,
        end_ns=end,
        attack_family=r.get("attack_family", "unknown"),
        target_path=r.get("target_path", "/"),
        platform=r.get("platform", ""),
        scale=r.get("scale", ""),
    )


# Simulator event-name → (syscall, flags) lowering.  Names observed in the
# reference's checked-in traces (m0/m1_trace.jsonl event-type census) and in
# `sim_lockbit_m1.py` log_event call sites.
_SIM_EVENT_LOWERING: dict[str, tuple[Syscall, int]] = {
    "file_created": (Syscall.WRITE, int(OpenFlags.O_WRONLY)),
    "file_encrypt_start": (Syscall.OPENAT, int(OpenFlags.O_RDWR)),
    "file_encrypt_complete": (Syscall.RENAME, 0),
    "ransom_note_created": (Syscall.WRITE, int(OpenFlags.O_WRONLY)),
    "process_enum": (Syscall.OPENAT, int(OpenFlags.O_RDONLY)),
    "network_enum": (Syscall.OPENAT, int(OpenFlags.O_RDONLY)),
    "user_enum": (Syscall.OPENAT, int(OpenFlags.O_RDONLY)),
    "disk_enum": (Syscall.OPENAT, int(OpenFlags.O_RDONLY)),
    "mount_enum": (Syscall.OPENAT, int(OpenFlags.O_RDONLY)),
}

_SUFFIX_FOR_ENUM = {
    "process_enum": "/proc/self/status",
    "network_enum": "/proc/net/tcp",
    "user_enum": "/etc/passwd",
    "disk_enum": "/proc/diskstats",
    "mount_enum": "/proc/mounts",
}


def _lower_sim_record(rec: dict, inodes: InodeTable) -> dict:
    """Lower one simulator-format JSON record to a schema record.  Phase
    markers and unknown event names are kept as MARKER events so record counts
    track trace-line counts."""
    name = rec.get("event", rec.get("syscall", ""))
    ts_ns = parse_iso_timestamp(rec["timestamp"]) if "timestamp" in rec else int(
        rec.get("ts_ns", 0)
    )
    path = str(rec.get("path", ""))
    out = {
        "ts_ns": ts_ns,
        "pid": int(rec.get("pid", 0)),
        "comm": str(rec.get("comm", "python3")),
        "bytes": int(rec.get("size", rec.get("bytes", 0)) or 0),
    }
    if name in _SIM_EVENT_LOWERING:
        syscall, flags = _SIM_EVENT_LOWERING[name]
        out["syscall"] = syscall
        out["flags"] = flags
        out["path"] = _SUFFIX_FOR_ENUM.get(name, path)
        if syscall == Syscall.RENAME:
            # encrypt_complete logs the destination (…lockbit3) path; recover src.
            if path.endswith(".lockbit3"):
                out["path"] = path[: -len(".lockbit3")]
                out["new_path"] = path
            else:
                out["path"] = path
                out["new_path"] = path + ".lockbit3"
    elif name in Syscall.__members__ or name.upper() in Syscall.__members__:
        out["syscall"] = Syscall.parse(name)
        out["path"] = path
        out["new_path"] = str(rec.get("new_path", ""))
        out["flags"] = int(rec.get("flags", 0) or 0)
        out["tid"] = int(rec.get("tid", rec.get("pid", 0)) or 0)
        out["ret_val"] = int(rec.get("ret_val", 0) or 0)
        out["mode"] = int(rec.get("mode", 0) or 0)
        out["uid"] = int(rec.get("uid", 0) or 0)
        out["gid"] = int(rec.get("gid", 0) or 0)
    else:
        out["syscall"] = Syscall.MARKER
        out["path"] = path
    # Stable synthetic inodes for traces that lack inode fields (InodeTable:
    # one path one inode, renames carry it — the reference's inode dedup).
    # Records carrying a real inode pin it in the table too, so mixed traces
    # (some lines with inodes, some without) still resolve one file per inode.
    src, dst = out.get("path", ""), out.get("new_path", "")
    real_inode = int(rec.get("inode", 0) or 0)
    if real_inode:
        out["inode"] = real_inode
        inodes.register(src, real_inode, dst)
    else:
        # absent OR zero inode → synthesize (an eBPF capture that failed to
        # resolve the inode reports 0, which must not collapse all files
        # into "no file")
        out["inode"] = inodes.carry_rename(src, dst) if dst else inodes.get(src)
    return out


def load_trace_jsonl(
    path: str | Path,
    ground_truth: Optional[str | Path] = None,
    strings: Optional[StringTable] = None,
) -> Trace:
    """Load a reference-format (or native-format) ND-JSON trace."""
    strings = strings if strings is not None else StringTable()
    inodes = InodeTable()
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("TRACE:"):
                line = line[len("TRACE:") :].strip()
            records.append(_lower_sim_record(json.loads(line), inodes))
    events = EventArrays.from_records(records, strings).sort_by_time()
    gt = load_ground_truth_csv(ground_truth) if ground_truth else None
    return Trace(events=events, strings=strings, ground_truth=gt, name=str(path))
