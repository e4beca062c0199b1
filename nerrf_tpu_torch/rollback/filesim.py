"""File-level LockBit-style attack simulator: real files, real damage.

(Copied from ``nerrf_tpu/rollback/filesim.py`` so the port needs nothing of
the JAX package; keep the two identical: the parity tests compare their
results.)

The benchmark equivalent of the reference's in-cluster simulator
(`benchmarks/m1/scripts/sim_lockbit_m1.py`): seeds enterprise-
named files, then XOR-"encrypts" them chunk-by-chunk with SHA-256-derived
per-file keystreams, renames to the ransom extension and drops a ransom note —
but running locally against a directory (no minikube), and emitting schema
`EventArrays` alongside the real file operations so the same run feeds both
the detector and the rollback benchmark.

Unlike the reference's rollback scorer (`m1_rollback.sh:74-133`, a pure
rename-back loop that only works because its sim leaves plaintext in place),
this simulator genuinely destroys content — recovery must come from the
snapshot store, which is the honest version of the product's claim.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np

from nerrf_tpu_torch.data.loaders import GroundTruth, Trace
from nerrf_tpu_torch.schema.events import EventArrays, InodeTable, OpenFlags, StringTable, Syscall

_NS = 1_000_000_000

_PREFIXES = ("report", "budget", "customer", "invoice", "analysis", "archive")


@dataclasses.dataclass(frozen=True)
class FileSimConfig:
    num_files: int = 45
    min_file_bytes: int = 64 * 1024
    max_file_bytes: int = 256 * 1024
    ransom_ext: str = ".lockbit3"
    chunk_bytes: int = 64 * 1024
    seed: int = 0


def _keystream(key: bytes, n: int) -> np.ndarray:
    """SHA-256-seeded keystream (mirrors the reference sim's key derivation)."""
    out = np.empty(n, np.uint8)
    pos = 0
    counter = 0
    while pos < n:
        block = hashlib.sha256(key + counter.to_bytes(8, "little")).digest()
        take = min(len(block), n - pos)
        out[pos : pos + take] = np.frombuffer(block[:take], np.uint8)
        pos += take
        counter += 1
    return out


def seed_files(target: str | Path, cfg: FileSimConfig) -> List[Path]:
    """Create the victim file set; returns created paths."""
    rng = np.random.default_rng(cfg.seed)
    target = Path(target)
    target.mkdir(parents=True, exist_ok=True)
    out = []
    for i in range(cfg.num_files):
        name = f"{_PREFIXES[i % len(_PREFIXES)]}_{2020 + i % 7}_{i:03d}.dat"
        size = int(rng.integers(cfg.min_file_bytes, cfg.max_file_bytes))
        p = target / name
        p.write_bytes(rng.integers(0, 256, size, np.uint8).tobytes())
        out.append(p)
    return out


def run_file_attack(
    target: str | Path, cfg: FileSimConfig, pid: int = 4567
) -> Tuple[Trace, List[Path]]:
    """Encrypt every .dat file in ``target``; returns (trace, encrypted paths).

    The trace records the attack at syscall granularity with exact labels, so
    detection runs on the same evidence a live eBPF capture would produce.
    """
    target = Path(target)
    strings = StringTable()
    inodes = InodeTable()
    records, labels = [], []
    t = time.time_ns()

    def emit(syscall, path, new_path="", nbytes=0, flags=0):
        nonlocal t
        t += 2_000_000  # 2 ms between syscalls
        path, new_path = str(path), str(new_path) if new_path else ""
        inode = inodes.carry_rename(path, new_path) if new_path else inodes.get(path)
        records.append({
            "ts_ns": t, "pid": pid, "comm": "python3", "syscall": syscall,
            "path": path, "new_path": new_path,
            "bytes": nbytes, "flags": flags, "inode": inode,
        })
        labels.append(1.0)

    start = t
    # recon burst
    for p in ("/proc/self/status", "/proc/net/tcp", "/etc/passwd"):
        emit(Syscall.OPENAT, p, flags=int(OpenFlags.O_RDONLY))
        emit(Syscall.READ, p, nbytes=2048)

    files = sorted(target.glob("*.dat"))
    encrypted = []
    for p in files:
        emit(Syscall.OPENAT, p, flags=int(OpenFlags.O_RDWR))
        data = np.frombuffer(p.read_bytes(), np.uint8)
        key = hashlib.sha256(p.name.encode()).digest()
        enc = data ^ _keystream(key, len(data))
        # record the true byte counts (what a kernel capture reports): the
        # final chunk is partial, and the replay gate reproduces file sizes
        # from exactly these numbers
        remaining = len(data)
        while remaining > 0:
            n = min(cfg.chunk_bytes, remaining)
            emit(Syscall.READ, p, nbytes=n)
            emit(Syscall.WRITE, p, nbytes=n)
            remaining -= n
        dst = p.with_suffix(p.suffix + cfg.ransom_ext)
        p.write_bytes(enc.tobytes())
        p.rename(dst)
        emit(Syscall.RENAME, p, new_path=dst)
        encrypted.append(dst)
    note = target / "README_LOCKBIT.txt"
    note.write_text("NERRF-TPU benchmark ransom note (simulated attack)\n")
    emit(Syscall.OPENAT, note, flags=int(OpenFlags.O_WRONLY))
    emit(Syscall.WRITE, note, nbytes=note.stat().st_size)

    ev = EventArrays.from_records(records, strings)
    trace = Trace(
        events=ev,
        strings=strings,
        ground_truth=GroundTruth(
            start_ns=start, end_ns=t, attack_family="LockBitFileSim",
            target_path=str(target), platform="local", scale=f"{len(files)}f",
        ),
        labels=np.asarray(labels, np.float32),
        name="filesim",
    )
    return trace, encrypted
