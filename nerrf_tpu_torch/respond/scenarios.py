"""Adversarial scenario corpus for the respond tier.

Four distinct attack families, each exercised two ways:

  * **trace-only** (`sim_config`) — a `data.synth.SimConfig` for the
    family, for detector-ladder evaluation at corpus scale;
  * **on-disk** (`stage_incident`) — real files, real damage, a snapshot
    taken BEFORE the attack and a syscall-granular trace of exactly what
    the attack did (the `rollback.filesim` discipline: emitted byte
    counts match on-disk mutations, so the sandbox gate's replay check
    passes for an honest trace and fails for a doctored one).  This is
    the full detect → plan → verify loop's substrate.

Families:

  mass-rename       LockBit-style: XOR-encrypt + rename to the ransom
                    extension + ransom note (`rollback.filesim` verbatim)
  exfil-staging     staged campaign: read-sweep every victim into a hidden
                    staging blob, then encrypt + rename; the blob is
                    attack residue the undo plan intentionally ignores
  cron-persistence  trojanize agent plugin binaries via write-tmp →
                    rename-onto (the atomic-replace idiom aimed at code)
                    and drop a hidden cron entry for boot persistence
  log-tamper        anti-forensics: rewrite each audit log through a
                    same-size scrub copy renamed over the original;
                    nothing is encrypted, nothing is left behind

Schedules are seeded and deterministic, keyed through the chaos plane's
`hash01` draw (`chaos.plan`): the same (seed, slot) is the same incident
forever, so a corpus run is replayable evidence, not a dice roll.

The port of ``nerrf_tpu/respond/scenarios.py`` over the port's host copies
(`chaos.plan`, `data`, `rollback.filesim`, `schema`): for the same
(family, seed, files) it stages the same bytes on disk and emits the same
events and string table.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np

from nerrf_tpu_torch.chaos.plan import hash01
from nerrf_tpu_torch.data.loaders import GroundTruth, Trace
from nerrf_tpu_torch.data.synth import SimConfig
from nerrf_tpu_torch.respond.verify import VerifyContext
from nerrf_tpu_torch.rollback.filesim import (FileSimConfig, _keystream,
                                              run_file_attack, seed_files)
from nerrf_tpu_torch.rollback.store import Manifest, SnapshotStore
from nerrf_tpu_torch.schema.events import (EventArrays, InodeTable,
                                           OpenFlags, StringTable, Syscall)

FAMILIES = ("mass-rename", "exfil-staging", "cron-persistence", "log-tamper")

# victim-root-relative layout of the persistence families (the synth
# module's PLUGIN_DIR/TAMPER_LOG_DIR counterparts, rebased under a root)
_PLUGIN_REL = "usr/lib/sysagent"
_CRON_REL = "etc/cron.d"
_LOG_REL = "var/log/app"
_STAGE_REL = ".cache"


def sim_config(family: str, seed: int, **overrides) -> SimConfig:
    """Trace-only corpus config for a family (detector-ladder eval)."""
    scenario = {
        "mass-rename": "standard",
        "exfil-staging": "exfil-encrypt",
        "cron-persistence": "cron-persistence",
        "log-tamper": "log-tamper",
    }[family]
    kw = dict(duration_sec=120.0, attack_start_sec=40.0,
              num_target_files=10, min_file_bytes=256 * 1024,
              max_file_bytes=1024 * 1024, chunk_bytes=64 * 1024,
              benign_rate_hz=30.0, seed=seed, scenario=scenario)
    kw.update(overrides)
    return SimConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ScheduledIncident:
    """One slot of a deterministic scenario schedule."""

    at_sec: float
    family: str
    seed: int
    files: int


def schedule(seed: int, n: int, duration_sec: float = 300.0,
             families: Tuple[str, ...] = FAMILIES) -> List[ScheduledIncident]:
    """A seeded, replay-stable incident schedule: family mix and arrival
    times are pure functions of (seed, slot) — the chaos plan's keyed-coin
    discipline, so two runs of the same schedule stage identical
    incidents."""
    out = []
    for i in range(int(n)):
        fam = families[int(hash01(seed, "respond.family", str(i))
                          * len(families)) % len(families)]
        out.append(ScheduledIncident(
            at_sec=round(hash01(seed, "respond.at", str(i))
                         * duration_sec, 3),
            family=fam,
            seed=seed * 1000 + i,
            files=4 + int(hash01(seed, "respond.files", str(i)) * 8),
        ))
    return sorted(out, key=lambda s: s.at_sec)


@dataclasses.dataclass
class StagedIncident:
    """One on-disk incident: attacked tree + pre-attack snapshot + trace."""

    family: str
    victim_root: Path
    store: SnapshotStore
    manifest: Manifest
    trace: Trace
    leaves_behind: Tuple[str, ...]

    def verify_context(self) -> VerifyContext:
        return VerifyContext(store=self.store, manifest=self.manifest,
                             victim_root=self.victim_root, trace=self.trace,
                             leaves_behind=self.leaves_behind)


class _DiskEmitter:
    """Trace emitter for on-disk attacks (the filesim pattern): every
    record's byte count matches a real mutation, which is exactly what
    the sandbox gate's replay step validates."""

    def __init__(self, pid: int = 4913, comm: str = "python3") -> None:
        self.strings = StringTable()
        self.inodes = InodeTable()
        self.records: list = []
        self.t = time.time_ns()
        self.pid, self.comm = pid, comm

    def emit(self, syscall, path, new_path="", nbytes=0, flags=0):
        self.t += 2_000_000
        path = str(path)
        new_path = str(new_path) if new_path else ""
        inode = (self.inodes.carry_rename(path, new_path) if new_path
                 else self.inodes.get(path))
        self.records.append({
            "ts_ns": self.t, "pid": self.pid, "comm": self.comm,
            "syscall": syscall, "path": path, "new_path": new_path,
            "bytes": nbytes, "flags": flags, "inode": inode,
        })

    def trace(self, family: str, start_ns: int, target: Path,
              n_files: int) -> Trace:
        ev = EventArrays.from_records(self.records, self.strings)
        return Trace(
            events=ev, strings=self.strings,
            ground_truth=GroundTruth(
                start_ns=start_ns, end_ns=self.t, attack_family=family,
                target_path=str(target), platform="local",
                scale=f"{n_files}f"),
            labels=np.ones(len(self.records), np.float32),
            name=f"respond-{family}",
        )


def _payload(name: str, size: int) -> bytes:
    """Deterministic same-size replacement bytes (trojan body / scrubbed
    log): the keystream generator filesim encrypts with."""
    return _keystream(hashlib.sha256(name.encode()).digest(), size).tobytes()


def _chunked_rw(em: _DiskEmitter, src: Path, dst: Path, size: int,
                chunk: int) -> None:
    """Emit the read(src)/write(dst) chunk pairs for a full-copy rewrite
    (true byte counts, partial final chunk — replay reproduces sizes from
    exactly these)."""
    remaining = size
    while remaining > 0:
        n = min(chunk, remaining)
        em.emit(Syscall.READ, src, nbytes=n)
        em.emit(Syscall.WRITE, dst, nbytes=n)
        remaining -= n


def _stage_mass_rename(victim: Path, seed: int, files: int,
                       chunk: int) -> Tuple[Trace, Tuple[str, ...]]:
    cfg = FileSimConfig(num_files=files, seed=seed, chunk_bytes=chunk)
    trace, _ = run_file_attack(victim, cfg)
    return trace, ("README_LOCKBIT.txt",)


def _stage_exfil_staging(victim: Path, seed: int, files: int,
                         chunk: int) -> Tuple[Trace, Tuple[str, ...]]:
    em = _DiskEmitter(pid=4821)
    start = em.t
    stage = victim / _STAGE_REL / ".sess_stage.bin"
    stage.parent.mkdir(parents=True, exist_ok=True)
    targets = sorted(victim.glob("*.dat"))
    # stage A: read-sweep every victim, compressing into the staging blob
    with open(stage, "wb") as out:
        for p in targets:
            em.emit(Syscall.OPENAT, p, flags=int(OpenFlags.O_RDONLY))
            remaining = p.stat().st_size
            while remaining > 0:
                n = min(chunk, remaining)
                em.emit(Syscall.READ, p, nbytes=n)
                em.emit(Syscall.WRITE, stage, nbytes=n // 3)
                out.write(b"\x00" * (n // 3))
                remaining -= n
    # stage B: encrypt in place + rename to the ransom extension
    for p in targets:
        em.emit(Syscall.OPENAT, p, flags=int(OpenFlags.O_RDWR))
        data = np.frombuffer(p.read_bytes(), np.uint8)
        enc = data ^ _keystream(hashlib.sha256(p.name.encode()).digest(),
                                len(data))
        _chunked_rw(em, p, p, len(data), chunk)
        dst = p.with_suffix(p.suffix + ".lockbit3")
        p.write_bytes(enc.tobytes())
        p.rename(dst)
        em.emit(Syscall.RENAME, p, new_path=dst)
    return (em.trace("ExfilStaging", start, victim, len(targets)),
            (".sess_stage.bin",))


def _stage_cron_persistence(victim: Path, seed: int, files: int,
                            chunk: int) -> Tuple[Trace, Tuple[str, ...]]:
    em = _DiskEmitter(pid=4913)
    start = em.t
    plugdir = victim / _PLUGIN_REL
    plugins = sorted(plugdir.glob("plugin_*.bin"))
    for p in plugins:
        em.emit(Syscall.STAT, p)
    for i, p in enumerate(plugins):
        tmp = plugdir / f".tmp_{i:02d}.bin"
        size = p.stat().st_size
        body = _payload(f"trojan:{p.name}:{seed}", size)
        em.emit(Syscall.OPENAT, p, flags=int(OpenFlags.O_RDONLY))
        _chunked_rw(em, p, tmp, size, chunk)
        tmp.write_bytes(body)
        tmp.replace(p)  # atomic-replace: the trojan takes the plugin's name
        em.emit(Syscall.RENAME, tmp, new_path=p)
    crondir = victim / _CRON_REL
    crondir.mkdir(parents=True, exist_ok=True)
    drop = crondir / ".sysupdate"
    entry = b"@reboot root /usr/lib/sysagent/.cache/run >/dev/null 2>&1\n" * 2
    em.emit(Syscall.OPENAT, drop, flags=int(OpenFlags.O_WRONLY))
    drop.write_bytes(entry)
    em.emit(Syscall.WRITE, drop, nbytes=len(entry))
    return (em.trace("CronPersistence", start, plugdir, len(plugins)),
            (".sysupdate",))


def _stage_log_tamper(victim: Path, seed: int, files: int,
                      chunk: int) -> Tuple[Trace, Tuple[str, ...]]:
    em = _DiskEmitter(pid=5102)
    start = em.t
    logdir = victim / _LOG_REL
    logs = sorted(logdir.glob("audit_*.log"))
    for i, lg in enumerate(logs):
        tmp = logdir / f".audit_{i:02d}.swp"
        size = lg.stat().st_size
        em.emit(Syscall.STAT, lg)
        em.emit(Syscall.OPENAT, lg, flags=int(OpenFlags.O_RDONLY))
        # same-size scrub copy: byte count preserved, content replaced
        _chunked_rw(em, lg, tmp, size, chunk)
        tmp.write_bytes(_payload(f"scrub:{lg.name}:{seed}", size))
        tmp.replace(lg)
        em.emit(Syscall.RENAME, tmp, new_path=lg)
    return em.trace("LogTamper", start, logdir, len(logs)), ()


def _seed_environment(victim: Path, family: str, seed: int,
                      files: int) -> None:
    rng = np.random.default_rng(seed)
    if family in ("mass-rename", "exfil-staging"):
        seed_files(victim, FileSimConfig(num_files=files, seed=seed))
    elif family == "cron-persistence":
        plugdir = victim / _PLUGIN_REL
        plugdir.mkdir(parents=True, exist_ok=True)
        for i in range(files):
            # big enough that reverting a 0.7-motif-scored binary has
            # positive expected gain under the planner's cost model
            size = int(rng.integers(384 * 1024, 1024 * 1024))
            (plugdir / f"plugin_{i:02d}.bin").write_bytes(
                rng.integers(0, 256, size, np.uint8).tobytes())
    elif family == "log-tamper":
        logdir = victim / _LOG_REL
        logdir.mkdir(parents=True, exist_ok=True)
        for i in range(files):
            size = int(rng.integers(1 << 20, 2 << 20))
            (logdir / f"audit_{i:02d}.log").write_bytes(
                rng.integers(0, 256, size, np.uint8).tobytes())
    else:
        raise ValueError(f"unknown family: {family!r} (know {FAMILIES})")


_STAGERS = {
    "mass-rename": _stage_mass_rename,
    "exfil-staging": _stage_exfil_staging,
    "cron-persistence": _stage_cron_persistence,
    "log-tamper": _stage_log_tamper,
}


def stage_incident(work_dir: str | Path, family: str, seed: int = 0,
                   files: int = 8,
                   chunk_bytes: int = 64 * 1024) -> StagedIncident:
    """Seed a victim tree, snapshot it, run the family's on-disk attack.

    The returned StagedIncident is everything the respond loop needs:
    detection runs on ``trace``, planning on the detection, verification
    through ``verify_context()`` — with the snapshot taken before the
    damage, exactly the operational contract."""
    if family not in _STAGERS:
        raise ValueError(f"unknown family: {family!r} (know {FAMILIES})")
    work = Path(work_dir)
    victim = work / f"victim-{family}-{seed}"
    victim.mkdir(parents=True, exist_ok=True)
    _seed_environment(victim, family, seed, files)
    store = SnapshotStore(work / f"store-{family}-{seed}")
    manifest = store.snapshot(victim, snapshot_id=f"{family}-{seed}")
    trace, leaves = _STAGERS[family](victim, seed, files, chunk_bytes)
    return StagedIncident(family=family, victim_root=victim, store=store,
                          manifest=manifest, trace=trace,
                          leaves_behind=leaves)
