"""Synthetic trace corpus generator.

(Copied from ``nerrf_tpu/data/synth.py`` so the port needs nothing of the JAX
package; keep the two identical: the parity tests compare their arrays.)

The reference ships only two tiny captured traces (88 and 149 events,
`benchmarks/m0,m1/results/*_trace.jsonl`) and *specifies* a "100 h benign +
1 h labelled attack" training corpus that was never built
(upstream NERRF `ROADMAP.md:50`, `README.md:87,103`).  This module is that
corpus's generator: a benign multi-service workload interleaved with a
LockBit-style five-phase attack whose structure follows the reference
simulator (`benchmarks/m1/scripts/sim_lockbit_m1.py`: recon → seed → chunked
encrypt+rename at a rate limit → ransom note → idle) and threat model
(`docs/content/docs/architecture.mdx:96-120`).

Everything is generated at syscall granularity (the ~25k-event density the
docs project for real eBPF capture, `threat-model.mdx:121-137`), with exact
per-event labels — which the reference's window-level ground truth cannot
provide — plus the window-level `GroundTruth` for format parity.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from nerrf_tpu_torch.data.loaders import GroundTruth, Trace
from nerrf_tpu_torch.schema.events import EventArrays, InodeTable, OpenFlags, StringTable, Syscall

_NS = 1_000_000_000


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Knobs for one simulated run.  Defaults approximate the reference M1
    scale (45-50 files of 2-5 MB, ~2 MB/s encrypt rate — sim_lockbit_m1.py:15-22)
    but at syscall granularity."""

    duration_sec: float = 300.0
    attack: bool = True
    attack_start_sec: float = 120.0
    num_target_files: int = 45
    min_file_bytes: int = 2 * 1024 * 1024
    max_file_bytes: int = 5 * 1024 * 1024
    encrypt_rate_bps: float = 2.0 * 1024 * 1024
    chunk_bytes: int = 256 * 1024
    target_dir: str = "/app/uploads"
    ransom_ext: str = ".lockbit3"
    # Benign workload intensity: mean syscall events per second across services.
    benign_rate_hz: float = 60.0
    seed: int = 0
    # Distribution-shift knob (the quality plane's drift-injection bench
    # leg): 0.0 = the historical generator, bit-identical traces.  d > 0
    # shifts the BENIGN population the way a real deployment drifts
    # without a single attack changing — event rate scales by (1 + d)
    # (denser windows: the node/edge-count distributions walk up the
    # bucket rungs) and the service mix interpolates toward an
    # IO-heavy profile (_DRIFT_SERVICE_WEIGHTS: backup/database-dominated
    # instead of web-dominated), moving the event-type mix and the score
    # distribution the reference profile was calibrated against.  Labels
    # and the attack stream are untouched: drift is a property of the
    # traffic, not of the threat.
    drift: float = 0.0
    # Adversarial/hard-negative scenario (the quality gates mean little if
    # the attack is linearly separable):
    #   "standard"            — the default five-phase attack
    #   "benign-mass-rename"  — NO attack; a backup archive job bulk-renames
    #                           every target file (.dat → .dat.bak) with
    #                           heavy reads/writes: the structural shape of
    #                           ransomware with benign intent (FP-undo probe)
    #   "slow-drip"           — attack spread across ~80% of the trace, one
    #                           file at a time, aggregate rate far below any
    #                           rate-limit detector
    #   "benign-comm"         — attack runs under the SAME pid+comm as the
    #                           benign python3 app worker, so identity
    #                           features carry zero signal
    #   "multi-process"       — attack sharded over 4 interleaved worker
    #                           pids, each encrypting a subset concurrently
    #
    # Stealth scenarios, each aimed at a specific blind spot of the
    # indicator heuristic (an eval the heuristic *fails*; indicator set:
    # threat-model.mdx:176-189):
    #   "inplace-stealth"     — encrypt in place: O_RDWR chunked read/write
    #                           sweeps, NO rename, extensions kept, recovery
    #                           note named nothing like README.  Kills the
    #                           suspicious-extension rule, the write→rename
    #                           motif and the note-name rule at once.
    #   "partial-encrypt"     — in-place encryption of only the head ~12% of
    #                           each file (enough to destroy most formats):
    #                           stays under any bytes-moved / rate trigger.
    #   "interleaved-backup"  — in-place encryption racing the benign backup
    #                           sweep over the SAME files; the backup then
    #                           archives ciphertext and renames victims to
    #                           .bak names no attack event ever wrote.
    #   "exfil-encrypt"       — staged: full read-only exfil sweep to a /tmp
    #                           staging file, a quiet dwell, then a partial
    #                           in-place encrypt pass.
    #   "benign-atomic-rewrite" — NO attack; an indexer rewrites every file
    #                           via the atomic-save idiom (write .tmp, rename
    #                           .tmp → file): the write→rename motif fires on
    #                           every file, so the heuristic mass-flags a
    #                           benign maintenance job (FP-undo probe).
    #
    # Incident-response families (the respond tier's scenario corpus,
    # nerrf_tpu/respond/scenarios.py — these exercise the detect→plan→
    # verify loop on damage that is NOT encryption):
    #   "cron-persistence"    — the attacker trojanizes the host agent's
    #                           plugin binaries via the atomic-replace idiom
    #                           (write payload tmp, rename onto the plugin)
    #                           and drops a hidden cron entry for boot
    #                           persistence; no victim data files touched.
    #   "log-tamper"          — anti-forensics: every application log is
    #                           scrubbed by rewriting it through a tmp copy
    #                           (same size, incriminating entries gone) and
    #                           renaming the copy over the original.
    scenario: str = "standard"


# Scenarios with no attack stream at all (hard-negative probes).
BENIGN_SCENARIOS = frozenset({"benign-mass-rename", "benign-atomic-rewrite"})
# Attack variants that never rename victims and keep extensions: invisible
# to every indicator the heuristic implements.
STEALTH_SCENARIOS = frozenset(
    {"inplace-stealth", "partial-encrypt", "interleaved-backup",
     "exfil-encrypt"})

# Incident-response families: damage that is persistence/anti-forensics
# rather than encryption.  Kept OUT of ATTACK_VARIANTS on purpose — the
# hard-corpus slot arithmetic in make_corpus (0.49/len) is frozen so the
# historical corpus mix stays bit-identical; the respond tier's scenario
# schedules (nerrf_tpu/respond/scenarios.py) draw these explicitly.
PERSISTENCE_VARIANTS = ("cron-persistence", "log-tamper")

# Where the persistence families do their damage (shared with the on-disk
# incident simulators in respond/scenarios.py so trace paths and disk paths
# agree).
PLUGIN_DIR = "/usr/lib/sysagent"
CRON_DROP = "/etc/cron.d/.sysupdate"
TAMPER_LOG_DIR = "/var/log/app"


_BENIGN_SERVICES = (
    # (comm, uid, weight) — a web stack with monitoring and backups, so benign
    # traffic includes /proc reads, renames, and python3 (non-separable comm).
    ("nginx", 33, 0.30),
    ("postgres", 70, 0.20),
    ("python3", 1000, 0.25),
    ("node-exporter", 65534, 0.10),
    ("backup-agent", 0, 0.10),
    ("logrotate", 0, 0.05),
)

_DOC_PREFIXES = ("report", "proposal", "analysis", "budget", "customer", "invoice")

# The drifted service mix (same service set, IO-heavy weighting): what a
# deployment looks like after a backup/ETL rollout the model never saw.
# SimConfig.drift interpolates the _BENIGN_SERVICES weights toward this.
_DRIFT_SERVICE_WEIGHTS = (0.05, 0.30, 0.10, 0.05, 0.40, 0.10)


def _target_file_names(rng: np.random.Generator, n: int) -> List[str]:
    return [
        f"{rng.choice(_DOC_PREFIXES)}_{rng.integers(2020, 2027)}_{i:03d}.dat"
        for i in range(n)
    ]


class _Emitter:
    def __init__(self):
        self.records: list[dict] = []
        self.labels: list[float] = []
        self.victims: list[bool] = []  # content-destroying attack events

    def emit(
        self,
        ts_ns: int,
        syscall: Syscall,
        path: str,
        *,
        pid: int,
        comm: str,
        attack: bool,
        new_path: str = "",
        nbytes: int = 0,
        flags: int = 0,
        uid: int = 0,
        ret_val: int = 0,
        victim: bool = False,
    ) -> None:
        # inode is assigned later, in TIME order (simulate_trace): the benign
        # and attack streams are emitted sequentially, so assigning here
        # would let a post-rename benign open of the old name alias the
        # renamed file's inode (emission order ≠ causal order)
        self.records.append(
            {
                "ts_ns": ts_ns,
                "pid": pid,
                "tid": pid,
                "comm": comm,
                "syscall": syscall,
                "path": path,
                "new_path": new_path,
                "flags": flags,
                "ret_val": ret_val,
                "bytes": nbytes,
                "inode": 0,
                "uid": uid,
            }
        )
        self.labels.append(1.0 if attack else 0.0)
        self.victims.append(bool(victim and attack))


def _emit_benign(em: _Emitter, cfg: SimConfig, rng: np.random.Generator, t0: int) -> None:
    # drift == 0 keeps the arithmetic AND the rng call sequence of the
    # historical generator, so existing seeds reproduce bit-identically.
    # The knob's whole domain is [0, 1] — clamp ONCE so the rate scale
    # and the mix interpolation can never disagree about an out-of-range
    # value (a negative raw drift would hand poisson a negative lambda)
    d = min(max(float(cfg.drift), 0.0), 1.0)
    n = rng.poisson(cfg.benign_rate_hz * (1.0 + d) * cfg.duration_sec)
    ts = np.sort(rng.uniform(0, cfg.duration_sec, n))
    weights = np.array([w for _, _, w in _BENIGN_SERVICES])
    if d:
        weights = (1.0 - d) * weights + d * np.asarray(_DRIFT_SERVICE_WEIGHTS)
    svc = rng.choice(len(_BENIGN_SERVICES), size=n, p=weights / weights.sum())
    pids = {i: 200 + i for i in range(len(_BENIGN_SERVICES))}
    log_seq = 0
    for i in range(n):
        comm, uid, _ = _BENIGN_SERVICES[svc[i]]
        pid = pids[int(svc[i])]
        t = t0 + int(ts[i] * _NS)
        r = rng.random()
        if comm == "nginx":
            if r < 0.5:
                em.emit(t, Syscall.OPENAT, f"/var/www/static/page_{rng.integers(50)}.html",
                        pid=pid, comm=comm, uid=uid, attack=False,
                        flags=int(OpenFlags.O_RDONLY))
            else:
                em.emit(t, Syscall.WRITE, "/var/log/nginx/access.log", pid=pid,
                        comm=comm, uid=uid, attack=False, nbytes=int(rng.integers(80, 400)))
        elif comm == "postgres":
            if r < 0.6:
                db = f"/var/lib/pg/base/{rng.integers(20)}.db"
                if r < 0.12:
                    # databases legitimately open data files O_RDWR — keeps
                    # the access mode informative but not attack-sufficient
                    em.emit(t, Syscall.OPENAT, db, pid=pid, comm=comm,
                            uid=uid, attack=False,
                            flags=int(OpenFlags.O_RDWR))
                em.emit(t, Syscall.WRITE, db,
                        pid=pid, comm=comm, uid=uid, attack=False,
                        nbytes=int(rng.integers(512, 8192)))
            elif r < 0.8:
                em.emit(t, Syscall.READ, f"/var/lib/pg/base/{rng.integers(20)}.db",
                        pid=pid, comm=comm, uid=uid, attack=False,
                        nbytes=int(rng.integers(512, 8192)))
            else:
                em.emit(t, Syscall.FSYNC, "/var/lib/pg/wal/000001.log", pid=pid,
                        comm=comm, uid=uid, attack=False)
        elif comm == "python3":
            # An app worker that legitimately touches the target directory.
            fname = f"{cfg.target_dir}/{rng.choice(_DOC_PREFIXES)}_{rng.integers(2020, 2027)}_{rng.integers(cfg.num_target_files):03d}.dat"
            if r < 0.45:
                em.emit(t, Syscall.OPENAT, fname, pid=pid, comm=comm, uid=uid,
                        attack=False, flags=int(OpenFlags.O_RDONLY))
            elif r < 0.75:
                em.emit(t, Syscall.READ, fname, pid=pid, comm=comm, uid=uid,
                        attack=False, nbytes=int(rng.integers(1024, 65536)))
            else:
                em.emit(t, Syscall.WRITE, f"{cfg.target_dir}/.tmp_upload_{rng.integers(9)}",
                        pid=pid, comm=comm, uid=uid, attack=False,
                        nbytes=int(rng.integers(1024, 262144)))
        elif comm == "node-exporter":
            proc = rng.choice(["/proc/stat", "/proc/meminfo", "/proc/net/dev", "/proc/loadavg"])
            em.emit(t, Syscall.OPENAT, str(proc), pid=pid, comm=comm, uid=uid,
                    attack=False, flags=int(OpenFlags.O_RDONLY))
        elif comm == "backup-agent":
            if r < 0.7:
                em.emit(t, Syscall.READ,
                        f"{cfg.target_dir}/{rng.choice(_DOC_PREFIXES)}_{rng.integers(2020, 2027)}_{rng.integers(cfg.num_target_files):03d}.dat",
                        pid=pid, comm=comm, uid=uid, attack=False,
                        nbytes=int(rng.integers(65536, 1 << 20)))
            else:
                em.emit(t, Syscall.WRITE, f"/backup/snap_{rng.integers(10)}.bak",
                        pid=pid, comm=comm, uid=uid, attack=False,
                        nbytes=int(rng.integers(65536, 1 << 20)))
        else:  # logrotate: benign rename traffic
            idx = log_seq % 5
            log_seq += 1
            em.emit(t, Syscall.RENAME, f"/var/log/app/service_{idx}.log", pid=pid,
                    comm=comm, uid=uid, attack=False,
                    new_path=f"/var/log/app/service_{idx}.log.1")


def _emit_benign_mass_rename(em: _Emitter, cfg: SimConfig,
                             rng: np.random.Generator, t0: int) -> None:
    """Hard negative: a backup archive job sweeps the target directory —
    open/read every file, write an archive copy, rename to .dat.bak — in one
    tight burst.  Mass renames + extension change + high IO in the attack's
    own directory, but benign (uid 0, no recon, reads-then-copies instead of
    in-place overwrite).  This is what the <5% FP-undo KPI is measured on."""
    pid = 208
    comm = "backup-agent"
    t = t0 + int(cfg.attack_start_sec * _NS)
    names = _target_file_names(rng, cfg.num_target_files)
    for nm in names:
        src = f"{cfg.target_dir}/{nm}"
        em.emit(t, Syscall.OPENAT, src, pid=pid, comm=comm, attack=False,
                flags=int(OpenFlags.O_RDONLY))
        t += int(rng.uniform(1, 5) * 1e6)
        size = int(rng.integers(cfg.min_file_bytes, cfg.max_file_bytes))
        for _ in range(max(1, size // cfg.chunk_bytes)):
            em.emit(t, Syscall.READ, src, pid=pid, comm=comm, attack=False,
                    nbytes=cfg.chunk_bytes)
            t += int(rng.uniform(1, 3) * 1e6)
            em.emit(t, Syscall.WRITE, f"/backup/archive/{nm}.gz", pid=pid,
                    comm=comm, attack=False, nbytes=cfg.chunk_bytes // 2)
            t += int(rng.uniform(1, 3) * 1e6)
        em.emit(t, Syscall.RENAME, src, pid=pid, comm=comm, attack=False,
                new_path=src + ".bak")
        t += int(rng.uniform(2, 10) * 1e6)


def _emit_attack(em: _Emitter, cfg: SimConfig, rng: np.random.Generator, t0: int) -> tuple[int, int]:
    """Five-phase LockBit-style attack; returns (start_ns, end_ns)."""
    if cfg.scenario == "multi-process":
        return _emit_attack_multiprocess(em, cfg, rng, t0)
    if cfg.scenario in STEALTH_SCENARIOS:
        return _emit_attack_stealth(em, cfg, rng, t0)
    if cfg.scenario == "cron-persistence":
        return _emit_attack_cron_persistence(em, cfg, rng, t0)
    if cfg.scenario == "log-tamper":
        return _emit_attack_log_tamper(em, cfg, rng, t0)
    # benign-comm: reuse the benign python3 app worker's identity (pid 202,
    # the pids[] entry _emit_benign uses), so comm/pid features are useless
    pid = 202 if cfg.scenario == "benign-comm" else 4567
    comm = "python3"
    t = t0 + int(cfg.attack_start_sec * _NS)
    start = t
    # slow-drip: spread file encryptions across most of the remaining trace
    drip_gap_ns = 0
    if cfg.scenario == "slow-drip":
        window = (cfg.duration_sec - cfg.attack_start_sec) * 0.85 * _NS
        drip_gap_ns = int(max(0.0, window) / max(cfg.num_target_files, 1))

    def step(lo_ms=2, hi_ms=40):
        nonlocal t
        t += int(rng.uniform(lo_ms, hi_ms) * 1e6)
        return t

    # P1 recon: burst of /proc + system enumeration (threat-model.mdx "Burst of /proc reads")
    for p in ("/proc/self/status", "/proc/net/tcp", "/etc/passwd", "/proc/diskstats",
              "/proc/mounts", "/proc/stat"):
        for _ in range(int(rng.integers(2, 6))):
            em.emit(step(), Syscall.OPENAT, p, pid=pid, comm=comm, attack=True,
                    flags=int(OpenFlags.O_RDONLY))
            em.emit(step(), Syscall.READ, p, pid=pid, comm=comm, attack=True,
                    nbytes=int(rng.integers(512, 4096)))

    # P2 target discovery
    em.emit(step(), Syscall.OPENAT, cfg.target_dir, pid=pid, comm=comm, attack=True,
            flags=int(OpenFlags.O_RDONLY))
    names = _target_file_names(rng, cfg.num_target_files)
    for nm in names:
        em.emit(step(1, 4), Syscall.STAT, f"{cfg.target_dir}/{nm}", pid=pid,
                comm=comm, attack=True)

    # P3 encrypt loop: per file open→read/write chunks→rename→unlink, rate-limited
    for nm in names:
        src = f"{cfg.target_dir}/{nm}"
        dst = src[: -len(".dat")] + cfg.ransom_ext if src.endswith(".dat") else src + cfg.ransom_ext
        size = int(rng.integers(cfg.min_file_bytes, cfg.max_file_bytes))
        em.emit(step(), Syscall.OPENAT, src, pid=pid, comm=comm, attack=True,
                flags=int(OpenFlags.O_RDWR))
        nchunks = max(1, size // cfg.chunk_bytes)
        for _ in range(nchunks):
            em.emit(step(1, 3), Syscall.READ, src, pid=pid, comm=comm, attack=True,
                    nbytes=cfg.chunk_bytes)
            em.emit(step(1, 3), Syscall.WRITE, src, pid=pid, comm=comm, attack=True,
                    nbytes=cfg.chunk_bytes, victim=True)
            # rate limit: advance wall clock to respect encrypt_rate_bps
            t += int(cfg.chunk_bytes / cfg.encrypt_rate_bps * 1e9)
        # in-place rename to the ransom extension; the inode survives under
        # dst (no unlink — neither the reference simulator's rename-by-rewrite
        # endstate nor real LockBit leaves a deleted old name behind)
        em.emit(step(), Syscall.RENAME, src, pid=pid, comm=comm, attack=True,
                new_path=dst, victim=True)
        t += drip_gap_ns  # slow-drip: long quiet gap before the next file

    # P4 ransom note
    note = f"{cfg.target_dir}/README_LOCKBIT.txt"
    em.emit(step(), Syscall.OPENAT, note, pid=pid, comm=comm, attack=True,
            flags=int(OpenFlags.O_WRONLY))
    em.emit(step(), Syscall.WRITE, note, pid=pid, comm=comm, attack=True, nbytes=1337)
    # P5 idle (no events)
    return start, t


def _emit_attack_multiprocess(em: _Emitter, cfg: SimConfig,
                              rng: np.random.Generator,
                              t0: int) -> tuple[int, int]:
    """The same five phases sharded over 4 worker pids whose encrypt loops
    run concurrently — per-pid rates look 4× lower and file ordering
    interleaves, defeating single-process burst heuristics."""
    comm = "python3"
    leader = 4567
    workers = [4567, 4568, 4569, 4570]
    t = t0 + int(cfg.attack_start_sec * _NS)
    start = t

    # leader does recon + discovery (as in the single-process path)
    for p in ("/proc/self/status", "/proc/net/tcp", "/etc/passwd"):
        for _ in range(int(rng.integers(2, 5))):
            t += int(rng.uniform(2, 30) * 1e6)
            em.emit(t, Syscall.OPENAT, p, pid=leader, comm=comm, attack=True,
                    flags=int(OpenFlags.O_RDONLY))
    names = _target_file_names(rng, cfg.num_target_files)
    for nm in names:
        t += int(rng.uniform(1, 4) * 1e6)
        em.emit(t, Syscall.STAT, f"{cfg.target_dir}/{nm}", pid=leader,
                comm=comm, attack=True)

    # workers encrypt interleaved shards on independent clocks
    cursors = {w: t + int(rng.uniform(5, 50) * 1e6) for w in workers}
    for i, nm in enumerate(names):
        w = workers[i % len(workers)]
        tw = cursors[w]
        src = f"{cfg.target_dir}/{nm}"
        dst = (src[: -len(".dat")] + cfg.ransom_ext
               if src.endswith(".dat") else src + cfg.ransom_ext)
        size = int(rng.integers(cfg.min_file_bytes, cfg.max_file_bytes))
        em.emit(tw, Syscall.OPENAT, src, pid=w, comm=comm, attack=True,
                flags=int(OpenFlags.O_RDWR))
        for _ in range(max(1, size // cfg.chunk_bytes)):
            tw += int(rng.uniform(1, 3) * 1e6)
            em.emit(tw, Syscall.READ, src, pid=w, comm=comm, attack=True,
                    nbytes=cfg.chunk_bytes)
            tw += int(rng.uniform(1, 3) * 1e6)
            em.emit(tw, Syscall.WRITE, src, pid=w, comm=comm, attack=True,
                    nbytes=cfg.chunk_bytes, victim=True)
            # each worker honors the rate limit independently (aggregate is
            # 4× — fast attacks are the easy case; interleaving is the test)
            tw += int(cfg.chunk_bytes / cfg.encrypt_rate_bps * 1e9)
        tw += int(rng.uniform(2, 10) * 1e6)
        em.emit(tw, Syscall.RENAME, src, pid=w, comm=comm, attack=True,
                new_path=dst, victim=True)
        cursors[w] = tw
    end = max(cursors.values())
    note = f"{cfg.target_dir}/README_LOCKBIT.txt"
    em.emit(end + int(1e7), Syscall.OPENAT, note, pid=leader, comm=comm,
            attack=True, flags=int(OpenFlags.O_WRONLY))
    em.emit(end + int(2e7), Syscall.WRITE, note, pid=leader, comm=comm,
            attack=True, nbytes=1337)
    return start, end + int(2e7)


def _emit_attack_stealth(em: _Emitter, cfg: SimConfig,
                         rng: np.random.Generator, t0: int) -> tuple[int, int]:
    """The stealth family: no rename, extensions kept, no README-style
    note — every indicator the closed-form heuristic keys on
    (threat-model.mdx:176-189) is absent, so detection must come from the
    access *structure*: one process O_RDWR-sweeping a directory with paired
    read/write chunks in place, after a stat-discovery pass.

    Variants (SimConfig.scenario):
      inplace-stealth     full-file in-place encryption + an innocuously
                          named recovery note
      partial-encrypt     only the head ~12% of each file is overwritten
                          (headers gone ⇒ file destroyed; bytes moved stay
                          far below any volume trigger); no note
      interleaved-backup  the benign backup sweep trails the encryptor over
                          the same files, archiving ciphertext and renaming
                          victims to .bak — the only renames in the trace
                          are benign
      exfil-encrypt       staged: read-only exfil of every file into a /tmp
                          staging blob, a quiet dwell, then partial in-place
                          encryption

    The attacker runs as comm "python3" (the benign app worker's comm, a
    compromised-app story) under its own pid, so neither comm nor open
    flags alone can carry the class — postgres legitimately opens O_RDWR
    (_emit_benign) and python3 is the densest benign identity.
    """
    scenario = cfg.scenario
    pid, comm = 4821, "python3"
    t = t0 + int(cfg.attack_start_sec * _NS)
    start = t

    def step(lo_ms=2, hi_ms=40):
        nonlocal t
        t += int(rng.uniform(lo_ms, hi_ms) * 1e6)
        return t

    # Light recon: two /proc touches — deliberately below the heuristic's
    # burst weighting; the model's process head may still use it.
    for p in ("/proc/self/status", "/proc/mounts"):
        em.emit(step(), Syscall.OPENAT, p, pid=pid, comm=comm, attack=True,
                flags=int(OpenFlags.O_RDONLY))
        em.emit(step(), Syscall.READ, p, pid=pid, comm=comm, attack=True,
                nbytes=int(rng.integers(512, 2048)))

    # Target discovery (unavoidable for any file-targeting payload).
    names = _target_file_names(rng, cfg.num_target_files)
    for nm in names:
        em.emit(step(1, 4), Syscall.STAT, f"{cfg.target_dir}/{nm}", pid=pid,
                comm=comm, attack=True)

    sizes = {nm: int(rng.integers(cfg.min_file_bytes, cfg.max_file_bytes))
             for nm in names}

    if scenario == "exfil-encrypt":
        # Stage A: full read-only sweep, compressing into one staging blob.
        stage = "/tmp/.sess_cache.bin"
        for nm in names:
            src = f"{cfg.target_dir}/{nm}"
            em.emit(step(1, 5), Syscall.OPENAT, src, pid=pid, comm=comm,
                    attack=True, flags=int(OpenFlags.O_RDONLY))
            for _ in range(max(1, sizes[nm] // cfg.chunk_bytes)):
                em.emit(step(1, 3), Syscall.READ, src, pid=pid, comm=comm,
                        attack=True, nbytes=cfg.chunk_bytes)
                em.emit(step(1, 3), Syscall.WRITE, stage, pid=pid, comm=comm,
                        attack=True, nbytes=cfg.chunk_bytes // 3)
        # Quiet dwell before the destructive stage (staged campaigns pause
        # between exfil and impact).
        t += int(min(0.15 * cfg.duration_sec, 30.0) * _NS)

    frac = 0.12 if scenario in ("partial-encrypt", "exfil-encrypt") else 1.0
    bk_pid, bk_comm = 208, "backup-agent"
    bk_t = t  # trailing benign sweep's clock (interleaved-backup only)
    for nm in names:
        src = f"{cfg.target_dir}/{nm}"
        em.emit(step(), Syscall.OPENAT, src, pid=pid, comm=comm, attack=True,
                flags=int(OpenFlags.O_RDWR))
        nchunks = max(1, int(sizes[nm] * frac) // cfg.chunk_bytes)
        for _ in range(nchunks):
            em.emit(step(1, 3), Syscall.READ, src, pid=pid, comm=comm,
                    attack=True, nbytes=cfg.chunk_bytes)
            em.emit(step(1, 3), Syscall.WRITE, src, pid=pid, comm=comm,
                    attack=True, nbytes=cfg.chunk_bytes, victim=True)
            t += int(cfg.chunk_bytes / cfg.encrypt_rate_bps * 1e9)
        if scenario == "interleaved-backup":
            # The backup job reaches each file only after the encryptor
            # leaves it (it archives ciphertext), but its event stream — on
            # its own clock — interleaves with the attacker's work on later
            # files.  Its rename is the ONLY rename the trace contains, and
            # it is benign: labels say so, and the victim set follows the
            # inode to the .bak name (simulate_trace).
            bk_t = max(bk_t, t + int(rng.uniform(5, 30) * 1e6))
            em.emit(bk_t, Syscall.OPENAT, src, pid=bk_pid, comm=bk_comm,
                    attack=False, flags=int(OpenFlags.O_RDONLY))
            for _ in range(max(1, sizes[nm] // cfg.chunk_bytes)):
                bk_t += int(rng.uniform(1, 3) * 1e6)
                em.emit(bk_t, Syscall.READ, src, pid=bk_pid, comm=bk_comm,
                        attack=False, nbytes=cfg.chunk_bytes)
                bk_t += int(rng.uniform(1, 3) * 1e6)
                em.emit(bk_t, Syscall.WRITE, f"/backup/archive/{nm}.gz",
                        pid=bk_pid, comm=bk_comm, attack=False,
                        nbytes=cfg.chunk_bytes // 2)
            bk_t += int(rng.uniform(2, 10) * 1e6)
            em.emit(bk_t, Syscall.RENAME, src, pid=bk_pid, comm=bk_comm,
                    attack=False, new_path=src + ".bak")

    end = max(t, bk_t)
    if scenario == "inplace-stealth":
        # A recovery note that matches no indicator: not README*, benign
        # extension.
        note = f"{cfg.target_dir}/how_to_recover.html"
        em.emit(step(), Syscall.OPENAT, note, pid=pid, comm=comm, attack=True,
                flags=int(OpenFlags.O_WRONLY))
        em.emit(step(), Syscall.WRITE, note, pid=pid, comm=comm, attack=True,
                nbytes=2048)
        end = t
    return start, end


def _emit_attack_cron_persistence(em: _Emitter, cfg: SimConfig,
                                  rng: np.random.Generator,
                                  t0: int) -> tuple[int, int]:
    """Persistence family: the attacker trojanizes the host agent's plugin
    binaries via the atomic-replace idiom (write the payload to a dotfile
    tmp, rename it onto the plugin — the write→rename motif, but aimed at
    *code*, not documents) and drops a hidden cron entry for boot
    persistence.  No victim data file is touched and nothing is encrypted:
    the undo plan the respond tier must produce is "restore the trojanized
    binaries from snapshot", and the cron drop is attack residue the
    rollback gate's leaves-behind policy has to account for."""
    pid, comm = 4913, "python3"
    t = t0 + int(cfg.attack_start_sec * _NS)
    start = t

    def step(lo_ms=2, hi_ms=40):
        nonlocal t
        t += int(rng.uniform(lo_ms, hi_ms) * 1e6)
        return t

    # Light recon: privilege + persistence-surface survey.
    for p in ("/proc/self/status", "/etc/passwd", "/proc/mounts"):
        em.emit(step(), Syscall.OPENAT, p, pid=pid, comm=comm, attack=True,
                flags=int(OpenFlags.O_RDONLY))
        em.emit(step(), Syscall.READ, p, pid=pid, comm=comm, attack=True,
                nbytes=int(rng.integers(512, 2048)))

    n = max(4, min(cfg.num_target_files, 12))
    names = [f"{PLUGIN_DIR}/plugin_{i:02d}.bin" for i in range(n)]
    em.emit(step(), Syscall.OPENAT, PLUGIN_DIR, pid=pid, comm=comm,
            attack=True, flags=int(OpenFlags.O_RDONLY))
    for nm in names:
        em.emit(step(1, 4), Syscall.STAT, nm, pid=pid, comm=comm, attack=True)

    for i, nm in enumerate(names):
        tmp = f"{PLUGIN_DIR}/.tmp_{i:02d}.bin"
        size = int(rng.integers(cfg.min_file_bytes, cfg.max_file_bytes))
        em.emit(step(), Syscall.OPENAT, nm, pid=pid, comm=comm, attack=True,
                flags=int(OpenFlags.O_RDONLY))
        for _ in range(max(1, size // cfg.chunk_bytes)):
            em.emit(step(1, 3), Syscall.READ, nm, pid=pid, comm=comm,
                    attack=True, nbytes=cfg.chunk_bytes)
            em.emit(step(1, 3), Syscall.WRITE, tmp, pid=pid, comm=comm,
                    attack=True, nbytes=cfg.chunk_bytes, victim=True)
        # the tmp's inode (already marked victim) is carried onto the plugin
        # name by the rename — the canonical final path is the binary itself
        em.emit(step(), Syscall.RENAME, tmp, pid=pid, comm=comm, attack=True,
                new_path=nm, victim=True)

    # Boot persistence: one small hidden cron entry (attack residue — a
    # path the snapshot manifest has never seen).
    em.emit(step(), Syscall.OPENAT, CRON_DROP, pid=pid, comm=comm,
            attack=True, flags=int(OpenFlags.O_WRONLY))
    em.emit(step(), Syscall.WRITE, CRON_DROP, pid=pid, comm=comm,
            attack=True, nbytes=142)
    return start, t


def _emit_attack_log_tamper(em: _Emitter, cfg: SimConfig,
                            rng: np.random.Generator,
                            t0: int) -> tuple[int, int]:
    """Anti-forensics family: audit logs are scrubbed by rewriting each one
    through a same-size tmp copy (incriminating entries replaced, byte count
    preserved so log-size monitors see nothing) and renaming the copy over
    the original.  No recon burst — the actor is already inside — and the
    touched directory is one benign services write to constantly, so the
    only signal is the write→rename motif on files nothing benign ever
    renames onto."""
    pid, comm = 5102, "python3"
    t = t0 + int(cfg.attack_start_sec * _NS)
    start = t

    def step(lo_ms=2, hi_ms=40):
        nonlocal t
        t += int(rng.uniform(lo_ms, hi_ms) * 1e6)
        return t

    n = max(3, min(cfg.num_target_files, 10))
    logs = [f"{TAMPER_LOG_DIR}/audit_{i:02d}.log" for i in range(n)]
    for i, lg in enumerate(logs):
        em.emit(step(1, 4), Syscall.STAT, lg, pid=pid, comm=comm, attack=True)
        tmp = f"{TAMPER_LOG_DIR}/.audit_{i:02d}.swp"
        size = int(rng.integers(cfg.min_file_bytes, cfg.max_file_bytes))
        em.emit(step(), Syscall.OPENAT, lg, pid=pid, comm=comm, attack=True,
                flags=int(OpenFlags.O_RDONLY))
        for _ in range(max(1, size // cfg.chunk_bytes)):
            em.emit(step(1, 3), Syscall.READ, lg, pid=pid, comm=comm,
                    attack=True, nbytes=cfg.chunk_bytes)
            # same-size scrub copy: bytes out == bytes in
            em.emit(step(1, 3), Syscall.WRITE, tmp, pid=pid, comm=comm,
                    attack=True, nbytes=cfg.chunk_bytes, victim=True)
        em.emit(step(), Syscall.RENAME, tmp, pid=pid, comm=comm, attack=True,
                new_path=lg, victim=True)
        t += int(rng.uniform(5, 20) * 1e6)
    return start, t


def _emit_benign_atomic_rewrite(em: _Emitter, cfg: SimConfig,
                                rng: np.random.Generator, t0: int) -> None:
    """Hard negative: an indexer refreshes every target file via the
    atomic-save idiom — read src, write ``.tmp_reindex_NNN``, rename the
    tmp over src.  The write→rename-by-the-same-process motif fires on
    EVERY file (the tmp inode is written, then carried onto the target name
    by the rename), so the indicator heuristic mass-flags a routine
    maintenance job; labels mark all of it benign.  This is the FP-undo
    probe aimed at the motif rule specifically, the counterpart of
    benign-mass-rename (which targets extension/rename-volume rules)."""
    pid, comm = 209, "python3"
    t = t0 + int(cfg.attack_start_sec * _NS)
    names = _target_file_names(rng, cfg.num_target_files)
    for i, nm in enumerate(names):
        src = f"{cfg.target_dir}/{nm}"
        tmp = f"{cfg.target_dir}/.tmp_reindex_{i:03d}"
        em.emit(t, Syscall.OPENAT, src, pid=pid, comm=comm, attack=False,
                flags=int(OpenFlags.O_RDONLY))
        size = int(rng.integers(cfg.min_file_bytes, cfg.max_file_bytes))
        for _ in range(max(1, size // cfg.chunk_bytes)):
            t += int(rng.uniform(1, 3) * 1e6)
            em.emit(t, Syscall.READ, src, pid=pid, comm=comm, attack=False,
                    nbytes=cfg.chunk_bytes)
            t += int(rng.uniform(1, 3) * 1e6)
            em.emit(t, Syscall.WRITE, tmp, pid=pid, comm=comm, attack=False,
                    nbytes=cfg.chunk_bytes)
        t += int(rng.uniform(2, 8) * 1e6)
        em.emit(t, Syscall.RENAME, tmp, pid=pid, comm=comm, attack=False,
                new_path=src)
        t += int(rng.uniform(5, 20) * 1e6)


def simulate_trace(cfg: SimConfig, name: str = "") -> Trace:
    """Generate one labelled trace."""
    rng = np.random.default_rng(cfg.seed)
    strings = StringTable()
    em = _Emitter()
    t0 = 1_700_000_000 * _NS + int(cfg.seed) * 10_000 * _NS
    _emit_benign(em, cfg, rng, t0)
    gt = None
    if cfg.scenario == "benign-mass-rename":
        # hard negative: structurally attack-like, labelled benign throughout
        _emit_benign_mass_rename(em, cfg, rng, t0)
    elif cfg.scenario == "benign-atomic-rewrite":
        _emit_benign_atomic_rewrite(em, cfg, rng, t0)
    elif cfg.attack:
        start, end = _emit_attack(em, cfg, rng, t0)
        family, tgt = {
            # the persistence families damage fixed system paths, not the
            # configurable document directory
            "cron-persistence": ("CronPersistenceSynthetic", PLUGIN_DIR),
            "log-tamper": ("LogTamperSynthetic", TAMPER_LOG_DIR),
        }.get(cfg.scenario, ("LockBitSynthetic", cfg.target_dir))
        gt = GroundTruth(
            start_ns=start,
            end_ns=end,
            attack_family=family,
            target_path=tgt,
            platform="synthetic",
            scale=f"{cfg.num_target_files}f",
        )
    # sort by time FIRST, then assign inodes walking causally: a rename
    # invalidates its source name, so later opens of it get a fresh inode
    order = sorted(range(len(em.records)), key=lambda i: em.records[i]["ts_ns"])
    inodes = InodeTable()
    recs = []
    victim_inos: set = set()
    ino_final: dict = {}  # inode → canonical final path (rename dest wins)
    for i in order:
        r = em.records[i]
        r["inode"] = (
            inodes.carry_rename(r["path"], r["new_path"])
            if r["new_path"] else inodes.get(r["path"])
        )
        if r["inode"]:
            ino_final[r["inode"]] = r["new_path"] or r["path"]
            if em.victims[i]:
                victim_inos.add(r["inode"])
        recs.append(r)
    events = EventArrays.from_records(recs, strings)
    labels = np.asarray([em.labels[i] for i in order], np.float32)
    return Trace(
        events=events,
        strings=strings,
        ground_truth=gt,
        labels=labels,
        name=name or f"synth-seed{cfg.seed}",
        # exact file-level truth, following each victim inode to its FINAL
        # name (a benign rename may move it — interleaved-backup) — this is
        # the same canonicalization rule pipeline._inode_to_path applies, so
        # detection keys and ground-truth keys cannot drift
        victim_paths=frozenset(ino_final[i] for i in victim_inos),
    )
