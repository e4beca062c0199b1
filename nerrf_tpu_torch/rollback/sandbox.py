"""Undo sandbox: clone → replay → rehearse → verify → approve.

(Copied from ``nerrf_tpu/rollback/sandbox.py`` so the port needs nothing of
the JAX package; keep the two identical: the parity tests compare their
results.)

The reference specifies Firecracker-microVM replay with an md5 safety gate
(`docs/content/docs/architecture.mdx:75-87`: clone victim
rootfs → deterministic replay → apply undo ops → validate checksums vs
pre-attack → approve).  In this containerized environment there is no
/dev/kvm, so the isolation boundary is a throwaway filesystem clone instead
of a microVM — the *gate logic* is identical, and `FirecrackerDriver`
documents the microVM wiring for hosts that have KVM.

The REPLAY step validates determinism, not just undo completeness: the
captured trace's filesystem operations are re-executed against a restore of
the pre-attack snapshot, and the resulting tree must reproduce the observed
victim state (names + sizes; payload bytes are not captured by any tracker,
the reference's included).  If the attacker did anything the trace does not
explain — a hidden write, an extra deletion, an uncaptured artifact — the
replayed tree diverges from reality and the gate refuses: an undo plan
validated against an incomplete story cannot be trusted.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, Optional

from nerrf_tpu_torch.planner.domain import UndoPlan
from nerrf_tpu_torch.rollback.executor import RollbackExecutor, RollbackReport
from nerrf_tpu_torch.rollback.store import Manifest, SnapshotStore


@dataclasses.dataclass
class GateResult:
    approved: bool
    rehearsal: RollbackReport
    residual_diff: Dict[str, str]
    reason: str
    # replay-vs-observed divergences (path → kind); empty = deterministic
    # or replay not requested
    replay_divergence: Dict[str, str] = dataclasses.field(default_factory=dict)
    # size-only mismatches on paths the attack did not structurally touch
    # (e.g. benign appends, whose offsets no syscall trace captures):
    # surfaced for the operator, but not grounds for rejection
    replay_warnings: Dict[str, str] = dataclasses.field(default_factory=dict)
    replay_ops: int = 0

    def to_dict(self) -> Dict:
        return {
            "approved": self.approved,
            "reason": self.reason,
            "residual_diff": self.residual_diff,
            "replay_divergence": self.replay_divergence,
            "replay_warnings": self.replay_warnings,
            "replay_ops": self.replay_ops,
            "rehearsal": self.rehearsal.to_dict(),
        }


def replay_trace_ops(events, strings, victim_root: Path,
                     replay_root: Path) -> tuple[int, set]:
    """Re-execute the trace's filesystem mutations (paths under victim_root,
    rebased onto replay_root), in event-time order.

    Syscall traces carry byte counts, not payloads or offsets (the
    reference's capture has the same limit), so writes are modeled as an
    offset cursor from 0 per write session WITHOUT truncation: full rewrites
    and in-place overwrites (the ransomware pattern) reproduce exactly;
    appends land at the head instead of the tail — same size when the file
    was fully rewritten, a (soft) size divergence otherwise.  Returns
    (ops_applied, structurally_touched_rel_paths) — the paths renamed,
    unlinked, or created, i.e. where size divergence is attack-relevant and
    must gate hard."""
    from nerrf_tpu_torch.schema.events import Syscall

    victim_root = Path(victim_root).resolve()
    ops = 0
    cursor: Dict[Path, int] = {}
    touched: set = set()

    def rebase(p: str) -> Optional[Path]:
        if not p:
            return None
        try:
            rel = Path(p).resolve().relative_to(victim_root)
        except ValueError:
            return None
        return replay_root / rel

    for i in range(len(events)):
        if not events.valid[i]:
            continue
        sc = int(events.syscall[i])
        path = rebase(strings.lookup(int(events.path_id[i])))
        if sc == int(Syscall.WRITE) and path is not None:
            path.parent.mkdir(parents=True, exist_ok=True)
            existed = path.exists()
            pos = cursor.get(path, 0)
            with open(path, "r+b" if existed else "wb") as f:
                f.seek(pos)
                f.write(b"\x00" * int(events.bytes[i]))
            cursor[path] = pos + int(events.bytes[i])
            if not existed:
                touched.add(str(path.relative_to(replay_root)))
            ops += 1
        elif sc == int(Syscall.RENAME):
            new = rebase(strings.lookup(int(events.new_path_id[i])))
            if path is not None and new is not None and path.exists():
                new.parent.mkdir(parents=True, exist_ok=True)
                os.replace(path, new)
                cursor.pop(path, None)
                touched.add(str(path.relative_to(replay_root)))
                touched.add(str(new.relative_to(replay_root)))
                ops += 1
        elif sc == int(Syscall.UNLINK) and path is not None:
            if path.exists():
                path.unlink()
                cursor.pop(path, None)
                touched.add(str(path.relative_to(replay_root)))
                ops += 1
    return ops, touched


def _tree_state(root: Path) -> Dict[str, int]:
    return {
        str(p.relative_to(root)): p.stat().st_size
        for p in sorted(root.rglob("*")) if p.is_file()
    }


class SandboxGate:
    """Clone → (replay →) rehearse → verify → approve."""

    def __init__(self, store: SnapshotStore, manifest: Manifest,
                 ransom_ext: str = ".lockbit3") -> None:
        self.store = store
        self.manifest = manifest
        self.ransom_ext = ransom_ext

    def _replay_check(self, trace, victim_root: Path,
                      tmp: Path) -> tuple[Dict[str, str], Dict[str, str], int]:
        """Restore pre-attack state, re-run the captured ops, diff the
        result against the observed victim tree (names + sizes).  Returns
        (hard_divergence, soft_warnings, ops): structural mismatches and
        size mismatches on attack-touched paths gate hard; size-only drift
        on untouched paths (offsets are uncapturable) is a warning."""
        replay = tmp / "replay"
        replay.mkdir()
        for rel in self.manifest.files:
            self.store.restore_file(self.manifest, rel, replay)
        ops, touched = replay_trace_ops(trace.events, trace.strings,
                                        victim_root, replay)
        got = _tree_state(replay)
        want = _tree_state(victim_root)
        div: Dict[str, str] = {}
        warn: Dict[str, str] = {}
        for rel in want.keys() - got.keys():
            div[rel] = "unexplained-by-trace"   # exists, replay can't produce
        for rel in got.keys() - want.keys():
            div[rel] = "missing-from-victim"    # replay makes it, reality lacks
        for rel in want.keys() & got.keys():
            if want[rel] != got[rel]:
                msg = f"size-mismatch:{got[rel]}!={want[rel]}"
                if rel in touched:
                    div[rel] = msg
                else:
                    warn[rel] = msg
        return div, warn, ops

    def rehearse(self, plan: UndoPlan, victim_root: str | Path,
                 trace=None,
                 ignore_extra: tuple[str, ...] = ("README_LOCKBIT.txt",)) -> GateResult:
        """Gate the plan.  With ``trace`` (the captured incident trace), the
        spec's full clone→replay→validate sequence runs first; without it
        only undo completeness is validated (legacy behavior)."""
        victim_root = Path(victim_root)
        with tempfile.TemporaryDirectory(prefix="nerrf-sandbox-") as tmp:
            tmp = Path(tmp)
            divergence: Dict[str, str] = {}
            warnings: Dict[str, str] = {}
            replay_ops = 0
            if trace is not None:
                divergence, warnings, replay_ops = self._replay_check(
                    trace, victim_root, tmp)
                if divergence:
                    return GateResult(
                        False, RollbackReport(), {},
                        f"replay diverges from observed state on "
                        f"{len(divergence)} path(s) — the trace does not "
                        f"deterministically explain the damage",
                        replay_divergence=divergence,
                        replay_warnings=warnings, replay_ops=replay_ops)
            clone = tmp / "clone"
            shutil.copytree(victim_root, clone)
            ex = RollbackExecutor(self.store, self.manifest, clone,
                                  ransom_ext=self.ransom_ext, allow_kill=False)
            rep = ex.execute(plan)
            diff = self.store.diff(self.manifest, clone)
            # attack artifacts the plan intentionally leaves (e.g. the ransom
            # note) can be ignored by policy; everything else must match
            residual = {
                k: v for k, v in diff.items()
                if not (v == "extra" and Path(k).name in ignore_extra)
            }
        if residual:
            return GateResult(False, rep, residual,
                              f"{len(residual)} paths differ from pre-attack snapshot",
                              replay_divergence=divergence,
                              replay_warnings=warnings, replay_ops=replay_ops)
        if rep.files_failed:
            return GateResult(False, rep, residual,
                              f"{rep.files_failed} restores failed",
                              replay_divergence=divergence,
                              replay_warnings=warnings, replay_ops=replay_ops)
        return GateResult(True, rep, residual,
                          "replay deterministic; clone matches pre-attack "
                          "snapshot" if trace is not None
                          else "clone matches pre-attack snapshot",
                          replay_divergence=divergence,
                          replay_warnings=warnings, replay_ops=replay_ops)


class FirecrackerDriver:
    """Driver for real microVM replay on hosts with KVM + firecracker.

    Not runnable in this environment (no /dev/kvm, no firecracker binary —
    availability is probed, never assumed).  The flow mirrors the spec
    (`architecture.mdx:79-86`): build a rootfs image from the clone, boot a
    microVM with a read-only base + writable overlay, run the executor
    inside, extract the overlay and hash-verify.
    """

    def __init__(self, firecracker_bin: str = "firecracker",
                 kernel_image: Optional[str] = None,
                 api_socket: str = "/tmp/nerrf-fc.sock") -> None:
        self.bin = firecracker_bin
        self.kernel_image = kernel_image
        self.api_socket = api_socket

    @staticmethod
    def available() -> bool:
        import os
        return os.path.exists("/dev/kvm") and shutil.which("firecracker") is not None

    def boot_clone(self, rootfs_image: str, vcpus: int = 1, mem_mib: int = 256,
                   socket_wait_sec: float = 5.0):  # pragma: no cover - requires KVM host
        """The reference spawns firecracker here and drives its API through
        the native C++ transport (``nerrf_tpu/rollback/fc.py``), which the
        port does not carry yet: it raises."""
        raise NotImplementedError(
            "FirecrackerDriver.boot_clone needs the native Firecracker binding "
            "(rollback/fc.py), which nerrf_tpu_torch does not carry yet")

    def rehearse(self, *a, **kw):  # pragma: no cover - requires KVM host
        raise RuntimeError(
            "Firecracker replay requires /dev/kvm and a firecracker binary; "
            "use SandboxGate (filesystem-clone rehearsal) in this environment."
        )
