"""Rollback executor: applies an UndoPlan to the real filesystem, verified.

(Copied from ``nerrf_tpu/rollback/executor.py`` so the port needs nothing of
the JAX package; keep the two identical: the parity tests compare their
results.)

Generalizes the reference's recovery mechanism — a rename-back loop with
millisecond timing (`benchmarks/m1/scripts/m1_rollback.sh:74-133`)
— into verified restoration: for each planned file reversion, restore the
pre-attack bytes from the content-addressed snapshot store, remove the
ransom-named artifact, and verify the result by sha256 against the snapshot
manifest (the spec's hash-validation step, `architecture.mdx:83-86`).
Process kills are recorded (and only executed for real when ``allow_kill`` is
set — the benchmark simulates victims in-process).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional

from nerrf_tpu_torch.planner.domain import ActionKind, UndoPlan
from nerrf_tpu_torch.rollback.store import Manifest, SnapshotStore, sha256_file


@dataclasses.dataclass
class RollbackReport:
    files_restored: int = 0
    files_failed: int = 0
    files_skipped: int = 0
    bytes_restored: int = 0
    procs_killed: int = 0
    duration_seconds: float = 0.0
    verified: bool = False
    details: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def files_per_sec(self) -> float:
        return self.files_restored / self.duration_seconds if self.duration_seconds else 0.0

    @property
    def mb_per_sec(self) -> float:
        return (self.bytes_restored / 1e6) / self.duration_seconds if self.duration_seconds else 0.0

    def to_dict(self) -> Dict:
        return {
            "files_restored": self.files_restored,
            "files_failed": self.files_failed,
            "files_skipped": self.files_skipped,
            "bytes_restored": self.bytes_restored,
            "procs_killed": self.procs_killed,
            "duration_seconds": self.duration_seconds,
            "files_per_sec": round(self.files_per_sec, 2),
            "mb_per_sec": round(self.mb_per_sec, 2),
            "verified": self.verified,
        }


class RollbackExecutor:
    def __init__(
        self,
        store: SnapshotStore,
        manifest: Manifest,
        root: str | Path,
        ransom_ext: str = ".lockbit3",
        allow_kill: bool = False,
        journal=None,
    ) -> None:
        if journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            journal = DEFAULT_JOURNAL
        self.store = store
        self.manifest = manifest
        self.root = Path(root)
        self.ransom_ext = ransom_ext
        self.allow_kill = allow_kill
        self._journal = journal

    def _step_unsafe(self, rel: str) -> Optional[str]:
        """Fail-closed preconditions for one REVERT_FILE step; returns the
        one-line refusal reason, or None when the step is safe to apply.

        * path escape — a manifest rel like ``../x`` (hostile or corrupted
          manifest) would make restore/unlink write OUTSIDE the sandbox
          root; every path this step will touch must resolve under root.
        * pre-image mismatch — the store blob about to be written must
          hash to the digest the manifest promises; a corrupted or
          tampered blob must never reach the victim tree (restore-then-
          verify would catch it AFTER the damage is done).
        """
        digest = self.manifest.files[rel][0]
        root = self.root.resolve()
        for candidate in (self.root / rel, self.root / (rel + self.ransom_ext)):
            # resolve the PARENT (the leaf may not exist yet): symlinked or
            # dot-dotted components both normalize away here
            resolved = candidate.parent.resolve() / candidate.name
            if not resolved.is_relative_to(root):
                return f"path escapes sandbox root: {candidate}"
        blob = self.store.dir / "blobs" / digest
        if not blob.is_file():
            return f"snapshot blob missing: {digest[:12]}"
        if sha256_file(blob) != digest:
            return f"pre-image hash mismatch: blob {digest[:12]} is corrupt"
        return None

    def _rel_of(self, path: str) -> Optional[str]:
        """Map a planned (possibly ransom-named) path to a manifest entry.

        Plan targets are absolute paths under the *original* victim root, but
        the executor may run against a different root (the sandbox gate's
        clone), so resolution tries ever-shorter path suffixes against the
        manifest — longest match wins, which keeps nested layouts unambiguous.
        """
        parts = Path(path).parts
        for k in range(len(parts)):
            rel = "/".join(parts[k:])
            if rel in self.manifest.files:
                return rel
            if rel.endswith(self.ransom_ext):
                orig = rel[: -len(self.ransom_ext)]
                if orig in self.manifest.files:
                    return orig
        return None

    def execute(self, plan: UndoPlan) -> RollbackReport:
        rep = RollbackReport()
        t0 = time.perf_counter()
        for action in plan.actions:
            if action.kind == ActionKind.REVERT_FILE:
                rel = self._rel_of(action.target)
                if rel is None:
                    rep.files_skipped += 1
                    rep.details.append({"target": action.target, "result": "no-snapshot"})
                    continue
                unsafe = self._step_unsafe(rel)
                if unsafe is not None:
                    # fail THIS step closed and keep executing the plan:
                    # one bad step must not strand the other victims
                    # mid-restore, and the refusal is journaled so the
                    # flight/doctor planes can see why a restore shrank
                    rep.files_failed += 1
                    rep.details.append(
                        {"target": action.target, "result": f"refused:{unsafe}"})
                    self._journal.record(
                        "rollback_step_failed", target=action.target,
                        rel=rel, reason=unsafe)
                    continue
                try:
                    restored = self.store.restore_file(self.manifest, rel, self.root)
                    # remove the ransom-named artifact the attack left behind
                    artifact = self.root / (rel + self.ransom_ext)
                    if artifact.is_file():
                        artifact.unlink()
                    ok = self.store.verify_file(self.manifest, rel, self.root)
                    if ok:
                        rep.files_restored += 1
                        rep.bytes_restored += self.manifest.files[rel][1]
                        rep.details.append({"target": str(restored), "result": "restored"})
                    else:
                        rep.files_failed += 1
                        rep.details.append({"target": str(restored), "result": "hash-mismatch"})
                except OSError as e:
                    rep.files_failed += 1
                    rep.details.append({"target": action.target, "result": f"error:{e}"})
            elif action.kind == ActionKind.KILL_PROCESS:
                rep.procs_killed += 1
                killed = False
                if self.allow_kill:
                    try:
                        import os
                        import signal

                        pid = int(action.target.split(":", 1)[0])
                        os.kill(pid, signal.SIGKILL)
                        killed = True
                    except (ValueError, ProcessLookupError, PermissionError):
                        pass
                rep.details.append({
                    "target": action.target,
                    "result": "killed" if killed else "kill-recorded",
                })
        rep.duration_seconds = time.perf_counter() - t0
        rep.verified = rep.files_failed == 0 and rep.files_restored > 0
        return rep
