"""Rollback: the snapshot store, the verified executor, the sandbox gate and
the file-level attack simulator.  Host copies of ``nerrf_tpu/rollback/``
(numpy and the filesystem only); the native Firecracker binding
(``rollback/fc.py``) is not carried yet, so ``FirecrackerDriver`` stays
gated as in the reference."""

from nerrf_tpu_torch.rollback.store import SnapshotStore, Manifest
from nerrf_tpu_torch.rollback.executor import RollbackExecutor, RollbackReport
from nerrf_tpu_torch.rollback.sandbox import SandboxGate, GateResult
from nerrf_tpu_torch.rollback.filesim import FileSimConfig, run_file_attack

__all__ = [
    "SnapshotStore",
    "Manifest",
    "RollbackExecutor",
    "RollbackReport",
    "SandboxGate",
    "GateResult",
    "FileSimConfig",
    "run_file_attack",
]
