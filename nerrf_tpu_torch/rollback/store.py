"""Content-addressed snapshot store — the rollback data plane.

(Copied from ``nerrf_tpu/rollback/store.py`` so the port needs nothing of
the JAX package; keep the two identical: the parity tests compare their
results.)

Plays the role of the reference's planned RocksDB-backed delta store +
OverlayFS reverse-diffs (`README.md:113`, `ROADMAP.md:58,75`
— neither was built): periodic snapshots of a protected directory, stored as
sha256-addressed blobs plus per-snapshot manifests, so any file can be
restored bit-exactly and any restore can be *verified* by hash — the safety
property the reference's md5-gate workflow requires
(`architecture.mdx:79-86`).

The store is deliberately simple and durable (files on disk, atomic renames);
the heavy lifting (detection, planning) lives on the TPU side.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Dict, Optional


def sha256_file(path: str | Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


@dataclasses.dataclass
class Manifest:
    """One snapshot: relative path → (sha256, size, mode)."""

    snapshot_id: str
    created_ns: int
    root: str
    files: Dict[str, tuple[str, int, int]]

    def to_json(self) -> str:
        return json.dumps(
            {
                "snapshot_id": self.snapshot_id,
                "created_ns": self.created_ns,
                "root": self.root,
                "files": {k: list(v) for k, v in self.files.items()},
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, s: str) -> "Manifest":
        d = json.loads(s)
        return cls(
            snapshot_id=d["snapshot_id"],
            created_ns=d["created_ns"],
            root=d["root"],
            files={k: tuple(v) for k, v in d["files"].items()},
        )


class SnapshotStore:
    """``store_dir/blobs/<sha256>`` + ``store_dir/manifests/<id>.json``."""

    def __init__(self, store_dir: str | Path) -> None:
        self.dir = Path(store_dir)
        (self.dir / "blobs").mkdir(parents=True, exist_ok=True)
        (self.dir / "manifests").mkdir(parents=True, exist_ok=True)

    # --- snapshot ------------------------------------------------------------
    def snapshot(self, root: str | Path, snapshot_id: Optional[str] = None) -> Manifest:
        root = Path(root)
        snapshot_id = snapshot_id or f"snap-{int(time.time() * 1000):x}"
        files: Dict[str, tuple[str, int, int]] = {}
        for p in sorted(root.rglob("*")):
            if not p.is_file():
                continue
            rel = str(p.relative_to(root))
            digest = sha256_file(p)
            st = p.stat()
            files[rel] = (digest, st.st_size, st.st_mode & 0o7777)
            blob = self.dir / "blobs" / digest
            if not blob.exists():
                tmp = blob.with_suffix(".tmp")
                shutil.copyfile(p, tmp)
                os.replace(tmp, blob)  # atomic publish
        m = Manifest(
            snapshot_id=snapshot_id,
            created_ns=time.time_ns(),
            root=str(root),
            files=files,
        )
        mpath = self.dir / "manifests" / f"{snapshot_id}.json"
        tmp = mpath.with_suffix(".tmp")
        tmp.write_text(m.to_json())
        os.replace(tmp, mpath)
        return m

    def load_manifest(self, snapshot_id: str) -> Manifest:
        return Manifest.from_json(
            (self.dir / "manifests" / f"{snapshot_id}.json").read_text()
        )

    def list_manifests(self) -> list[str]:
        return sorted(p.stem for p in (self.dir / "manifests").glob("*.json"))

    # --- restore -------------------------------------------------------------
    def restore_file(self, manifest: Manifest, rel: str, dest_root: str | Path) -> Path:
        """Restore one file bit-exactly; returns the restored path."""
        digest, size, mode = manifest.files[rel]
        blob = self.dir / "blobs" / digest
        out = Path(dest_root) / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + ".nerrf-restore")
        shutil.copyfile(blob, tmp)
        os.chmod(tmp, mode)
        os.replace(tmp, out)
        return out

    def verify_file(self, manifest: Manifest, rel: str, root: str | Path) -> bool:
        digest, size, _ = manifest.files[rel]
        p = Path(root) / rel
        return p.is_file() and p.stat().st_size == size and sha256_file(p) == digest

    def diff(self, manifest: Manifest, root: str | Path) -> Dict[str, str]:
        """Manifest vs directory: rel path → 'missing' | 'modified' | 'extra'."""
        root = Path(root)
        out: Dict[str, str] = {}
        seen = set()
        for rel in manifest.files:
            seen.add(rel)
            p = root / rel
            if not p.is_file():
                out[rel] = "missing"
            elif not self.verify_file(manifest, rel, root):
                out[rel] = "modified"
        for p in root.rglob("*"):
            if p.is_file():
                rel = str(p.relative_to(root))
                if rel not in manifest.files:
                    out[rel] = "extra"
        return out
