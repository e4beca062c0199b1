"""File-backed model registry: immutable versioned checkpoints + an
atomically-renamed LIVE pointer.

The port of ``nerrf_tpu/registry/store.py``, kept identical but for the
checkpoint it holds.  A version is a checkpoint of the port
(`train.checkpoint`: ``params.pt`` beside ``model_config.json``), so a
registry written by the port holds the port's checkpoints and is not
interchangeable with one written by the reference (whose versions hold an
orbax ``params/`` directory); the pointer files and the layout above them
are the same.  One part waits for another plane: `executables_dir` returns
None (the AOT sidecar comes with the compile cache, ROADMAP A.7).

Layout (one directory tree, shareable as a ReadWriteMany volume between
the trainer that publishes and the serve pods that poll):

    <root>/lineages/<lineage>/
        v1/                 immutable checkpoint dir (train/checkpoint.py
        v2/                 sidecar format: params.pt + model_config.json)
        LIVE                JSON pointer {"version": N, "previous": M, ...}

Invariants:

  * a version directory appears atomically (copy → rename) and is never
    mutated after publish — rollback is a pointer move, never a rewrite;
  * schema/feature-layout gates run at PUBLISH time (the sidecar checks in
    `train.checkpoint`), not apply time: a stale-layout checkpoint is
    rejected before any serve pod can see it;
  * the LIVE pointer is written temp-then-`os.replace`, so a polling
    reader sees the old pointer or the new one, never a torn file;
  * concurrent publishers are safe: version numbers are claimed by the
    atomic rename itself (the loser of a race re-numbers and retries).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import List, Optional

LIVE_POINTER = "LIVE"


class ModelRegistry:
    """The file-backed store.  Thread- and process-safe for its published
    surface: publish / promote / rollback / read."""

    def __init__(self, root: str | Path, journal=None) -> None:
        self.root = Path(root).absolute()
        # flight journal for publish records; None → the process-wide
        # DEFAULT_JOURNAL, resolved lazily at publish (keeps this module
        # import-light and lets embedders with an isolated journal — the
        # serve bench, tests — keep their records out of the shared ring)
        self._journal = journal

    def _journal_or_default(self):
        if self._journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            self._journal = DEFAULT_JOURNAL
        return self._journal

    # -- paths ----------------------------------------------------------------

    def lineage_dir(self, lineage: str) -> Path:
        if not lineage or "/" in lineage or lineage.startswith("."):
            raise ValueError(f"invalid lineage name {lineage!r}")
        return self.root / "lineages" / lineage

    def version_dir(self, lineage: str, version: int) -> Path:
        return self.lineage_dir(lineage) / f"v{int(version)}"

    # -- read side ------------------------------------------------------------

    def lineages(self) -> List[str]:
        base = self.root / "lineages"
        if not base.is_dir():
            return []
        return sorted(p.name for p in base.iterdir() if p.is_dir())

    def versions(self, lineage: str) -> List[int]:
        d = self.lineage_dir(lineage)
        if not d.is_dir():
            return []
        out = []
        for p in d.iterdir():
            if p.is_dir() and p.name.startswith("v") and \
                    p.name[1:].isdigit():
                out.append(int(p.name[1:]))
        return sorted(out)

    def live(self, lineage: str) -> Optional[dict]:
        """The LIVE pointer record, or None when nothing is promoted."""
        p = self.lineage_dir(lineage) / LIVE_POINTER
        try:
            return json.loads(p.read_text())
        except FileNotFoundError:
            return None
        except json.JSONDecodeError as e:
            raise ValueError(f"corrupt LIVE pointer {p}: {e}") from None

    def live_version(self, lineage: str) -> Optional[int]:
        rec = self.live(lineage)
        return int(rec["version"]) if rec else None

    def load(self, lineage: str, version: Optional[int] = None):
        """→ (state_dict, JointConfig, calibration, version), the tensors on
        the CPU.  ``version=None`` loads LIVE (error when nothing is
        promoted)."""
        from nerrf_tpu_torch.train.checkpoint import load_calibration, load_checkpoint

        if version is None:
            version = self.live_version(lineage)
            if version is None:
                raise FileNotFoundError(
                    f"lineage {lineage!r} has no LIVE version (publish then "
                    f"`nerrf models promote`)")
        path = self.version_dir(lineage, version)
        if not path.is_dir():
            raise FileNotFoundError(
                f"lineage {lineage!r} has no version v{version} "
                f"(have: {self.versions(lineage)})")
        state_dict, cfg = load_checkpoint(path)
        return state_dict, cfg, load_calibration(path), int(version)

    def executables_dir(self, lineage: str, version: int):
        """The version's AOT ``executables/`` sidecar path: always None here,
        since the port has no compile cache to read one (ROADMAP A.7);
        readers treat absence as a plain cache miss."""
        return None

    def quality_profile(self, lineage: str, version: int) -> Optional[dict]:
        """The version's reference quality profile (the checkpoint's
        ``quality_profile.json`` sidecar, published with the weights), or
        None when the version predates profiles OR the sidecar is
        unreadable — drift monitoring is advisory and must never block a
        swap the way a corrupt model sidecar blocks a load (the serve
        plane simply exports no quality series: null-not-fake)."""
        from nerrf_tpu_torch.quality import PROFILE_FILENAME

        f = self.version_dir(lineage, int(version)) / PROFILE_FILENAME
        try:
            return json.loads(f.read_text())
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return None

    def status(self, lineage: str) -> dict:
        live = self.live(lineage)
        versions = []
        for v in self.versions(lineage):
            meta = {}
            try:
                meta = json.loads(
                    (self.version_dir(lineage, v) / "model_config.json")
                    .read_text())
            except (OSError, json.JSONDecodeError):
                pass
            versions.append({
                "version": v,
                "live": bool(live and live.get("version") == v),
                "schema_version": meta.get("schema_version"),
                "calibration": meta.get("calibration"),
                "published_at": meta.get("published_at"),
                "source": meta.get("published_from"),
                "executables": self.executables_dir(lineage, v) is not None,
                "quality_profile":
                    self.quality_profile(lineage, v) is not None,
                # retrain provenance (nerrf_tpu/learn): None for a
                # human-published version, the trigger-seq/replay-
                # fingerprint/parent-version stamp for a supervisor one
                "provenance": meta.get("provenance"),
            })
        return {"lineage": lineage, "live": live, "versions": versions}

    # -- publish --------------------------------------------------------------

    def publish(self, lineage: str, src_dir: str | Path,
                source: Optional[str] = None,
                executables: Optional[str | Path] = None) -> int:
        """Copy a checkpoint directory into the lineage as the next
        immutable version and return its number.  The schema/feature-layout
        gates run HERE — a checkpoint the current code could not load is
        rejected at publish, never discovered at apply time by a serving
        pod.  Does NOT touch LIVE (promotion is a separate, guarded step).

        ``executables`` (an AOT sidecar in the reference) is refused: the
        port has no compile cache to write or read one (ROADMAP A.7)."""
        if executables is not None:
            raise NotImplementedError(
                "publishing an AOT executables sidecar needs the compile "
                "cache (ROADMAP A.7)")
        src = Path(src_dir).absolute()
        validate_checkpoint_dir(src)
        import errno

        from nerrf_tpu_torch import chaos

        ldir = self.lineage_dir(lineage)
        ldir.mkdir(parents=True, exist_ok=True)
        tmp = ldir / f".publish.tmp-{os.getpid()}-{time.monotonic_ns()}"
        try:
            shutil.copytree(src, tmp)
            # chaos fault point (no-op disarmed): the store volume failing
            # mid-publish — the BaseException sweep below must leave no
            # tmp dir and no partial version behind
            chaos.inject("registry.store_io", lineage=lineage)
            # stamp provenance into the *copy*'s sidecar (the source
            # checkpoint stays untouched)
            sidecar = tmp / "model_config.json"
            meta = json.loads(sidecar.read_text())
            meta["published_at"] = time.time()
            meta["published_from"] = source or str(src)
            # chaos fault point (no-op disarmed): a torn/bit-rotted
            # sidecar in the published copy — every later load must fail
            # with the one-line corrupt-sidecar error, never a traceback
            sidecar.write_bytes(chaos.mangle(
                "registry.corrupt_sidecar",
                json.dumps(meta, indent=2).encode(), lineage=lineage))
            while True:
                version = (max(self.versions(lineage), default=0)) + 1
                try:
                    # the atomic claim: rename fails when a concurrent
                    # publisher took this number first — re-scan and retry
                    os.rename(tmp, self.version_dir(lineage, version))
                    self._journal_or_default().record(
                        "registry_publish", lineage=lineage,
                        version=version, source=source or str(src))
                    return version
                except OSError as e:
                    # ONLY a lost race (the target exists) is retryable;
                    # anything else (read-only volume, a stray FILE named
                    # vN, permissions) would recompute the same number and
                    # spin forever
                    if e.errno not in (errno.EEXIST, errno.ENOTEMPTY):
                        raise
                    continue
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def publish_params(self, lineage: str, params, cfg,
                       calibration: Optional[dict] = None,
                       source: Optional[str] = None) -> int:
        """Publish an in-memory state dict (save → gate → copy-in)."""
        import tempfile

        from nerrf_tpu_torch.train.checkpoint import save_checkpoint

        with tempfile.TemporaryDirectory(prefix="nerrf-publish-") as td:
            ckpt = Path(td) / "model"
            save_checkpoint(ckpt, params, cfg, calibration=calibration)
            return self.publish(lineage, ckpt, source=source or "in-memory")

    # -- promotion / rollback -------------------------------------------------

    def promote(self, lineage: str, version: int,
                kind: str = "manual") -> dict:
        """Repoint LIVE at ``version`` (temp-then-replace: atomic for every
        polling reader).  Returns the new pointer record."""
        version = int(version)
        if not self.version_dir(lineage, version).is_dir():
            raise FileNotFoundError(
                f"cannot promote: lineage {lineage!r} has no v{version} "
                f"(have: {self.versions(lineage)})")
        ldir = self.lineage_dir(lineage)
        prev = self.live_version(lineage)
        rec = {"version": version, "previous": prev,
               "promoted_at": time.time(), "kind": kind}
        tmp = ldir / f".{LIVE_POINTER}.tmp-{os.getpid()}-{time.monotonic_ns()}"
        tmp.write_text(json.dumps(rec, indent=2))
        os.replace(tmp, ldir / LIVE_POINTER)
        return rec

    def rollback(self, lineage: str,
                 version: Optional[int] = None) -> dict:
        """One-command rollback: repoint LIVE at ``version``, or at the
        pointer's recorded ``previous`` (falling back to the newest version
        below live).  A pointer move only — the bad version's directory
        stays for the post-mortem."""
        live = self.live(lineage)
        if live is None:
            raise FileNotFoundError(
                f"lineage {lineage!r} has no LIVE version to roll back from")
        if version is None:
            version = live.get("previous")
            if version is None:
                older = [v for v in self.versions(lineage)
                         if v < int(live["version"])]
                if not older:
                    raise ValueError(
                        f"lineage {lineage!r} has no version older than the "
                        f"live v{live['version']} to roll back to")
                version = older[-1]
        return self.promote(lineage, int(version), kind="rollback")


def validate_checkpoint_dir(path: str | Path) -> dict:
    """The publish-time gate: the sidecar must parse, carry a loadable
    schema version, and match the feature layout the current code produces
    — the same checks `load_checkpoint` runs, moved to where a bad
    checkpoint is cheap to reject.  Returns the parsed sidecar."""
    from nerrf_tpu_torch.train.checkpoint import (
        PARAMS_FILENAME,
        _check_feature_layout,
        _check_schema_version,
        _read_sidecar,
    )

    path = Path(path).absolute()
    meta = _read_sidecar(path, "model_config.json")
    _check_schema_version(meta, path)
    _check_feature_layout(meta, path, keys=("node", "edge", "seq"))
    if not (path / PARAMS_FILENAME).is_file():
        raise FileNotFoundError(
            f"not a checkpoint: {path} has a sidecar but no "
            f"{PARAMS_FILENAME} (torn copy?)")
    for key in ("gnn", "lstm", "fuse"):
        if key not in meta:
            raise ValueError(
                f"corrupt checkpoint sidecar {path / 'model_config.json'}: "
                f"missing the {key!r} model-config field")
    return meta
