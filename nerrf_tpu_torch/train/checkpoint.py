"""Model checkpoint save/restore: the port of ``nerrf_tpu/train/checkpoint.py``.

A checkpoint is a directory of two files:

* ``params.pt``: ``torch.save`` of the model's ``state_dict``, every tensor
  on the CPU, read back with ``torch.load(..., map_location="cpu",
  weights_only=True)``;
* ``model_config.json``: the reference's sidecar, the same dict written the
  same way for the same config (model widths, aggregation, LSTM impl,
  feature layout, schema version, and the held-out calibration when there
  is one), so the checkpoint describes the network that reads it.

The sidecar records no ``dtype`` and no ``routing``, as the reference's
does not: a checkpoint loads as the default-dtype config.
``load_checkpoint`` returns ``(state_dict, JointConfig)``; the caller builds
``NerrfNet(cfg)`` on its device and loads the state into it.

Left out (ROADMAP A.5, A.6): the reference quality profile that the
reference's ``calibrate_and_resave`` writes beside the sidecar (a
checkpoint here ships without a drift baseline, and says so in the log),
the StreamNet checkpoints (``save/load_stream_checkpoint``) and the
producer of the ``provenance`` stamp (``save_checkpoint`` writes one when
it is given).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import torch

from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig
from nerrf_tpu_torch.tracing import span as trace_span

PARAMS_FILENAME = "params.pt"
CONFIG_FILENAME = "model_config.json"

# Sidecar schema version, stamped into every checkpoint and validated at
# load.  The feature-dim stamp below catches the known drift axes (node/
# edge/seq widths); the version catches everything else: bump it whenever
# the meaning of stamped fields or the parameter layout changes such that
# old checkpoints must not load silently.  The reference's value.
SCHEMA_VERSION = 2
# the oldest stamped schema this code still loads: raise this floor (not
# just SCHEMA_VERSION) when a change means older checkpoints must not load
# silently — only a floor can actually reject them
MIN_SCHEMA_VERSION = 2


@contextlib.contextmanager
def _atomic_dir(path: Path):
    """Write-temp-then-rename checkpoint publish.

    The body saves into a sibling temp directory; only a *complete* save is
    renamed into place (rename(2) is atomic on one filesystem), so a
    concurrent reader — a serve pod's loader — can never observe a torn
    checkpoint directory: it sees the old complete checkpoint, the new
    complete checkpoint, or nothing.  A crash mid-save leaves the temp
    directory behind (reclaimed by the next save to the same path) and the
    previous checkpoint recoverable: a crash in the narrow window between
    the two final renames parks it at ``.<name>.old``, which the next save
    renames back before starting."""
    path = Path(path).absolute()
    tmp = path.parent / f".{path.name}.tmp"
    old = path.parent / f".{path.name}.old"
    if not path.exists() and old.exists():
        # crashed between the two renames last time: the parked previous
        # checkpoint is the only good copy — restore it, never discard it
        os.rename(old, path)
    for leftover in (tmp, old):
        if leftover.exists():
            shutil.rmtree(leftover)
    tmp.mkdir(parents=True)
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # swap: park the previous checkpoint, rename the new one in, then
    # reclaim — both renames are atomic, so no reader ever sees a mix
    if path.exists():
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _read_sidecar(path: Path, name: str) -> dict:
    """The checkpoint's JSON sidecar, with the two corruption modes turned
    into one-line actionable errors instead of a raw KeyError/JSONDecodeError
    surfacing deep inside the loader."""
    f = path / name
    try:
        return json.loads(f.read_text())
    except FileNotFoundError:
        raise FileNotFoundError(
            f"not a checkpoint: {path} has no {name} sidecar (wrong "
            f"directory, a torn copy, or a save that never finished)"
        ) from None
    except json.JSONDecodeError as e:
        raise ValueError(
            f"corrupt checkpoint sidecar {f}: not valid JSON ({e})") from None
    except UnicodeDecodeError as e:
        # bit rot rarely respects UTF-8 boundaries: a mangled byte inside
        # a multi-byte sequence fails DECODE before json ever parses —
        # same corruption class, same one-line error
        raise ValueError(
            f"corrupt checkpoint sidecar {f}: not valid UTF-8 ({e})"
        ) from None


def _check_schema_version(meta: dict, path: Path) -> None:
    got = meta.get("schema_version")
    if got is None:
        # legacy unstamped sidecar: falls through to the feature-layout
        # check, which produces its own actionable retrain message
        return
    if got > SCHEMA_VERSION:
        raise ValueError(
            f"retrain or upgrade: checkpoint {path} carries sidecar schema "
            f"v{got}, this code writes v{SCHEMA_VERSION} — it was saved by "
            f"a newer version of the code")
    if got < MIN_SCHEMA_VERSION:
        raise ValueError(
            f"retrain: checkpoint {path} carries sidecar schema v{got}, "
            f"older than the oldest supported v{MIN_SCHEMA_VERSION} — its "
            f"layout predates changes this code cannot load")


def _feature_layout() -> dict:
    """The input-feature layout the current code produces.  Stamped into
    every sidecar and verified at load, so that a checkpoint trained on
    another layout fails here and not with a shape error inside the
    forward."""
    from nerrf_tpu_torch.data.sequences import SEQ_FEATURE_DIM
    from nerrf_tpu_torch.graph.builder import EDGE_FEATURE_DIM, NODE_FEATURE_DIM
    return {"node": NODE_FEATURE_DIM, "edge": EDGE_FEATURE_DIM,
            "seq": SEQ_FEATURE_DIM}


def _check_feature_layout(meta: dict, path: Path, keys: tuple) -> None:
    want = _feature_layout()
    got = meta.get("features")
    if got is None:
        raise ValueError(
            f"checkpoint {path} predates feature-layout versioning (no "
            f"'features' field in its sidecar); the input feature layout "
            f"has since changed (current: {want}) — retrain, or stamp the "
            f"sidecar by hand if you are certain it matches")
    bad = {k: (got.get(k), want[k]) for k in keys if got.get(k) != want[k]}
    if bad:
        raise ValueError(
            f"retrain: feature layout changed — checkpoint {path} was "
            f"trained with {got}, current code produces {want} "
            f"(mismatched: {bad})")


def save_checkpoint(path: str | Path, state_dict: Mapping[str, torch.Tensor],
                    cfg: JointConfig, calibration: dict | None = None,
                    provenance: dict | None = None) -> None:
    """Publish ``state_dict`` (a ``NerrfNet``'s, on any device) and ``cfg``'s
    sidecar at ``path``, atomically (:func:`_atomic_dir`): the weights
    first, then the sidecar."""
    meta = {
        "gnn": {"hidden": cfg.gnn.hidden, "num_layers": cfg.gnn.num_layers,
                "dropout": cfg.gnn.dropout,
                "aggregation": cfg.gnn.aggregation},
        "lstm": {"hidden": cfg.lstm.hidden, "num_layers": cfg.lstm.num_layers,
                 "dropout": cfg.lstm.dropout, "impl": cfg.lstm.impl},
        "fuse": cfg.fuse,
        "features": _feature_layout(),
        "schema_version": SCHEMA_VERSION,
    }
    if calibration:
        # held-out-calibrated operating points (node_threshold: the
        # probability cut the file-level detector should flag at) belong
        # WITH the weights: a checkpoint evaluated at someone else's
        # threshold silently changes its false-positive behavior
        meta["calibration"] = calibration
    if provenance:
        # retrain provenance: which trigger, which replay content and which
        # parent version produced these weights
        meta["provenance"] = provenance
    host = {k: v.detach().cpu() for k, v in state_dict.items()}
    with _atomic_dir(path) as tmp:
        with trace_span("checkpoint", kind="params"):
            torch.save(host, tmp / PARAMS_FILENAME)
        (tmp / CONFIG_FILENAME).write_text(json.dumps(meta, indent=2))


def load_checkpoint(path: str | Path) -> Tuple[Dict[str, torch.Tensor], JointConfig]:
    """``(state_dict, cfg)`` of the checkpoint at ``path``, the tensors on
    the CPU, after the sidecar's schema and feature-layout checks."""
    path = Path(path).absolute()
    meta = _read_sidecar(path, CONFIG_FILENAME)
    _check_schema_version(meta, path)
    _check_feature_layout(meta, path, keys=("node", "edge", "seq"))
    try:
        cfg = JointConfig(
            gnn=GraphSAGEConfig(**meta["gnn"]),
            lstm=LSTMConfig(**meta["lstm"]),
            fuse=meta["fuse"],
        )
    except (KeyError, TypeError) as e:
        raise ValueError(
            f"corrupt checkpoint sidecar {path / CONFIG_FILENAME}: "
            f"missing or malformed model-config field ({e!r})") from None
    state_dict = torch.load(path / PARAMS_FILENAME, map_location="cpu",
                            weights_only=True)
    return state_dict, cfg


def load_calibration(path: str | Path) -> dict:
    """The checkpoint's held-out-calibrated operating points ({} when the
    checkpoint predates calibration).  Separate from load_checkpoint so its
    two-tuple contract stays stable for existing callers."""
    return _read_sidecar(Path(path).absolute(),
                         CONFIG_FILENAME).get("calibration") or {}


def calibrate_and_resave(path: str | Path, model, node_loss_weight: float = 1.0,
                         log=None, provenance: dict | None = None,
                         device=None) -> Optional[dict]:
    """Calibrate the file detector's operating point on held-out incidents
    (:func:`nerrf_tpu_torch.pipeline.calibrate_file_thresholds`, with
    ``model`` on ``device``) and re-save the checkpoint at ``path`` with it.

    Best-effort by contract: the caller must have saved the plain
    checkpoint FIRST; any failure here logs and returns None, leaving that
    checkpoint (and its 0.5 default threshold) intact.  Skips (None) when
    the node head wasn't trained — calibrating an untrained head would
    fabricate a cut.

    Returns the calibration dict written to the sidecar, or None."""
    if node_loss_weight <= 0:
        return None
    from nerrf_tpu_torch.pipeline import calibrate_file_thresholds

    try:
        cals = calibrate_file_thresholds(model, log=log, device=device)
    except Exception as e:  # noqa: BLE001 — plain checkpoint already safe
        if log:
            log(f"calibration failed ({type(e).__name__}: {e}); "
                "checkpoint keeps the 0.5 default threshold")
        return None
    if not cals.get("max"):
        if log:
            log("calibration unreachable; checkpoint keeps the 0.5 "
                "default threshold")
        return None
    cal = cals["max"]
    calibration = {"node_threshold": round(cal.threshold, 4),
                   "node_threshold_kind": cal.kind,
                   "node_threshold_recall": round(cal.recall, 4)}
    if cals.get("robust"):
        # the robust-aggregation leg runs at its OWN calibrated cut (robust
        # scores sit at/below max scores)
        r = cals["robust"]
        calibration.update({"node_threshold_robust": round(r.threshold, 4),
                            "node_threshold_robust_kind": r.kind,
                            "node_threshold_robust_recall": round(r.recall, 4)})
    if log:
        log("quality profile not built (not ported); checkpoint ships "
            "without a drift baseline")
    # provenance is threaded through the re-save: a retrained checkpoint
    # that gets calibrated must not lose its retrain stamp to this rewrite
    save_checkpoint(path, model.state_dict(), model.cfg,
                    calibration=calibration, provenance=provenance)
    return calibration
