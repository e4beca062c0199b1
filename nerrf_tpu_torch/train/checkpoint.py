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

A StreamNet checkpoint (``save/load_stream_checkpoint``) is ``params.pt``
beside the reference's ``stream_config.json``: the model's fields with its
dtype's name, the stream feature width, the schema version and the
calibrated per-event threshold, which lives in logit space.

A calibrated checkpoint also carries ``quality_profile.json``, the
reference quality profile (`quality.profile`) that `calibrate_and_resave`
builds at the calibrated operating point: the drift baseline a serve pod
compares live traffic against.  ``provenance`` is written when it is given
(its producer, the learn plane, is not ported yet).
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
STREAM_CONFIG_FILENAME = "stream_config.json"

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


def architecture(cfg: JointConfig) -> dict:
    """The model fields a sidecar records for ``cfg``: what a checkpoint
    says of the network (no dtype, no routing), and so what two configs are
    compared on when one of them was loaded from a checkpoint."""
    return {
        "gnn": {"hidden": cfg.gnn.hidden, "num_layers": cfg.gnn.num_layers,
                "dropout": cfg.gnn.dropout,
                "aggregation": cfg.gnn.aggregation},
        "lstm": {"hidden": cfg.lstm.hidden, "num_layers": cfg.lstm.num_layers,
                 "dropout": cfg.lstm.dropout, "impl": cfg.lstm.impl},
        "fuse": cfg.fuse,
    }


def save_checkpoint(path: str | Path, state_dict: Mapping[str, torch.Tensor],
                    cfg: JointConfig, calibration: dict | None = None,
                    quality_profile: dict | None = None,
                    provenance: dict | None = None) -> None:
    """Publish ``state_dict`` (a ``NerrfNet``'s, on any device) and ``cfg``'s
    sidecar at ``path``, atomically (:func:`_atomic_dir`): the weights
    first, then the sidecar, then the quality profile when there is one."""
    meta = {
        **architecture(cfg),
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
        if quality_profile:
            # the reference quality profile rides the checkpoint as its own
            # sidecar: the score/feature distribution this model was
            # calibrated against, published with the weights so every serve
            # pod can watch live traffic drift away from it
            from nerrf_tpu_torch.quality import PROFILE_FILENAME

            (tmp / PROFILE_FILENAME).write_text(
                json.dumps(quality_profile, indent=2))


def load_quality_profile(path: str | Path) -> dict | None:
    """The checkpoint's reference quality profile sidecar, or None when
    the checkpoint predates profiles: callers treat None as "export no
    quality metrics", never as an empty distribution.  Delegates to the
    quality plane's one loader, so a malformed or newer-schema sidecar fails
    here with the one-line ValueError every caller already handles."""
    from nerrf_tpu_torch.quality import load_profile

    prof = load_profile(Path(path).absolute())
    return prof.to_dict() if prof is not None else None


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
    # reference quality profile at the freshly calibrated operating point:
    # the score/feature distribution this model and cut expect, stamped
    # beside the calibration so every serve pod watching this version has a
    # drift baseline.  Best-effort, as calibration itself: a failed profile
    # never blocks the calibrated checkpoint
    profile = None
    try:
        from nerrf_tpu_torch.quality import build_reference_profile

        profile = build_reference_profile(
            model, traces=profile_traces(),
            threshold=calibration["node_threshold"], log=log).to_dict()
    except Exception as e:  # noqa: BLE001 — profile is advisory
        if log:
            log(f"quality profile build failed ({type(e).__name__}: {e}); "
                "checkpoint ships without a drift baseline")
    # provenance is threaded through the re-save: a retrained checkpoint
    # that gets calibrated must not lose its retrain stamp to this rewrite
    save_checkpoint(path, model.state_dict(), model.cfg,
                    calibration=calibration, quality_profile=profile,
                    provenance=provenance)
    return calibration


def profile_traces() -> list:
    """The held-out traces `calibrate_and_resave` builds the quality profile
    over, the reference's: four 120 s traces, a quarter of them attacks,
    seeds from 9500, disjoint from both the training corpus and the
    calibration incidents (from 9000)."""
    from nerrf_tpu_torch.data.synth import make_corpus

    return make_corpus(4, attack_fraction=0.25, base_seed=9500,
                       duration_sec=120.0)


def save_stream_checkpoint(path: str | Path, state_dict: Mapping[str, torch.Tensor],
                           cfg, calibration: dict | None = None) -> None:
    """Publish a ``StreamNet``'s ``state_dict`` and the reference's
    ``stream_config.json`` for ``cfg`` (a ``StreamConfig``) at ``path``,
    atomically.  ``stream_event_threshold`` is a cut on raw event logits
    (the calibration sweeps ``event_logits``, never sigmoided), unlike the
    joint model's probability ``node_threshold``: when ``calibration``
    carries the threshold but not its space, ``"logit"`` is stamped in."""
    from nerrf_tpu_torch.data.stream import STREAM_FEATURE_DIM

    meta = {
        "stream": {"dim": cfg.dim, "num_heads": cfg.num_heads,
                   "num_layers": cfg.num_layers, "mlp_mult": cfg.mlp_mult,
                   "dropout": cfg.dropout, "remat": cfg.remat,
                   "dtype": str(cfg.dtype).removeprefix("torch.")},
        "features": {"stream": STREAM_FEATURE_DIM},
        "schema_version": SCHEMA_VERSION,
    }
    if calibration:
        if "stream_event_threshold" in calibration:
            calibration = {"stream_event_threshold_space": "logit", **calibration}
        meta["calibration"] = calibration
    host = {k: v.detach().cpu() for k, v in state_dict.items()}
    with _atomic_dir(path) as tmp:
        with trace_span("checkpoint", kind="stream_params"):
            torch.save(host, tmp / PARAMS_FILENAME)
        (tmp / STREAM_CONFIG_FILENAME).write_text(json.dumps(meta, indent=2))


def load_stream_checkpoint(path: str | Path):
    """``(state_dict, StreamConfig, calibration)`` of the stream checkpoint
    at ``path``, the tensors on the CPU, after the schema-version and
    feature-width checks."""
    from nerrf_tpu_torch.data.stream import STREAM_FEATURE_DIM
    from nerrf_tpu_torch.models.stream import StreamConfig

    path = Path(path).absolute()
    meta = _read_sidecar(path, STREAM_CONFIG_FILENAME)
    _check_schema_version(meta, path)
    got = (meta.get("features") or {}).get("stream")
    if got is not None and got != STREAM_FEATURE_DIM:
        raise ValueError(
            f"retrain: feature layout changed — stream checkpoint {path} "
            f"was trained with {got}-dim event features, current code "
            f"produces {STREAM_FEATURE_DIM}")
    if "stream" not in meta:
        raise ValueError(
            f"corrupt checkpoint sidecar {path / STREAM_CONFIG_FILENAME}: "
            f"missing the 'stream' model-config field")
    fields = dict(meta["stream"])
    dt = getattr(torch, str(fields.get("dtype")), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"corrupt checkpoint sidecar {path / STREAM_CONFIG_FILENAME}: "
                         f"unknown dtype {fields.get('dtype')!r}")
    fields["dtype"] = dt
    cfg = StreamConfig(**fields)
    state_dict = torch.load(path / PARAMS_FILENAME, map_location="cpu",
                            weights_only=True)
    return state_dict, cfg, meta.get("calibration") or {}
