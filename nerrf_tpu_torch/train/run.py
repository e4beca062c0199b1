"""Experiment runner: one command from a named config to trained artifacts.

The port of ``nerrf_tpu/train/run.py``, driven by the experiment registry
(:mod:`nerrf_tpu_torch.config`)::

    python -m nerrf_tpu_torch.train.run --experiment joint-100h --out DIR
    python -m nerrf_tpu_torch.train.run --experiment toy-graphsage --out DIR \\
        --device cpu

Produces under ``--out``: the experiment config as run
(``experiment.json``), a model checkpoint (``model/``, see
:mod:`nerrf_tpu_torch.train.checkpoint`) with its held-out-calibrated
operating threshold when the calibration reaches one, and ``metrics.json``
with the quality gates evaluated on the held-out split.

The run trains on one device: the card unless ``device='cpu'``.  It builds
the experiment's in-memory corpus; an experiment whose ``corpus_dir`` names
a corpus that was never generated (no ``manifest.json``) falls back to the
in-memory corpus with the reference's log line.  Left out, each refused
with ``NotImplementedError`` when asked for: the disk-sharded corpus, the
elastic full-state checkpoints (``ckpt_every``), the compile cache and the
training-health plane (``metrics_port``, ``flight_dir``, ``archive_dir``)
(ROADMAP A.3); the registry publish (``publish_to``, A.6); the sharded
trainer over a device mesh (A.8).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from nerrf_tpu_torch.device import resolve_device
from nerrf_tpu_torch.tracing import span


def _log(msg: str) -> None:
    print(f"[run] {msg}", file=sys.stderr, flush=True)


def run_experiment(name_or_path: str, out_dir: str | Path,
                   num_steps: int | None = None,
                   ckpt_every: int = 0,
                   calibrate: bool = True,
                   publish_to: str | None = None,
                   compile_cache=None,
                   metrics_port: int = -1,
                   flight_dir: str | None = None,
                   archive_dir: str | None = None,
                   device=None) -> dict:
    """Train the experiment ``name_or_path`` (a registry name, a
    ``configs/<name>.json`` or any experiment JSON) on ``device`` and write
    its artifacts under ``out_dir``; returns the ``metrics.json`` report.
    ``num_steps`` overrides the experiment's; ``calibrate=False`` skips the
    held-out threshold calibration."""
    left_out = {
        "ckpt_every": (ckpt_every > 0, "elastic checkpoints (ROADMAP A.3)"),
        "publish_to": (publish_to is not None, "the model registry (ROADMAP A.6)"),
        "compile_cache": (compile_cache is not None, "the compile cache (ROADMAP A.3)"),
        "metrics_port": (metrics_port >= 0, "the training-health plane (ROADMAP A.3)"),
        "flight_dir": (flight_dir is not None, "the training flight recorder (ROADMAP A.3)"),
        "archive_dir": (archive_dir is not None, "the telemetry archive (ROADMAP A.3)"),
    }
    for name, (asked, what) in left_out.items():
        if asked:
            raise NotImplementedError(f"run_experiment({name}=...): {what} is not ported")
    dev = resolve_device(device)
    return _run_experiment(name_or_path, out_dir, num_steps, calibrate, dev)


def _run_experiment(name_or_path, out_dir, num_steps, calibrate, dev) -> dict:
    import dataclasses

    from nerrf_tpu_torch.config import get_experiment
    from nerrf_tpu_torch.train.data import build_dataset
    from nerrf_tpu_torch.train.loop import train_nerrfnet

    exp = get_experiment(name_or_path)
    cfg = exp.train
    if num_steps is not None:
        cfg = dataclasses.replace(cfg, num_steps=num_steps)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    exp.save(out / "experiment.json")

    t0 = time.time()
    if exp.corpus_dir:
        cdir = Path(exp.corpus_dir)
        if not cdir.is_absolute():
            cdir = Path(__file__).resolve().parents[2] / cdir
        if (cdir / "manifest.json").exists():
            raise NotImplementedError(
                f"experiment {exp.name}: the disk corpus at {cdir} is not "
                f"ported (ROADMAP A.3)")
        _log(f"corpus_dir {cdir} not generated "
             f"(python scripts/gen_corpus.py --out {cdir}) — falling back "
             f"to the in-memory corpus "
             f"({exp.corpus.num_traces}×{exp.corpus.duration_sec:.0f}s = "
             f"{exp.corpus.num_traces * exp.corpus.duration_sec / 3600:.1f}h)")

    _log(f"experiment {exp.name}: building corpus "
         f"({exp.corpus.num_traces} traces × {exp.corpus.duration_sec:.0f}s)")
    with span("build_corpus"):
        train_traces, eval_traces = exp.build_corpus()
    with span("build_dataset"):
        train_ds = build_dataset(train_traces, exp.dataset)
        eval_ds = build_dataset(eval_traces, exp.dataset) if eval_traces else None
    _log(f"dataset: {len(train_ds)} train windows"
         + (f" / {len(eval_ds)} eval" if eval_ds else ""))
    res = train_nerrfnet(train_ds, eval_ds, cfg, log=_log, device=dev)
    return _finish(exp, cfg, out, dev, res.metrics, res.steps_per_sec,
                   res.state.model, t0, calibrate=calibrate)


def _finish(exp, cfg, out: Path, dev, metrics, steps_per_sec, model, t0,
            calibrate: bool = True) -> dict:
    from nerrf_tpu_torch.train.checkpoint import (
        calibrate_and_resave,
        save_checkpoint,
    )

    # weights FIRST: calibration below is best-effort post-processing and
    # must never be able to lose a finished training run
    save_checkpoint(out / "model", model.state_dict(), cfg.model)
    # the held-out-calibrated file-detector operating point travels with
    # the weights (calibrate_and_resave skips an untrained node head)
    calibration = (calibrate_and_resave(out / "model", model,
                                        node_loss_weight=cfg.node_loss_weight,
                                        log=_log, device=dev)
                   if calibrate else None)
    report = {
        "experiment": exp.name,
        "backend": dev.type,
        "devices": 1,
        "num_steps": cfg.num_steps,
        "steps_per_sec": round(steps_per_sec, 3),
        "metrics": {k: round(float(v), 4) for k, v in metrics.items()},
        "calibration": calibration,
        # A head's gate only applies when the experiment trains that head:
        # lstm-impact runs with edge/node weights 0 and toy-graphsage with
        # seq weight 0 — an untrained head's gate could never pass and would
        # fail successful runs of those registry experiments.
        "gates": {
            **({"edge_auc>=0.90": bool(metrics.get("edge_auc", 0) >= 0.90)}
               if cfg.edge_loss_weight > 0 else {}),
            **({"seq_f1>=0.95": bool(metrics.get("seq_f1", 0) >= 0.95)}
               if cfg.seq_loss_weight > 0 else {}),
        },
        "wall_seconds": round(time.time() - t0, 1),
    }
    (out / "metrics.json").write_text(json.dumps(report, indent=2) + "\n")
    _log(f"done: {report['metrics']} at {steps_per_sec:.1f} steps/s")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nerrf_tpu_torch.train.run",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--experiment", required=True,
                    help="registry name or experiment JSON path")
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=None,
                    help="override the experiment's num_steps")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    report = run_experiment(args.experiment, args.out, args.steps,
                            device=args.device)
    return 0 if all(report["gates"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
