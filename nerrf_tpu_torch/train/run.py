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

The run trains on one device: the card unless ``device='cpu'``.  An
experiment whose ``corpus_dir`` holds a generated corpus (``manifest.json``;
``python -m nerrf_tpu_torch.train.corpus``) trains from it, rotating its
shards through the card (``loop.train_sharded_stream``) and evaluating on
its held-out traces; a ``corpus_dir`` that was never generated falls back to
the in-memory corpus with the reference's log line.  ``ckpt_every > 0``
writes full-state checkpoints under ``train_state/`` and resumes from the
newest (``elastic.train_elastic``, or the sharded trainer's own).  A
``monitor`` (``trainwatch.TrainHealthMonitor``) turns the in-step telemetry
on and halts a diverged run, which then writes a ``metrics.json`` saying
why and no checkpoint.  ``publish_to`` publishes the calibrated checkpoint
into that model registry's ``lineage`` (`registry.ModelRegistry.publish`;
``metrics.json`` then names the ``published_version``).  An experiment that
names a mesh trains on the one card, as the reference does on one device.
``metrics_port``, ``flight_dir`` and ``archive_dir`` arm the training-health
plane through ``trainwatch.training_health``, as the reference's do.  Left
out, refused with ``NotImplementedError`` when asked for: the compile cache
(``compile_cache``, ROADMAP B.D1).
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
                   lineage: str = "default",
                   compile_cache=None,
                   metrics_port: int = -1,
                   flight_dir: str | None = None,
                   archive_dir: str | None = None,
                   device=None,
                   monitor=None) -> dict:
    """Train the experiment ``name_or_path`` (a registry name, a
    ``configs/<name>.json`` or any experiment JSON) on ``device`` and write
    its artifacts under ``out_dir``; returns the ``metrics.json`` report.
    ``num_steps`` overrides the experiment's; ``ckpt_every`` checkpoints the
    full state every so many steps and resumes from the newest;
    ``calibrate=False`` skips the held-out threshold calibration;
    ``publish_to`` names a model registry to publish the checkpoint into,
    as ``lineage``'s next version.  ``metrics_port`` ≥ 0 and
    ``flight_dir`` arm the training-health plane
    (`trainwatch.training_health`: a train-aware ``/readyz`` and
    doctor-readable bundles of the train triggers), and ``archive_dir``
    spools the run's journal and metrics to a telemetry archive; or
    ``monitor`` watches the run's health (telemetry on) without them."""
    if compile_cache is not None:
        raise NotImplementedError(
            "run_experiment(compile_cache=...): the compile cache (a capture "
            "cache of CUDA graphs, ROADMAP B.D1) is not ported")
    dev = resolve_device(device)
    publish = (publish_to, lineage)
    if monitor is not None:
        if metrics_port >= 0 or flight_dir or archive_dir:
            raise ValueError("run_experiment: pass a monitor or the "
                             "training-health surfaces, not both")
        return _run_experiment(name_or_path, out_dir, num_steps, ckpt_every,
                               calibrate, dev, monitor, publish)
    from nerrf_tpu_torch.trainwatch import training_health

    with training_health(metrics_port=metrics_port, flight_dir=flight_dir,
                         archive_dir=archive_dir, log=_log) as monitor:
        return _run_experiment(name_or_path, out_dir, num_steps, ckpt_every,
                               calibrate, dev, monitor, publish)


def _halted_report(exp, cfg, out: Path, monitor, steps_per_sec) -> dict:
    """The divergence-halt exit: the weights of a run the monitor stopped
    are not finite, so nothing is saved or calibrated.  ``metrics.json``
    says why there is no model, with a failing gate."""
    step, reason = monitor.diverged
    report = {
        "experiment": exp.name,
        "num_steps": cfg.num_steps,
        "steps_per_sec": round(steps_per_sec, 3),
        "metrics": {},
        "diverged": {"step": step, "reason": reason},
        "gates": {"not_diverged": False},
    }
    (out / "metrics.json").write_text(json.dumps(report, indent=2) + "\n")
    _log(f"training diverged at step {step} ({reason}); NOT saving a "
         f"checkpoint — restart from the last good checkpoint")
    return report


def _run_experiment(name_or_path, out_dir, num_steps, ckpt_every, calibrate,
                    dev, monitor, publish) -> dict:
    import dataclasses

    from nerrf_tpu_torch.config import get_experiment
    from nerrf_tpu_torch.train.data import build_dataset

    exp = get_experiment(name_or_path)
    cfg = exp.train
    if num_steps is not None:
        cfg = dataclasses.replace(cfg, num_steps=num_steps)
    if monitor is not None and not cfg.telemetry:
        # the health plane is armed: the in-step telemetry comes with it
        # (without grad and update norms divergence detection is loss-only)
        cfg = dataclasses.replace(cfg, telemetry=True)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    exp.save(out / "experiment.json")
    ckpt_dir = (out / "train_state") if ckpt_every > 0 else None

    t0 = time.time()
    if exp.corpus_dir:
        cdir = Path(exp.corpus_dir)
        if not cdir.is_absolute():
            cdir = Path(__file__).resolve().parents[2] / cdir
        if (cdir / "manifest.json").exists():
            return _run_on_disk_corpus(exp, cfg, cdir, out, ckpt_dir, ckpt_every,
                                       calibrate, dev, monitor, t0, publish)
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
    if ckpt_dir is not None:
        from nerrf_tpu_torch.train.elastic import train_elastic

        res = train_elastic(train_ds, eval_ds, cfg, ckpt_dir=ckpt_dir,
                            save_every=ckpt_every, log=_log, monitor=monitor,
                            device=dev)
    else:
        from nerrf_tpu_torch.train.loop import train_nerrfnet

        res = train_nerrfnet(train_ds, eval_ds, cfg, log=_log, device=dev,
                             monitor=monitor)
    if monitor is not None and monitor.diverged is not None:
        return _halted_report(exp, cfg, out, monitor, res.steps_per_sec)
    return _finish(exp, cfg, out, dev, res.metrics, res.steps_per_sec,
                   res.state.model, t0, calibrate=calibrate, publish=publish)


def _run_on_disk_corpus(exp, cfg, cdir, out, ckpt_dir, ckpt_every, calibrate,
                        dev, monitor, t0, publish) -> dict:
    """The disk-sharded corpus branch: train by shard rotation, evaluate on
    the corpus's held-out traces, and add the corpus's size to the report."""
    from nerrf_tpu_torch.train.corpus import ShardedCorpus
    from nerrf_tpu_torch.train.loop import train_sharded_stream

    sc = ShardedCorpus(cdir)
    _log(f"experiment {exp.name}: disk corpus {sc.hours:.1f}h, "
         f"{sc.train_windows} train windows ({len(sc.train_shards)} shards)")
    # the shards' shapes are authoritative (the manifest's auto-fit)
    cap = sc.manifest.get("graph_capacity")
    g = exp.dataset.graph
    if cap and (cap["max_nodes"] != g.max_nodes or cap["max_edges"] != g.max_edges):
        _log(f"WARNING: corpus capacities {cap} != experiment config "
             f"({g.max_nodes}n/{g.max_edges}e) — training uses the corpus "
             f"shapes; update the config/regenerate to align")
    with span("build_dataset"):
        eval_ds = sc.eval_dataset()
    _log(f"eval split: {len(eval_ds)} held-out-trace windows")
    res = train_sharded_stream(sc, cfg, eval_ds=eval_ds, log=_log,
                               ckpt_dir=ckpt_dir, save_every=ckpt_every,
                               monitor=monitor, device=dev)
    if monitor is not None and monitor.diverged is not None:
        return _halted_report(exp, cfg, out, monitor, res.steps_per_sec)
    extra = {
        "corpus_hours": round(sc.hours, 2),
        "corpus_train_windows": sc.train_windows,
        "corpus_eval_windows": int(sc.manifest["eval_windows"]),
    }
    return _finish(exp, cfg, out, dev, res.metrics, res.steps_per_sec,
                   res.state.model, t0, extra, calibrate=calibrate,
                   publish=publish)


def _finish(exp, cfg, out: Path, dev, metrics, steps_per_sec, model, t0,
            extra: dict | None = None, calibrate: bool = True,
            publish: tuple = (None, "default")) -> dict:
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
    publish_to, lineage = publish
    published = None
    if publish_to:
        # after calibrate_and_resave, so the version carries its operating
        # threshold and quality profile; best-effort: a registry failure
        # must never lose a finished training run (the checkpoint is
        # already safe under out/)
        try:
            from nerrf_tpu_torch.registry import ModelRegistry

            published = ModelRegistry(publish_to).publish(
                lineage, out / "model",
                source=f"nerrf_tpu_torch.train.run --experiment {exp.name}")
            _log(f"published {out / 'model'} as {lineage}/v{published} "
                 f"in {publish_to}")
        except Exception as e:  # noqa: BLE001
            _log(f"registry publish failed ({type(e).__name__}: {e}); "
                 f"checkpoint remains at {out / 'model'}")
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
        **({"published_version": published} if published else {}),
        **(extra or {}),
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
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="full-state checkpoints every N steps, resuming "
                         "from the newest")
    ap.add_argument("--publish", default=None, metavar="REGISTRY",
                    help="publish the calibrated checkpoint into this model "
                         "registry (a new immutable version; promotion "
                         "stays separate)")
    ap.add_argument("--lineage", default="default",
                    help="registry lineage to publish into (with --publish)")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="training-health /metrics + /healthz + /readyz "
                         "port (-1 disables; 0 = ephemeral).  /readyz is "
                         "train-aware: 503 before the first completed "
                         "step and after a divergence halt")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="arm the training flight recorder: "
                         "train_divergence / train_starvation / "
                         "train_stall triggers dump self-contained "
                         "bundles here, readable offline with `nerrf "
                         "doctor <bundle>`")
    ap.add_argument("--archive-dir", default=None, metavar="DIR",
                    help="spool the run's telemetry (journal records, "
                         "cadenced metrics snapshots, step-cadence "
                         "workload sketches) into a crash-safe segmented "
                         "archive here; `nerrf report` reads it offline")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    publish = (dict(publish_to=args.publish, lineage=args.lineage)
               if args.publish else {})
    # the training-health surfaces asked for, and only those
    health = {k: v for k, v in (("metrics_port", args.metrics_port),
                                ("flight_dir", args.flight_dir),
                                ("archive_dir", args.archive_dir))
              if v is not None and v != -1}
    report = run_experiment(args.experiment, args.out, args.steps,
                            ckpt_every=args.ckpt_every, device=args.device,
                            **publish, **health)
    return 0 if all(report["gates"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
