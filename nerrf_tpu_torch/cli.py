"""The nerrf command-line interface, on the card.

The port of ``nerrf_tpu/cli.py``: the same subcommands, flags, defaults,
artifacts and exit codes over the port's paths.  Usage:

    python -m nerrf_tpu_torch.cli simulate       --incident DIR [--files N]
    python -m nerrf_tpu_torch.cli train-detector --model-dir DIR [--steps N]
    python -m nerrf_tpu_torch.cli undo           --incident DIR [--model-dir DIR]
                                                 [--dry-run] [--no-gate]
    python -m nerrf_tpu_torch.cli status         --incident DIR
    python -m nerrf_tpu_torch.cli models         publish|list|promote|rollback|status
    python -m nerrf_tpu_torch.cli serve-detect   --registry DIR [--archive-dir DIR]
                                                 [--flight-dir DIR]
    python -m nerrf_tpu_torch.cli report         DIR
    python -m nerrf_tpu_torch.cli doctor         BUNDLE|ARCHIVE
    python -m nerrf_tpu_torch.cli alerts label   TRACE_ID tp|fp --replay-dir DIR
    python -m nerrf_tpu_torch.cli chaos          sites|validate PLAN|example
    python -m nerrf_tpu_torch.cli tune           CORPUS|ARCHIVE --out FILE
                                                 [--model-dir DIR]

An *incident directory* is the unit of state: victim files under ``victim/``,
the snapshot store under ``store/``, the captured trace, and every stage's
JSON artifact (plan.json, gate.json, report.json) — so ``status`` can always
reconstruct where an incident stands.

Every subcommand that touches a tensor (train-detector, undo, warmup,
serve-detect, respond) takes ``--device {cuda,cpu}``, default ``cuda``:
without CUDA it raises unless given ``--device cpu``, which runs the
kernels' plain versions.  Nothing moves to the CPU on its own, and a
device planner that fails to warm raises (the reference's undo and warmup
retreat to the host search or record the error).  The subcommands and
flags of planes the port does not have yet keep the reference's parser
entries and exit 2 with one line naming the ROADMAP item they wait for.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _log(msg: str) -> None:
    print(f"[nerrf] {msg}", file=sys.stderr, flush=True)


def _buckets(specs):
    """``["NxExS", ...]`` → ``((N, E, S), ...)``."""
    return tuple(tuple(int(x) for x in b.split("x")) for b in specs)


def _load_model(model_dir, dev):
    """The checkpoint at ``model_dir`` as an eval-mode `NerrfNet` on ``dev``."""
    import torch

    from nerrf_tpu_torch.models import NerrfNet
    from nerrf_tpu_torch.train.checkpoint import load_checkpoint

    state, model_cfg = load_checkpoint(model_dir)
    with torch.device(dev):
        model = NerrfNet(model_cfg)
    model.load_state_dict(state, strict=True)
    return model.eval()


# --------------------------------------------------------------------------
def cmd_simulate(args) -> int:
    from nerrf_tpu_torch.rollback import FileSimConfig, SnapshotStore, run_file_attack
    from nerrf_tpu_torch.rollback.filesim import seed_files
    from nerrf_tpu_torch.schema.events import events_to_jsonl

    inc = Path(args.incident)
    victim = inc / "victim"
    if victim.exists() and any(victim.iterdir()):
        _log(f"refusing to simulate: {victim} is not empty")
        return 2
    cfg = FileSimConfig(num_files=args.files, seed=args.seed)
    seed_files(victim, cfg)
    store = SnapshotStore(inc / "store")
    manifest = store.snapshot(victim, snapshot_id="pre-attack")
    _log(f"seeded {len(manifest.files)} files, snapshot 'pre-attack' taken")

    t0 = time.time()
    trace, encrypted = run_file_attack(victim, cfg)
    (inc / "trace.jsonl").write_text(events_to_jsonl(trace.events, trace.strings))
    (inc / "incident.json").write_text(json.dumps({
        "created": time.time(),
        "attack_family": trace.ground_truth.attack_family,
        "target": str(victim),
        "snapshot_id": "pre-attack",
        "files_encrypted": len(encrypted),
        "attack_seconds": round(time.time() - t0, 3),
    }, indent=2))
    _log(f"attack complete: {len(encrypted)} files encrypted, trace written")
    return 0


# --------------------------------------------------------------------------
def cmd_train_detector(args) -> int:
    from nerrf_tpu_torch.data import make_corpus
    from nerrf_tpu_torch.device import resolve_device
    from nerrf_tpu_torch.graph import GraphConfig
    from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig
    from nerrf_tpu_torch.train import build_dataset
    from nerrf_tpu_torch.train.checkpoint import calibrate_and_resave, save_checkpoint
    from nerrf_tpu_torch.train.data import DatasetConfig
    from nerrf_tpu_torch.train.loop import TrainConfig, train_nerrfnet

    dev = resolve_device(args.device)
    model_cfg = JointConfig(
        gnn=GraphSAGEConfig(hidden=args.hidden, num_layers=args.layers, dropout=0.05),
        lstm=LSTMConfig(hidden=args.hidden, num_layers=1, dropout=0.05),
    )
    n_eval = max(2, args.traces // 4)
    if args.traces < n_eval + 4:
        _log(f"--traces must be ≥ {n_eval + 4} (need {n_eval} eval + ≥4 train runs)")
        return 2
    # hard-scenario mix: a deployed detector trained on rename-style attacks
    # alone re-learns the heuristic's shortcut (data/synth.py ATTACK_VARIANTS)
    corpus = make_corpus(args.traces, attack_fraction=0.5, base_seed=args.seed,
                         duration_sec=150.0, num_target_files=8,
                         benign_rate_hz=25.0, hard_scenarios=True)
    ds_cfg = DatasetConfig(graph=GraphConfig(max_nodes=256, max_edges=512),
                           seq_len=100, max_seqs=128)
    train_ds = build_dataset(corpus[:-n_eval], ds_cfg)
    eval_ds = build_dataset(corpus[-n_eval:], ds_cfg)
    _log(f"training detector on {len(train_ds)} windows ({args.steps} steps)…")
    train_cfg = TrainConfig(
        model=model_cfg, batch_size=8, num_steps=args.steps,
        learning_rate=3e-3, warmup_steps=min(30, args.steps // 5),
        # arming the health plane turns the in-step telemetry on with it:
        # divergence detection without grad/update norms is loss-only (an
        # armed archive wants the same records durable)
        telemetry=(args.metrics_port >= 0 or bool(args.flight_dir)
                   or bool(args.archive_dir)))
    # training-health plane: /readyz with the train-aware check, the
    # train_divergence/starvation/stall bundles and the telemetry archive;
    # all three off costs the loop nothing
    from nerrf_tpu_torch.trainwatch import training_health

    with training_health(metrics_port=args.metrics_port,
                         flight_dir=args.flight_dir,
                         archive_dir=args.archive_dir, log=_log) as monitor:
        if args.ckpt_every > 0:
            from nerrf_tpu_torch.train.elastic import train_elastic

            res = train_elastic(
                train_ds, eval_ds, train_cfg,
                ckpt_dir=Path(args.model_dir) / "train_state",
                save_every=args.ckpt_every, log=_log, monitor=monitor,
                device=dev)
        else:
            res = train_nerrfnet(train_ds, eval_ds, train_cfg, log=_log,
                                 monitor=monitor, device=dev)
    if not res.metrics:
        # a divergence-halted run has no metrics and no usable weights —
        # the flight bundle (if armed) carries the evidence
        _log("training halted without metrics (diverged?); not saving a "
             "checkpoint")
        return 1
    _log(f"metrics: edge_auc={res.metrics['edge_auc']:.4f} "
         f"seq_f1={res.metrics['seq_f1']:.4f} ({res.steps_per_sec:.1f} steps/s)")
    model = res.state.model
    save_checkpoint(args.model_dir, model.state_dict(), model_cfg)
    _log(f"checkpoint saved to {args.model_dir}")
    # calibrate the file-detector operating point and re-save the sidecar:
    # an uncalibrated checkpoint operates `undo` at the 0.5 cut that
    # measurably flags benign rotated logs
    calibrate_and_resave(args.model_dir, model,
                         node_loss_weight=train_cfg.node_loss_weight,
                         log=_log, device=dev)
    if args.publish:
        # the train→serve hand-off: publish the calibrated checkpoint into
        # the registry lineage (immutable version, schema/feature-gated at
        # publish).  Promotion stays separate: a resident serve pod picks
        # the version up as a shadow candidate and promotes it only when
        # the guardrails pass.  Best-effort: a registry failure must not
        # turn a finished training run into a CLI failure, the checkpoint
        # is already safe under --model-dir
        try:
            from nerrf_tpu_torch.registry import ModelRegistry

            version = ModelRegistry(args.publish).publish(
                args.lineage, args.model_dir,
                source=f"nerrf train-detector --steps {args.steps}")
            _log(f"published {args.model_dir} as {args.lineage}/v{version} "
                 f"in {args.publish}")
        except Exception as e:  # noqa: BLE001
            _log(f"registry publish failed ({type(e).__name__}: {e}); "
                 f"checkpoint remains at {args.model_dir}")
    return 0 if res.metrics["edge_auc"] >= 0.9 else 1


# --------------------------------------------------------------------------
def cmd_undo(args) -> int:
    from nerrf_tpu_torch.data.loaders import load_trace_jsonl
    from nerrf_tpu_torch.device import resolve_device
    from nerrf_tpu_torch.pipeline import build_undo_domain, heuristic_detect, model_detect
    from nerrf_tpu_torch.planner import DeviceMCTS, MCTSConfig, make_planner
    from nerrf_tpu_torch.planner.value_net import ValueNet
    from nerrf_tpu_torch.rollback import RollbackExecutor, SandboxGate, SnapshotStore
    from nerrf_tpu_torch.tracing import span

    dev = resolve_device(args.device)
    # Daemon-boot warmup, BEFORE the MTTR clock: build the search kernel and
    # set up the value net once, as run_recovery_bench's boot step does, so
    # the incident window pays neither.  A failed warmup raises: the port
    # has no host retreat for a device planner
    value = ValueNet.create(device=dev)
    if args.planner != "host":
        t_warm = time.perf_counter()
        DeviceMCTS.warmup_for(1, 1, cfg=MCTSConfig(num_simulations=args.simulations),
                              value=value, device=dev)
        _log(f"device planner warm ({time.perf_counter() - t_warm:.1f}s boot-time "
             f"build)")

    inc = Path(args.incident)
    meta = json.loads((inc / "incident.json").read_text())
    victim = Path(meta["target"])
    t_start = time.perf_counter()

    # --trace: detect on a trace OTHER than the incident's own file (the copy
    # that crossed the wire, so detection consumes delivered bytes)
    trace = load_trace_jsonl(Path(args.trace) if args.trace
                             else inc / "trace.jsonl")
    store = SnapshotStore(inc / "store")
    manifest = store.load_manifest(meta["snapshot_id"])

    # --- detect -------------------------------------------------------------
    # each stage is a span: --trace-out writes the incident's
    # detect/plan/gate/execute split, as the reference's help text says
    with span("undo_detect"):
        if args.model_dir:
            from nerrf_tpu_torch.train.checkpoint import load_calibration

            model = _load_model(args.model_dir, dev)
            calib = load_calibration(args.model_dir)
            detection = model_detect(trace, model,
                                     threshold=calib.get("node_threshold"), device=dev)
        else:
            detection = heuristic_detect(trace)
    flagged = detection.flagged_files()
    _log(f"detect[{detection.detector}]: {len(flagged)}/{len(detection.file_scores)} "
         f"files flagged, {sum(1 for v in detection.proc_scores.values() if v > 0.5)} "
         "processes flagged")

    # --- plan ---------------------------------------------------------------
    with span("undo_plan"):
        domain = build_undo_domain(detection, manifest, root=str(victim))
        # `value` was created at boot (before the MTTR clock); fit_to_domain
        # only retrains its weights
        value.fit_to_domain(domain, num_rollouts=256, horizon=32, steps=200)
        planner = make_planner(domain, value,
                               MCTSConfig(num_simulations=args.simulations),
                               kind=args.planner, device=dev)
        plan = planner.plan()
    (inc / "plan.json").write_text(json.dumps(plan.to_dict(), indent=2))
    _log(f"plan[{type(planner).__name__}]: {len(plan.actions)} actions, "
         f"{plan.rollouts} rollouts @ {plan.rollouts_per_sec:.0f}/s")

    # --- sandbox gate: clone → replay the captured trace → rehearse --------
    if not args.no_gate:
        with span("undo_gate"):
            gate = SandboxGate(store, manifest).rehearse(plan, victim, trace=trace)
        (inc / "gate.json").write_text(json.dumps(gate.to_dict(), indent=2))
        _log(f"sandbox gate: approved={gate.approved} ({gate.reason})")
        if not gate.approved:
            return 3

    if args.dry_run:
        _log("dry run: stopping before execution")
        return 0

    # --- execute ------------------------------------------------------------
    with span("undo_execute"):
        report = RollbackExecutor(store, manifest, victim).execute(plan)
    mttr = time.perf_counter() - t_start
    out = report.to_dict()
    out["mttr_seconds"] = round(mttr, 3)
    (inc / "report.json").write_text(json.dumps(out, indent=2))
    _log(f"rollback: {report.files_restored} files restored "
         f"({report.mb_per_sec:.0f} MB/s), verified={report.verified}, "
         f"MTTR={mttr:.2f}s")
    return 0 if report.verified else 4


# --------------------------------------------------------------------------
def cmd_warmup(args) -> int:
    """Host-provisioning sweep: one detector forward for every configured
    capacity bucket and the device planner's build, so a cold host's first
    incident pays neither inside the MTTR window.  A planner that fails to
    warm raises (the reference records a ``planner_error``)."""
    from nerrf_tpu_torch.device import resolve_device
    from nerrf_tpu_torch.planner import DeviceMCTS, MCTSConfig
    from nerrf_tpu_torch.planner.value_net import ValueNet

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    out = {}
    if args.model_dir:
        from nerrf_tpu_torch.pipeline import DETECTOR_WARMUP_BUCKETS, warmup_detector

        buckets = _buckets(args.buckets) if args.buckets else DETECTOR_WARMUP_BUCKETS
        out["detector"] = warmup_detector(_load_model(args.model_dir, dev),
                                          buckets=buckets, log=_log)
    value = ValueNet.create(device=dev)
    t1 = time.perf_counter()
    DeviceMCTS.warmup_for(1, 1, cfg=MCTSConfig(num_simulations=800), value=value,
                          device=dev)
    out["planner_seconds"] = round(time.perf_counter() - t1, 1)
    out["wall_seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out, indent=2))
    return 0


# --------------------------------------------------------------------------
def _profile_model(args, cfg, dev):
    """The profile subcommands' model on ``dev``: the checkpoint when given,
    else the untrained small detector (shapes are what the cost and capture
    planes measure; weights don't matter)."""
    from nerrf_tpu_torch.models import JointConfig
    from nerrf_tpu_torch.serve import init_untrained_model

    if getattr(args, "model_dir", None):
        return _load_model(args.model_dir, dev)
    return init_untrained_model(JointConfig().small, cfg, device=dev)


def _profile_serve_cfg(args):
    from nerrf_tpu_torch.serve import ServeConfig

    if getattr(args, "smoke", False):
        return ServeConfig(buckets=((64, 128, 32),))
    if getattr(args, "buckets", None):
        return ServeConfig(buckets=_buckets(args.buckets))
    return ServeConfig()


def cmd_profile(args) -> int:
    """Device-efficiency plane CLI (docs/device-efficiency.md):

    ``costs``   — the per-program cost/MFU table: analytic FLOPs, byte
    floor, roofline intensity for every serve bucket program + the train
    step; ``--measure N`` times real calls so the same invocation prints
    measured MFU on the card (null off it — never fabricated).
    ``capture`` — a torch.profiler trace: drive the serve ladder locally
    under the profiler, or pull one from a live service started with
    ``--profiler-port`` (``--target``).
    """
    if args.profile_cmd == "costs":
        return _profile_costs(args)
    return _profile_capture(args)


def _profile_costs(args) -> int:
    import numpy as np
    import torch

    from nerrf_tpu_torch.device import resolve_device
    from nerrf_tpu_torch.devtime import chip_peaks, serve_program_costs
    from nerrf_tpu_torch.pipeline import make_eval_fn
    from nerrf_tpu_torch.serve.service import warmup_batches

    dev = resolve_device(args.device)
    cfg = _profile_serve_cfg(args)
    model = _profile_model(args, cfg, dev)
    eval_fn = make_eval_fn(model)
    peaks = chip_peaks(dev)
    costs = serve_program_costs(model, cfg, cross_check=args.cross_check)
    rows = {}
    for cost in costs.values():
        rows[cost.program] = {**cost.to_dict(), "measured": None}
    if not args.no_train:
        from nerrf_tpu_torch.devtime import train_step_cost
        from nerrf_tpu_torch.pipeline import warmup_trace
        from nerrf_tpu_torch.train.data import windows_of_trace
        from nerrf_tpu_torch.train.loop import TrainConfig

        samples = windows_of_trace(
            warmup_trace("profile-costs"),
            cfg.dataset_config(sorted(cfg.buckets)[0]))
        if samples:
            arrays = {k: np.stack([s[k] for s in samples])
                      for k in samples[0]}
            tc = train_step_cost(model, TrainConfig(model=model.cfg),
                                 arrays, cross_check=args.cross_check)
            if tc is not None:
                rows[tc.program] = {**tc.to_dict(), "measured": None}
    if args.measure > 0:
        # real timed calls per bucket, after one call outside the timing
        # (the kernel libraries' build and load): the measured-MFU column.
        # The eval function returns host arrays, so each call is synced.
        # Unrounded, so mfu × peak × seconds_per_call gives back the flops
        for _bucket, tag, batch in warmup_batches(cfg):
            program = f"serve_eval[{tag}]"
            if program not in rows:
                continue
            eval_fn(batch)
            t0 = time.perf_counter()
            for _ in range(args.measure):
                eval_fn(batch)
            per_call = (time.perf_counter() - t0) / args.measure
            flops = rows[program]["flops"]
            achieved = flops / per_call if per_call > 0 else None
            rows[program]["measured"] = {
                "seconds_per_call": per_call,
                "achieved_tflops": achieved / 1e12 if achieved else None,
                "mfu": (achieved / (peaks.tflops_bf16 * 1e12)
                        if achieved and peaks else None),
            }
    out = {
        "backend": dev.type,
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else ""),
        "peaks": ({"kind": peaks.kind,
                   "tflops_bf16": peaks.tflops_bf16,
                   "hbm_gbps": peaks.hbm_gbps,
                   "ridge_flops_per_byte":
                       round(peaks.ridge_flops_per_byte, 1)}
                  if peaks else None),
        "flops_authority": "analytic FlopCounterMode counts on meta tensors "
                           "(bench/flops.py); the profiler's count recorded "
                           "as cross-check only",
        "programs": rows,
    }
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    peak_s = (f"{peaks.tflops_bf16:g} TFLOP/s bf16, {peaks.hbm_gbps:g} GB/s"
              if peaks else "unknown (no card-relative numbers)")
    print(f"device: {out['device_kind'] or out['backend']}  peak: {peak_s}")
    print(f"{'program':<28} {'Gflops/call':>12} {'MB floor':>9} "
          f"{'flops/B':>8} {'s/call':>8} {'MFU':>7}")
    for name, r in sorted(rows.items()):
        meas = r.get("measured") or {}
        mfu = meas.get("mfu")
        spc = meas.get("seconds_per_call")
        print(f"{name:<28} {r['flops'] / 1e9:>12.2f} "
              f"{r['bytes_accessed'] / 1e6:>9.1f} "
              f"{(r['intensity_flops_per_byte'] or 0):>8.1f} "
              f"{f'{spc:.5f}' if spc is not None else '-':>8} "
              f"{f'{mfu:.2%}' if mfu is not None else 'null':>7}")
    return 0


def _profile_capture(args) -> int:
    from nerrf_tpu_torch.devtime import profiled, trace_summary

    if args.target:
        # remote capture from a service started with --profiler-port: its
        # GET /capture?seconds=S captures in the serving process and
        # answers with the trace file
        from nerrf_tpu_torch.devtime.capture import fetch_capture

        try:
            fetch_capture(args.target, args.seconds, args.out)
        except (OSError, ValueError) as e:
            _log(f"remote capture from {args.target} failed: "
                 f"{type(e).__name__}: {e}")
            return 1
        summary = trace_summary(args.out)
        print(json.dumps({"trace_dir": args.out, **(summary or {})}))
        return 0 if summary else 1
    # local driven capture: score the serve ladder's donor batches under
    # the profiler for --seconds, so the trace holds real device work
    from nerrf_tpu_torch.device import resolve_device
    from nerrf_tpu_torch.pipeline import make_eval_fn
    from nerrf_tpu_torch.serve.service import warmup_batches

    dev = resolve_device(args.device)
    cfg = _profile_serve_cfg(args)
    model = _profile_model(args, cfg, dev)
    eval_fn = make_eval_fn(model)
    donors = [(tag, batch) for _b, tag, batch in warmup_batches(cfg)]
    if not donors:
        _log("no warmup donor batches for the configured ladder")
        return 2
    for _tag, batch in donors:
        # build and load the kernel libraries OUTSIDE the capture window,
        # so the capture shows steady-state scoring
        eval_fn(batch)
    with profiled(args.out) as active:
        if active is None:
            _log("profiler could not start (see profile_failed journal "
                 "record) — nothing captured")
            return 1
        # the window opens once the profiler has started (its first start
        # takes a while), and holds at least one pass over the ladder
        deadline = time.monotonic() + args.seconds
        while True:
            for _tag, batch in donors:
                eval_fn(batch)
            if time.monotonic() >= deadline:
                break
    summary = trace_summary(args.out)
    print(json.dumps({"trace_dir": args.out, **(summary or {})}))
    if summary:
        _log(f"trace captured: {summary['files']} file(s) in {args.out} — "
             f"load in Perfetto/TensorBoard")
    return 0 if summary else 1


# --------------------------------------------------------------------------
def cmd_trace(args) -> int:
    """Offline inspector for ``--trace-out`` artifacts: per-stage latency
    table (count, total/mean/p50/max ms, % of wall) from a Chrome-trace
    JSON file.  The same file loads in Perfetto / chrome://tracing for the
    timeline view; this is the terminal-sized summary."""
    from nerrf_tpu_torch import tracing

    try:
        events = tracing.load_chrome_trace(args.file)
    except (OSError, ValueError) as e:
        # ValueError covers both JSONDecodeError and UnicodeDecodeError
        # (binary Perfetto traces are not the JSON flavor this reads)
        _log(f"cannot read trace {args.file}: {e}")
        return 2
    if not events:
        _log(f"no complete ('X') span events in {args.file}")
        return 1
    print(tracing.format_stage_table(events))
    return 0


# --------------------------------------------------------------------------
def cmd_status(args) -> int:
    inc = Path(args.incident)
    stages = {
        "incident": inc / "incident.json",
        "plan": inc / "plan.json",
        "gate": inc / "gate.json",
        "report": inc / "report.json",
    }
    out = {}
    for name, p in stages.items():
        out[name] = json.loads(p.read_text()) if p.exists() else None
    state = (
        "recovered" if out["report"] and out["report"].get("verified")
        else "planned" if out["plan"]
        else "attacked" if out["incident"]
        else "empty"
    )
    print(json.dumps({"state": state, **out}, indent=2))
    return 0


# --------------------------------------------------------------------------
def cmd_models(args) -> int:
    """Model lifecycle registry: publish → (shadow) → promote → rollback.
    Every action prints one JSON document; the registry layout and the
    promotion guardrails are documented in docs/model-lifecycle.md.  A
    registry written here holds the port's checkpoints."""
    from nerrf_tpu_torch.registry import ModelRegistry

    reg = ModelRegistry(args.registry)
    out: dict
    if args.models_cmd == "publish":
        version = reg.publish(args.lineage, args.model_dir,
                              source=args.source)
        out = {"lineage": args.lineage, "published": version,
               "path": str(reg.version_dir(args.lineage, version)),
               "executables": reg.executables_dir(
                   args.lineage, version) is not None}
        if args.promote:
            out["live"] = reg.promote(args.lineage, version)
    elif args.models_cmd == "list":
        lineages = [args.lineage] if args.lineage else reg.lineages()
        out = {"registry": str(reg.root),
               "lineages": {ln: reg.status(ln) for ln in lineages}}
    elif args.models_cmd == "promote":
        out = {"lineage": args.lineage,
               "live": reg.promote(args.lineage, args.version)}
    elif args.models_cmd == "rollback":
        out = {"lineage": args.lineage,
               "live": reg.rollback(args.lineage, args.version)}
    elif args.models_cmd == "status":
        out = reg.status(args.lineage)
    else:  # pragma: no cover — argparse enforces the choices
        _log(f"unknown models subcommand {args.models_cmd!r}")
        return 2
    print(json.dumps(out, indent=2))
    return 0


# --------------------------------------------------------------------------
def cmd_quality(args) -> int:
    """The detection-quality plane's offline face (docs/quality.md):
    ``show`` renders a reference profile (checkpoint sidecar or bare
    JSON) or a flight bundle's live divergence table; ``compare`` PSIs
    two profiles against each other — score distribution, top-drifting
    window features, margin mass and alert-rate deltas."""
    from nerrf_tpu_torch.quality import load_profile
    from nerrf_tpu_torch.quality.sketch import psi, top_drifting

    def _load(path):
        """→ ("bundle", quality dict) | ("profile", QualityProfile)."""
        p = Path(path)
        if p.is_dir() and (p / "quality.json").is_file():
            return "bundle", json.loads((p / "quality.json").read_text())
        prof = load_profile(p)
        if prof is None:
            raise FileNotFoundError(
                f"{path} is neither a quality profile (no "
                f"quality_profile.json), nor a flight bundle with a "
                f"quality.json — the checkpoint may predate profiles")
        return "profile", prof

    if args.quality_cmd == "show":
        try:
            kind, obj = _load(args.path)
        except (FileNotFoundError, ValueError) as e:
            _log(str(e))
            return 2
        if kind == "bundle":
            if args.json:
                print(json.dumps(obj, indent=2))
                return 0
            from nerrf_tpu_torch.flight.doctor import quality_section

            print("\n".join(quality_section(obj)))
            return 0
        if args.json:
            print(json.dumps(obj.to_dict(), indent=2))
            return 0
        s = obj.summary()
        print(f"quality profile (schema v{s['schema']}): "
              f"{s['windows']} windows / {s['node_scores']} node scores")
        print(f"  threshold {s['threshold']:g}  margin mass "
              f"{s['margin_mass']:g} (eps {s['margin_eps']:g})  "
              f"alert rate {s['alert_rate']:g}")
        q = s["score_quantiles"]
        print(f"  score quantiles p50/p90/p99: "
              f"{q['p50']}/{q['p90']}/{q['p99']}")
        for name in s["features"]:
            fq = obj.features[name].quantiles()
            print(f"  feature {name:<16} p50/p90/p99: "
                  f"{fq['p50']}/{fq['p90']}/{fq['p99']} "
                  f"({obj.features[name].total} samples)")
        return 0

    if args.quality_cmd == "compare":
        try:
            _, ref = _load(args.reference)
            _, other = _load(args.other)
        except (FileNotFoundError, ValueError) as e:
            _log(str(e))
            return 2
        if not hasattr(ref, "score") or not hasattr(other, "score"):
            _log("compare wants two PROFILES (use `show` for a bundle's "
                 "live table)")
            return 2
        score_psi = psi(ref.score, other.score)
        feats = top_drifting(ref.features, other.features)
        out = {
            "score_psi": round(score_psi, 4),
            "feature_psi": {k: round(v, 4) for k, v in feats},
            "margin_mass": {"reference": round(ref.margin_mass, 4),
                            "other": round(other.margin_mass, 4)},
            "alert_rate": {"reference": round(ref.alert_rate, 4),
                           "other": round(other.alert_rate, 4)},
            "windows": {"reference": ref.windows, "other": other.windows},
        }
        if args.json:
            print(json.dumps(out, indent=2))
        else:
            print(f"score PSI {score_psi:.4f} "
                  f"(<0.1 stable, 0.1-0.25 moderate, >0.25 major)")
            print("top drifting features:")
            for k, v in feats:
                print(f"  {k:<16} PSI {v:.4f}")
            print(f"margin mass {ref.margin_mass:.4f} -> "
                  f"{other.margin_mass:.4f}   alert rate "
                  f"{ref.alert_rate:.4f} -> {other.alert_rate:.4f}")
        if args.psi_threshold is not None:
            worst = max([score_psi] + [v for _, v in feats])
            if worst >= args.psi_threshold:
                _log(f"PSI {worst:.4f} >= {args.psi_threshold:g}")
                return 1
        return 0
    _log(f"unknown quality subcommand {args.quality_cmd!r}")
    return 2  # pragma: no cover — argparse enforces the choices




# --------------------------------------------------------------------------
def cmd_archive(args) -> int:
    """Telemetry archive maintenance: segment inventory, retention prune,
    integrity verify, cross-host merge, and the tune-corpus export
    (docs/archive.md), and the learn plane's replay-buffer export
    (``--replay``).  All offline: no device, no live process."""
    from nerrf_tpu_torch.archive import (
        export_tune,
        list_segments,
        merge_archives,
        verify_archive,
    )
    from nerrf_tpu_torch.flight.journal import SchemaVersionError

    try:
        if args.archive_cmd == "ls":
            names = list_segments(args.dir)
            total = 0
            for name in names:
                p = Path(args.dir) / name
                size = p.stat().st_size if p.exists() else 0
                total += size
                state = "open" if name.endswith(".open") else "sealed"
                print(f"{name:<44} {size:>10}  {state}")
            print(f"{len(names)} segment(s), {total} bytes")
            return 0
        if args.archive_cmd == "prune":
            # out-of-band retention: sealed segments only — the dir may
            # belong to a LIVE writer whose .open tail must stay its own
            from nerrf_tpu_torch.archive import prune_archive

            if not Path(args.dir).is_dir():
                raise FileNotFoundError(args.dir)
            print(json.dumps(prune_archive(args.dir, args.max_bytes)))
            return 0
        if args.archive_cmd == "verify":
            v = verify_archive(args.dir)
            if args.json:
                print(json.dumps(v, indent=2))
            else:
                for s in v["segments"]:
                    flags = []
                    if s["partial_tail"]:
                        flags.append("partial-tail")
                    if s["corrupt_lines"]:
                        flags.append(f"{s['corrupt_lines']} corrupt")
                    if s["error"]:
                        flags.append(s["error"])
                    print(f"{s['segment']:<44} {s['records']:>7} records  "
                          + (" ".join(flags) or "ok"))
                print(f"{'OK' if v['ok'] else 'DAMAGED'}: {v['records']} "
                      f"records / {v['bytes']} bytes in "
                      f"{len(v['segments'])} segment(s)")
            return 0 if v["ok"] else 1
        if args.archive_cmd == "merge":
            out = merge_archives(args.sources, args.out, log=_log)
            print(json.dumps(out))
            return 0
        if args.archive_cmd == "export" and args.replay:
            # learn-plane reader: the replay buffer → deterministic,
            # seedable training batches (docs/learning.md); host code —
            # window lowering is numpy
            from nerrf_tpu_torch.learn import (
                build_replay_dataset,
                iter_replay,
                replay_batches,
                replay_stats,
            )
            from nerrf_tpu_torch.serve.config import ServeConfig
            from nerrf_tpu_torch.train.data import DatasetConfig

            stats = replay_stats(args.dir)
            if not stats["windows"]:
                _log(f"refusing to export: replay buffer {args.dir} holds "
                     "no scored windows (serve with the learn plane "
                     "attached first)")
                return 1
            bucket = None
            if args.bucket:
                bucket = tuple(int(x) for x in
                               args.bucket.replace("x", ",").split(","))
            else:
                # shape authority from the buffer itself: replay records
                # carry the bucket serve admission lowered them into
                for rec in iter_replay(args.dir):
                    if rec.get("bucket"):
                        bucket = tuple(rec["bucket"])
                    break
            ds_cfg = (ServeConfig().dataset_config(bucket) if bucket
                      else DatasetConfig())
            ds, info = build_replay_dataset(
                args.dir, ds_cfg, seed=args.seed, limit=args.limit)
            batches = 0
            if ds is not None:
                batches = sum(1 for _ in replay_batches(
                    ds, args.batch_size, seed=args.seed))
            doc = {"replay_dir": str(args.dir), "bucket": list(bucket or ()),
                   "seed": args.seed, "batch_size": args.batch_size,
                   "batches": batches, "stats": stats, "dataset": info}
            if args.out and ds is not None:
                import numpy as np

                np.savez_compressed(args.out, **ds.arrays)
                _log(f"replay dataset written to {args.out} "
                     f"({info['windows']} windows, seed {args.seed})")
            print(json.dumps(doc, indent=2))
            return 0
        if args.archive_cmd == "export":
            corpus = export_tune(args.dir)
            # polite refusal, not a garbage corpus: an archive with no
            # scored windows or no per-bucket cost rows cannot feed a
            # fit — say so in one line and exit nonzero
            if not corpus["windows_observed"]:
                _log(f"refusing to export: archive {args.dir} holds no "
                     "observed windows (run a serve with --archive-dir "
                     "first)")
                return 1
            if not corpus.get("bucket_cost"):
                _log(f"refusing to export: archive {args.dir} has no "
                     "per-bucket cost table (device-stage telemetry "
                     "missing) — the tune fit would have nothing to "
                     "measure")
                return 1
            text = json.dumps(corpus, indent=2)
            if args.out:
                Path(args.out).write_text(text + "\n")
                _log(f"tune corpus written to {args.out} "
                     f"({corpus['windows_observed']} windows observed)")
            else:
                print(text)
            return 0
    except SchemaVersionError as e:
        _log(f"cannot read archive: {e}")
        return 2
    except FileNotFoundError as e:
        _log(f"not an archive directory: {e}")
        return 2
    return 2


def cmd_report(args) -> int:
    """Offline fleet report over archived telemetry (docs/archive.md):
    SLO conformance, capacity headroom, drift, device efficiency and
    training health from segments alone — or, with --compare, a
    cross-run regression diff that exits 1 when the candidate regressed.
    --gate frames the diff as a queue pre-flight: one-line PASS/FAIL
    verdict, and a missing baseline passes with a note (first run before
    an artifact-of-record is banked)."""
    from nerrf_tpu_torch.archive import CompareConfig, report_main

    cfg = CompareConfig(p99_ratio=args.p99_ratio,
                        cost_ratio=args.cost_ratio,
                        loss_ratio=args.loss_ratio,
                        rate_abs=args.rate_abs,
                        psi_breach=args.psi_breach)
    return report_main(args.dir, since=args.since, until=args.until,
                       compare=args.compare, as_json=args.json,
                       gate=args.gate, compare_cfg=cfg)


def _load_any_trace(path: str, ground_truth=None):
    from nerrf_tpu_torch.data.datasets import load_trace_csv, load_trace_parquet
    from nerrf_tpu_torch.data.loaders import load_trace_jsonl

    p = Path(path)
    if p.suffix == ".csv":
        return load_trace_csv(p, ground_truth=ground_truth)
    if p.suffix == ".parquet":
        return load_trace_parquet(p, ground_truth=ground_truth)
    return load_trace_jsonl(p, ground_truth=ground_truth)


# --------------------------------------------------------------------------
def cmd_alerts(args) -> int:
    """Operator feedback on served alerts (docs/learning.md): label a
    window's alert tp/fp by its trace_id.  The disposition lands twice —
    an ``alert_disposition`` journal record (flight/archive evidence)
    and the replay buffer's sidecar, where the `export --replay` reader
    joins it into training labels by trace_id, last-wins."""
    from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL
    from nerrf_tpu_torch.learn import append_disposition

    rec = append_disposition(args.replay_dir, args.trace_id,
                             args.label, note=args.note)
    DEFAULT_JOURNAL.record(
        "alert_disposition", trace_id=args.trace_id,
        label=args.label, note=args.note,
        replay_dir=str(args.replay_dir))
    print(json.dumps(rec))
    return 0


def cmd_doctor(args) -> int:
    """The incident doctor: reconstruct a flight-recorder bundle's
    timeline and per-stage attribution offline, no live process needed
    (docs/flight-recorder.md).  A telemetry ARCHIVE directory renders the
    offline fleet report instead (docs/archive.md).  Without an argument
    the reference runs its environment doctor, which the port refuses
    (:data:`UNPORTED_FLAGS`)."""
    from nerrf_tpu_torch.archive import is_archive_dir
    from nerrf_tpu_torch.flight.doctor import doctor_main

    if (not Path(args.bundle, "manifest.json").is_file()
            and is_archive_dir(args.bundle)):
        # an archive dir, not a bundle: same verb, the report reader
        from nerrf_tpu_torch.archive import report_main

        return report_main([args.bundle], as_json=args.json)
    return doctor_main(args.bundle, tail=args.tail, as_json=args.json)


# --------------------------------------------------------------------------
def cmd_chaos(args) -> int:
    """Chaos plane (docs/chaos.md): the fault-point catalog, plan
    validation, and an example schedule — the game-day front door.  A plan
    is armed on a pod via ``NERRF_CHAOS_PLAN=<plan.json>`` (serve-detect
    reads it at boot) or ``serve-detect --chaos-plan``; this subcommand
    never arms anything itself.  The example is the reference's less its
    ``compilecache.corrupt_payload`` spec, which the port refuses until it
    has a compile cache (ROADMAP A.7)."""
    from nerrf_tpu_torch import chaos

    if args.chaos_cmd == "sites":
        rows = sorted(chaos.SITES.items())
        if args.json:
            print(json.dumps(dict(rows), indent=2))
        else:
            for site, desc in rows:
                print(f"{site:<32} {desc}")
        return 0
    if args.chaos_cmd == "example":
        plan = chaos.FaultPlan(seed=7, faults=(
            chaos.FaultSpec(site="serve.poison_window", prob=0.05,
                            match={"stream": "s1"}),
            chaos.FaultSpec(site="ingest.wire_error", every=40),
            chaos.FaultSpec(site="serve.device_latency", every=9,
                            mode="stall", delay_sec=0.2,
                            after_sec=5.0, for_sec=20.0),
        ))
        print(json.dumps(plan.to_dict(), indent=2))
        return 0
    # validate
    try:
        plan = chaos.load_plan(args.plan)
        chaos.validate_plan(plan)
    except (OSError, ValueError, TypeError) as e:
        _log(f"chaos plan {args.plan}: INVALID — {e}")
        return 1
    sites = sorted({s.site for s in plan.faults})
    print(json.dumps({"plan": args.plan, "valid": True, "seed": plan.seed,
                      "faults": len(plan.faults), "sites": sites},
                     indent=2))
    return 0


def cmd_tune(args) -> int:
    """Fit the learned bucket ladder + per-rung kernel routing from an
    archived cost corpus and emit the versioned tuned-ladder artifact
    (docs/tuning.md).  Deterministic: same corpus → same artifact, so the
    tuned-vs-static comparison inside is reproducible evidence, not a
    wall-clock sample.  ``--kernel-bench`` has no default in the port: the
    reference's, a CPU record, says nothing of the card's crossover, and
    without one the fit cites the reference's authored constant."""
    from nerrf_tpu_torch.tune import (
        TuneError,
        load_kernel_bench_crossover,
        save_artifact,
        tune,
    )

    src = Path(args.corpus)
    try:
        if src.is_dir():
            # convenience: point at an archive dir and we export inline
            from nerrf_tpu_torch.archive import export_tune

            corpus = export_tune(src)
        else:
            try:
                corpus = json.loads(src.read_text())
            except FileNotFoundError:
                _log(f"no such corpus file or archive directory: {src}")
                return 1
            except ValueError as e:
                _log(f"corpus {src} is not JSON ({e})")
                return 1

        model_cfg = None
        analytic = None
        if args.model_dir:
            # the checkpoint's real architecture sizes the cost model's
            # work terms, and its analytic devtime surface (traced on
            # `meta`, no card needed) anchors thin/missing buckets — both
            # optional, both fail-open
            from nerrf_tpu_torch.train.checkpoint import load_checkpoint

            _state, model_cfg = load_checkpoint(args.model_dir)
            try:
                import torch

                from nerrf_tpu_torch.devtime.costmodel import (
                    serve_program_costs,
                )
                from nerrf_tpu_torch.models import NerrfNet
                from nerrf_tpu_torch.serve.config import ServeConfig

                with torch.device("meta"):
                    on_meta = NerrfNet(model_cfg)
                costs = serve_program_costs(on_meta, ServeConfig())
                analytic = {tag: c.flops for tag, c in costs.items()}
            except Exception as e:  # noqa: BLE001 — prior, not gate
                _log(f"analytic cost surface unavailable ({e}); fitting "
                     f"from measurements alone")

        kb = (load_kernel_bench_crossover(args.kernel_bench)
              if args.kernel_bench else None)
        art = tune(corpus, model_cfg=model_cfg, analytic=analytic,
                   kernel_bench=kb, max_rungs=args.max_rungs)
    except TuneError as e:
        _log(f"refusing to tune: {e}")
        return 1

    exp = art["expected"]
    if args.out:
        save_artifact(args.out, art)
        _log(f"tuned ladder written to {args.out}: "
             f"{len(art['buckets'])} rung(s), expected "
             f"{exp['static_device_seconds_per_window']:.3g}s → "
             f"{exp['tuned_device_seconds_per_window']:.3g}s per window "
             f"({exp['improvement']:.1%} improvement)")
    if args.json or not args.out:
        print(json.dumps(art, indent=2))
    return 0


# --------------------------------------------------------------------------
def cmd_serve(args) -> int:
    """Serve a trace over the Tracker wire protocol (+ /metrics endpoint):
    the replay flavor of the tracker daemon."""
    import signal

    from nerrf_tpu_torch.ingest.service import TraceReplayServer
    from nerrf_tpu_torch.observability import MetricsServer

    if args.duration <= 0:
        # Block BEFORE spawning any thread: child threads inherit the mask,
        # so process-directed SIGTERM/SIGINT can only wake sigwait below.
        signal.pthread_sigmask(
            signal.SIG_BLOCK, {signal.SIGINT, signal.SIGTERM})

    trace = _load_any_trace(args.trace)
    host, _, port = args.address.rpartition(":")
    server = TraceReplayServer(trace.events, trace.strings,
                               address=f"{host or '0.0.0.0'}:{port}",
                               batch_size=args.batch_size)
    bound = server.start()
    metrics = MetricsServer(host="0.0.0.0", port=args.metrics_port) \
        if args.metrics_port >= 0 else None
    _log(f"serving {trace.events.num_valid} events on :{bound}"
         + (f", metrics on :{metrics.port}" if metrics else ""))
    try:
        if args.duration > 0:
            time.sleep(args.duration)
        else:
            signal.sigwait({signal.SIGINT, signal.SIGTERM})
    finally:
        server.stop()
        if metrics:
            metrics.close()
    return 0


def cmd_serve_detect(args) -> int:
    """`serve-detect` (:func:`_serve_detect`); a chaos plan it armed is
    disarmed when it returns, so an in-process caller inherits none."""
    from nerrf_tpu_torch import chaos

    before = chaos.controller()
    try:
        return _serve_detect(args)
    finally:
        if chaos.controller() is not before:
            chaos.disarm()


def _serve_detect(args) -> int:
    """The online detection pod: admit N concurrent Tracker streams, window
    each, and score cross-stream micro-batches through one warmed forward a
    capacity bucket on the card (nerrf_tpu_torch/serve).  Streams come from
    --target endpoints (live trackers) and/or --trace files (each served
    through an in-process TraceReplayServer, so the full wire protocol is
    exercised either way).  Readiness (/readyz on the metrics port) flips
    only after every configured bucket is warm.  With --registry the pod
    boots from the lineage's LIVE version and a ModelManager polls it:
    versions published into the lineage shadow-score on the live batches
    and hot-swap in when the guardrails pass, promotions and rollbacks from
    any process land without a restart.  --archive-dir spools the telemetry
    to a durable archive that `report` reads offline.  --tuned serves a
    tuned-ladder artifact's rungs with its per-rung kernel routing;
    --chaos-plan (else $NERRF_CHAOS_PLAN) arms a fault plan."""
    import dataclasses as _dc

    from nerrf_tpu_torch.device import resolve_device
    from nerrf_tpu_torch.models import JointConfig
    from nerrf_tpu_torch.observability import DEFAULT_REGISTRY, MetricsServer
    from nerrf_tpu_torch.serve import (
        OnlineDetectionService,
        ServeConfig,
        init_untrained_model,
    )
    from nerrf_tpu_torch.serve.config import bucket_tag

    dev = resolve_device(args.device)
    cfg_kwargs = dict(
        batch_size=args.batch_size,
        batch_close_sec=args.close_ms / 1000.0,
        window_deadline_sec=args.deadline_sec,
        stream_queue_slots=args.queue_slots,
    )
    if args.buckets:
        cfg_kwargs["buckets"] = _buckets(args.buckets)
    cfg = ServeConfig(**cfg_kwargs)

    tuned_art = None
    if args.tuned:
        # tuned-ladder boot (docs/tuning.md): the artifact's rung set
        # replaces the ladder (including any --buckets) and its routing
        # table rides into the model config below — warmup then runs
        # exactly the tuned rungs and admission admits exactly their
        # reachable shapes
        from nerrf_tpu_torch.tune import (
            TuneError,
            apply_to_serve_config,
            load_artifact,
        )

        try:
            tuned_art = load_artifact(args.tuned)
        except TuneError as e:
            _log(str(e))
            return 2
        cfg = apply_to_serve_config(tuned_art, cfg)
        _log(f"tuned ladder from {args.tuned}: {len(cfg.buckets)} rung(s), "
             f"routing {tuned_art.get('routing')}")

    # chaos plane (docs/chaos.md): arm a fault plan for a game day —
    # --chaos-plan wins, else $NERRF_CHAOS_PLAN (one env var on the pod).
    # Neither set → every fault point stays a free no-op.  A bad plan is
    # a one-line refusal to boot (the operator asked for faults the pod
    # cannot inject — serving WITHOUT them would fake the game day)
    from nerrf_tpu_torch import chaos

    try:
        if args.chaos_plan:
            ctl = chaos.arm(chaos.load_plan(args.chaos_plan))
            _log(f"chaos: armed {len(ctl.plan.faults)} fault spec(s) "
                 f"from {args.chaos_plan} (seed {ctl.plan.seed})")
        else:
            chaos.arm_from_env(log=_log)
    except (OSError, ValueError, TypeError) as e:
        _log(f"chaos plan INVALID — {e} "
             f"(check it with `chaos validate`)")
        return 2

    manager = None
    quality_profile = None
    if args.registry:
        # registry mode: boot from the lineage's LIVE version and keep a
        # ModelManager polling: checkpoints published into the lineage
        # shadow-score and hot-swap in without a pod restart
        import torch

        from nerrf_tpu_torch.models import NerrfNet
        from nerrf_tpu_torch.registry import (
            ModelManager,
            ModelRegistry,
            RegistryConfig,
        )

        manager = ModelManager(
            ModelRegistry(args.registry), args.lineage,
            cfg=RegistryConfig(poll_sec=args.poll_sec), log=_log)
        state, model_cfg, calib, version = manager.boot()
        with torch.device(dev):
            model = NerrfNet(model_cfg)
        model.load_state_dict(state, strict=True)
        model.eval()
        if calib.get("node_threshold") is not None:
            cfg = _dc.replace(cfg, threshold=calib["node_threshold"])
        _log(f"registry boot: {args.lineage}/v{version} LIVE "
             f"from {args.registry}")
    elif args.model_dir:
        from nerrf_tpu_torch.quality import load_profile
        from nerrf_tpu_torch.train.checkpoint import load_calibration

        model = _load_model(args.model_dir, dev)
        calib = load_calibration(args.model_dir)
        if calib.get("node_threshold") is not None:
            cfg = _dc.replace(cfg, threshold=calib["node_threshold"])
        try:
            # the quality plane's own loader validates (schema ceiling,
            # field shapes), so a malformed or newer-schema sidecar is a
            # one-line downgrade to no baseline here: drift monitoring is
            # advisory and must never block serving
            quality_profile = load_profile(args.model_dir)
        except ValueError as e:
            _log(f"quality profile unreadable ({e}); serving without a "
                 f"drift baseline")
    else:
        _log("no --model-dir: serving an UNTRAINED small detector "
             "(load testing only — scores carry no meaning)")
        model = init_untrained_model(JointConfig().small, cfg, device=dev)

    if tuned_art is not None:
        import torch

        from nerrf_tpu_torch.models import NerrfNet
        from nerrf_tpu_torch.tune import apply_to_model_config

        with torch.device(dev):
            tuned = NerrfNet(apply_to_model_config(tuned_art, model.cfg))
        tuned.load_state_dict(model.state_dict(), strict=True)
        model = tuned.eval()

    service = OnlineDetectionService(model, cfg=cfg, device=dev)
    if quality_profile is not None:
        # checkpoint-dir boot: bind the shipped drift baseline (registry
        # boots get theirs through manager.attach below, version-stamped)
        service.set_quality_profile(quality_profile)
    archive = None
    if args.archive_dir:
        # telemetry archive plane: every journal record, cadenced metrics
        # snapshots and the workload sketches spool to crash-safe segments;
        # `report` reconstructs SLO, capacity and drift offline
        from nerrf_tpu_torch.archive import ArchiveConfig, ArchiveWriter

        archive = ArchiveWriter(ArchiveConfig(out_dir=args.archive_dir),
                                log=_log)
        service.attach_archive(archive)
        _log(f"telemetry archive spooling to {args.archive_dir}")
    responder = None
    respond_ctx = None
    if args.respond:
        # online incident-response tier: every alert at or above the
        # calibrated-severity gate becomes an incident, batched search-kernel
        # waves plan them, and each plan replays through the rollback
        # sandbox gate before surfacing
        from nerrf_tpu_torch.respond import RespondConfig, ResponseRouter

        responder = ResponseRouter(
            RespondConfig(severity_min=args.respond_severity), device=dev)
        if args.respond_store and args.respond_root:
            # a snapshot handle for the served streams: with it, plans are
            # verifiable; without it every plan is quarantined (fail closed)
            from nerrf_tpu_torch.respond import VerifyContext
            from nerrf_tpu_torch.rollback.store import SnapshotStore

            snap_store = SnapshotStore(args.respond_store)
            snap_id = args.respond_snapshot or \
                (snap_store.list_manifests() or [None])[-1]
            if snap_id is None:
                _log(f"respond: no manifests in {args.respond_store} — "
                     f"plans will be quarantined unverified")
            else:
                respond_ctx = VerifyContext(
                    store=snap_store,
                    manifest=snap_store.load_manifest(snap_id),
                    victim_root=Path(args.respond_root))
                _log(f"respond: verifying against snapshot {snap_id} "
                     f"over {args.respond_root}")
        service.attach_respond(responder)
        responder.start()
        _log(f"respond tier armed: severity>={args.respond_severity:g}, "
             f"{len(responder.cfg.batch_slots)} batch slots warmed in "
             f"{responder.warmup_seconds:.1f}s")
    recorder = None
    uninstall_crash = None
    if args.flight_dir:
        # incident flight recorder: trailing-p99 breach / drop burst /
        # shadow-disagreement / guardrail-veto / quality-drift triggers dump
        # self-contained bundles into --flight-dir, and the excepthook +
        # faulthandler hooks turn an uncaught crash into a bundle too —
        # wired BEFORE streams connect so startup failures are covered
        from nerrf_tpu_torch.flight import (
            FlightConfig,
            FlightRecorder,
            install_crash_handlers,
        )

        recorder = FlightRecorder(
            FlightConfig(out_dir=args.flight_dir,
                         p99_breach_sec=args.deadline_sec,
                         profile_on_p99_sec=args.profile_on_breach_sec),
            info=service.flight_info, slo=service.slo,
            quality=service.quality_snapshot, archive=archive, log=_log)
        service.attach_flight(recorder)
        uninstall_crash = install_crash_handlers(recorder)
        _log(f"flight recorder armed: bundles in {args.flight_dir}"
             + (f" (+{args.profile_on_breach_sec:g}s profiler trace per "
                f"p99 breach)" if args.profile_on_breach_sec > 0 else ""))
    profiler = None
    if args.profiler_port >= 0:
        # the capture endpoint: `profile capture --target` pulls a
        # torch.profiler trace of the live pod without touching the hot path
        from nerrf_tpu_torch.devtime.capture import ProfilerServer

        profiler = ProfilerServer(host="0.0.0.0", port=args.profiler_port)
        _log(f"profiler server on :{profiler.port} "
             f"(GET /capture?seconds=S)")
    if manager is not None:
        manager.attach(service)
        manager.start_polling()
    metrics = None
    replays = []
    try:
        if args.metrics_port >= 0:
            # readiness is live from the first probe: "booting" (503) during
            # the warmup sweep below, then "ready"
            metrics = MetricsServer(host="0.0.0.0", port=args.metrics_port,
                                    ready_check=service.ready)
            _log(f"metrics on :{metrics.port} (/healthz, /readyz)")
        _log(f"warming {len(cfg.buckets)} bucket forwards…")
        service.start(log=_log)

        targets = [(f"target{i}", t) for i, t in enumerate(args.target or [])]
        for i, path in enumerate(args.trace or []):
            from nerrf_tpu_torch.ingest.service import TraceReplayServer

            tr = _load_any_trace(path)
            rs = TraceReplayServer(tr.events, tr.strings,
                                   batch_size=args.frame_events)
            port = rs.start()
            replays.append(rs)
            targets.append((f"trace{i}:{Path(path).stem}", f"127.0.0.1:{port}"))
        if not targets:
            _log("nothing to serve: pass --target and/or --trace")
            return 2
        if responder is not None and respond_ctx is not None:
            for name, _addr in targets:
                responder.bind_context(name, respond_ctx)
        runs = [service.connect(name, addr, timeout=args.stream_timeout,
                                follow=args.follow)
                for name, addr in targets]
        _log(f"{len(runs)} streams admitted"
             + (" (follow: reconnect at stream end)" if args.follow else ""))
        deadline = time.monotonic() + args.duration if args.duration > 0 \
            else None
        for run in runs:
            run.done.wait(timeout=None if deadline is None
                          else max(deadline - time.monotonic(), 0.1))

        out_dir = Path(args.out) if args.out else None
        if out_dir:
            out_dir.mkdir(parents=True, exist_ok=True)
        summary = {"streams": {}, "alerts": 0}
        for run in runs:
            det = run.result
            entry = {"done": run.done.is_set(),
                     "error": repr(run.error) if run.error else None}
            if det is not None:
                entry.update(
                    detector=det.detector, threshold=det.threshold,
                    files_scored=len(det.file_scores),
                    files_flagged=len(det.flagged_files()))
                if out_dir:
                    safe = run.stream.replace("/", "_").replace(":", "_")
                    (out_dir / f"detect_{safe}.json").write_text(json.dumps({
                        "stream": run.stream,
                        "detector": det.detector,
                        "threshold": det.threshold,
                        "file_scores": det.file_scores,
                        "proc_scores": det.proc_scores,
                    }, indent=2))
            summary["streams"][run.stream] = entry
        alerts = service.sink.drain()
        summary["alerts"] = len(alerts)
        if out_dir:
            with (out_dir / "alerts.jsonl").open("w") as f:
                for a in alerts:
                    f.write(json.dumps({
                        "stream": a.stream, "window": a.window_idx,
                        "max_prob": round(a.max_prob, 4),
                        "hot": a.hot, "late": a.late,
                        "latency_ms": round(
                            (a.t_scored - a.t_admit) * 1e3, 1),
                    }) + "\n")
        summary["windows_scored"] = DEFAULT_REGISTRY.value(
            "serve_windows_scored_total")
        if service.live_version is not None:
            summary["model_version"] = f"v{service.live_version}"
        summary["admission_dropped"] = {
            reason: DEFAULT_REGISTRY.value(
                "serve_admission_dropped_total", labels={"reason": reason})
            for reason in ("backpressure", "oversize", "leave", "closed")}
        # per-bucket recompile counter summed over the served ladder: the
        # zero-recompile contract made scriptable
        summary["recompiles_after_warmup"] = sum(
            DEFAULT_REGISTRY.value("serve_recompiles_total",
                                   labels={"bucket": bucket_tag(b)}) or 0
            for b in cfg.buckets)
        if responder is not None:
            responder.drain(timeout=30.0)
            summary["respond"] = responder.stats()
        print(json.dumps(summary, indent=2))
        return 0
    except BaseException as e:
        # a MAIN-thread crash would only reach sys.excepthook AFTER the
        # finally below has already uninstalled it — journal (→ bundle)
        # here, while the recorder is still subscribed.  Ctrl-C is a
        # routine shutdown, not an incident
        if recorder is not None and not isinstance(
                e, (SystemExit, KeyboardInterrupt)):
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL
            from nerrf_tpu_torch.flight.recorder import journal_exception

            journal_exception(DEFAULT_JOURNAL, type(e), e,
                              e.__traceback__, "main")
        raise
    finally:
        if manager is not None:
            manager.close()
        if responder is not None:
            responder.stop()
        service.stop()
        for rs in replays:
            rs.stop()
        if metrics:
            metrics.close()
        if profiler is not None:
            profiler.close()
        if recorder is not None:
            recorder.close()
        if archive is not None:
            # after the recorder: a crash bundle dumped during teardown
            # still stamps a live archive position; close() drains the
            # backlog and seals the tail segment
            archive.close()
        if uninstall_crash is not None:
            uninstall_crash()


def cmd_respond(args) -> int:
    """The incident-response corpus end to end, no serve pod needed: stage
    each adversarial family on disk (victim tree snapshotted FIRST), run
    detection on the attack trace, plan every incident through the batched
    search kernel, replay every plan through the rollback sandbox gate.  One
    JSON report; exit 1 if any family failed to produce a verified plan."""
    import tempfile

    from nerrf_tpu_torch.device import resolve_device
    from nerrf_tpu_torch.pipeline import heuristic_detect
    from nerrf_tpu_torch.respond import (
        FAMILIES,
        RespondConfig,
        ResponseRouter,
        stage_incident,
    )

    dev = resolve_device(args.device)
    fams = tuple(args.family or FAMILIES)
    unknown = [f for f in fams if f not in FAMILIES]
    if unknown:
        _log(f"unknown family {unknown} (know {list(FAMILIES)})")
        return 2
    cfg = RespondConfig(num_simulations=args.sims, verify=not args.no_verify)
    work = Path(args.work_dir) if args.work_dir else Path(
        tempfile.mkdtemp(prefix="nerrf_respond_"))
    work.mkdir(parents=True, exist_ok=True)
    _log(f"staging {len(fams)} families under {work}")
    router = ResponseRouter(cfg, device=dev).start()
    try:
        for fam in fams:
            staged = stage_incident(work, fam, seed=args.seed, files=args.files)
            det = heuristic_detect(staged.trace)
            _log(f"{fam}: {len(det.flagged_files())} files flagged, "
                 f"{len(det.proc_scores)} procs")
            router.submit_detection(fam, det, context=staged.verify_context())
        drained = router.drain(timeout=cfg.timeout_seconds * len(fams) + 120.0)
        report = {
            "families": {vp.incident.stream: vp.to_dict()
                         for vp in router.results()},
            "stats": router.stats(),
            "drained": drained,
        }
    finally:
        router.stop()
    print(json.dumps(report, indent=2))
    complete = drained and len(report["families"]) == len(fams)
    verified = args.no_verify or all(
        v["verified"] for v in report["families"].values())
    clean = report["stats"]["recompiles"] == 0
    return 0 if (complete and verified and clean) else 1


def cmd_ingest(args) -> int:
    """Drain a tracker's StreamEvents into a trace store (the ingest pod:
    gRPC → native decode → time-bucketed segments).  Blocks are appended
    and flushed incrementally, so a dropped stream or deadline expiry loses
    nothing already received; --follow reconnects forever (daemon mode)."""
    import grpc

    from nerrf_tpu_torch.graph.store import TraceStore
    from nerrf_tpu_torch.ingest.service import TrackerClient
    from nerrf_tpu_torch.observability import DEFAULT_REGISTRY, MetricsServer

    metrics = None
    if args.metrics_port >= 0:
        try:
            metrics = MetricsServer(host="0.0.0.0", port=args.metrics_port)
        except OSError:
            # port taken (another ingest/serve on this host): an ephemeral
            # port rather than refusing to ingest at all
            metrics = MetricsServer(host="0.0.0.0", port=0)
            _log(f"metrics port {args.metrics_port} in use; using ephemeral")
        _log(f"metrics on :{metrics.port}")
    total = 0
    segments = 0
    try:
        with TraceStore(args.store_dir, bucket_sec=args.bucket_sec) as st:
            # Durability flush on a wall-clock cadence, not per decoded frame:
            # every flush rewrites the active bucket's whole segment, so
            # per-frame flushing is O(rows²) disk traffic.  At most
            # --flush-sec of received-but-unflushed events are lost on a
            # crash (a dropped *stream* loses nothing: the finally-flush
            # below runs per connection).
            last_flush = time.monotonic()
            while True:
                client = TrackerClient(args.target)
                try:
                    for events, strings in client.iter_blocks(
                            max_events=args.max_events or None,
                            timeout=args.timeout):
                        stored = st.append(events, strings)
                        total += stored
                        DEFAULT_REGISTRY.counter_inc(
                            "ingest_events_stored_total", stored,
                            help="events appended to the trace store")
                        now = time.monotonic()
                        if now - last_flush >= args.flush_sec:
                            segments += st.flush()
                            last_flush = now
                except grpc.RpcError as e:
                    _log(f"stream ended: {e.code().name}")
                finally:
                    segments += st.flush()
                    last_flush = time.monotonic()
                if not args.follow:
                    break
                time.sleep(args.reconnect_sec)
            out = {
                "events": total,
                "segments_written": segments,
                "segments_live": st.num_segments,
                "strings": st.num_strings,
                "engine": "native" if st.is_native else "python",
            }
    finally:
        if metrics:
            metrics.close()
    print(json.dumps(out))
    return 0


# --------------------------------------------------------------------------
# what the port does not have yet: the subcommands of planes still to port,
# and the flags that reach them, each with the ROADMAP item it waits for

# subcommand → (the reference's help text, what it needs, ROADMAP item)
UNPORTED_COMMANDS = {
    "cache": ("persistent compile cache: list, prune, verify, pre-warm",
              "the compile cache (a capture cache of CUDA graphs)", "A.7"),
    "lint": ("static analysis over nerrf_tpu's own ASTs (purity, recompile, "
             "sync, lock discipline, the concurrency tier, metrics "
             "contract); --deep adds the jaxpr-level program contracts",
             "the analysis rules over the port", "A.7"),
}

# (subcommand, flag, is it asked for?, what it needs, ROADMAP item)
UNPORTED_FLAGS = (
    ("train-detector", "--aot-cache", lambda a: a.aot_cache is not None,
     "the compile cache", "A.7"),
    ("serve-detect", "--aot-cache", lambda a: a.aot_cache is not None,
     "the compile cache", "A.7"),
    ("models", "publish --aot",
     lambda a: a.models_cmd == "publish" and a.aot,
     "the compile cache", "A.7"),
    ("doctor", "with no bundle (the environment doctor)",
     lambda a: a.bundle is None,
     "an environment doctor of the port's own (the reference's runs "
     "scripts/check_env.py, a JAX backend probe)", "A.7"),
)


def _refusal(args) -> str:
    """The one-line refusal for what ``args`` asks of an unported plane, or
    '' when it asks nothing of one."""
    if args.cmd in UNPORTED_COMMANDS:
        _help, what, item = UNPORTED_COMMANDS[args.cmd]
        return (f"`{args.cmd}` needs {what}, which is not ported yet "
                f"(ROADMAP {item})")
    for cmd, flag, asked, what, item in UNPORTED_FLAGS:
        if cmd == args.cmd and asked(args):
            return (f"{cmd} {flag} needs {what}, which is not ported yet "
                    f"(ROADMAP {item})")
    return ""


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where tensors live (default: the card; 'cpu' runs "
                        "the kernels' plain versions); without CUDA the "
                        "default raises")


# --------------------------------------------------------------------------
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nerrf", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("simulate", help="seed victim files, snapshot, run attack")
    p.add_argument("--incident", required=True)
    p.add_argument("--files", type=int, default=45)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("train-detector", help="train + checkpoint a detector")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--traces", type=int, default=12)
    p.add_argument("--hidden", type=int, default=48)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--seed", type=int, default=21)
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="checkpoint the full train state every N steps and "
                        "resume from the latest on restart (0 = off)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write a Chrome-trace JSON of the run's host spans "
                        "(enables per-step synced attribution spans)")
    p.add_argument("--publish", default=None, metavar="REGISTRY",
                   help="publish the calibrated checkpoint into this model "
                        "registry (a new immutable version; promotion "
                        "stays separate: pods shadow-score it first)")
    p.add_argument("--lineage", default="default",
                   help="registry lineage to publish into (with --publish)")
    p.add_argument("--aot-cache", default=None, metavar="DIR",
                   help="persistent compile cache root: not ported yet "
                        "(ROADMAP A.7), exits 2")
    p.add_argument("--no-aot-cache", action="store_true",
                   help="accepted and does nothing: the port has no compile "
                        "cache yet (ROADMAP A.7)")
    p.add_argument("--metrics-port", type=int, default=-1,
                   help="training-health /metrics + /healthz + /readyz "
                        "port (-1 disables; 0 = ephemeral); /readyz fails "
                        "before the first step and on a divergence halt "
                        "(docs/training-health.md)")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="arm the training flight recorder: divergence/"
                        "starvation/stall bundles land here, readable "
                        "offline with `nerrf doctor <bundle>`")
    p.add_argument("--archive-dir", default=None, metavar="DIR",
                   help="spool the run's telemetry (journal, metrics "
                        "snapshots, step sketches) into a crash-safe "
                        "segmented archive `nerrf report` reads offline "
                        "(docs/archive.md)")
    _add_device(p)
    p.set_defaults(fn=cmd_train_detector)


    p = sub.add_parser("models", help="model lifecycle registry: publish, "
                                      "list, promote, rollback, status")
    msub = p.add_subparsers(dest="models_cmd", required=True)

    def _models_common(mp, lineage_required=True):
        mp.add_argument("--registry", required=True, metavar="DIR",
                        help="registry root (the serve pods' --registry)")
        # `list` alone leaves --lineage optional (None = every lineage)
        mp.add_argument("--lineage", required=lineage_required, default=None,
                        help="model lineage name")
        mp.set_defaults(fn=cmd_models)

    mp = msub.add_parser("publish", help="copy a checkpoint in as the next "
                                         "immutable version (schema/feature "
                                         "gated)")
    _models_common(mp)
    mp.add_argument("--model-dir", required=True,
                    help="checkpoint directory to publish")
    mp.add_argument("--source", default=None,
                    help="provenance note stamped into the version sidecar")
    mp.add_argument("--promote", action="store_true",
                    help="also repoint LIVE at the new version immediately "
                        "(skips shadow scoring — prefer guarded promotion)")
    mp.add_argument("--aot", action="store_true",
                    help="the AOT executables sidecar: needs the compile "
                         "cache, not ported yet (ROADMAP A.7), exits 2")
    mp = msub.add_parser("list", help="lineages, versions, LIVE pointers")
    _models_common(mp, lineage_required=False)
    mp = msub.add_parser("promote", help="repoint LIVE at a version "
                                         "(atomic; pods hot-swap on their "
                                         "next poll)")
    _models_common(mp)
    mp.add_argument("--version", type=int, required=True)
    mp = msub.add_parser("rollback", help="one-command rollback: repoint "
                                          "LIVE at the previous (or given) "
                                          "version")
    _models_common(mp)
    mp.add_argument("--version", type=int, default=None,
                    help="explicit version to roll back to (default: the "
                         "LIVE pointer's recorded previous)")
    mp = msub.add_parser("status", help="one lineage's versions + LIVE")
    _models_common(mp)


    p = sub.add_parser("undo", help="detect, plan, rehearse and roll back")
    p.add_argument("--incident", required=True)
    p.add_argument("--model-dir", default=None,
                   help="trained detector checkpoint (default: heuristic)")
    p.add_argument("--simulations", type=int, default=800)
    p.add_argument("--planner", choices=("auto", "host", "device"),
                   default="auto",
                   help="host = batched-leaf MCTS; device = the whole "
                        "search as one kernel launch a chunk on --device; "
                        "auto (default) = device — plan time dominates "
                        "MTTR, so the card is the KPI path")
    p.add_argument("--trace", default=None,
                   help="detect on this trace file instead of the "
                        "incident's own trace.jsonl (e2e wire artifact)")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--no-gate", action="store_true")
    p.add_argument("--no-probe", action="store_true",
                   help="accepted and does nothing: the port probes no "
                        "backend (no fallback, by rule)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write a Chrome-trace JSON of the incident's "
                        "detect/plan/gate/execute spans")
    _add_device(p)
    p.set_defaults(fn=cmd_undo)

    p = sub.add_parser("status", help="incident state")
    p.add_argument("--incident", required=True)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("warmup", help="boot-time compile sweep (detector "
                                      "buckets + device planner) into the "
                                      "persistent cache")
    p.add_argument("--model-dir", default=None,
                   help="detector checkpoint to warm (skipped if absent)")
    p.add_argument("--buckets", nargs="*", default=None,
                   metavar="NxExS",
                   help="capacity buckets, e.g. 1024x2048x128 "
                        "4096x8192x512 (default: the configured ladder)")
    p.add_argument("--no-probe", action="store_true",
                   help="accepted and does nothing: the port probes no "
                        "backend (no fallback, by rule)")
    _add_device(p)
    p.set_defaults(fn=cmd_warmup)

    p = sub.add_parser("serve", help="serve a trace over the Tracker protocol")
    p.add_argument("--trace", required=True,
                   help="trace file (.jsonl/.csv/.parquet)")
    p.add_argument("--address", default="0.0.0.0:50051")
    p.add_argument("--metrics-port", type=int, default=9090,
                   help="Prometheus /metrics port (-1 disables)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--duration", type=float, default=0,
                   help="serve for N seconds then exit (0 = until signal)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write a Chrome-trace JSON of the serve session's "
                        "host spans on exit")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("serve-detect",
                       help="online detection service: score N tracker "
                            "streams through shared device micro-batches")
    p.add_argument("--model-dir", default=None,
                   help="trained detector checkpoint (default: an untrained "
                        "small model, for load testing only)")
    p.add_argument("--registry", default=None, metavar="DIR",
                   help="model registry root: boot from the lineage's LIVE "
                        "version and poll for promotions, rollbacks and "
                        "shadow candidates (instead of --model-dir)")
    p.add_argument("--lineage", default="default",
                   help="registry lineage to serve (with --registry)")
    p.add_argument("--poll-sec", type=float, default=10.0,
                   help="registry poll cadence (with --registry)")
    p.add_argument("--target", action="append", default=None,
                   metavar="HOST:PORT",
                   help="tracker endpoint to admit as one stream "
                        "(repeatable)")
    p.add_argument("--trace", action="append", default=None, metavar="FILE",
                   help="trace file to serve through an in-process replay "
                        "server and admit as one stream (repeatable)")
    p.add_argument("--buckets", nargs="*", default=None, metavar="NxExS",
                   help="capacity-bucket ladder, e.g. 256x512x128 "
                        "1024x2048x128 (default: the warmup ladder)")
    p.add_argument("--tuned", default=None, metavar="FILE",
                   help="tuned-ladder artifact from `tune`: serve on its "
                        "fitted bucket ladder + per-rung kernel routing "
                        "table (overrides --buckets; docs/tuning.md)")
    p.add_argument("--batch-size", type=int, default=8,
                   help="padded device batch slots per launch")
    p.add_argument("--close-ms", type=float, default=50.0,
                   help="batch-close deadline: fire a partial batch after "
                        "the oldest window waited this long")
    p.add_argument("--deadline-sec", type=float, default=2.0,
                   help="per-window admit→alert SLO budget (late windows "
                        "still score, counted)")
    p.add_argument("--queue-slots", type=int, default=64,
                   help="per-stream bounded admission queue (drop-oldest)")
    p.add_argument("--frame-events", type=int, default=256,
                   help="events per wire frame for --trace replay servers")
    p.add_argument("--stream-timeout", type=float, default=300.0,
                   help="gRPC deadline per stream drain")
    p.add_argument("--follow", action="store_true",
                   help="resident mode (the serve pod): finalize and "
                        "reconnect each stream when it ends instead of "
                        "exiting — pair with a long --stream-timeout")
    p.add_argument("--duration", type=float, default=0,
                   help="stop waiting after N seconds (0 = until every "
                        "stream ends; with --follow that is forever)")
    p.add_argument("--metrics-port", type=int, default=9092,
                   help="Prometheus /metrics + /healthz + /readyz port "
                        "(-1 disables); default 9092 so serve (9090) and "
                        "ingest (9091) coexist on one host")
    p.add_argument("--out", default=None, metavar="DIR",
                   help="write per-stream detection JSON + alerts.jsonl")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="arm the incident flight recorder: anomaly "
                        "triggers (p99 breach, drop burst, shadow "
                        "disagreement, guardrail veto, quality drift, "
                        "uncaught crash via excepthook+faulthandler) dump "
                        "self-contained diagnostic bundles here, readable "
                        "offline with `nerrf doctor <bundle>`")
    p.add_argument("--archive-dir", default=None, metavar="DIR",
                   help="spool the serve run's telemetry (journal records, "
                        "metrics snapshots, workload sketches) to crash-"
                        "safe segments that `report` reads offline")
    p.add_argument("--aot-cache", default=None, metavar="DIR",
                   help="persistent compile cache root: not ported yet "
                        "(ROADMAP A.7), exits 2")
    p.add_argument("--no-aot-cache", action="store_true",
                   help="accepted and does nothing: the port has no compile "
                        "cache yet (ROADMAP A.7)")
    p.add_argument("--no-probe", action="store_true",
                   help="accepted and does nothing: the port probes no "
                        "backend (no fallback, by rule)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write a Chrome-trace JSON of the serve session's "
                        "host spans on exit")
    p.add_argument("--chaos-plan", default=None, metavar="FILE",
                   help="arm a chaos fault plan for this run (game day: "
                        "seeded fault injection at the named points, every "
                        "firing journaled; docs/chaos.md).  Default: "
                        "$NERRF_CHAOS_PLAN when set, else disarmed")
    p.add_argument("--profiler-port", type=int, default=-1,
                   help="serve GET /capture?seconds=S on this port (a "
                        "torch.profiler trace of the live pod, pulled by "
                        "`profile capture --target`; -1 disables)")
    p.add_argument("--profile-on-breach-sec", type=float, default=0.0,
                   help="with --flight-dir: embed this many seconds of "
                        "torch.profiler trace in every p99-breach bundle "
                        "(0 = off; keep it ≤ 2 s)")
    p.add_argument("--respond", action="store_true",
                   help="arm the online incident-response tier: alerts at "
                        "or above --respond-severity become incidents, "
                        "batched search-kernel waves emit undo plans, and "
                        "every plan is sandbox-verified before surfacing")
    p.add_argument("--respond-severity", type=float, default=0.5,
                   help="calibrated-severity admission floor for the "
                        "respond tier (0..1; the demux-boundary number "
                        "alert consumers also see)")
    p.add_argument("--respond-store", default=None, metavar="DIR",
                   help="snapshot store for plan verification; without it "
                        "every plan is quarantined unverified (fail "
                        "closed)")
    p.add_argument("--respond-snapshot", default=None, metavar="ID",
                   help="manifest id in --respond-store to verify against "
                        "(default: the latest)")
    p.add_argument("--respond-root", default=None, metavar="DIR",
                   help="live tree the verified plans would roll back "
                        "(rehearsals run on a clone, never on this tree)")
    _add_device(p)
    p.set_defaults(fn=cmd_serve_detect)

    p = sub.add_parser("respond",
                       help="incident-response corpus end to end: stage "
                            "adversarial families on disk, detect, plan "
                            "in batched search-kernel waves, sandbox-verify "
                            "every plan")
    p.add_argument("--family", action="append", default=None,
                   help="attack family to stage (repeatable; default all: "
                        "mass-rename, exfil-staging, cron-persistence, "
                        "log-tamper)")
    p.add_argument("--seed", type=int, default=0,
                   help="deterministic corpus seed (same seed = same "
                        "victims, same damage, same trace)")
    p.add_argument("--files", type=int, default=6,
                   help="victim files per family")
    p.add_argument("--sims", type=int, default=96,
                   help="MCTS simulation budget per batched search")
    p.add_argument("--no-verify", action="store_true",
                   help="skip sandbox verification (throughput probing "
                        "only — plans surface UNVERIFIED)")
    p.add_argument("--work-dir", default=None, metavar="DIR",
                   help="where victim trees + snapshots are staged "
                        "(default: a fresh temp dir)")
    _add_device(p)
    p.set_defaults(fn=cmd_respond)

    p = sub.add_parser("chaos", help="chaos plane: fault-point catalog, "
                                     "plan validation, example schedule "
                                     "(docs/chaos.md)")
    chsub = p.add_subparsers(dest="chaos_cmd", required=True)
    chp = chsub.add_parser("sites", help="list every armed-able fault "
                                         "point and what it simulates")
    chp.add_argument("--json", action="store_true",
                     help="machine-readable catalog")
    chp.set_defaults(fn=cmd_chaos)
    chp = chsub.add_parser("validate", help="parse + validate a plan "
                                            "file; exit 1 when invalid")
    chp.add_argument("plan", help="fault plan JSON "
                                  "(see `chaos example`)")
    chp.set_defaults(fn=cmd_chaos)
    chp = chsub.add_parser("example", help="print a commented-by-shape "
                                           "example plan to stdout")
    chp.set_defaults(fn=cmd_chaos)

    p = sub.add_parser("quality", help="detection-quality plane: reference "
                                       "profiles and drift tables "
                                       "(docs/quality.md)")
    qsub = p.add_subparsers(dest="quality_cmd", required=True)
    qp = qsub.add_parser("show", help="render a reference profile "
                                      "(checkpoint dir or profile JSON) "
                                      "or a flight bundle's live "
                                      "divergence table")
    qp.add_argument("path", help="checkpoint dir / quality_profile.json / "
                                 "flight bundle dir")
    qp.add_argument("--json", action="store_true",
                    help="machine-readable output")
    qp.set_defaults(fn=cmd_quality)
    qp = qsub.add_parser("compare", help="PSI two reference profiles: "
                                         "score distribution, top-"
                                         "drifting features, margin/"
                                         "alert-rate deltas")
    qp.add_argument("reference", help="the baseline profile "
                                      "(checkpoint dir or JSON)")
    qp.add_argument("other", help="the profile to judge against it")
    qp.add_argument("--json", action="store_true",
                    help="machine-readable output")
    qp.add_argument("--psi-threshold", type=float, default=None,
                    metavar="X", help="exit 1 when any PSI >= X "
                                      "(CI gating)")
    qp.set_defaults(fn=cmd_quality)


    _unported_parser(sub, "cache")

    p = sub.add_parser("profile", help="device-efficiency plane: per-"
                                       "program cost/MFU table, "
                                       "torch.profiler capture "
                                       "(docs/device-efficiency.md)")
    psub = p.add_subparsers(dest="profile_cmd", required=True)
    pp = psub.add_parser("costs", help="per-program cost table: analytic "
                                       "FLOPs / byte floor / roofline "
                                       "intensity for the serve ladder + "
                                       "the train step; --measure adds "
                                       "timed calls → measured MFU (null "
                                       "off the card, never fabricated)")
    pp.add_argument("--model-dir", default=None,
                    help="checkpoint whose programs to cost (default: the "
                         "untrained small detector — shapes are what "
                         "matter)")
    pp.add_argument("--buckets", nargs="*", default=None, metavar="NxExS",
                    help="capacity-bucket ladder (default: the serve "
                         "ladder)")
    pp.add_argument("--smoke", action="store_true",
                    help="one tiny bucket (64n/128e/32s)")
    pp.add_argument("--measure", type=int, default=0, metavar="N",
                    help="time N real calls per bucket after one untimed "
                         "call (the measured-MFU column; 0 = analytic only)")
    pp.add_argument("--cross-check", action="store_true",
                    help="also record torch.profiler's FLOP count and the "
                         "kernel seconds of one real call per program on "
                         "the card (recorded as cross-check, never the MFU "
                         "numerator; null on the CPU)")
    pp.add_argument("--no-train", action="store_true",
                    help="skip the train-step row")
    pp.add_argument("--json", action="store_true")
    pp.add_argument("--no-probe", action="store_true",
                    help="accepted and does nothing: the port probes no "
                         "backend (no fallback, by rule)")
    _add_device(pp)
    pp.set_defaults(fn=cmd_profile)
    pp = psub.add_parser("capture", help="capture a torch.profiler trace "
                                         "(Perfetto/TensorBoard readable): "
                                         "drive the serve ladder locally, "
                                         "or pull one from a live service's "
                                         "--profiler-port")
    pp.add_argument("--out", required=True, metavar="DIR",
                    help="trace output directory")
    pp.add_argument("--seconds", type=float, default=3.0,
                    help="capture duration")
    pp.add_argument("--target", default=None, metavar="HOST:PORT",
                    help="a live service's --profiler-port endpoint "
                         "(GET /capture)")
    pp.add_argument("--model-dir", default=None,
                    help="checkpoint to drive in local mode")
    pp.add_argument("--buckets", nargs="*", default=None, metavar="NxExS")
    pp.add_argument("--smoke", action="store_true",
                    help="one tiny bucket (fast local capture)")
    pp.add_argument("--no-probe", action="store_true",
                    help="accepted and does nothing: the port probes no "
                         "backend (no fallback, by rule)")
    _add_device(pp)
    pp.set_defaults(fn=cmd_profile)

    p = sub.add_parser("trace", help="per-stage latency table from a "
                                     "--trace-out Chrome-trace file")
    p.add_argument("--file", required=True,
                   help="Chrome-trace JSON produced by --trace-out (or any "
                        "trace-event file)")
    p.set_defaults(fn=cmd_trace)

    _unported_parser(sub, "lint")

    p = sub.add_parser("archive", help="telemetry archive: segment "
                                       "inventory, retention prune, "
                                       "integrity verify, cross-host "
                                       "merge, tune-corpus export "
                                       "(docs/archive.md)")
    asub = p.add_subparsers(dest="archive_cmd", required=True)
    ar = asub.add_parser("ls", help="segment inventory (name, bytes, "
                                    "sealed/open), oldest first")
    ar.add_argument("dir", help="archive directory (a serve/train run's "
                                "--archive-dir)")
    ar.set_defaults(fn=cmd_archive)
    ar = asub.add_parser("prune", help="enforce a retention bound now: "
                                       "delete oldest sealed segments "
                                       "past --max-bytes")
    ar.add_argument("dir")
    ar.add_argument("--max-bytes", type=int, required=True,
                    help="total archive size to prune down to")
    ar.set_defaults(fn=cmd_archive)
    ar = asub.add_parser("verify", help="integrity check every segment "
                                        "(a torn final line is the "
                                        "tolerated crash shape; mid-"
                                        "segment damage exits 1)")
    ar.add_argument("dir")
    ar.add_argument("--json", action="store_true")
    ar.set_defaults(fn=cmd_archive)
    ar = asub.add_parser("merge", help="merge N archive directories into "
                                       "a fresh one (cross-host "
                                       "aggregation: records interleave "
                                       "by time, sketches stay "
                                       "attributable per run)")
    ar.add_argument("sources", nargs="+", help="archive directories to "
                                               "merge")
    ar.add_argument("--out", required=True, help="merged archive "
                                                 "directory (created)")
    ar.set_defaults(fn=cmd_archive)
    ar = asub.add_parser("export", help="emit the tune-ready corpus: the "
                                        "observed window-size "
                                        "distribution + per-bucket "
                                        "measured cost table the `nerrf "
                                        "tune` cost-model fit consumes")
    ar.add_argument("dir")
    ar.add_argument("--tune", action="store_true",
                    help="the cost-model corpus (the default export; "
                         "the flag names the schema)")
    ar.add_argument("--replay", action="store_true",
                    help="read `dir` as a learn-plane replay buffer "
                         "instead: lower its scored windows (with "
                         "disposition labels joined by trace_id) into "
                         "deterministic, seedable training batches "
                         "(docs/learning.md)")
    ar.add_argument("--seed", type=int, default=0,
                    help="replay shuffle/batch seed (same buffer + same "
                         "seed = bit-identical batches)")
    ar.add_argument("--limit", type=int, default=None,
                    help="cap the replay windows lowered (applied after "
                         "the seeded shuffle)")
    ar.add_argument("--batch-size", type=int, default=8,
                    help="replay batch size (inventory only — the "
                         "trainer slices its own)")
    ar.add_argument("--bucket", default=None, metavar="N,E,S",
                    help="padded shape to lower replay windows into "
                         "(default: the bucket stamped in the buffer's "
                         "first record)")
    ar.add_argument("--out", default=None, metavar="FILE",
                    help="write the corpus JSON (or, with --replay, the "
                         "stacked dataset .npz) here instead of stdout")
    ar.set_defaults(fn=cmd_archive)


    p = sub.add_parser("alerts", help="operator feedback on served "
                                      "alerts: tp/fp dispositions that "
                                      "join the replay buffer's label "
                                      "stream (docs/learning.md)")
    alsub = p.add_subparsers(dest="alerts_cmd", required=True)
    al = alsub.add_parser("label", help="record one disposition by "
                                        "trace_id (journal record + "
                                        "replay-buffer sidecar)")
    al.add_argument("trace_id", help="the alert's trace_id (alert "
                                     "records, `nerrf doctor` timeline)")
    al.add_argument("label", choices=["tp", "fp"],
                    help="true positive (the window really was an "
                         "attack) or false positive")
    al.add_argument("--note", default=None,
                    help="free-text context stored with the disposition")
    al.add_argument("--replay-dir", default="replay-buffer", metavar="DIR",
                    help="the replay buffer whose sidecar receives the "
                         "label (default: ./replay-buffer)")
    al.set_defaults(fn=cmd_alerts)

    p = sub.add_parser("tune", help="fit a learned bucket ladder + "
                                    "per-rung kernel routing from an "
                                    "archived cost corpus; emits the "
                                    "tuned-ladder artifact serve-detect "
                                    "--tuned consumes (docs/tuning.md)")
    p.add_argument("corpus", help="tune corpus JSON (`archive export "
                                  "--tune --out`) or an archive directory "
                                  "to export inline")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="write the tuned-ladder artifact here (default: "
                        "print to stdout)")
    p.add_argument("--model-dir", default=None, metavar="DIR",
                   help="checkpoint whose architecture sizes the cost "
                        "model and whose analytic devtime surface anchors "
                        "thin buckets (default: the stock detector "
                        "config, measurements only)")
    p.add_argument("--max-rungs", type=int, default=None,
                   help="rung-count bound for the ladder search "
                        "(default: the static ladder's graph-rung count)")
    p.add_argument("--kernel-bench", default=None, metavar="FILE",
                   help="kernel microbenchmark artifact whose measured "
                        "dense/fused crossover calibrates the routing "
                        "prior (default: none; the reference's authored "
                        "constant, named in the artifact's provenance)")
    p.add_argument("--json", action="store_true",
                   help="print the artifact JSON even with --out")
    p.set_defaults(fn=cmd_tune)

    p = sub.add_parser("report", help="offline fleet report over archived "
                                      "telemetry: SLO/capacity/drift/"
                                      "efficiency/train health from "
                                      "segments alone; --compare diffs "
                                      "two runs (docs/archive.md)")
    p.add_argument("dir", nargs="*", default=[],
                   help="archive director(ies) — multiple dirs merge "
                        "into one report")
    p.add_argument("--compare", nargs=2, default=None,
                   metavar=("BASELINE", "CANDIDATE"),
                   help="diff two archive dirs and exit 1 when the "
                        "candidate regressed (p99, breach/drop rate, "
                        "per-bucket device cost, drift, train loss)")
    p.add_argument("--gate", action="store_true",
                   help="continuous-regression framing for --compare: "
                        "one-line GATE PASS/FAIL verdict, and a missing "
                        "baseline passes with a note (first run before "
                        "an artifact-of-record is banked)")
    from nerrf_tpu_torch.archive.report import CompareConfig as _CmpCfg
    p.add_argument("--p99-ratio", type=float,
                   default=_CmpCfg.p99_ratio, metavar="R",
                   help="flag when candidate e2e p99 > baseline ×R "
                        "(default %(default)s)")
    p.add_argument("--cost-ratio", type=float,
                   default=_CmpCfg.cost_ratio, metavar="R",
                   help="flag when per-bucket device seconds/batch > "
                        "baseline ×R (default %(default)s)")
    p.add_argument("--loss-ratio", type=float,
                   default=_CmpCfg.loss_ratio, metavar="R",
                   help="flag when final train loss > baseline ×R "
                        "(default %(default)s)")
    p.add_argument("--rate-abs", type=float,
                   default=_CmpCfg.rate_abs, metavar="A",
                   help="flag when breach/drop rate > baseline +A "
                        "(default %(default)s)")
    p.add_argument("--psi-breach", type=float,
                   default=_CmpCfg.psi_breach, metavar="P",
                   help="flag when score-drift PSI crosses P in the "
                        "candidate only (default %(default)s)")
    p.add_argument("--since", type=float, default=None, metavar="UNIX",
                   help="only records at/after this unix timestamp")
    p.add_argument("--until", type=float, default=None, metavar="UNIX",
                   help="only records at/before this unix timestamp")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report")
    p.set_defaults(fn=cmd_report)


    p = sub.add_parser("doctor", help="diagnose the environment, read a "
                                      "flight-recorder incident bundle, "
                                      "or report over a telemetry "
                                      "archive directory")
    p.add_argument("bundle", nargs="?", default=None,
                   help="flight bundle directory (bundle-<utc>-<trigger>): "
                        "print the incident timeline + per-stage "
                        "attribution offline; or a telemetry archive "
                        "directory: its report; omit for the environment "
                        "doctor (not ported: exits 2)")
    p.add_argument("--tail", type=int, default=None,
                   help="only the last N journal records of the timeline")
    p.add_argument("--build", action="store_true",
                   help="also build missing native libraries (env mode)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable summary")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("ingest", help="drain a tracker into a trace store")
    p.add_argument("--target", required=True, help="tracker host:port")
    p.add_argument("--store-dir", required=True)
    p.add_argument("--bucket-sec", type=float, default=30.0)
    p.add_argument("--max-events", type=int, default=0)
    p.add_argument("--timeout", type=float, default=30.0)
    p.add_argument("--follow", action="store_true",
                   help="reconnect and keep draining forever (daemon mode)")
    p.add_argument("--reconnect-sec", type=float, default=2.0)
    p.add_argument("--flush-sec", type=float, default=5.0,
                   help="durability flush cadence (seconds)")
    p.add_argument("--metrics-port", type=int, default=9091,
                   help="Prometheus /metrics port (-1 disables). Default "
                        "9091 so serve (9090) + ingest coexist on one host; "
                        "the K8s ingest pod passes 9090 explicitly")
    p.set_defaults(fn=cmd_ingest)
    return ap


def _unported_parser(sub, name: str) -> None:
    """The reference's entry for ``name``, which takes any arguments and
    refuses (:func:`_refusal`)."""
    ref_help, what, item = UNPORTED_COMMANDS[name]
    p = sub.add_parser(name, help=ref_help,
                       description=f"Needs {what}: not ported yet "
                                   f"(ROADMAP {item}); exits 2.")
    p.set_defaults(fn=None)


# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = build_parser()
    args, rest = ap.parse_known_args(argv)
    refusal = _refusal(args)
    if refusal:
        _log(refusal)
        return 2
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    trace_out = getattr(args, "trace_out", None)
    if trace_out:
        # enable BEFORE the command body: hot loops open per-step synced
        # spans only when the tracer is enabled.  Clear first so the file
        # holds THIS command's spans (embedded callers may run several
        # commands in one process), and restore the previous state after —
        # --trace-out on one command must not leave later commands paying
        # the per-step sync.
        from nerrf_tpu_torch import tracing

        prev_enabled = tracing.DEFAULT_TRACER.enabled
        tracing.DEFAULT_TRACER.clear()
        tracing.set_enabled(True)
    try:
        return args.fn(args)
    finally:
        if trace_out:
            tracing.set_enabled(prev_enabled)
            try:
                path = tracing.DEFAULT_TRACER.write(trace_out)
            except OSError as e:
                # must not mask the command's own outcome with a write
                # failure at the very end of a long run
                _log(f"could not write trace to {trace_out}: {e}")
            else:
                _log(f"{len(tracing.DEFAULT_TRACER.records())} spans "
                     f"written to {path} — inspect with `trace --file "
                     f"{path}` or load in Perfetto/chrome://tracing")


if __name__ == "__main__":
    raise SystemExit(main())
