"""The nerrf command-line interface, on the card.

The port of ``nerrf_tpu/cli.py``: the same subcommands, flags, defaults,
artifacts and exit codes over the port's paths.  Usage:

    python -m nerrf_tpu_torch.cli simulate       --incident DIR [--files N]
    python -m nerrf_tpu_torch.cli train-detector --model-dir DIR [--steps N]
    python -m nerrf_tpu_torch.cli undo           --incident DIR [--model-dir DIR]
                                                 [--dry-run] [--no-gate]
    python -m nerrf_tpu_torch.cli status         --incident DIR

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
        learning_rate=3e-3, warmup_steps=min(30, args.steps // 5))
    if args.ckpt_every > 0:
        from nerrf_tpu_torch.train.elastic import train_elastic

        res = train_elastic(
            train_ds, eval_ds, train_cfg,
            ckpt_dir=Path(args.model_dir) / "train_state",
            save_every=args.ckpt_every, log=_log, device=dev)
    else:
        res = train_nerrfnet(train_ds, eval_ds, train_cfg, log=_log, device=dev)
    if not res.metrics:
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


def _load_any_trace(path: str, ground_truth=None):
    from nerrf_tpu_torch.data.datasets import load_trace_csv, load_trace_parquet
    from nerrf_tpu_torch.data.loaders import load_trace_jsonl

    p = Path(path)
    if p.suffix == ".csv":
        return load_trace_csv(p, ground_truth=ground_truth)
    if p.suffix == ".parquet":
        return load_trace_parquet(p, ground_truth=ground_truth)
    return load_trace_jsonl(p, ground_truth=ground_truth)


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
    """The online detection pod: admit N concurrent Tracker streams, window
    each, and score cross-stream micro-batches through one warmed forward a
    capacity bucket on the card (nerrf_tpu_torch/serve).  Streams come from
    --target endpoints (live trackers) and/or --trace files (each served
    through an in-process TraceReplayServer, so the full wire protocol is
    exercised either way).  Readiness (/readyz on the metrics port) flips
    only after every configured bucket is warm."""
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

    if args.model_dir:
        from nerrf_tpu_torch.train.checkpoint import load_calibration

        model = _load_model(args.model_dir, dev)
        calib = load_calibration(args.model_dir)
        if calib.get("node_threshold") is not None:
            cfg = _dc.replace(cfg, threshold=calib["node_threshold"])
    else:
        _log("no --model-dir: serving an UNTRAINED small detector "
             "(load testing only — scores carry no meaning)")
        model = init_untrained_model(JointConfig().small, cfg, device=dev)

    service = OnlineDetectionService(model, cfg=cfg, device=dev)
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
    finally:
        if responder is not None:
            responder.stop()
        service.stop()
        for rs in replays:
            rs.stop()
        if metrics:
            metrics.close()


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
    "models": ("model lifecycle registry: publish, list, promote, rollback, "
               "status", "the model registry", "A.6"),
    "chaos": ("chaos plane: fault-point catalog, plan validation, example "
              "schedule (docs/chaos.md)", "the chaos plane's fault points",
              "A.6"),
    "quality": ("detection-quality plane: reference profiles and drift "
                "tables (docs/quality.md)", "the detection-quality plane",
                "A.6"),
    "cache": ("persistent compile cache: list, prune, verify, pre-warm",
              "the compile cache (a capture cache of CUDA graphs)", "A.7"),
    "profile": ("device-efficiency plane: per-program cost/MFU table, jax "
                "profiler capture (docs/device-efficiency.md)",
                "the device-time plane", "A.6"),
    "lint": ("static analysis over nerrf_tpu's own ASTs (purity, recompile, "
             "sync, lock discipline, the concurrency tier, metrics "
             "contract); --deep adds the jaxpr-level program contracts",
             "the analysis rules over the port", "A.7"),
    "archive": ("telemetry archive: segment inventory, retention prune, "
                "integrity verify, cross-host merge, tune-corpus export "
                "(docs/archive.md)", "the telemetry archive", "A.6"),
    "alerts": ("operator feedback on served alerts: tp/fp dispositions that "
               "join the replay buffer's label stream (docs/learning.md)",
               "the learn plane", "A.6"),
    "tune": ("fit a learned bucket ladder + per-rung kernel routing from an "
             "archived cost corpus; emits the tuned-ladder artifact "
             "serve-detect --tuned and the AOT re-export consume "
             "(docs/tuning.md)", "the ladder tuner", "A.6"),
    "report": ("offline fleet report over archived telemetry: SLO/capacity/"
               "drift/efficiency/train health from segments alone; --compare "
               "diffs two runs (docs/archive.md)",
               "the telemetry archive's report", "A.6"),
    "doctor": ("diagnose the environment, read a flight-recorder incident "
               "bundle, or report over a telemetry archive directory",
               "the flight recorder's doctor", "A.6"),
}

# (subcommand, flag, is it asked for?, what it needs, ROADMAP item)
UNPORTED_FLAGS = (
    ("train-detector", "--publish", lambda a: a.publish is not None,
     "the model registry", "A.6"),
    ("train-detector", "--aot-cache", lambda a: a.aot_cache is not None,
     "the compile cache", "A.7"),
    ("train-detector", "--metrics-port", lambda a: a.metrics_port >= 0,
     "trainwatch.training_health", "A.6"),
    ("train-detector", "--flight-dir", lambda a: a.flight_dir is not None,
     "the training flight recorder", "A.6"),
    ("train-detector", "--archive-dir", lambda a: a.archive_dir is not None,
     "the telemetry archive", "A.6"),
    ("serve-detect", "--registry", lambda a: a.registry is not None,
     "the model registry", "A.6"),
    ("serve-detect", "--tuned", lambda a: a.tuned is not None,
     "the ladder tuner", "A.6"),
    ("serve-detect", "--flight-dir", lambda a: a.flight_dir is not None,
     "the flight recorder", "A.6"),
    ("serve-detect", "--archive-dir", lambda a: a.archive_dir is not None,
     "the telemetry archive", "A.6"),
    ("serve-detect", "--chaos-plan", lambda a: a.chaos_plan is not None,
     "the chaos plane's fault points", "A.6"),
    ("serve-detect", "$NERRF_CHAOS_PLAN",
     lambda a: bool(os.environ.get("NERRF_CHAOS_PLAN")),
     "the chaos plane's fault points", "A.6"),
    ("serve-detect", "--profiler-port", lambda a: a.profiler_port >= 0,
     "the device-time plane's profiler server", "A.6"),
    ("serve-detect", "--profile-on-breach-sec",
     lambda a: a.profile_on_breach_sec > 0,
     "the flight recorder's profiler capture", "A.6"),
    ("serve-detect", "--aot-cache", lambda a: a.aot_cache is not None,
     "the compile cache", "A.7"),
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
                   help="publish into a model registry: not ported yet "
                        "(ROADMAP A.6), exits 2")
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
                        "port (-1 disables): ≥ 0 needs "
                        "trainwatch.training_health, not ported yet "
                        "(ROADMAP A.6), exits 2")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="the training flight recorder: not ported yet "
                        "(ROADMAP A.6), exits 2")
    p.add_argument("--archive-dir", default=None, metavar="DIR",
                   help="the telemetry archive: not ported yet (ROADMAP "
                        "A.6), exits 2")
    _add_device(p)
    p.set_defaults(fn=cmd_train_detector)

    _unported_parser(sub, "models")

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
                   help="model registry root: not ported yet (ROADMAP A.6), "
                        "exits 2")
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
                   help="tuned-ladder artifact: not ported yet (ROADMAP "
                        "A.6), exits 2")
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
                   help="the incident flight recorder: not ported yet "
                        "(ROADMAP A.6), exits 2")
    p.add_argument("--archive-dir", default=None, metavar="DIR",
                   help="the telemetry archive: not ported yet (ROADMAP "
                        "A.6), exits 2")
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
                   help="arm a chaos fault plan: not ported yet (ROADMAP "
                        "A.6), exits 2, as does $NERRF_CHAOS_PLAN when set")
    p.add_argument("--profiler-port", type=int, default=-1,
                   help="a profiler server on this port: not ported yet "
                        "(ROADMAP A.6), exits 2 when ≥ 0")
    p.add_argument("--profile-on-breach-sec", type=float, default=0.0,
                   help="profiler trace in p99-breach bundles: not ported "
                        "yet (ROADMAP A.6), exits 2 when > 0")
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

    for name in ("chaos", "quality", "cache", "profile"):
        _unported_parser(sub, name)

    p = sub.add_parser("trace", help="per-stage latency table from a "
                                     "--trace-out Chrome-trace file")
    p.add_argument("--file", required=True,
                   help="Chrome-trace JSON produced by --trace-out (or any "
                        "trace-event file)")
    p.set_defaults(fn=cmd_trace)

    for name in ("lint", "archive", "alerts", "tune", "report", "doctor"):
        _unported_parser(sub, name)

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
