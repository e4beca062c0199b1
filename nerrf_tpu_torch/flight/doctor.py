"""Offline bundle reader: `nerrf doctor <bundle>`.

A host copy of ``nerrf_tpu/flight/doctor.py``, kept identical but for
the profiler capture's directory, which the manifest names.

Reconstructs an incident from a flight-recorder bundle alone — no live
process, no scrape history.  The report has four sections:

  1. header — trigger, reason, when, environment + model lineage at dump;
  2. incident timeline — the journal tail, one line per record, timed
     relative to the bundle's creation (negative = before the trigger);
  3. compile provenance — every ``compile`` journal record (program,
     cache/fresh/live source, seconds, fingerprint, miss reason), so a
     slow-boot incident is diagnosable offline: a ladder that compiled
     fresh when a populated cache volume was mounted is a cache-key or
     corruption problem, visible right here without chip access;
  4. per-stage attribution — `nerrf trace`'s latency table over the
     bundled span ring (the same Chrome-trace file loads in Perfetto);
  5. SLO state — per-stream trailing p50/p99/breaches and budget burn
     from the manifest's SLO snapshot, exemplar trace IDs included;
  6. detection quality — the embedded ``quality.json`` (live trailing
     sketches + the reference profile): per-stream score PSI and
     alert-rate z, top-drifting window features, calibration margin mass
     vs the reference — a ``quality_drift`` bundle is analyzable without
     the pod, and any other bundle answers "was the model drifting";
  7. training health — the journal tail's ``train_start`` /
     ``train_health`` records (loss, grad norm, update ratio,
     throughput, data-wait, nonfinite flags) plus, for ``train_*``
     triggers, the manifest context's loss tail and last-good-checkpoint
     restart pointer (docs/training-health.md).  Serve-side bundles
     degrade to one line.
  8. fleet — the controller's decision tail (``fleet_scale`` /
     ``fleet_rebalance`` / ``fleet_shed`` journal records) with the
     per-replica headroom evidence each scale decision carried
     (docs/fleet.md).  Single-replica bundles degrade to one line.

Unreadable pieces degrade per-section (a bundle written mid-crash may
lack a file) — partial evidence beats no report.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from nerrf_tpu_torch.flight.journal import JournalRecord, load_journal

REQUIRED_FILES = ("manifest.json", "journal.jsonl", "trace.json",
                  "metrics.prom")


def read_bundle(path) -> dict:
    """Load a bundle directory → {"manifest", "records", "events",
    "metrics", "missing"}.  Raises FileNotFoundError only when ``path``
    is not a bundle at all (no manifest)."""
    root = os.fspath(path)
    manifest_path = os.path.join(root, "manifest.json")
    if not os.path.isfile(manifest_path):
        raise FileNotFoundError(
            f"{root} is not a flight bundle (no manifest.json)")
    with open(manifest_path) as f:
        manifest = json.load(f)
    out = {"manifest": manifest, "records": [], "events": [],
           "metrics": "", "missing": []}
    jpath = os.path.join(root, "journal.jsonl")
    if os.path.isfile(jpath):
        out["records"] = load_journal(jpath)
    else:
        out["missing"].append("journal.jsonl")
    tpath = os.path.join(root, "trace.json")
    if os.path.isfile(tpath):
        try:
            from nerrf_tpu_torch.tracing import load_chrome_trace

            out["events"] = load_chrome_trace(tpath)
        except (OSError, ValueError):
            out["missing"].append("trace.json")
    else:
        out["missing"].append("trace.json")
    mpath = os.path.join(root, "metrics.prom")
    if os.path.isfile(mpath):
        with open(mpath) as f:
            out["metrics"] = f.read()
    else:
        out["missing"].append("metrics.prom")
    # optional embedded torch.profiler capture (the flight recorder's
    # opt-in profile_on_p99_sec action), in the dir the manifest names:
    # inventory only — the trace itself loads in Perfetto/TensorBoard,
    # not here.  trace_summary imports no torch and devtime's package
    # init is lazy, so the offline doctor stays light
    from nerrf_tpu_torch.devtime.capture import trace_summary

    pdir = (manifest.get("profile") or {}).get("dir")
    out["profile"] = (trace_summary(os.path.join(root, pdir))
                      if pdir else None)
    # optional embedded quality snapshot (live drift sketches + reference
    # profile) — bundles from profile-less versions simply lack it
    out["quality"] = None
    qpath = os.path.join(root, "quality.json")
    if os.path.isfile(qpath):
        try:
            with open(qpath) as f:
                out["quality"] = json.load(f)
        except (OSError, ValueError):
            out["missing"].append("quality.json")
    return out


def _fmt_record(rec: JournalRecord, t0_wall: float) -> str:
    dt = rec.t_wall - t0_wall
    who = rec.stream or "-"
    if rec.window_id is not None:
        who += f"/w{rec.window_id}"
    extras = " ".join(
        f"{k}={_compact(v)}" for k, v in sorted(rec.data.items()))
    tid = f" [{rec.trace_id}]" if rec.trace_id else ""
    return (f"  #{rec.seq:<6} {dt:+9.3f}s  {rec.kind:<18} "
            f"{who:<16}{tid} {extras}").rstrip()


def _compact(v) -> str:
    if isinstance(v, float):
        return f"{v:g}"
    if isinstance(v, (list, tuple)):
        return ",".join(str(x) for x in v[:6]) + ("…" if len(v) > 6 else "")
    if isinstance(v, dict):
        return "{" + ",".join(f"{k}:{_compact(x)}"
                              for k, x in sorted(v.items())) + "}"
    s = str(v)
    return s if len(s) <= 60 else s[:57] + "…"


def compile_provenance(records: List[JournalRecord]) -> List[dict]:
    """Every compile-cache resolution in the journal, in order: [{program,
    source, seconds, fingerprint, reason}, ...].  ``source`` is "cache"
    (deserialized — no tracing), "fresh" (compiled live, persisted) or
    "live" (uncached fallback); ``reason`` carries the miss/fallback cause
    when there was one."""
    return [{"program": r.data.get("program"),
             "source": r.data.get("source"),
             "seconds": r.data.get("seconds"),
             "fingerprint": r.data.get("fingerprint"),
             "reason": r.data.get("reason")}
            for r in records if r.kind == "compile"]


def format_report(bundle: dict, tail: Optional[int] = None) -> str:
    man = bundle["manifest"]
    lines: List[str] = []
    lines.append(f"flight bundle: trigger={man.get('trigger')} "
                 f"at {man.get('created_utc')}")
    lines.append(f"  reason: {man.get('reason')}")
    ctx = man.get("context") or {}
    if ctx:
        lines.append("  context: " + " ".join(
            f"{k}={_compact(v)}" for k, v in sorted(ctx.items())))
    env = man.get("env") or {}
    if env:
        lines.append(
            "  env: python %s, %s, backend=%s, pid=%s"
            % (env.get("python"), env.get("platform"),
               env.get("jax_backend", "n/a"), env.get("pid")))
    lineage = man.get("lineage")
    if lineage:
        lines.append("  model: " + " ".join(
            f"{k}={_compact(v)}" for k, v in sorted(lineage.items())))
    arch = man.get("archive")
    if arch:
        seqs = arch.get("journal_seq") or {}
        lines.append(
            f"  archive context: {arch.get('dir')}/"
            f"{arch.get('segment') or '(no segment yet)'}"
            + (f" seq {seqs.get('lo')}..{seqs.get('hi')}" if seqs else "")
            + " — `nerrf report <dir>` reads the whole run around "
              "this bundle")
    if bundle["missing"]:
        lines.append("  MISSING from bundle: "
                     + ", ".join(bundle["missing"]))

    records = bundle["records"]
    if tail is not None:
        records = records[-tail:]
    lines.append("")
    seq = man.get("journal_seq") or {}
    lines.append(f"incident timeline ({len(records)} records, "
                 f"seq {seq.get('lo')}..{seq.get('hi')}; "
                 f"t relative to the trigger):")
    t0 = float(man.get("created_unix") or
               (records[-1].t_wall if records else 0.0))
    for rec in records:
        lines.append(_fmt_record(rec, t0))
    if not records:
        lines.append("  (no journal records)")

    compiles = compile_provenance(bundle["records"])
    if compiles:
        lines.append("")
        lines.append(f"compile provenance ({len(compiles)} resolutions; "
                     f"source=cache deserialized, fresh compiled+persisted, "
                     f"live uncached fallback):")
        lines.append(f"  {'program':<28} {'source':<7} {'seconds':>8}  "
                     f"{'fingerprint':<34} reason")
        for c in compiles:
            lines.append(
                f"  {str(c['program'] or '-'):<28} "
                f"{str(c['source'] or '-'):<7} "
                f"{_num(c['seconds']):>8}  "
                f"{str(c['fingerprint'] or '-'):<34} "
                f"{c['reason'] or '-'}".rstrip())

    prof = bundle.get("profile")
    if prof:
        man_prof = man.get("profile") or {}
        lines.append("")
        lines.append(
            f"profiler trace: {prof['files']} file(s), {prof['bytes']} "
            f"bytes in {man_prof['dir']}/"
            + (f" ({man_prof['seconds']:g}s capture on the breach)"
               if man_prof.get("seconds") else "")
            + " — load in Perfetto or TensorBoard")
    elif (man.get("profile") or {}).get("error"):
        lines.append("")
        lines.append(f"profiler trace: {man['profile']['error']}")

    lines.append("")
    if bundle["events"]:
        from nerrf_tpu_torch.tracing import format_stage_table

        lines.append("per-stage attribution (bundled span ring):")
        lines.append(format_stage_table(bundle["events"]))
    else:
        lines.append("per-stage attribution: no span events in bundle")

    slo = man.get("slo") or {}
    per_stream = slo.get("per_stream") or {}
    lines.append("")
    if per_stream:
        lines.append(f"SLO state (deadline {slo.get('deadline_sec')}s, "
                     f"trailing exact percentiles):")
        header = (f"  {'stream':<18} {'n':>6} {'p50_ms':>9} {'p99_ms':>9} "
                  f"{'breaches':>8}  worst")
        lines.append(header)
        for stream, s in sorted(per_stream.items()):
            worst = s.get("exemplar_trace_id") or "-"
            lines.append(
                f"  {stream:<18} {s.get('count', 0):>6} "
                f"{_num(s.get('p50_ms')):>9} {_num(s.get('p99_ms')):>9} "
                f"{s.get('breaches', 0):>8}  {worst} "
                f"({_num(s.get('exemplar_ms'))}ms)")
            burn = s.get("budget_burn") or {}
            if burn:
                lines.append("  " + " " * 18 + "burn: " + " ".join(
                    f"{k}={v:.0%}" for k, v in sorted(burn.items())))
    else:
        lines.append("SLO state: not recorded in manifest")

    lines.append("")
    lines.extend(quality_section(bundle.get("quality")))

    lines.append("")
    lines.extend(train_section(bundle))

    lines.append("")
    lines.extend(fleet_section(bundle))

    lines.append("")
    lines.extend(respond_section(bundle))

    lines.append("")
    lines.extend(learn_section(bundle))
    return "\n".join(lines)


#: journal kinds the training-health section reads
TRAIN_KINDS = ("train_start", "train_health", "train_done")


def train_section(bundle: dict) -> List[str]:
    """The training-health report over a bundle's journal tail + manifest
    (docs/training-health.md) — shared by `nerrf doctor` and the bench's
    offline-readability gate.  Degrades to one line on a serve-side
    bundle (no train records, non-train trigger): partial evidence beats
    a confusing empty table."""
    man = bundle.get("manifest") or {}
    trigger = str(man.get("trigger") or "")
    records = [r for r in bundle.get("records", [])
               if r.kind in TRAIN_KINDS]
    if not records and not trigger.startswith("train_"):
        return ["training health: no train records in bundle "
                "(serve-side bundle, or the run predates trainwatch)"]
    lines = ["training health:"]
    start = next((r for r in records if r.kind == "train_start"), None)
    if start is not None:
        lines.append(
            f"  run: config={start.data.get('config_fingerprint', '-')} "
            f"model={start.data.get('model_fingerprint', '-')} "
            f"steps={start.data.get('steps', '-')} "
            f"seed={start.data.get('seed', '-')}")
    health = [r for r in records if r.kind == "train_health"]
    if health:
        lines.append(f"  {'step':>8} {'loss':>12} {'grad_norm':>11} "
                     f"{'upd_ratio':>11} {'steps/s':>8} {'data_wait':>9} "
                     f"nonfinite")
        for r in health[-8:]:
            d = r.data
            nf = d.get("nonfinite") or {}
            lines.append(
                f"  {d.get('step', '-'):>8} {_num(d.get('loss')):>12} "
                f"{_num(d.get('grad_norm')):>11} "
                f"{_num(d.get('update_ratio')):>11} "
                f"{_num(d.get('steps_per_sec')):>8} "
                f"{_num(d.get('data_wait_fraction')):>9} "
                + (",".join(f"{k}×{v:g}" for k, v in sorted(nf.items()))
                   if nf else "-"))
    else:
        lines.append("  (no cadenced train_health records in the "
                     "journal tail)")
    if trigger.startswith("train_"):
        ctx = man.get("context") or {}
        lines.append(
            f"  trigger: {trigger} at step {ctx.get('step', '-')}  "
            f"last good checkpoint: "
            f"{ctx.get('last_good_checkpoint') or '-'}")
        tail = ctx.get("loss_tail") or []
        if tail:
            lines.append("  loss tail (newest last): " + " ".join(
                f"{e.get('step')}:{_num(e.get('loss'))}"
                for e in tail[-10:]))
    done = next((r for r in records if r.kind == "train_done"), None)
    if done is not None and done.data.get("halted"):
        lines.append(f"  halted: {done.data['halted']}")
    return lines


#: journal kinds the fleet section reads
FLEET_KINDS = ("fleet_scale", "fleet_rebalance", "fleet_shed")


def fleet_section(bundle: dict) -> List[str]:
    """The fleet-control report over a bundle's journal tail
    (docs/fleet.md): the controller's decision tail plus the per-replica
    headroom evidence the latest scale decision carried.  Degrades to
    one line on single-replica bundles — most pods never see a fleet
    decision, and an empty table would read as a broken controller."""
    records = [r for r in bundle.get("records", [])
               if r.kind in FLEET_KINDS]
    if not records:
        return ["fleet: no fleet records in bundle (single-replica pod, "
                "or the run predates the fleet control plane)"]
    lines = [f"fleet (controller decision tail, {len(records)} records):"]
    for r in records[-10:]:
        d = r.data
        if r.kind == "fleet_scale":
            ev = d.get("evidence") or {}
            lines.append(
                f"  scale {d.get('direction', '-'):<4} "
                f"{d.get('replica', '-'):<8} "
                f"{d.get('replicas_before', '-')}→"
                f"{d.get('replicas_after', '-')} replicas  "
                f"reason={d.get('reason', '-')} "
                f"worst_headroom={_num(ev.get('worst_headroom_streams'))}")
        elif r.kind == "fleet_rebalance":
            moved = d.get("moved") or []
            lines.append(
                f"  rebalance: {len(moved)} stream(s) moved "
                f"({_compact(moved)}) across "
                f"{len(d.get('replicas') or [])} replicas")
        else:  # fleet_shed
            lines.append(
                f"  shed {d.get('victim', r.stream) or '-'}: "
                f"burn={_num(d.get('burn_ratio'))} "
                f"reason={d.get('reason', '-')}")
    latest = next((r for r in reversed(records)
                   if r.kind == "fleet_scale"), None)
    per = ((latest.data.get("evidence") or {}).get("per_replica")
           if latest else None)
    if per:
        lines.append("  per-replica headroom at last scale decision: "
                     + " ".join(f"{k}={_num(v)}"
                                for k, v in sorted(per.items())))
    return lines


#: journal kinds the respond section reads
RESPOND_KINDS = ("incident_enqueued", "plan_emitted", "plan_verified",
                 "plan_rejected", "rollback_step_failed")


def respond_section(bundle: dict) -> List[str]:
    """The incident-response report over a bundle's journal tail
    (docs/response.md): queue admissions/evictions, the plan ledger
    (emitted vs verified vs rejected — every reject with its journaled
    quarantine reason), and any executor steps that failed closed.
    Degrades to one line when the respond tier never ran."""
    records = [r for r in bundle.get("records", [])
               if r.kind in RESPOND_KINDS]
    if not records:
        return ["respond: no incident-response records in bundle "
                "(tier not attached, or the run predates it)"]
    by = {k: [r for r in records if r.kind == k] for k in RESPOND_KINDS}
    dropped = [r for r in by["incident_enqueued"] if r.data.get("dropped")]
    lines = [
        f"respond (incident-response tail, {len(records)} records):",
        f"  incidents: {len(by['incident_enqueued']) - len(dropped)} "
        f"enqueued, {len(dropped)} evicted (queue_full); plans: "
        f"{len(by['plan_emitted'])} emitted → "
        f"{len(by['plan_verified'])} verified, "
        f"{len(by['plan_rejected'])} rejected"]
    for r in by["plan_rejected"][-5:]:
        lines.append(
            f"  rejected {r.stream or '-'} w{r.data.get('window_id', '-')}"
            f": {r.data.get('reason', '-')}")
    for r in by["rollback_step_failed"][-5:]:
        lines.append(
            f"  executor refused {r.data.get('rel', '-')}: "
            f"{r.data.get('reason', '-')}")
    latest = by["plan_verified"][-1] if by["plan_verified"] else None
    if latest:
        lines.append(
            f"  last verified plan: {latest.stream or '-'} "
            f"w{latest.data.get('window_id', '-')} "
            f"actions={latest.data.get('actions', '-')} "
            f"files_restored={latest.data.get('files_restored', '-')} "
            f"replay_ops={latest.data.get('replay_ops', '-')}")
    return lines


#: journal kinds the continuous-learning section reads
LEARN_KINDS = ("retrain_triggered", "retrain_done", "retrain_aborted",
               "alert_disposition")


def learn_section(bundle: dict) -> List[str]:
    """The continuous-learning report over a bundle's journal tail
    (docs/learning.md): the last drift trigger that armed the
    supervisor, every retrain's outcome, the provenance chain of the
    last published candidate (parent version → version, replay
    fingerprint), and operator disposition volume.  Degrades to one
    line on bundles without learn records."""
    records = [r for r in bundle.get("records", [])
               if r.kind in LEARN_KINDS]
    if not records:
        return ["learn: no continuous-learning records in bundle "
                "(supervisor not attached, or the run predates it)"]
    by = {k: [r for r in records if r.kind == k] for k in LEARN_KINDS}
    lines = [
        f"learn (continuous-learning tail, {len(records)} records):",
        f"  retrains: {len(by['retrain_triggered'])} triggered → "
        f"{len(by['retrain_done'])} published, "
        f"{len(by['retrain_aborted'])} aborted; "
        f"dispositions: {len(by['alert_disposition'])}"]
    last_trig = by["retrain_triggered"][-1] if by["retrain_triggered"] \
        else None
    if last_trig:
        lines.append(
            f"  last trigger: seq {last_trig.data.get('trigger_seq', '-')}"
            f" parent v{last_trig.data.get('parent_version', '-')} "
            f"replay {last_trig.data.get('replay_fingerprint', '-')}")
    for r in by["retrain_aborted"][-3:]:
        lines.append(
            f"  aborted (trigger seq {r.data.get('trigger_seq', '-')}): "
            f"{r.data.get('reason', '-')}")
    done = by["retrain_done"][-1] if by["retrain_done"] else None
    if done:
        lines.append(
            f"  last published: v{done.data.get('parent_version', '-')} "
            f"→ v{done.data.get('version', '-')} "
            f"(lineage {done.data.get('lineage', '-')}, replay "
            f"{done.data.get('replay_fingerprint', '-')}, "
            f"{_num(done.data.get('wall_sec'))}s, edge AUC "
            f"{_num(done.data.get('edge_auc'))}) — shadow/canary "
            f"decide promotion")
    return lines


def quality_section(quality: Optional[dict]) -> List[str]:
    """The drift report over an embedded ``quality.json`` snapshot — the
    live-divergence table `nerrf doctor` and `nerrf quality show` share.
    Degrades to one line when the bundle predates quality profiles."""
    if not quality:
        return ["detection quality: no quality.json in bundle "
                "(live version predates profiles, or the plane is off)"]
    ref = quality.get("reference") or {}
    lines = [
        f"detection quality (drift vs reference profile, "
        f"version {quality.get('version') or '-'}):",
        f"  reference: {ref.get('windows', 0)} windows / "
        f"{ref.get('node_scores', 0)} node scores, threshold "
        f"{_num(ref.get('threshold'))}, margin mass "
        f"{_num(ref.get('margin_mass'))} (eps {_num(ref.get('margin_eps'))})",
        f"  live: {quality.get('windows_observed', 0)} windows observed, "
        f"margin mass {_num(quality.get('margin_mass'))}",
    ]
    per_stream = quality.get("per_stream") or {}
    if per_stream:
        lines.append(f"  {'stream':<18} {'windows':>7} {'scores':>8} "
                     f"{'score_psi':>9} {'alert_z':>8}  p50/p90/p99")
        for stream, s in sorted(
                per_stream.items(),
                key=lambda kv: -(kv[1].get("score_psi") or 0.0)):
            q = s.get("score_quantiles") or {}
            lines.append(
                f"  {stream:<18} {s.get('windows', 0):>7} "
                f"{s.get('scores', 0):>8} {_num(s.get('score_psi')):>9} "
                f"{_num(s.get('alert_rate_z')):>8}  "
                f"{_num(q.get('p50'))}/{_num(q.get('p90'))}/"
                f"{_num(q.get('p99'))}")
    else:
        lines.append("  (no live streams sketched yet)")
    feats = quality.get("features") or {}
    drifting = sorted(((k, v.get("psi")) for k, v in feats.items()
                       if v.get("psi") is not None),
                      key=lambda t: -t[1])
    if drifting:
        lines.append("  top drifting features: " + ", ".join(
            f"{k}={v:g}" for k, v in drifting[:8]))
    return lines


def _num(v) -> str:
    return "-" if v is None else f"{v:g}"


def doctor_main(path, tail: Optional[int] = None, as_json: bool = False,
                out=print) -> int:
    """The `nerrf doctor <bundle>` body; returns a CLI exit code."""
    from nerrf_tpu_torch.flight.journal import SchemaVersionError

    try:
        bundle = read_bundle(path)
    except FileNotFoundError as e:
        out(str(e))
        return 2
    except SchemaVersionError as e:
        # a bundle written by a NEWER major journal schema: refuse with
        # one line rather than render re-defined fields wrong
        out(f"cannot read bundle {path}: {e}")
        return 2
    except (OSError, ValueError) as e:
        out(f"cannot read bundle {path}: {e}")
        return 2
    if as_json:
        out(json.dumps({
            "manifest": bundle["manifest"],
            "records": [r.to_dict() for r in bundle["records"]],
            "compile_provenance": compile_provenance(bundle["records"]),
            "span_events": len(bundle["events"]),
            "profile": bundle.get("profile"),
            "quality": bundle.get("quality"),
            "missing": bundle["missing"],
        }, indent=2))
    else:
        out(format_report(bundle, tail=tail))
    return 1 if bundle["missing"] else 0
