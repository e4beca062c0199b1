"""Offline fleet reports over archived telemetry — no live process.

A host copy of ``nerrf_tpu/archive/report.py``, kept identical.

`build_report` reconstructs the operator-facing summaries every live
plane exports — SLO conformance, capacity headroom, detection-quality
drift, device efficiency, training health, incident inventory — from
archive segments alone: the journal stream gives the events (breaches,
drops, quarantines, bundles, train health), the cumulative workload
sketches give the distributions (window sizes, stage latencies, device
seconds per program), and the cadenced metrics snapshots give the gauge
trajectories (headroom, MFU).  Sketches and totals are merged across
``run`` ids by count/sum addition — exact, so a report over a merged
multi-host archive is the same arithmetic as a single-host one.

`compare_reports` diffs two runs and flags regressions (`nerrf report
--compare A B` — the cross-run CI gate), and `export_tune` emits the
observed window-size distribution + per-bucket measured cost table the
future `nerrf tune` cost-model fit consumes (the TpuGraphs-style
dataset, arXiv:2308.13490: measured per-configuration cost over the
production workload distribution).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Tuple

from nerrf_tpu_torch.archive.spool import iter_records, list_segments

#: compare_reports default thresholds: (ratio regressions fire past ×R,
#: rate regressions past +abs).  Deliberately loose — a cross-run diff
#: on a noisy CPU rig must flag real regressions, not scheduler jitter.
#: Kept as module constants for callers that want the defaults by name;
#: `CompareConfig` is the tunable form (`nerrf report --compare` flags).
P99_REGRESSION_RATIO = 1.5
COST_REGRESSION_RATIO = 1.5
LOSS_REGRESSION_RATIO = 1.25
RATE_REGRESSION_ABS = 0.02
PSI_BREACH = 0.25


@dataclasses.dataclass(frozen=True)
class CompareConfig:
    """Tolerance knobs for `compare_reports` — one field per regression
    class, CLI-settable (`--p99-ratio` etc.) so a queue's gate can be
    tightened or loosened without editing code.  The thresholds used are
    stamped into the comparison output, so a gate failure names the bar
    it was judged against."""

    p99_ratio: float = P99_REGRESSION_RATIO      # e2e p99 ×R
    cost_ratio: float = COST_REGRESSION_RATIO    # device s/batch ×R
    loss_ratio: float = LOSS_REGRESSION_RATIO    # final train loss ×R
    rate_abs: float = RATE_REGRESSION_ABS        # breach/drop rate +abs
    psi_breach: float = PSI_BREACH               # score-drift PSI bar

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

_NAME_TAG = re.compile(r"^([a-z_]+)\[(.+)\]$")


def _merge_sketches(sketch_records: List[dict]) -> Tuple[dict, dict]:
    """Last cumulative sketch record per run, merged across runs by
    count/sum addition → ({name: Sketch}, {name: {count, sum}})."""
    from nerrf_tpu_torch.quality.sketch import Sketch

    last_per_run: Dict[tuple, dict] = {}
    for rec in sketch_records:  # segment order: later wins per run
        # keyed by (src, run): a merged archive keeps each source's runs
        # distinct even if two hosts ever minted the same run id
        last_per_run[(rec.get("src"), rec.get("run") or "?")] = rec
    sketches: Dict[str, object] = {}
    totals: Dict[str, dict] = {}
    for rec in last_per_run.values():
        data = rec.get("data") or {}
        for name, d in (data.get("sketches") or {}).items():
            try:
                sk = Sketch.from_dict(d)
            except (ValueError, KeyError, TypeError):
                continue
            have = sketches.get(name)
            sketches[name] = sk if have is None else have.merge(sk)
        for name, t in (data.get("totals") or {}).items():
            agg = totals.setdefault(name, {"count": 0, "sum": 0.0})
            agg["count"] += int(t.get("count") or 0)
            agg["sum"] += float(t.get("sum") or 0.0)
    return sketches, totals


def _tagged(mapping: dict, prefix: str) -> Dict[str, object]:
    """``{tag: value}`` for every ``prefix[tag]`` key in ``mapping``."""
    out = {}
    for name, v in mapping.items():
        m = _NAME_TAG.match(name)
        if m and m.group(1) == prefix:
            out[m.group(2)] = v
    return out


def _gauge_series(snapshots: List[dict], name: str) -> List[float]:
    """Every value of one (possibly labeled) gauge across the snapshot
    cadence, in time order — min/last trajectories for the report."""
    out = []
    for rec in snapshots:
        series = ((rec.get("data") or {}).get("gauges") or {}).get(name)
        if series:
            out.extend(float(v) for v in series.values())
    return out


def _q(sketch, qs=(0.5, 0.9, 0.99)) -> Optional[dict]:
    return None if sketch is None else sketch.quantiles(qs)


def _ms(q: Optional[dict]) -> Optional[dict]:
    if q is None:
        return None
    return {k: (None if v is None else round(v * 1e3, 2))
            for k, v in q.items()}


def build_report(paths, since: Optional[float] = None,
                 until: Optional[float] = None) -> dict:
    """The offline fleet report over one or more archive directories."""
    if isinstance(paths, (str,)) or hasattr(paths, "__fspath__"):
        paths = [paths]
    records = list(iter_records(paths, since=since, until=until))
    kinds: Dict[str, int] = {}
    by_kind: Dict[str, List[dict]] = {}
    for rec in records:
        k = str(rec.get("kind"))
        kinds[k] = kinds.get(k, 0) + 1
        by_kind.setdefault(k, []).append(rec)
    sketches, totals = _merge_sketches(by_kind.get("workload_sketch", []))
    snapshots = by_kind.get("metrics_snapshot", [])
    times = [r["t_wall"] for r in records if r.get("t_wall") is not None]
    segments = sum(len(list_segments(p)) for p in paths)
    runs = sorted({r.get("run") for r in records if r.get("run")})

    # -- SLO conformance ------------------------------------------------------
    windows = sum(t["count"] for n, t in totals.items()
                  if n.startswith("windows["))
    breaches = by_kind.get("slo_breach", [])
    breaches_by_stream: Dict[str, int] = {}
    for rec in breaches:
        s = rec.get("stream") or "?"
        breaches_by_stream[s] = breaches_by_stream.get(s, 0) + 1
    deadline = None
    for rec in by_kind.get("config", []):
        deadline = (rec.get("data") or {}).get("window_deadline_sec",
                                               deadline)
    slo = {
        "windows_scored": windows,
        "deadline_sec": deadline,
        "breaches": len(breaches),
        "breach_rate": round(len(breaches) / windows, 4) if windows else None,
        "breaches_by_stream": breaches_by_stream or None,
        "e2e_ms": _ms(_q(sketches.get("e2e_latency_seconds"))),
        "stage_ms": {tag: _ms(_q(sk)) for tag, sk in sorted(
            _tagged(sketches, "stage_seconds").items())} or None,
    }

    # -- capacity headroom ----------------------------------------------------
    headroom = _gauge_series(snapshots, "capacity_headroom_streams")
    occ_totals = _tagged(totals, "occupancy")
    capacity = {
        "headroom_streams_min": round(min(headroom), 2) if headroom else None,
        "headroom_streams_last": round(headroom[-1], 2) if headroom
                                 else None,
        "saturation_events": kinds.get("capacity_saturation", 0),
        "occupancy_mean": {
            tag: round(t["sum"] / t["count"], 2)
            for tag, t in sorted(occ_totals.items()) if t["count"]} or None,
    }

    # -- detection-quality drift ----------------------------------------------
    per_stream: Dict[str, dict] = {}
    worst_feature = None
    for rec in by_kind.get("quality_stats", []):
        d = rec.get("data") or {}
        s = rec.get("stream") or "?"
        psi = d.get("worst_score_psi")
        ent = per_stream.setdefault(s, {"last_score_psi": None,
                                        "max_score_psi": None})
        if psi is not None:
            ent["last_score_psi"] = round(float(psi), 4)
            ent["max_score_psi"] = round(
                max(float(psi), ent["max_score_psi"] or 0.0), 4)
        f = d.get("worst_feature_psi")
        if f is not None:
            worst_feature = max(float(f), worst_feature or 0.0)
    drift = {
        "quality_stats_records": kinds.get("quality_stats", 0),
        "streams": per_stream or None,
        "worst_score_psi": max(
            (e["max_score_psi"] for e in per_stream.values()
             if e["max_score_psi"] is not None), default=None),
        "worst_feature_psi": (round(worst_feature, 4)
                              if worst_feature is not None else None),
        "drift_bundles": sum(
            1 for r in by_kind.get("bundle", [])
            if (r.get("data") or {}).get("trigger") == "quality_drift"),
    }

    # -- device efficiency ----------------------------------------------------
    dev_totals = _tagged(totals, "device_seconds")
    dev_sketches = _tagged(sketches, "device_seconds")
    programs = {}
    for tag, t in sorted(dev_totals.items()):
        q = _q(dev_sketches.get(tag))
        programs[tag] = {
            "windows": int((_tagged(totals, "windows").get(tag) or
                            {"count": 0})["count"]),
            "batches": t["count"],
            "device_seconds_total": round(t["sum"], 4),
            "device_seconds_mean": (round(t["sum"] / t["count"], 6)
                                    if t["count"] else None),
            "device_seconds_p99_ms": (_ms(q) or {}).get("p99"),
        }
    mfu = _gauge_series(snapshots, "device_mfu")
    efficiency = {
        "programs": programs or None,
        "mfu_last": round(mfu[-1], 4) if mfu else None,
    }

    # -- training health ------------------------------------------------------
    health = by_kind.get("train_health", [])
    last_health = (health[-1].get("data") or {}) if health else {}
    nonfinite = 0
    max_grad = None
    for rec in health:
        d = rec.get("data") or {}
        nf = d.get("nonfinite") or {}
        nonfinite += int(sum(nf.values())) if nf else 0
        g = d.get("grad_norm")
        if g is not None:
            max_grad = max(float(g), max_grad or 0.0)
    halted = [(r.get("data") or {}).get("halted")
              for r in by_kind.get("train_done", [])]
    train = {
        "train_starts": kinds.get("train_start", 0),
        "health_records": len(health),
        "last": {k: last_health.get(k) for k in
                 ("step", "loss", "grad_norm", "update_ratio",
                  "steps_per_sec", "data_wait_fraction")} if health
                else None,
        "max_grad_norm": max_grad,
        "nonfinite_total": nonfinite,
        "halted": next((h for h in halted if h), None),
        "step_seconds_p50_ms": (_ms(_q(sketches.get("train_step_seconds")))
                                or {}).get("p50"),
    }

    # -- workload (the tune export's raw material) ----------------------------
    workload = {
        "window_nodes": _q(sketches.get("window_nodes")),
        "window_edges": _q(sketches.get("window_edges")),
        "window_files": _q(sketches.get("window_files")),
    }

    # -- incident inventory ---------------------------------------------------
    drops: Dict[str, int] = {}
    for rec in by_kind.get("admission_drop", []) \
            + by_kind.get("demux_drop", []):
        reason = (rec.get("data") or {}).get("reason") or rec.get("kind")
        drops[str(reason)] = drops.get(str(reason), 0) + 1
    incidents = {
        "bundles": [{"trigger": (r.get("data") or {}).get("trigger"),
                     "path": (r.get("data") or {}).get("path")}
                    for r in by_kind.get("bundle", [])] or None,
        "exceptions": kinds.get("exception", 0),
        "quarantines": kinds.get("stream_quarantined", 0),
        "reconnects": kinds.get("reconnect", 0),
        "device_batch_failures": kinds.get("device_batch_failed", 0),
        "drops": drops or None,
    }

    return {
        "span": {
            "dirs": [str(p) for p in paths],
            "segments": segments,
            "records": len(records),
            "runs": runs,
            "from_unix": min(times) if times else None,
            "to_unix": max(times) if times else None,
            "kinds": dict(sorted(kinds.items())),
        },
        "slo": slo,
        "capacity": capacity,
        "drift": drift,
        "efficiency": efficiency,
        "train": train,
        "workload": workload,
        "incidents": incidents,
    }


def format_report(report: dict) -> str:
    """Human rendering of `build_report` (the `nerrf report` default)."""
    lines: List[str] = []
    span = report["span"]
    dur = (span["to_unix"] - span["from_unix"]
           if span["from_unix"] is not None and span["to_unix"] is not None
           else None)
    lines.append(
        f"telemetry archive report: {span['records']} records / "
        f"{span['segments']} segment(s) over "
        f"{dur:.0f}s" if dur is not None else
        f"telemetry archive report: {span['records']} records / "
        f"{span['segments']} segment(s)")
    lines.append("  dirs: " + ", ".join(span["dirs"]))
    if span["runs"]:
        lines.append(f"  runs: {', '.join(span['runs'])}")

    slo = report["slo"]
    lines.append("")
    lines.append(f"SLO conformance ({slo['windows_scored']} windows, "
                 f"deadline {slo['deadline_sec']}s):")
    if slo["e2e_ms"]:
        q = slo["e2e_ms"]
        lines.append(f"  e2e p50/p90/p99: {q.get('p50')}/{q.get('p90')}/"
                     f"{q.get('p99')} ms (sketch resolution)")
    lines.append(f"  breaches: {slo['breaches']}"
                 + (f" (rate {slo['breach_rate']})"
                    if slo["breach_rate"] is not None else ""))
    for stage, q in (slo["stage_ms"] or {}).items():
        lines.append(f"  stage {stage:<8} p50/p99: "
                     f"{q.get('p50')}/{q.get('p99')} ms")

    cap = report["capacity"]
    lines.append("")
    lines.append(
        f"capacity: headroom min/last "
        f"{cap['headroom_streams_min']}/{cap['headroom_streams_last']} "
        f"streams, {cap['saturation_events']} saturation event(s)")
    for tag, m in (cap["occupancy_mean"] or {}).items():
        lines.append(f"  occupancy[{tag}] mean: {m}")

    drift = report["drift"]
    lines.append("")
    lines.append(
        f"drift: worst score PSI {drift['worst_score_psi']}, worst "
        f"feature PSI {drift['worst_feature_psi']} over "
        f"{drift['quality_stats_records']} quality_stats record(s), "
        f"{drift['drift_bundles']} drift bundle(s)")

    eff = report["efficiency"]
    lines.append("")
    lines.append("device efficiency:")
    for tag, p in (eff["programs"] or {}).items():
        lines.append(
            f"  {tag:<20} {p['windows']:>6} windows "
            f"{p['batches']:>6} batches  mean "
            f"{p['device_seconds_mean']}s  p99 "
            f"{p['device_seconds_p99_ms']}ms")
    if not eff["programs"]:
        lines.append("  (no device-seconds sketches archived)")
    if eff["mfu_last"] is not None:
        lines.append(f"  MFU (last snapshot): {eff['mfu_last']}")

    tr = report["train"]
    lines.append("")
    if tr["health_records"]:
        last = tr["last"] or {}
        lines.append(
            f"training health: {tr['health_records']} record(s), last "
            f"step {last.get('step')} loss {last.get('loss')} "
            f"grad {last.get('grad_norm')} at "
            f"{last.get('steps_per_sec')} steps/s; max grad "
            f"{tr['max_grad_norm']}, nonfinite {tr['nonfinite_total']}"
            + (f"; HALTED: {tr['halted']}" if tr["halted"] else ""))
    elif tr["train_starts"]:
        # a short run can finish before the monitor's journal cadence
        # cuts a single train_health record — the start/done markers are
        # still evidence worth printing
        lines.append(
            f"training health: {tr['train_starts']} run(s) archived, no "
            f"cadenced health records in range (run shorter than the "
            f"journal cadence)"
            + (f"; HALTED: {tr['halted']}" if tr["halted"] else ""))
    else:
        lines.append("training health: no train records in range")

    inc = report["incidents"]
    lines.append("")
    lines.append(
        f"incidents: {len(inc['bundles'] or [])} bundle(s), "
        f"{inc['exceptions']} exception(s), {inc['quarantines']} "
        f"quarantine(s), {inc['reconnects']} reconnect(s), "
        f"{inc['device_batch_failures']} device batch failure(s)")
    for b in inc["bundles"] or []:
        lines.append(f"  bundle {b['trigger']}: {b['path']}")
    if inc["drops"]:
        lines.append("  drops: " + " ".join(
            f"{k}={v}" for k, v in sorted(inc["drops"].items())))
    return "\n".join(lines)


# -- cross-run regression diff ------------------------------------------------


def compare_reports(a: dict, b: dict,
                    cfg: Optional[CompareConfig] = None) -> dict:
    """Diff run B against baseline run A; every flagged regression is one
    dict with what/baseline/candidate — the `--compare` CI gate fails on
    a non-empty list.  The thresholds actually applied (``cfg``, default
    `CompareConfig()`) are stamped into the result so the verdict is
    self-describing."""
    cfg = cfg or CompareConfig()
    regressions: List[dict] = []

    def flag(what: str, base, cand) -> None:
        regressions.append({"what": what, "baseline": base,
                            "candidate": cand})

    pa = ((a["slo"].get("e2e_ms") or {}).get("p99"))
    pb = ((b["slo"].get("e2e_ms") or {}).get("p99"))
    if pa and pb and pb > pa * cfg.p99_ratio:
        flag(f"e2e p99 regressed ×{pb / pa:.2f} "
             f"(threshold ×{cfg.p99_ratio:g})", pa, pb)
    ra = a["slo"].get("breach_rate") or 0.0
    rb = b["slo"].get("breach_rate") or 0.0
    if rb > ra + cfg.rate_abs:
        flag("SLO breach rate regressed", ra, rb)

    drops_a = sum((a["incidents"].get("drops") or {}).values())
    drops_b = sum((b["incidents"].get("drops") or {}).values())
    wa = max(a["slo"].get("windows_scored") or 0, 1)
    wb = max(b["slo"].get("windows_scored") or 0, 1)
    if drops_b / wb > drops_a / wa + cfg.rate_abs:
        flag("window drop rate regressed",
             round(drops_a / wa, 4), round(drops_b / wb, 4))

    progs_a = a["efficiency"].get("programs") or {}
    progs_b = b["efficiency"].get("programs") or {}
    for tag in sorted(set(progs_a) & set(progs_b)):
        ca = progs_a[tag].get("device_seconds_mean")
        cb = progs_b[tag].get("device_seconds_mean")
        if ca and cb and cb > ca * cfg.cost_ratio:
            flag(f"device seconds per batch regressed ×{cb / ca:.2f} "
                 f"on {tag}", ca, cb)

    psi_a = a["drift"].get("worst_score_psi") or 0.0
    psi_b = b["drift"].get("worst_score_psi") or 0.0
    if psi_b >= cfg.psi_breach > psi_a:
        flag(f"score drift crossed the {cfg.psi_breach:g} PSI breach",
             psi_a, psi_b)

    la = (a["train"].get("last") or {}).get("loss")
    lb = (b["train"].get("last") or {}).get("loss")
    if la and lb and lb > la * cfg.loss_ratio:
        flag(f"final train loss regressed ×{lb / la:.2f}", la, lb)
    if b["train"].get("halted") and not a["train"].get("halted"):
        flag("training halted in candidate", None, b["train"]["halted"])

    return {"baseline": a["span"]["dirs"], "candidate": b["span"]["dirs"],
            "thresholds": cfg.to_dict(),
            "regressions": regressions, "ok": not regressions}


def format_compare(cmp: dict) -> str:
    lines = [f"compare: baseline {', '.join(cmp['baseline'])} vs "
             f"candidate {', '.join(cmp['candidate'])}"]
    th = cmp.get("thresholds")
    if th:
        lines.append("  thresholds: " + " ".join(
            f"{k}={v:g}" for k, v in sorted(th.items())))
    if cmp["ok"]:
        lines.append("  no regressions flagged")
    for r in cmp["regressions"]:
        lines.append(f"  REGRESSION: {r['what']} "
                     f"(baseline {r['baseline']} → {r['candidate']})")
    return "\n".join(lines)


# -- the tune-ready corpus ----------------------------------------------------


def export_tune(paths, since: Optional[float] = None,
                until: Optional[float] = None) -> dict:
    """The dataset the learned-ladder cost-model fit consumes: the
    observed window-size distribution (mergeable sketches + quantiles)
    and the per-bucket measured cost table (windows, batches, mean/p99
    device seconds, mean occupancy) straight from production telemetry —
    what the live gauges showed, now durable and mergeable."""
    if isinstance(paths, (str,)) or hasattr(paths, "__fspath__"):
        paths = [paths]
    sketch_records = list(iter_records(paths, since=since, until=until,
                                       kinds=("workload_sketch",)))
    sketches, totals = _merge_sketches(sketch_records)
    dist = {}
    rejected = {}
    for feat in ("nodes", "edges", "files"):
        sk = sketches.get(f"window_{feat}")
        if sk is not None:
            dist[feat] = {"sketch": sk.to_dict(), "total": sk.total,
                          "quantiles": sk.quantiles((0.5, 0.9, 0.99))}
        rj = sketches.get(f"rejected_window_{feat}")
        if rj is not None and rj.total:
            rejected[feat] = {"sketch": rj.to_dict(), "total": rj.total,
                              "quantiles": rj.quantiles((0.5, 0.9, 0.99))}
    dev_totals = _tagged(totals, "device_seconds")
    win_totals = _tagged(totals, "windows")
    occ_totals = _tagged(totals, "occupancy")
    dev_sketches = _tagged(sketches, "device_seconds")
    table = {}
    for tag in sorted(set(dev_totals) | set(win_totals)):
        dt = dev_totals.get(tag) or {"count": 0, "sum": 0.0}
        occ = occ_totals.get(tag)
        q = _q(dev_sketches.get(tag), qs=(0.5, 0.99))
        table[tag] = {
            "windows": (win_totals.get(tag) or {"count": 0})["count"],
            "batches": dt["count"],
            "device_seconds_mean": (round(dt["sum"] / dt["count"], 6)
                                    if dt["count"] else None),
            "device_seconds_p99": (q or {}).get("p99"),
            "occupancy_mean": (round(occ["sum"] / occ["count"], 3)
                               if occ and occ["count"] else None),
        }
    rej_total = totals.get("rejected_windows")
    return {
        "schema": 1,
        "kind": "nerrf_tune_corpus",
        "source": [str(p) for p in paths],
        "windows_observed": sum(t["count"] for t in win_totals.values()),
        "windows_rejected": int(rej_total["count"]) if rej_total else 0,
        "window_size_distribution": dist or None,
        # demand beyond the top rung (admission-rejected window sizes) —
        # what a ladder extension would capture; tune merges this into
        # its demand points so rejected traffic pulls rungs up
        "rejected_window_size_distribution": rejected or None,
        "bucket_cost": table or None,
        "provenance": "nerrf archive export --tune",
    }


def report_main(paths, since=None, until=None, compare=None,
                as_json=False, out=print, gate=False,
                compare_cfg: Optional[CompareConfig] = None) -> int:
    """The `nerrf report` body; returns a CLI exit code (compare mode:
    1 when a regression is flagged).

    ``gate=True`` is the continuous-regression form (`--gate`): the same
    compare verdict framed for queue pre-flights — a one-line GATE
    PASS/FAIL verdict, and a *missing or empty baseline* passes with a
    note instead of erroring, so the first run before an
    artifact-of-record is banked doesn't hard-fail the queue."""
    from nerrf_tpu_torch.flight.journal import SchemaVersionError

    try:
        if compare:
            if gate:
                try:
                    a = build_report([compare[0]], since=since,
                                     until=until)
                except (FileNotFoundError, SchemaVersionError) as e:
                    out(f"GATE PASS (no banked baseline at "
                        f"{compare[0]}: {e})")
                    return 0
                if not a["span"]["records"]:
                    out(f"GATE PASS (baseline {compare[0]} holds no "
                        f"records in range — nothing banked yet)")
                    return 0
            else:
                a = build_report([compare[0]], since=since, until=until)
            b = build_report([compare[1]], since=since, until=until)
            cmp = compare_reports(a, b, cfg=compare_cfg)
            out(json.dumps(cmp, indent=2) if as_json else
                format_compare(cmp))
            if gate:
                out("GATE PASS" if cmp["ok"] else
                    "GATE FAIL: " + "; ".join(
                        r["what"] for r in cmp["regressions"]))
            return 0 if cmp["ok"] else 1
        report = build_report(paths, since=since, until=until)
        out(json.dumps(report, indent=2) if as_json else
            format_report(report))
        return 0 if report["span"]["records"] else 1
    except SchemaVersionError as e:
        out(f"cannot read archive: {e}")
        return 2
    except FileNotFoundError as e:
        out(f"not an archive directory: {e}")
        return 2
