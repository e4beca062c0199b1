"""On-disk dataset layer: per-event trace CSV/Parquet and corpus directories.

A host copy of ``nerrf_tpu/data/datasets.py``, kept identical (its files
are byte-equal to the reference's):

  * per-event trace CSV/Parquet (one row per syscall event, resolved strings,
    per-event label column);
  * ground-truth CSV in the reference's header (start_ts,end_ts,start_iso,
    end_iso,attack_family,target_path,duration_sec,platform,scale);
  * corpus directories with a manifest, round-trippable via
    `export_corpus` / `load_corpus`.

``pyarrow`` is imported only by the Parquet functions: without it they
raise ``ImportError`` and the CSV path is unaffected.

CLI::

    python -m nerrf_tpu_torch.data.datasets toy    [--out datasets]
    python -m nerrf_tpu_torch.data.datasets corpus --out DIR [--hours 2.0]
                                                   [--parquet] [--seed 42]
"""

from __future__ import annotations

import csv
import datetime
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from nerrf_tpu_torch.data.loaders import GroundTruth, Trace
from nerrf_tpu_torch.data.synth import SimConfig, simulate_trace
from nerrf_tpu_torch.schema.events import EventArrays, StringTable

TRACE_COLUMNS = (
    "ts_ns", "pid", "tid", "comm", "syscall", "path", "new_path",
    "flags", "ret_val", "bytes", "inode", "mode", "uid", "gid", "label",
)


def _iso(ns: int) -> str:
    return (
        datetime.datetime.fromtimestamp(ns / 1e9, tz=datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%SZ")
    )


def trace_rows(trace: Trace):
    """Yield one plain-dict row per valid event (resolved strings + label)."""
    ev, st = trace.events, trace.strings
    labels = trace.labels
    for i in range(len(ev)):
        if not ev.valid[i]:
            continue
        row = ev.record(i, st)
        row["label"] = float(labels[i]) if labels is not None else 0.0
        yield row


def write_trace_csv(trace: Trace, path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=TRACE_COLUMNS)
        w.writeheader()
        for row in trace_rows(trace):
            w.writerow(row)
    return path


def write_trace_parquet(trace: Trace, path: str | Path) -> Path:
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = list(trace_rows(trace))
    table = pa.table({c: [r[c] for r in rows] for c in TRACE_COLUMNS})
    pq.write_table(table, path)
    return path


def _trace_from_rows(rows: List[dict], name: str,
                     ground_truth: Optional[GroundTruth]) -> Trace:
    strings = StringTable()
    records = []
    labels = []
    for r in rows:
        records.append({
            "ts_ns": int(r["ts_ns"]),
            "pid": int(r["pid"]),
            "tid": int(r["tid"]),
            "comm": r["comm"],
            "syscall": r["syscall"],
            "path": r["path"],
            "new_path": r["new_path"] or "",
            "flags": int(r["flags"]),
            "ret_val": int(r["ret_val"]),
            "bytes": int(r["bytes"]),
            "inode": int(r["inode"]),
            "mode": int(r["mode"]),
            "uid": int(r["uid"]),
            "gid": int(r["gid"]),
        })
        labels.append(float(r["label"]))
    events = EventArrays.from_records(records, strings)
    return Trace(
        events=events,
        strings=strings,
        ground_truth=ground_truth,
        labels=np.asarray(labels, np.float32),
        name=name,
    )


def load_trace_csv(path: str | Path, name: str = "",
                   ground_truth: Optional[GroundTruth] = None) -> Trace:
    path = Path(path)
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return _trace_from_rows(rows, name or path.stem, ground_truth)


def load_trace_parquet(path: str | Path, name: str = "",
                       ground_truth: Optional[GroundTruth] = None) -> Trace:
    import pyarrow.parquet as pq

    path = Path(path)
    rows = pq.read_table(path).to_pylist()
    return _trace_from_rows(rows, name or path.stem, ground_truth)


def write_ground_truth_csv(gt: GroundTruth, path: str | Path) -> Path:
    """The reference format's header and semantics (second-resolution epoch
    ts)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([
            "start_ts", "end_ts", "start_iso", "end_iso", "attack_family",
            "target_path", "duration_sec", "platform", "scale",
        ])
        start_s = gt.start_ns // 10**9          # floor: window start
        end_s = -(-gt.end_ns // 10**9)          # ceil: window end
        w.writerow([
            start_s, end_s,
            _iso(start_s * 10**9), _iso(end_s * 10**9),
            gt.attack_family, gt.target_path,
            end_s - start_s, gt.platform, gt.scale,
        ])
    return path


# --------------------------------------------------------------------------
# corpus directories
# --------------------------------------------------------------------------

def export_corpus(traces: List[Trace], out_dir: str | Path,
                  parquet: bool = False) -> Path:
    """Write a corpus directory::

        <out>/traces/<name>.csv[.parquet]
        <out>/ground_truth/<name>.csv      (attack traces only)
        <out>/manifest.json
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    manifest = {"format": "nerrf-corpus-v1", "traces": []}
    for t in traces:
        if parquet:
            write_trace_parquet(t, out / "traces" / f"{t.name}.parquet")
        else:
            write_trace_csv(t, out / "traces" / f"{t.name}.csv")
        entry = {
            "name": t.name,
            "file": f"traces/{t.name}.{'parquet' if parquet else 'csv'}",
            "num_events": int(t.events.num_valid),
            "attack": t.ground_truth is not None,
        }
        if t.ground_truth is not None:
            gt_file = f"ground_truth/{t.name}.csv"
            write_ground_truth_csv(t.ground_truth, out / gt_file)
            entry["ground_truth"] = gt_file
        manifest["traces"].append(entry)
    # manifest last and atomic: load_corpus keys off it, so a crash
    # mid-export must leave "no corpus", never a torn manifest
    tmp = out / "manifest.json.tmp"
    tmp.write_text(json.dumps(manifest, indent=2) + "\n")
    tmp.replace(out / "manifest.json")
    return out


def load_corpus(corpus_dir: str | Path) -> List[Trace]:
    from nerrf_tpu_torch.data.loaders import load_ground_truth_csv

    corpus_dir = Path(corpus_dir)
    manifest = json.loads((corpus_dir / "manifest.json").read_text())
    traces = []
    for entry in manifest["traces"]:
        gt = None
        if entry.get("ground_truth"):
            gt = load_ground_truth_csv(corpus_dir / entry["ground_truth"])
        p = corpus_dir / entry["file"]
        if p.suffix == ".parquet":
            traces.append(load_trace_parquet(p, entry["name"], gt))
        else:
            traces.append(load_trace_csv(p, entry["name"], gt))
    return traces


# --------------------------------------------------------------------------
# generators
# --------------------------------------------------------------------------

def toy_trace() -> Trace:
    """The deterministic toy trace checked in at
    datasets/traces/toy_trace.csv (BASELINE.json configs[0])."""
    return simulate_trace(
        SimConfig(
            duration_sec=120.0, attack=True, attack_start_sec=45.0,
            num_target_files=8, min_file_bytes=64 * 1024,
            max_file_bytes=128 * 1024, chunk_bytes=32 * 1024,
            benign_rate_hz=6.0, seed=1234,
        ),
        name="toy_trace",
    )


def make_hour_corpus(hours: float, attack_hours: float = 1.0,
                     base_seed: int = 42, trace_minutes: float = 10.0):
    """The reference corpus shape: ~`hours` benign + `attack_hours`
    labelled attack, as independent `trace_minutes`-long runs.  Delegates to
    `make_corpus`, whose Bresenham spread keeps both classes present in any
    contiguous train/eval split."""
    from nerrf_tpu_torch.data.synth import make_corpus

    per = trace_minutes * 60.0
    n_attack = max(1, round(attack_hours * 3600.0 / per))
    n_benign = max(1, round(hours * 3600.0 / per))
    n = n_benign + n_attack
    return make_corpus(
        n, attack_fraction=n_attack / n, base_seed=base_seed,
        duration_sec=per, num_target_files=(20, 46),
        benign_rate_hz=(30.0, 80.0),
    )


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="nerrf_tpu_torch.data.datasets")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("toy")
    t.add_argument("--out", default="datasets")
    c = sub.add_parser("corpus")
    c.add_argument("--out", required=True)
    c.add_argument("--hours", type=float, default=2.0,
                   help="benign hours (reference corpus spec: 100)")
    c.add_argument("--attack-hours", type=float, default=0.25)
    c.add_argument("--parquet", action="store_true")
    c.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    if args.cmd == "toy":
        tr = toy_trace()
        out = Path(args.out)
        p = write_trace_csv(tr, out / "traces" / "toy_trace.csv")
        g = write_ground_truth_csv(tr.ground_truth,
                                   out / "traces" / "toy_ground_truth.csv")
        print(p)
        print(g)
    else:
        traces = make_hour_corpus(args.hours, args.attack_hours, args.seed)
        out = export_corpus(traces, args.out, parquet=args.parquet)
        print(f"{out}: {len(traces)} traces, "
              f"{sum(t.events.num_valid for t in traces)} events")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
