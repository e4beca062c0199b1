"""The 100 h corpus: streaming generation to disk shards, and the shard reader.

A host copy of the reference's ``nerrf_tpu/train/corpus.py`` (numpy only),
kept identical: for the same spec both packages write byte-identical shards
and the same ``manifest.json`` (only the wall-clock fields ``gen_seconds``
and ``fit_seconds`` differ), and each reads the other's corpus.

At production density (600 s traces, 40 Hz benign load, about 25 k events a
trace) 100 h is about 600 traces, 24 k window samples, 16 GB of window
tensors: too big for device memory and too big to regenerate per run.  So
the corpus is generated once, streamed trace by trace into fixed-size shards
on disk, and training rotates the shards through the card
(:func:`nerrf_tpu_torch.train.loop.train_sharded_stream`).

Layout (one directory per corpus)::

    manifest.json              hours, windows, shard list, configs, dtypes
    shard_0000/{node_feat.npy, ...}
    shard_0001/...             each at most shard_windows samples, train split
    eval_0000/...              held-out TRACES (split before windowing, so no
                               window of an eval trace leaks into train)

float32 feature and label arrays are stored as float16 (counts, ratios, Δt
and {0, 1} labels all fit): half the disk and half the host→device bytes.
The trainer casts to float32 on the card, after the batch gather.

Run as a module to generate one (the flags of ``scripts/gen_corpus.py``)::

    python -m nerrf_tpu_torch.train.corpus --out datasets/corpus100
    python -m nerrf_tpu_torch.train.corpus --out /tmp/c1 --hours 1 \\
        --shard-windows 64
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from nerrf_tpu_torch.train.data import DatasetConfig, WindowDataset, windows_of_trace

# float arrays stored as f16 on disk; everything else (masks, int ids like
# node_aux/node_type, embedding inputs) keeps its dtype
_F16_KEYS = ("node_feat", "edge_feat", "seq_feat",
             "node_label", "edge_label", "seq_label")


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    """Generation parameters (the reference's, field for field).

    ``hard_scenarios`` mixes the adversarial variants of ``data/synth.py``
    into the corpus: benign mass-renames and atomic-rewrite jobs among the
    benign traces, and the evasion variants among the attack traces, so the
    detector sees hard negatives and hard positives.  ``auto_fit`` runs a
    measuring pass over every window of every trace first (traces are
    seed-deterministic), sizes the graph capacities to the corpus-wide
    densest window (× ``fit_headroom``, next power of two), and then checks
    that the windowing pass dropped nothing."""

    hours: float = 100.0
    duration_sec: float = 600.0
    attack_fraction: float = 0.5
    num_target_files: int = 24
    benign_rate_hz: float = 40.0
    base_seed: int = 1000
    eval_fraction: float = 0.1     # fraction of TRACES held out
    shard_windows: int = 2000      # samples per shard (~0.7 GB at f16)
    hard_scenarios: bool = True
    # fraction of benign traces carrying a hard negative (split evenly
    # between mass-rename and atomic-rewrite), and of attack traces drawn
    # from the adversarial variants (split evenly across ATTACK_VARIANTS)
    benign_hard_fraction: float = 0.2
    attack_variant_fraction: float = 0.49  # 7 variants × 7%; standard keeps 51%
    auto_fit: bool = True
    fit_headroom: float = 1.25


def _write_shard(out: Path, samples: List[dict], dtypes: Dict[str, str]) -> int:
    out.mkdir(parents=True, exist_ok=True)
    keys = samples[0].keys()
    for k in keys:
        arr = np.stack([s[k] for s in samples])
        dtypes.setdefault(k, str(arr.dtype))
        if k in _F16_KEYS:
            arr = arr.astype(np.float16)
        np.save(out / f"{k}.npy", arr)
    return len(samples)


def generate_corpus(
    out_dir: str | Path,
    spec: CorpusSpec = CorpusSpec(),
    dataset: Optional[DatasetConfig] = None,
    log=None,
) -> dict:
    """Stream-generate ``spec.hours`` of traces into shards under ``out_dir``.

    Memory stays bounded at one shard of samples (plus one trace).
    Idempotent: an existing complete manifest short-circuits.
    """
    from nerrf_tpu_torch.data.synth import SimConfig, simulate_trace

    out = Path(out_dir)
    man_path = out / "manifest.json"
    if man_path.exists():
        man = json.loads(man_path.read_text())
        if man.get("complete"):
            if log:
                log(f"corpus exists: {man['hours']:.1f}h, "
                    f"{man['train_windows']} train windows — skipping")
            return man
    out.mkdir(parents=True, exist_ok=True)
    dataset = dataset or DatasetConfig()

    n_traces = max(1, round(spec.hours * 3600.0 / spec.duration_sec))
    rng = np.random.default_rng(spec.base_seed)
    is_attack = rng.random(n_traces) < spec.attack_fraction
    is_eval = rng.random(n_traces) < spec.eval_fraction
    if spec.eval_fraction > 0 and n_traces >= 2 and not is_eval.any():
        is_eval[-1] = True  # small corpora must still have a held-out trace

    def sim_config(i: int) -> "SimConfig":
        """The per-trace SimConfig: a pure function of (spec, i), so the
        measuring pass and the windowing pass see identical traces."""
        trng = np.random.default_rng((spec.base_seed, i))
        scenario = "standard"
        if spec.hard_scenarios:
            u = trng.random()
            if is_attack[i]:
                from nerrf_tpu_torch.data.synth import ATTACK_VARIANTS as variants

                slot = spec.attack_variant_fraction / len(variants)
                idx = int(u // slot) if slot > 0 else len(variants)
                if idx < len(variants):
                    scenario = variants[idx]
            elif u < spec.benign_hard_fraction / 2:
                scenario = "benign-mass-rename"
            elif u < spec.benign_hard_fraction:
                scenario = "benign-atomic-rewrite"
        return SimConfig(
            num_target_files=int(trng.integers(max(4, spec.num_target_files // 2),
                                               spec.num_target_files + 1)),
            duration_sec=spec.duration_sec,
            benign_rate_hz=float(trng.uniform(spec.benign_rate_hz * 0.5,
                                              spec.benign_rate_hz * 1.5)),
            attack_start_sec=float(trng.uniform(0.15, 0.7) * spec.duration_sec),
            seed=spec.base_seed + i,
            attack=bool(is_attack[i]),
            scenario=scenario,
        )

    fit_info = None
    if spec.auto_fit:
        # pass 0: measure the densest window of the whole corpus, then size
        # the graph capacities so that no window drops anything
        from nerrf_tpu_torch.graph.builder import measure_window, snapshot_windows

        t_fit = time.time()
        max_n = max_e = 0
        for i in range(n_traces):
            tr = simulate_trace(sim_config(i))
            ev = tr.events
            if ev.num_valid == 0:
                continue
            ts = ev.ts_ns[ev.valid]
            for lo, hi in snapshot_windows(int(ts.min()), int(ts.max()),
                                           dataset.graph):
                n, e = measure_window(ev, lo, hi)
                max_n, max_e = max(max_n, n), max(max_e, e)
            if log and (i + 1) % 100 == 0:
                log(f"fit pass: {i + 1}/{n_traces} traces, "
                    f"max so far {max_n}n/{max_e}e")
        fitted = dataset.graph.fit_counts(max_n, max_e,
                                          headroom=spec.fit_headroom)
        dataset = dataclasses.replace(dataset, graph=fitted)
        fit_info = {
            "max_window_nodes": max_n,
            "max_window_edges": max_e,
            "headroom": spec.fit_headroom,
            "fitted_max_nodes": fitted.max_nodes,
            "fitted_max_edges": fitted.max_edges,
            "fit_seconds": round(time.time() - t_fit, 1),
        }
        if log:
            log(f"auto-fit: densest window {max_n}n/{max_e}e → capacities "
                f"{fitted.max_nodes}n/{fitted.max_edges}e "
                f"({fit_info['fit_seconds']:.0f}s)")

    dtypes: Dict[str, str] = {}
    shards: List[dict] = []
    buf: Dict[bool, List[dict]] = {True: [], False: []}  # eval? → samples
    counts = {"train": 0, "eval": 0}
    label_pos = {"edge": 0.0, "seq": 0.0}
    t0 = time.time()

    def flush(eval_split: bool, force: bool = False) -> None:
        b = buf[eval_split]
        limit = spec.shard_windows
        while len(b) >= limit or (force and b):
            chunk, buf[eval_split] = b[:limit], b[limit:]
            b = buf[eval_split]
            kind = "eval" if eval_split else "shard"
            name = f"{kind}_{sum(1 for s in shards if s['kind'] == kind):04d}"
            n = _write_shard(out / name, chunk, dtypes)
            shards.append({"name": name, "kind": kind, "windows": n})
            counts["eval" if eval_split else "train"] += n
            if log:
                log(f"  wrote {name}: {n} windows "
                    f"({time.time() - t0:.0f}s elapsed)")

    scenario_counts: Dict[str, int] = {}
    drop_tally = {"events": 0, "nodes": 0, "edges": 0, "windows": 0}
    for i in range(n_traces):
        # structural variety per trace (files, load, attack onset), not just
        # the sim seed: a fixed onset would be a trivially learnable clock
        sim = sim_config(i)
        scenario_counts[sim.scenario] = scenario_counts.get(sim.scenario, 0) + 1
        tr = simulate_trace(sim)
        wstats: list = []
        samples = windows_of_trace(tr, dataset, stats_out=wstats)
        for st in wstats:
            if st.dropped_events or st.dropped_nodes or st.dropped_edges:
                drop_tally["events"] += st.dropped_events
                drop_tally["nodes"] += st.dropped_nodes
                drop_tally["edges"] += st.dropped_edges
                drop_tally["windows"] += 1
        for s in samples:
            label_pos["edge"] += float(s["edge_label"].sum())
            label_pos["seq"] += float(s["seq_label"].sum())
        buf[bool(is_eval[i])].extend(samples)
        flush(bool(is_eval[i]))
        if log and (i + 1) % 50 == 0:
            log(f"corpus: {i + 1}/{n_traces} traces "
                f"({(i + 1) * spec.duration_sec / 3600:.1f}h)")
    flush(False, force=True)
    flush(True, force=True)
    if spec.auto_fit and drop_tally["windows"]:
        raise ValueError(
            f"corpus windowing dropped data despite auto-fit capacities "
            f"{dataset.graph.max_nodes}n/{dataset.graph.max_edges}e: "
            f"{drop_tally} — fit pass and windowing pass disagree (bug)")

    man = {
        "complete": True,
        "hours": n_traces * spec.duration_sec / 3600.0,
        "num_traces": n_traces,
        "train_windows": counts["train"],
        "eval_windows": counts["eval"],
        "shards": shards,
        "dtypes": dtypes,
        "spec": dataclasses.asdict(spec),
        "gen_seconds": round(time.time() - t0, 1),
        "label_pos": label_pos,
        "scenario_counts": scenario_counts,
        "graph_capacity": {"max_nodes": dataset.graph.max_nodes,
                           "max_edges": dataset.graph.max_edges},
        "auto_fit": fit_info,
        "dropped": drop_tally,
    }
    # the manifest commits the corpus (ShardedCorpus opens it first), so it
    # lands atomically after every shard is on disk
    tmp = man_path.with_name(man_path.name + ".tmp")
    tmp.write_text(json.dumps(man, indent=2) + "\n")
    tmp.replace(man_path)
    if log:
        log(f"corpus complete: {man['hours']:.1f}h, "
            f"{counts['train']} train / {counts['eval']} eval windows in "
            f"{man['gen_seconds']:.0f}s")
    return man


class ShardedCorpus:
    """Reader: shard-at-a-time access to a generated corpus directory."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        man_path = self.path / "manifest.json"
        if not man_path.exists():
            raise FileNotFoundError(
                f"no corpus manifest at {man_path}; generate it with "
                f"`python -m nerrf_tpu_torch.train.corpus --out {self.path}`")
        self.manifest = json.loads(man_path.read_text())
        if not self.manifest.get("complete"):
            raise ValueError(f"corpus at {self.path} is incomplete")
        self.train_shards = [s["name"] for s in self.manifest["shards"]
                             if s["kind"] == "shard"]
        self.eval_shards = [s["name"] for s in self.manifest["shards"]
                            if s["kind"] == "eval"]

    @property
    def hours(self) -> float:
        return float(self.manifest["hours"])

    @property
    def train_windows(self) -> int:
        return int(self.manifest["train_windows"])

    def load_shard(self, name: str, upcast: bool = False) -> Dict[str, np.ndarray]:
        """Arrays of one shard.  f16 storage dtypes are kept unless
        ``upcast`` (f32 on the host, for evaluation)."""
        d = self.path / name
        arrays = {p.stem: np.load(p) for p in sorted(d.glob("*.npy"))}
        if upcast:
            arrays = {
                k: v.astype(np.float32) if v.dtype == np.float16 else v
                for k, v in arrays.items()
            }
        return arrays

    def eval_dataset(self, max_windows: int = 4000) -> WindowDataset:
        """Held-out split as a WindowDataset (host RAM, f32)."""
        parts, total = [], 0
        for name in self.eval_shards:
            arrs = self.load_shard(name, upcast=True)
            parts.append(WindowDataset(arrs))
            total += len(parts[-1])
            if total >= max_windows:
                break
        if not parts:
            raise ValueError("corpus has no eval shards")
        ds = WindowDataset.concatenate(parts)
        if len(ds) > max_windows:
            ds = ds.take(np.arange(max_windows))
        return ds

    def iter_train_shards(self, epoch_seed: int) -> Iterator[Dict[str, np.ndarray]]:
        order = np.random.default_rng(epoch_seed).permutation(
            len(self.train_shards))
        for i in order:
            yield self.load_shard(self.train_shards[int(i)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nerrf_tpu_torch.train.corpus",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--hours", type=float, default=100.0)
    ap.add_argument("--duration-sec", type=float, default=600.0)
    ap.add_argument("--benign-rate-hz", type=float, default=40.0)
    ap.add_argument("--files", type=int, default=24)
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--shard-windows", type=int, default=2000)
    args = ap.parse_args(argv)
    spec = CorpusSpec(
        hours=args.hours,
        duration_sec=args.duration_sec,
        benign_rate_hz=args.benign_rate_hz,
        num_target_files=args.files,
        base_seed=args.seed,
        shard_windows=args.shard_windows,
    )
    man = generate_corpus(args.out, spec,
                          log=lambda m: print(f"[gen] {m}", flush=True))
    print(f"[gen] manifest: {man['hours']:.1f}h "
          f"{man['train_windows']}+{man['eval_windows']} windows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
