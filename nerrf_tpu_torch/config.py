"""Experiment config layer: dataclass ⇄ JSON, plus the experiment registry.

The port of ``nerrf_tpu/config.py``.  Every named experiment is a
serializable `Experiment` whose JSON form is checked in under ``configs/``
and whose in-memory form is plain nested dataclasses (SimConfig-derived
CorpusConfig / DatasetConfig / TrainConfig / MeshConfig / MCTSConfig /
StreamConfig).  The same experiment gives the same ``to_json`` text here and
in the reference, and every ``configs/*.json`` loads in both.

Serialization rules (kept deliberately small, the reference's):
  * nested dataclasses recurse;
  * ``dtype`` fields (``torch.bfloat16`` & friends) encode as the dtype's
    name (``"bfloat16"``, ``"float32"``) and decode as ``torch.<name>``;
  * unknown keys on load are an error (config drift should fail loudly).

``MCTSConfig`` is the planner's own (``planner/mcts.py``) and
``StreamConfig`` StreamNet's (``models/stream.py``), as in the reference.
``MeshConfig`` is a data-only copy of the reference's (``parallel/mesh.py``),
here so that every experiment parses; it moves to its own module when the
port takes that module (ROADMAP A.7).

CLI::

    python -m nerrf_tpu_torch.config list
    python -m nerrf_tpu_torch.config dump <name> [--out FILE]

(The reference's ``sync``, which rewrites ``configs/``, stays with the
reference: those files are its.)
"""

from __future__ import annotations

import dataclasses
import json
import typing
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from nerrf_tpu_torch.graph.builder import GraphConfig
from nerrf_tpu_torch.models.graphsage import GraphSAGEConfig
from nerrf_tpu_torch.models.joint import JointConfig
from nerrf_tpu_torch.models.lstm import LSTMConfig
from nerrf_tpu_torch.models.stream import StreamConfig
from nerrf_tpu_torch.planner.mcts import MCTSConfig
from nerrf_tpu_torch.train.data import DatasetConfig
from nerrf_tpu_torch.train.loop import TrainConfig

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


# --------------------------------------------------------------------------
# the config of a module the port has not taken yet (data only)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The reference's device mesh shape (``parallel/mesh.py``; moves there
    with ROADMAP A.7).  The port trains on one card."""

    dp: int = -1  # -1: use all remaining devices
    tp: int = 1
    sp: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        dp, tp, sp = self.dp, self.tp, self.sp
        if dp == -1:
            if n_devices % (tp * sp):
                raise ValueError(f"{n_devices} devices not divisible by tp*sp={tp * sp}")
            dp = n_devices // (tp * sp)
        if dp * tp * sp != n_devices:
            raise ValueError(f"dp*tp*sp={dp * tp * sp} != {n_devices} devices")
        return dp, tp, sp


# --------------------------------------------------------------------------
# dataclass ⇄ dict
# --------------------------------------------------------------------------

def to_dict(cfg: Any) -> Any:
    """Recursively convert a (nested) config dataclass to JSON-able data."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {
            f.name: to_dict(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)
        }
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, torch.dtype):
        return str(cfg).removeprefix("torch.")
    return cfg


def _unwrap_optional(tp: Any) -> Any:
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def from_dict(cls: type, data: Dict[str, Any]) -> Any:
    """Rebuild dataclass ``cls`` from `to_dict` output.  Unknown keys raise."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a dataclass")
    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs: Dict[str, Any] = {}
    for name, value in data.items():
        tp = _unwrap_optional(hints.get(name, Any))
        f = fields[name]
        if value is None:
            kwargs[name] = None
        elif dataclasses.is_dataclass(tp) and isinstance(value, dict):
            kwargs[name] = from_dict(tp, value)
        elif name == "dtype" or (
            isinstance(value, str)
            and f.default is not dataclasses.MISSING
            and isinstance(f.default, torch.dtype)
        ):
            kwargs[name] = _dtype(str(value))
        else:
            kwargs[name] = value
    return cls(**kwargs)


# --------------------------------------------------------------------------
# Experiment
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    """How many simulated traces to generate and at what scale."""

    num_traces: int = 12
    attack_fraction: float = 0.5
    base_seed: int = 42
    duration_sec: float = 300.0
    num_target_files: int = 45
    benign_rate_hz: float = 60.0
    eval_fraction: float = 0.25


@dataclasses.dataclass(frozen=True)
class Experiment:
    """One named, fully-specified run."""

    name: str
    description: str
    corpus: CorpusConfig = CorpusConfig()
    dataset: DatasetConfig = DatasetConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()
    mcts: MCTSConfig = MCTSConfig()
    stream: Optional[StreamConfig] = None
    # the disk-sharded corpus, for runs whose window tensors exceed host
    # memory: when it is generated run.py trains by shard rotation
    # (train_sharded_stream); when it is absent, the in-memory ``corpus``
    # is generated instead
    corpus_dir: Optional[str] = None

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(to_dict(self), indent=indent, sort_keys=False) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "Experiment":
        return from_dict(cls, json.loads(text))

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path

    @classmethod
    def load(cls, path: str | Path) -> "Experiment":
        return cls.from_json(Path(path).read_text())

    def build_corpus(self):
        """Generate this experiment's corpus → (train_traces, eval_traces):
        the last ``round(num_traces · eval_fraction)`` traces (at least 1,
        at most all but one) are held out."""
        from nerrf_tpu_torch.data.synth import make_corpus

        c = self.corpus
        traces = make_corpus(
            c.num_traces, attack_fraction=c.attack_fraction,
            base_seed=c.base_seed, duration_sec=c.duration_sec,
            num_target_files=c.num_target_files,
            benign_rate_hz=c.benign_rate_hz,
        )
        n_eval = (
            min(len(traces) - 1, max(1, round(len(traces) * c.eval_fraction)))
            if c.eval_fraction > 0 else 0
        )
        split = len(traces) - n_eval
        return traces[:split], traces[split:]


def _small_joint() -> JointConfig:
    return JointConfig(
        gnn=GraphSAGEConfig(hidden=64, num_layers=8),
        lstm=LSTMConfig(hidden=64, num_layers=1),
    )


def _experiments() -> Dict[str, Experiment]:
    """The registry: the reference's six experiments, field for field and
    word for word (their ``to_json`` texts are identical)."""
    toy = Experiment(
        name="toy-graphsage",
        description=(
            "GraphSAGE-T anomaly detector on datasets/traces/toy_trace.csv "
            "(single short trace, CPU-sized model; BASELINE.json configs[0])"
        ),
        corpus=CorpusConfig(num_traces=4, duration_sec=120.0,
                            num_target_files=8, benign_rate_hz=6.0,
                            eval_fraction=0.5),
        dataset=DatasetConfig(
            graph=GraphConfig(window_sec=45.0, stride_sec=15.0,
                              max_nodes=128, max_edges=256),
            seq_len=50, max_seqs=64,
        ),
        train=TrainConfig(model=_small_joint(), batch_size=4, num_steps=200,
                          eval_every=50, seq_loss_weight=0.0),
    )
    lstm = Experiment(
        name="lstm-impact",
        description=(
            "BiLSTM impact predictor on per-file syscall event sequences "
            "(reference spec architecture.mdx:55-59; BASELINE.json configs[1])"
        ),
        corpus=CorpusConfig(num_traces=8, duration_sec=240.0,
                            num_target_files=24, benign_rate_hz=40.0),
        dataset=DatasetConfig(seq_len=100, max_seqs=128),
        train=TrainConfig(
            model=JointConfig(gnn=GraphSAGEConfig(hidden=32, num_layers=2),
                              lstm=LSTMConfig(), fuse=False),
            batch_size=8, num_steps=400, edge_loss_weight=0.0,
            node_loss_weight=0.0, seq_loss_weight=1.0,
        ),
    )
    joint = Experiment(
        name="joint-100h",
        description=(
            "Joint GraphSAGE-T + BiLSTM training at full flagship size on "
            "the TRUE 100 h corpus (ROADMAP.md:50's '100h benign + labelled "
            "attack'; BASELINE.json configs[2]).  Requires the disk corpus: "
            "python scripts/gen_corpus.py --out datasets/corpus100.  The "
            "in-memory `corpus` below is only the fallback when the disk "
            "corpus is absent (and is then honestly a ~4h run)."
        ),
        corpus=CorpusConfig(num_traces=24, duration_sec=600.0,
                            num_target_files=45, benign_rate_hz=60.0),
        # graph capacities match the corpus generator's auto-fit (densest
        # window × 1.25 headroom, pow2 bucket → 1024/2048): smaller buckets
        # truncate attack-burst windows
        dataset=DatasetConfig(
            graph=GraphConfig(window_sec=45.0, stride_sec=15.0,
                              max_nodes=1024, max_edges=2048),
            seq_len=100, max_seqs=128),
        train=TrainConfig(batch_size=8, num_steps=12000, eval_every=500),
        corpus_dir="datasets/corpus100",
    )
    dense = Experiment(
        name="joint-dense",
        description=(
            "Joint model at the DEPLOYED density bucket: 4096 nodes / 8192 "
            "edges, trained on ~25k-event windows (550 Hz × 45 s — the "
            "threat-model.mdx:121-137 live-capture projection).  The "
            "flagship joint-100h trains at the corpus-fitted 1024/2048; "
            "this experiment is the proof the stack trains at the bucket "
            "real eBPF density actually needs (VERDICT r4 weak #4: that "
            "bucket had never been trained or benched)."
        ),
        corpus=CorpusConfig(num_traces=8, duration_sec=180.0,
                            num_target_files=45, benign_rate_hz=550.0,
                            eval_fraction=0.25),
        dataset=DatasetConfig(
            graph=GraphConfig(window_sec=45.0, stride_sec=15.0,
                              max_nodes=4096, max_edges=8192),
            seq_len=100, max_seqs=128),
        train=TrainConfig(batch_size=8, num_steps=3000, eval_every=250),
    )
    mcts = Experiment(
        name="mcts-lockbit",
        description=(
            "MCTS rollback planner with GNN value net on the LockBit-on-"
            "WordPress scenario (architecture.mdx:62-72; BASELINE.json configs[3])"
        ),
        corpus=CorpusConfig(num_traces=6, duration_sec=300.0),
        train=TrainConfig(model=_small_joint(), batch_size=8, num_steps=600),
        mcts=MCTSConfig(num_simulations=800, batch_size=32),
    )
    multihost = Experiment(
        name="multihost-online",
        description=(
            "Multi-host pod training + online planner (supply-chain image-"
            "poison scenario; BASELINE.json configs[4]): dp×tp mesh for the "
            "joint model, sp ring attention for the stream detector"
        ),
        corpus=CorpusConfig(num_traces=16, duration_sec=600.0),
        train=TrainConfig(batch_size=16, num_steps=2000, eval_every=200),
        mesh=MeshConfig(dp=-1, tp=2, sp=1),
        mcts=MCTSConfig(num_simulations=1000, batch_size=64),
        stream=StreamConfig(),
    )
    return {e.name: e for e in (toy, lstm, joint, dense, mcts, multihost)}


EXPERIMENTS: Dict[str, Experiment] = _experiments()


def get_experiment(name_or_path: str) -> Experiment:
    """Resolve a registry name, a ``configs/<name>.json``, or any JSON path."""
    if name_or_path in EXPERIMENTS:
        return EXPERIMENTS[name_or_path]
    p = Path(name_or_path)
    if p.exists():
        return Experiment.load(p)
    p = CONFIG_DIR / f"{name_or_path}.json"
    if p.exists():
        return Experiment.load(p)
    raise KeyError(
        f"unknown experiment {name_or_path!r}; registry: {sorted(EXPERIMENTS)}"
    )


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="nerrf_tpu_torch.config")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list")
    d = sub.add_parser("dump")
    d.add_argument("name")
    d.add_argument("--out")
    args = ap.parse_args(argv)

    if args.cmd == "list":
        for name, e in EXPERIMENTS.items():
            print(f"{name:18s} {e.description}")
    elif args.cmd == "dump":
        exp = get_experiment(args.name)
        if args.out:
            exp.save(args.out)
        else:
            print(exp.to_json(), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
