"""The port's experiment config layer (nerrf_tpu_torch.config) against the
JAX package's (nerrf_tpu.config): the same JSON in, the same dicts and the
same text out, the same registry, the same corpus splits (bit-equal)."""

import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerrf_tpu import config as jconfig
from nerrf_tpu.parallel.mesh import MeshConfig as JMeshConfig
from nerrf_tpu.planner.mcts import MCTSConfig as JMCTSConfig
from nerrf_tpu.models.stream import StreamConfig as JStreamConfig
from nerrf_tpu_torch import config
from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig
from nerrf_tpu_torch.train.loop import TrainConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_every_checked_in_config_loads_alike(path):
    want = jconfig.Experiment.load(path)
    got = config.Experiment.load(path)
    assert config.to_dict(got) == jconfig.to_dict(want)
    assert got.to_json() == want.to_json()
    assert config.get_experiment(str(path)) == got
    assert config.get_experiment(path.stem) == (config.EXPERIMENTS.get(path.stem) or got)


def test_registry_is_the_references_word_for_word():
    assert list(config.EXPERIMENTS) == list(jconfig.EXPERIMENTS)
    for name, exp in config.EXPERIMENTS.items():
        assert exp.to_json() == jconfig.EXPERIMENTS[name].to_json(), name
        assert config.Experiment.from_json(exp.to_json()) == exp
    with pytest.raises(KeyError, match="unknown experiment"):
        config.get_experiment("no-such-experiment")


def test_config_module_dataclasses_match_the_references():
    for port, ref in ((config.MeshConfig, JMeshConfig), (config.MCTSConfig, JMCTSConfig),
                      (config.StreamConfig, JStreamConfig)):
        assert config.to_dict(port()) == jconfig.to_dict(ref()), port.__name__
    for n, kw in ((8, {}), (8, dict(tp=2)), (6, dict(tp=2, sp=3)), (4, dict(dp=2, tp=2))):
        assert config.MeshConfig(**kw).resolve(n) == JMeshConfig(**kw).resolve(n)
    for n, kw in ((6, dict(tp=4)), (8, dict(dp=3))):
        with pytest.raises(ValueError) as want:
            JMeshConfig(**kw).resolve(n)
        with pytest.raises(ValueError) as got:
            config.MeshConfig(**kw).resolve(n)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("where", ["top", "train", "gnn"])
def test_unknown_keys_raise_on_both(where):
    d = json.loads(jconfig.EXPERIMENTS["toy-graphsage"].to_json())
    {"top": d, "train": d["train"], "gnn": d["train"]["model"]["gnn"]}[where]["bogus"] = 1
    text = json.dumps(d)
    with pytest.raises(KeyError, match="unknown config keys") as want:
        jconfig.Experiment.from_json(text)
    with pytest.raises(KeyError, match="unknown config keys") as got:
        config.Experiment.from_json(text)
    assert str(got.value) == str(want.value)


def test_dtypes_round_trip():
    for dt, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        cfg = JointConfig(gnn=GraphSAGEConfig(hidden=8, num_layers=1, dtype=dt),
                          lstm=LSTMConfig(hidden=8, num_layers=1, dtype=dt))
        d = config.to_dict(cfg)
        assert d["gnn"]["dtype"] == d["lstm"]["dtype"] == name
        back = config.from_dict(JointConfig, d)
        assert back == cfg and back.gnn.dtype is dt
        assert d == jconfig.to_dict(jconfig.from_dict(jconfig.JointConfig, d))
    stream = config.StreamConfig(dtype=torch.float32)
    assert config.from_dict(config.StreamConfig, config.to_dict(stream)) == stream
    exp = dataclasses.replace(config.EXPERIMENTS["multihost-online"], stream=stream)
    assert config.Experiment.from_json(exp.to_json()) == exp
    assert jconfig.Experiment.from_json(exp.to_json()).stream.dtype is jnp.float32
    # routing tables: lists in JSON, one canonical tuple shape in memory
    routed = dataclasses.replace(
        config.EXPERIMENTS["toy-graphsage"],
        train=TrainConfig(model=JointConfig(gnn=GraphSAGEConfig(
            routing=((4096, "fused"), (1024, "dense_adj"))))))
    back = config.Experiment.from_json(routed.to_json())
    assert back == routed and back.train.model.gnn.routing == ((1024, "dense_adj"), (4096, "fused"))
    assert jconfig.Experiment.from_json(routed.to_json()).to_json() == routed.to_json()
    with pytest.raises(ValueError, match="unknown dtype"):
        config.from_dict(LSTMConfig, {"dtype": "float7"})


def _assert_traces_equal(got, want):
    assert [t.name for t in got] == [t.name for t in want]
    for a, b in zip(got, want):
        for f in dataclasses.fields(a.events):
            np.testing.assert_array_equal(getattr(a.events, f.name),
                                          getattr(b.events, f.name), err_msg=f.name)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.victim_paths == b.victim_paths


@pytest.mark.parametrize("corpus", [
    dict(num_traces=4, duration_sec=120.0, num_target_files=8, benign_rate_hz=6.0,
         eval_fraction=0.5),
    # joint-100h's split cut to 6 traces: held out corpus-4-benign, corpus-5-atk
    dict(num_traces=6, duration_sec=60.0, num_target_files=6, benign_rate_hz=8.0),
    dict(num_traces=3, duration_sec=45.0, num_target_files=4, benign_rate_hz=8.0,
         eval_fraction=0.0),
])
def test_build_corpus_splits_are_bit_equal(corpus):
    exp = config.Experiment(name="split", description="",
                            corpus=config.CorpusConfig(**corpus))
    jexp = jconfig.Experiment.from_json(exp.to_json())
    train, held = exp.build_corpus()
    jtrain, jheld = jexp.build_corpus()
    _assert_traces_equal(train, jtrain)
    _assert_traces_equal(held, jheld)
    if corpus["num_traces"] == 6:
        assert [t.name for t in held] == ["corpus-4-benign", "corpus-5-atk"]


def test_cli_list_and_dump_match_the_reference(capsys, tmp_path):
    assert config.main(["list"]) == 0
    listed = capsys.readouterr().out
    assert jconfig.main(["list"]) == 0
    assert listed == capsys.readouterr().out
    assert config.main(["dump", "joint-100h"]) == 0
    assert capsys.readouterr().out == jconfig.EXPERIMENTS["joint-100h"].to_json()
    assert config.main(["dump", "toy-graphsage", "--out", str(tmp_path / "t.json")]) == 0
    assert (tmp_path / "t.json").read_text() == jconfig.EXPERIMENTS["toy-graphsage"].to_json()
