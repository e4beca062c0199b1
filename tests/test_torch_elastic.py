"""The port's elastic training (nerrf_tpu_torch.train.elastic) on the CPU:
preempt → resume reproduces the uninterrupted run bit for bit (dropout on),
the checkpoint directory's commit rules and heartbeat are the reference's,
each step draws its batch from ``default_rng((seed, step))`` as the
reference's loop does, and ``run_experiment(ckpt_every=...)`` trains through
it to a ``metrics.json``."""

import json
import time

import numpy as np
import pytest
import torch

from nerrf_tpu.train import elastic as jelastic
from nerrf_tpu_torch.data import make_corpus
from nerrf_tpu_torch.graph import GraphConfig
from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig
from nerrf_tpu_torch.train import data as tdata
from nerrf_tpu_torch.train import elastic
from nerrf_tpu_torch.train import loop as tloop
from nerrf_tpu_torch.train import run

TINY = JointConfig(
    gnn=GraphSAGEConfig(hidden=16, num_layers=2, dropout=0.1, dtype=torch.float32,
                        aggregation="segment"),
    lstm=LSTMConfig(hidden=16, num_layers=1, dropout=0.1, dtype=torch.float32))


@pytest.fixture(scope="module")
def ds():
    return tdata.build_dataset(
        make_corpus(n_traces=2, duration_sec=60.0, num_target_files=4,
                    benign_rate_hz=20.0, base_seed=3),
        tdata.DatasetConfig(graph=GraphConfig(window_sec=45.0, stride_sec=20.0,
                                              max_nodes=64, max_edges=128),
                            seq_len=24, max_seqs=32))


def _cfg(num_steps=12):
    return tloop.TrainConfig(model=TINY, batch_size=2, num_steps=num_steps,
                             warmup_steps=2, seed=3)


def _state_dicts_equal(a, b):
    for (name, x), y in zip(a.state.model.state_dict().items(),
                            b.state.model.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = a.state.optimizer.state_dict(), b.state.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


@pytest.mark.parametrize("path", ["resident", "streamed"])
def test_preempt_resume_is_bit_identical(tmp_path, ds, monkeypatch, path):
    if path == "streamed":
        monkeypatch.setenv("NERRF_RESIDENT_MAX_BYTES", "0")
    cfg = _cfg(12)
    ref = elastic.train_elastic(ds, cfg=cfg, ckpt_dir=tmp_path / "ref", save_every=4,
                                device="cpu")
    with pytest.raises(elastic.Preemption):
        elastic.train_elastic(ds, cfg=cfg, ckpt_dir=tmp_path / "pre", save_every=4,
                              fault=elastic.fault_at(6), device="cpu")
    assert elastic.latest_step(tmp_path / "pre") == 4
    lines = []
    res = elastic.train_elastic(ds, cfg=cfg, ckpt_dir=tmp_path / "pre", save_every=4,
                                device="cpu", log=lines.append)
    assert "resumed from step 4" in lines
    assert res.state.step == ref.state.step == cfg.num_steps
    _state_dicts_equal(ref, res)
    assert res.history == ref.history[1:]  # the resumed run logs from step 7
    assert elastic.latest_step(tmp_path / "pre") == cfg.num_steps
    assert res.metrics == ref.metrics


def test_each_step_draws_from_its_own_seed(tmp_path, ds, monkeypatch):
    cfg = _cfg(5)
    drawn = []
    real = tloop._gather

    def recording(data, idx):
        drawn.append(idx.numpy().copy())
        return real(data, idx)

    monkeypatch.setattr(tloop, "_gather", recording)
    elastic.train_elastic(ds, cfg=cfg, ckpt_dir=tmp_path, save_every=10, device="cpu")
    n = len(ds)
    want = [np.random.default_rng((cfg.seed, s)).choice(n, size=cfg.batch_size,
                                                        replace=False)
            for s in range(cfg.num_steps)]
    assert len(drawn) == len(want)
    for a, b in zip(drawn, want):
        np.testing.assert_array_equal(a, b)
    # dropout: one generator re-seeded per step by a fixed function of (seed, step)
    seeds = {tloop._step_seed(cfg.seed, s) for s in range(100)}
    assert len(seeds) == 100 and tloop._step_seed(3, 7) == tloop._step_seed(3, 7)


def test_torn_checkpoint_is_ignored(tmp_path, ds):
    cfg = _cfg(8)
    elastic.train_elastic(ds, cfg=cfg, ckpt_dir=tmp_path / "c", save_every=4,
                          device="cpu")
    assert elastic.latest_step(tmp_path / "c") == jelastic.latest_step(tmp_path / "c") == 8
    (tmp_path / "c" / "step_00000008" / "meta.json").unlink()
    assert elastic.latest_step(tmp_path / "c") == jelastic.latest_step(tmp_path / "c") == 4
    saved = torch.load(tmp_path / "c" / "step_00000004" / elastic.STATE_FILENAME,
                       weights_only=True)
    assert saved["step"] == 4 and {"model", "optimizer"} <= set(saved)
    assert all(v.device.type == "cpu" for v in saved["model"].values())


def test_staged_meta_tmp_is_not_a_commit_marker(tmp_path):
    ok = tmp_path / "step_00000008"
    ok.mkdir(parents=True)
    (ok / "meta.json").write_text(json.dumps({"step": 8}) + "\n")
    torn = tmp_path / "step_00000016"
    torn.mkdir(parents=True)
    (torn / "meta.json.tmp").write_text('{"step": 1')  # killed mid-write
    assert elastic.latest_step(tmp_path) == jelastic.latest_step(tmp_path) == 8
    assert elastic.latest_step(tmp_path / "none") is None


def test_heartbeat_failure_detection(tmp_path):
    assert elastic.HEARTBEAT_SEC == jelastic.HEARTBEAT_SEC
    assert elastic.stale_heartbeat(tmp_path, timeout_sec=60)  # none yet
    elastic._heartbeat(tmp_path, 3)
    assert not elastic.stale_heartbeat(tmp_path, timeout_sec=60)
    assert not jelastic.stale_heartbeat(tmp_path, timeout_sec=60)
    hb = tmp_path / "heartbeat.json"
    hb.write_text(json.dumps({"step": 1, "ts": time.time() - 120}))
    assert elastic.stale_heartbeat(tmp_path, timeout_sec=60)
    assert jelastic.stale_heartbeat(tmp_path, timeout_sec=60)


def test_compile_cache_is_refused(tmp_path, ds):
    with pytest.raises(NotImplementedError, match="B.D1"):
        elastic.train_elastic(ds, cfg=_cfg(2), ckpt_dir=tmp_path, compile_cache=object(),
                              device="cpu")


def _experiment(tmp):
    exp = {
        "name": "tiny-elastic", "description": "the ckpt_every branch",
        "corpus": {"num_traces": 3, "attack_fraction": 0.5, "base_seed": 42,
                   "duration_sec": 90.0, "num_target_files": 6,
                   "benign_rate_hz": 10.0, "eval_fraction": 0.34},
        "dataset": {"graph": {"window_sec": 45.0, "stride_sec": 15.0,
                              "max_nodes": 128, "max_edges": 256},
                    "seq_len": 24, "max_seqs": 32, "min_events": 4},
        "train": {"model": {"gnn": {"hidden": 16, "num_layers": 2, "dropout": 0.0,
                                    "dtype": "float32", "aggregation": "segment"},
                            "lstm": {"hidden": 16, "num_layers": 1, "dropout": 0.0,
                                     "dtype": "float32"},
                            "fuse": True},
                  "batch_size": 4, "num_steps": 6, "warmup_steps": 2,
                  "eval_every": 10, "seed": 0},
    }
    path = tmp / "tiny-elastic.json"
    path.write_text(json.dumps(exp))
    return path


def test_run_experiment_ckpt_every_writes_metrics_and_resumes(tmp_path, capsys):
    path = _experiment(tmp_path)
    report = run.run_experiment(str(path), tmp_path / "out", ckpt_every=4,
                                calibrate=False, device="cpu")
    assert json.loads((tmp_path / "out" / "metrics.json").read_text()) == report
    assert report["num_steps"] == 6 and report["backend"] == "cpu"
    assert np.isfinite(report["metrics"]["edge_auc"])
    assert elastic.latest_step(tmp_path / "out" / "train_state") == 6
    assert (tmp_path / "out" / "model" / "params.pt").exists()
    # a second call finds the finished run and trains no step
    again = run.run_experiment(str(path), tmp_path / "out", ckpt_every=4,
                               calibrate=False, device="cpu")
    assert "resumed from step 6" in capsys.readouterr().err
    assert again["metrics"] == report["metrics"]


def test_main_passes_ckpt_every(monkeypatch, tmp_path):
    seen = {}

    def fake(name, out, steps, **kw):
        seen.update(kw, name=name, steps=steps)
        return {"gates": {"g": True}}

    monkeypatch.setattr(run, "run_experiment", fake)
    assert run.main(["--experiment", "toy-graphsage", "--out", str(tmp_path),
                     "--ckpt-every", "7", "--steps", "3", "--device", "cpu"]) == 0
    assert seen == {"name": "toy-graphsage", "steps": 3, "ckpt_every": 7, "device": "cpu"}
