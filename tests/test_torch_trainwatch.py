"""The port's training-health plane (nerrf_tpu_torch.trainwatch) against the
JAX package's, on the CPU.

Tolerances:

* ``step_telemetry``, ``global_norm``, ``nonfinite_count`` on the same
  params and gradients (numpy, from a seed): relative 1e-6 (float32 sums
  in another order); the nonfinite flags and counts equal;
* the in-step telemetry against an independent float64 norm of the same
  raw gradients and update: relative 1e-6;
* the two monitors fed one scripted sequence of losses and telemetry on one
  scripted clock: equal ``snapshot()``s, gauges and journal records, the
  same latch step.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerrf_tpu.flight.journal import EventJournal as JEventJournal
from nerrf_tpu.observability import MetricsRegistry as JMetricsRegistry
from nerrf_tpu.trainwatch import monitor as jmonitor
from nerrf_tpu.trainwatch import telemetry as jtelemetry
from nerrf_tpu_torch import trainwatch
from nerrf_tpu_torch.data import make_corpus
from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL, EventJournal
from nerrf_tpu_torch.graph import GraphConfig
from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.train import data as tdata
from nerrf_tpu_torch.train import elastic
from nerrf_tpu_torch.train import loop as tloop
from nerrf_tpu_torch.train import run
from nerrf_tpu_torch.trainwatch import monitor as tmonitor

RTOL = 1e-6
TINY = JointConfig(
    gnn=GraphSAGEConfig(hidden=16, num_layers=2, dropout=0.1, dtype=torch.float32,
                        aggregation="segment"),
    lstm=LSTMConfig(hidden=16, num_layers=1, dropout=0.1, dtype=torch.float32))
SHAPES = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}


@pytest.fixture(scope="module")
def ds():
    return tdata.build_dataset(
        make_corpus(n_traces=2, duration_sec=60.0, num_target_files=4,
                    benign_rate_hz=20.0, base_seed=3),
        tdata.DatasetConfig(graph=GraphConfig(window_sec=45.0, stride_sec=20.0,
                                              max_nodes=64, max_edges=128),
                            seq_len=24, max_seqs=32))


def _tree(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("poison", [None, "nan_grad", "inf_loss", "nan_component"])
def test_step_telemetry_matches_the_reference(poison):
    rng = np.random.default_rng(11)
    old, grads = _tree(rng), _tree(rng, 0.3)
    new = {k: v - 0.01 * grads[k] for k, v in old.items()}
    loss = np.float32(1.25)
    losses = {"edge_loss": np.float32(0.5), "node_loss": np.float32(0.25),
              "seq_loss": np.float32(0.5)}
    if poison == "nan_grad":
        grads["a"][2, 3] = np.nan
        grads["c"][0, 0, 1] = np.inf
    elif poison == "inf_loss":
        loss = np.float32(np.inf)
    elif poison == "nan_component":
        losses["node_loss"] = np.float32(np.nan)
    t = lambda tree: {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}
    got = trainwatch.step_telemetry(t(old), t(new), t(grads), torch.tensor(loss),
                                    t(losses))
    want = jtelemetry.step_telemetry(j(old), j(new), j(grads), jnp.asarray(loss),
                                     j(losses))
    assert got.keys() == want.keys()
    for k in ("grad_norm", "param_norm", "update_norm", "update_ratio"):
        g, w = float(got[k]), float(want[k])
        if math.isfinite(w):
            assert abs(g - w) <= RTOL * abs(w), k
        else:
            assert not math.isfinite(g), k
    assert got["nonfinite"].keys() == want["nonfinite"].keys()
    for k, v in want["nonfinite"].items():
        assert float(got["nonfinite"][k]) == float(v), k
    assert float(trainwatch.nonfinite_count(t(grads))) == float(
        jtelemetry.nonfinite_count(j(grads)))
    assert float(trainwatch.global_norm([])) == float(jtelemetry.global_norm([])) == 0.0


def test_train_step_telemetry_reads_its_own_gradients(ds):
    cfg = tloop.TrainConfig(model=TINY, batch_size=4, num_steps=3, warmup_steps=0,
                            telemetry=True)
    batch = tloop.batch_to_device(ds.arrays, np.arange(4), "cpu")
    state = tloop.init_state(cfg, "cpu")
    twin = tloop.init_state(cfg, "cpu").model
    before = [p.detach().double().clone() for p in state.model.parameters()]
    step = tloop.make_train_step(state.model, cfg)
    state, loss, aux = step(state, batch, torch.Generator().manual_seed(2))
    tel = aux["telemetry"]
    loss_fn = tloop.make_loss_fn(twin, cfg)
    twin_loss, _ = loss_fn(batch, torch.Generator().manual_seed(2))
    twin_loss.backward()
    want = math.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in twin.parameters()
                         if p.grad is not None))
    assert float(twin_loss.detach()) == float(loss)
    assert abs(float(tel["grad_norm"]) - want) <= RTOL * want
    upd = math.sqrt(sum(float(((p.detach().double() - b) ** 2).sum())
                        for p, b in zip(state.model.parameters(), before)))
    assert abs(float(tel["update_norm"]) - upd) <= 1e-5 * upd
    floats = tloop._telemetry_floats(aux)
    assert set(floats["nonfinite"]) == {"edge_loss", "node_loss", "seq_loss", "total",
                                        "grads"}
    assert not any(floats["nonfinite"].values())
    assert set(tloop._loss_components(aux)) == {"edge_loss", "node_loss", "seq_loss"}
    entry = tloop._history_entry(0, loss, aux)
    assert set(entry) == {"step", "loss", "grad_norm", "update_ratio"}


class _Clock:
    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t


def _script():
    """(loss, telemetry, data_wait_s) per observation: a calm run, a wait-
    heavy stretch, a sustained spike, then a non-finite gradient."""
    out = []
    for i in range(40):
        loss = 1.0 - 0.01 * i
        if 20 <= i < 24:
            loss = 50.0
        tel = {"grad_norm": 0.5 + 0.01 * i, "param_norm": 10.0, "update_norm": 0.01,
               "update_ratio": 0.001 * (1 + i % 3),
               "nonfinite": {"edge_loss": 0.0, "node_loss": 0.0, "seq_loss": 0.0,
                             "total": 0.0, "grads": 3.0 if i == 30 else 0.0}}
        out.append((loss, tel, 0.9 if 10 <= i < 30 else 0.05))
    return out


@pytest.mark.parametrize("halt", [True, False])
def test_monitor_matches_the_reference(monkeypatch, halt):
    runs = []
    for mod, reg_cls, jour_cls in ((tmonitor, MetricsRegistry, EventJournal),
                                   (jmonitor, JMetricsRegistry, JEventJournal)):
        clock, logs = _Clock(), []
        monkeypatch.setattr(mod, "time", clock)
        reg, journal = reg_cls(), jour_cls()
        cfg = mod.TrainHealthConfig(starved_min_steps=4, journal_every=5,
                                    halt_on_divergence=halt)
        mon = mod.TrainHealthMonitor(cfg, registry=reg, journal=journal, log=logs.append)
        mon.set_run(config_fingerprint="abc", steps=400, seed=1)
        halted_at, snaps = None, []
        for i, (loss, tel, wait) in enumerate(_script()):
            clock.t += 1.0
            mon.observe_step(10 * i, loss, telemetry=tel, data_wait_s=wait,
                             components={"edge_loss": loss / 2})
            snaps.append(mon.snapshot())
            if mon.should_halt and halted_at is None:
                halted_at = 10 * i
        mon.note_checkpoint("ckpt/step_00000100", 100)
        runs.append(dict(snaps=snaps, halted_at=halted_at, diverged=mon.diverged,
                         info=mon.flight_info(), ready=mon.ready(),
                         reg=json.loads(json.dumps(reg.snapshot())),
                         journal=[(r.kind, r.data) for r in journal.tail()],
                         logs=logs))
    port, ref = runs
    assert port["snaps"] == ref["snaps"]
    assert port["diverged"] == ref["diverged"] and port["diverged"][0] == 220
    assert port["halted_at"] == ref["halted_at"] == (220 if halt else None)
    assert port["info"] == ref["info"] and port["ready"] == ref["ready"]
    assert port["reg"] == ref["reg"]
    assert port["journal"] == ref["journal"]
    kinds = [k for k, _ in port["journal"]]
    assert kinds.count("train_health") >= 8
    # no flight recorder attached: a trigger logs and dumps no bundle
    assert port["logs"] == ref["logs"]
    assert any("train_divergence" in m and "no bundle" in m for m in port["logs"])
    assert any("train_starvation" in m for m in port["logs"])


def test_monitor_config_and_gauge_help_are_the_references():
    assert tmonitor.TrainHealthConfig() == tmonitor.TrainHealthConfig(
        **vars(jmonitor.TrainHealthConfig()))
    assert tmonitor._HELP == jmonitor._HELP


def _poisoned(ds, cfg):
    """A copy of ``ds`` with NaN node features in one window that the
    schedule first trains on at a step past 0; that step."""
    sched = tloop.make_idx_schedule(len(ds), cfg)
    for step in range(1, cfg.num_steps):
        fresh = set(sched[step].tolist()) - set(sched[:step].ravel().tolist())
        if fresh:
            break
    arrays = dict(ds.arrays, node_feat=ds.arrays["node_feat"].copy())
    arrays["node_feat"][min(fresh)] = np.nan
    return tdata.WindowDataset(arrays), step


@pytest.mark.parametrize("path", ["resident", "streamed"])
def test_a_nan_window_halts_train_nerrfnet(ds, monkeypatch, path):
    if path == "streamed":
        monkeypatch.setenv("NERRF_RESIDENT_MAX_BYTES", "0")
    cfg = tloop.TrainConfig(model=TINY, batch_size=2, num_steps=8, warmup_steps=1,
                            eval_every=1, telemetry=True)
    bad, at = _poisoned(ds, cfg)
    logs = []
    mon = trainwatch.TrainHealthMonitor(log=logs.append)
    seq = DEFAULT_JOURNAL.seq
    res = tloop.train_nerrfnet(bad, cfg=cfg, device="cpu", monitor=mon, log=logs.append)
    assert res.metrics == {}
    assert [h["step"] for h in res.history] == list(range(at + 1))
    assert mon.diverged[0] == at > 0 and "non-finite" in mon.diverged[1]
    assert mon.should_halt and mon.snapshot()["observed"] == at + 1
    assert sum("train_divergence" in m for m in logs) == 1  # latched once
    assert any(m.startswith(f"trainwatch: halting at step {at}") for m in logs)
    done = [r for r in DEFAULT_JOURNAL.tail() if r.seq > seq and r.kind == "train_done"]
    assert done[-1].data["halted"] == mon.diverged[1] and done[-1].data["steps_done"] == at + 1


def test_a_diverged_elastic_run_keeps_the_last_good_checkpoint(ds, tmp_path):
    cfg = tloop.TrainConfig(model=TINY, batch_size=2, num_steps=8, warmup_steps=1,
                            telemetry=True, seed=5)
    window = int(np.random.default_rng((cfg.seed, 5)).choice(len(ds), size=2,
                                                             replace=False)[0])
    arrays = dict(ds.arrays, node_feat=ds.arrays["node_feat"].copy())
    arrays["node_feat"][window] = np.nan
    mon = trainwatch.TrainHealthMonitor()
    res = elastic.train_elastic(tdata.WindowDataset(arrays), cfg=cfg, ckpt_dir=tmp_path,
                                save_every=2, monitor=mon, device="cpu")
    assert res.metrics == {} and mon.diverged[0] == 5
    assert elastic.latest_step(tmp_path) == 4
    assert mon.flight_info()["last_good_checkpoint_step"] == 4


def test_run_experiment_with_a_monitor_halts_and_saves_nothing(tmp_path, monkeypatch):
    from nerrf_tpu_torch.train import data as tdata_mod

    real = tdata_mod.build_dataset
    calls = []

    def poisoned(traces, cfg=None):
        out = real(traces, cfg)
        calls.append(len(out))
        if len(calls) == 1:  # the train split
            out.arrays["node_feat"][:] = np.nan
        return out

    monkeypatch.setattr(tdata_mod, "build_dataset", poisoned)
    exp = {
        "name": "tiny-nan", "description": "a diverging run",
        "corpus": {"num_traces": 3, "attack_fraction": 0.5, "base_seed": 42,
                   "duration_sec": 90.0, "num_target_files": 6,
                   "benign_rate_hz": 10.0, "eval_fraction": 0.34},
        "dataset": {"graph": {"window_sec": 45.0, "stride_sec": 15.0,
                              "max_nodes": 128, "max_edges": 256},
                    "seq_len": 24, "max_seqs": 32, "min_events": 4},
        "train": {"model": {"gnn": {"hidden": 16, "num_layers": 2, "dtype": "float32"},
                            "lstm": {"hidden": 16, "num_layers": 1, "dtype": "float32"},
                            "fuse": True},
                  "batch_size": 4, "num_steps": 4, "eval_every": 1, "seed": 0},
    }
    (tmp_path / "nan.json").write_text(json.dumps(exp))
    mon = trainwatch.TrainHealthMonitor()
    report = run.run_experiment(str(tmp_path / "nan.json"), tmp_path / "out",
                                device="cpu", monitor=mon)
    assert report["gates"] == {"not_diverged": False} and report["metrics"] == {}
    assert report["diverged"]["step"] == 0
    assert json.loads((tmp_path / "out" / "metrics.json").read_text()) == report
    assert not (tmp_path / "out" / "model").exists()
    saved = json.loads((tmp_path / "out" / "experiment.json").read_text())
    assert saved["train"]["telemetry"] is False  # the monitor turned it on for the run


def test_history_stays_bounded(ds, monkeypatch):
    assert tloop.HISTORY_LIMIT == 512
    monkeypatch.setattr(tloop, "HISTORY_LIMIT", 3)
    cfg = tloop.TrainConfig(model=TINY, batch_size=2, num_steps=6, warmup_steps=1,
                            eval_every=1)
    short = tloop.train_nerrfnet(ds, cfg=cfg, device="cpu")
    full = tloop.train_nerrfnet(ds, cfg=cfg, device="cpu", full_history=True)
    assert [h["step"] for h in short.history] == [3, 4, 5]
    assert [h["step"] for h in full.history] == list(range(6))
    assert full.history[3:] == short.history
