"""The port's resident, scheduled and superstep train steps and the upload
that puts a dataset on the device (nerrf_tpu_torch.train.loop), on the CPU.

Tolerances:

* inside the port, every flavor against the streamed step (same init, same
  schedule rows, one dropout generator drawn in the same order, dropout
  on): bit-equal losses and params;
* the port's scheduled training against the JAX package's
  ``make_train_step_scheduled`` from the same converted init (float32,
  dropout 0, ``segment``): losses rtol 1e-4, the limit of
  ``test_train_step_tracks_reference`` (measured at most 3.8e-6 there);
* the path choice (``_fits_resident`` and ``NERRF_RESIDENT_MAX_BYTES``) and
  the upload: equal.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerrf_tpu.data.synth import make_corpus as j_make_corpus
from nerrf_tpu.graph import GraphConfig as JGraphConfig
from nerrf_tpu.models.joint import JointConfig as JJointConfig
from nerrf_tpu.models.joint import NerrfNet as JNerrfNet
from nerrf_tpu.train import data as jdata
from nerrf_tpu.train import loop as jloop
from nerrf_tpu_torch import tracing
from nerrf_tpu_torch.convert import load_flax_params
from nerrf_tpu_torch.data import make_corpus
from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL
from nerrf_tpu_torch.graph import GraphConfig
from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig, NerrfNet
from nerrf_tpu_torch.observability import DEFAULT_REGISTRY
from nerrf_tpu_torch.train import data as tdata
from nerrf_tpu_torch.train import loop as tloop

CORPUS = dict(n_traces=2, duration_sec=60.0, num_target_files=4,
              benign_rate_hz=20.0, base_seed=3)
GRAPH = dict(window_sec=45.0, stride_sec=20.0, max_nodes=64, max_edges=128)
SEQS = dict(seq_len=24, max_seqs=32)
LOSS_RTOL = 1e-4
# 2 layers of width 16, dropout on: the flavors must agree bit for bit
TINY = JointConfig(
    gnn=GraphSAGEConfig(hidden=16, num_layers=2, dropout=0.1, dtype=torch.float32,
                        aggregation="segment"),
    lstm=LSTMConfig(hidden=16, num_layers=1, dropout=0.1, dtype=torch.float32))


@pytest.fixture(scope="module")
def datasets():
    ds = tdata.build_dataset(make_corpus(**CORPUS),
                             tdata.DatasetConfig(graph=GraphConfig(**GRAPH), **SEQS))
    jds = jdata.build_dataset(j_make_corpus(**CORPUS),
                              jdata.DatasetConfig(graph=JGraphConfig(**GRAPH), **SEQS))
    return ds, jds


def _params(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _run(kind, ds, cfg, k=3):
    """``cfg.num_steps`` steps of one flavor from the seed's init: the losses
    (floats) and the final params."""
    state = tloop.init_state(cfg, "cpu")
    gen = torch.Generator().manual_seed(cfg.seed)
    sched = tloop.make_idx_schedule(len(ds), cfg)
    losses = []
    if kind == "streamed":
        step = tloop.make_train_step(state.model, cfg)
        for s in range(cfg.num_steps):
            state, loss, _ = step(state, tloop.batch_to_device(ds.arrays, sched[s], "cpu"),
                                  gen)
            losses.append(float(loss))
    elif kind == "resident":
        step = tloop.make_train_step_resident(state.model, cfg, ds.arrays)
        for s in range(cfg.num_steps):
            state, loss, _ = step(state, sched[s], gen)
            losses.append(float(loss))
    elif kind == "scheduled":
        step = tloop.make_train_step_scheduled(state.model, cfg, ds.arrays, sched)
        for _ in range(cfg.num_steps):
            state, loss, _ = step(state, gen)
            losses.append(float(loss))
    else:
        step = tloop.make_train_superstep(state.model, cfg, ds.arrays, sched, k)
        for _ in range(cfg.num_steps // k):
            state, chunk = step(state, gen)
            assert chunk.shape == (k,)
            losses.extend(chunk.tolist())
    return losses, _params(state), state.step


@pytest.fixture(scope="module")
def flavors(datasets):
    ds, _ = datasets
    cfg = tloop.TrainConfig(model=TINY, batch_size=4, num_steps=6, warmup_steps=1,
                            seed=4)
    return {kind: _run(kind, ds, cfg)
            for kind in ("streamed", "resident", "scheduled", "superstep")}


@pytest.mark.parametrize("kind", ["resident", "scheduled", "superstep"])
def test_flavor_is_bit_equal_to_the_streamed_step(flavors, kind):
    want_losses, want, want_step = flavors["streamed"]
    losses, params, step = flavors[kind]
    assert step == want_step == 6
    assert losses == want_losses
    assert np.isfinite(losses).all()
    for name in want:
        assert torch.equal(params[name], want[name]), name


def test_train_nerrfnet_resident_equals_streamed(datasets, monkeypatch):
    ds, _ = datasets
    cfg = tloop.TrainConfig(model=TINY, batch_size=4, num_steps=5, warmup_steps=1,
                            eval_every=1)
    since = time.perf_counter()
    res = tloop.train_nerrfnet(ds, cfg=cfg, device="cpu")
    monkeypatch.setenv("NERRF_RESIDENT_MAX_BYTES", "0")
    streamed = tloop.train_nerrfnet(ds, cfg=cfg, device="cpu")
    loops = [s.args["resident"] for s in tracing.records()
             if s.name == "train_loop" and s.t0 >= since]
    assert loops == [True, False]
    assert [h["loss"] for h in res.history] == [h["loss"] for h in streamed.history]
    for (name, a), b in zip(res.state.model.state_dict().items(),
                            streamed.state.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert res.metrics == streamed.metrics


@pytest.mark.parametrize("limit", [None, "0", "1000000", str(10 ** 12)])
def test_fits_resident_picks_the_reference_branch(datasets, monkeypatch, limit):
    ds, jds = datasets
    if limit is not None:
        monkeypatch.setenv("NERRF_RESIDENT_MAX_BYTES", limit)
    assert tloop.RESIDENT_MAX_BYTES == jloop.RESIDENT_MAX_BYTES == 2 << 30
    assert tloop._dataset_bytes(ds.arrays) == jloop._dataset_bytes(jds.arrays)
    for arrays in (ds.arrays, {k: v[:1] for k, v in ds.arrays.items()}):
        assert tloop._fits_resident(arrays) == jloop._fits_resident(arrays)


def test_scheduled_training_tracks_the_reference(datasets):
    ds, jds = datasets
    jc, tc = JJointConfig(), JointConfig()
    jc = dataclasses.replace(
        jc, gnn=dataclasses.replace(jc.gnn, hidden=16, num_layers=2, dtype=jnp.float32,
                                    dropout=0.0),
        lstm=dataclasses.replace(jc.lstm, hidden=16, num_layers=1, dtype=jnp.float32,
                                 dropout=0.0))
    tc = dataclasses.replace(
        tc, gnn=dataclasses.replace(tc.gnn, hidden=16, num_layers=2, dtype=torch.float32,
                                    dropout=0.0, aggregation="segment"),
        lstm=dataclasses.replace(tc.lstm, hidden=16, num_layers=1, dtype=torch.float32,
                                 dropout=0.0))
    kw = dict(batch_size=4, num_steps=5, warmup_steps=1, seed=0)
    jcfg, cfg = jloop.TrainConfig(model=jc, **kw), tloop.TrainConfig(model=tc, **kw)
    sched = tloop.make_idx_schedule(len(ds), cfg)
    jmodel = JNerrfNet(jc)
    jstate = jloop.init_state(jmodel, jcfg, jds.arrays, jax.random.PRNGKey(0))
    init = jax.device_get(jstate.params)
    jstep = jloop.make_train_step_scheduled(jmodel, jcfg, jds.arrays, sched)
    model = load_flax_params(NerrfNet(tc), init)
    state = tloop.TrainState(model, tloop.make_tx(model, cfg))
    step = tloop.make_train_step_scheduled(model, cfg, ds.arrays, sched)
    rng = jax.random.PRNGKey(1)
    want, got = [], []
    for _ in range(cfg.num_steps):
        jstate, jl, _, rng = jstep(jstate, rng)
        state, loss, _ = step(state)
        want.append(float(jl))
        got.append(float(loss))
    assert state.step == int(jstate.step) == cfg.num_steps
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_chunked_upload_equals_a_single_copy(datasets):
    ds, _ = datasets
    up = tloop.device_put_chunked(ds.arrays, max_bytes=1 << 10, device="cpu")
    assert up.event is None and up.seconds() is None
    up.wait()
    assert up.nbytes == tloop._dataset_bytes(ds.arrays)
    assert up.arrays.keys() == ds.arrays.keys()
    for k, v in ds.arrays.items():
        single = torch.from_numpy(v)
        assert up.arrays[k].dtype == single.dtype, k
        assert torch.equal(up.arrays[k], single), k
        assert up.arrays[k].data_ptr() != single.data_ptr()  # a copy
    f16 = {"x": ds.arrays["node_feat"].astype(np.float16)}
    batch = tloop._gather(tloop.device_put_chunked(f16, device="cpu").arrays,
                          torch.tensor([2, 0]))
    assert batch["x"].dtype == torch.float32  # cast after the gather
    assert torch.equal(batch["x"], torch.from_numpy(f16["x"][[2, 0]].astype(np.float32)))


def test_journal_and_gauges_of_a_run(datasets):
    ds, _ = datasets
    cfg = tloop.TrainConfig(model=TINY, batch_size=4, num_steps=3, warmup_steps=1,
                            eval_every=2)
    seq = DEFAULT_JOURNAL.seq
    res = tloop.train_nerrfnet(ds, cfg=cfg, device="cpu")
    recs = [r for r in DEFAULT_JOURNAL.tail() if r.seq > seq]
    assert [r.kind for r in recs] == ["train_start", "train_done"]
    assert recs[0].data["steps"] == 3 and recs[0].data["windows"] == len(ds)
    assert recs[1].data["steps_done"] == 3 and "halted" not in recs[1].data
    assert recs[1].data["metrics"]["edge_auc"] == round(res.metrics["edge_auc"], 4)
    assert DEFAULT_REGISTRY.value("train_step") == 2.0
    assert DEFAULT_REGISTRY.value("train_loss") == res.history[-1]["loss"]
    bucket = f"{GRAPH['max_nodes']}n/{GRAPH['max_edges']}e"
    for kind, frac in tdata.padding_waste_fractions(ds.arrays).items():
        assert DEFAULT_REGISTRY.value("train_padding_waste_fraction",
                                      labels={"kind": kind, "bucket": bucket}) == frac


def test_traced_steps_report_the_host_fractions(datasets, monkeypatch):
    ds, _ = datasets
    cfg = tloop.TrainConfig(model=TINY, batch_size=4, num_steps=3, warmup_steps=1)
    monkeypatch.setattr(tracing, "_ENABLED", True)
    monkeypatch.setenv("NERRF_RESIDENT_MAX_BYTES", "0")
    since = time.perf_counter()
    tloop.train_nerrfnet(ds, cfg=cfg, device="cpu")
    names = [s.name for s in tracing.records() if s.t0 >= since]
    assert names.count("device_step") == 3 and names.count("data_wait") == 3
    for gauge in ("train_host_blocked_fraction", "train_data_wait_fraction"):
        assert 0.0 <= DEFAULT_REGISTRY.value(gauge) <= 1.0
