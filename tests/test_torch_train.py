"""The port's training (nerrf_tpu_torch.train) against the JAX package's.

Same corpus from the same seeds, the same converted init, the same batch
schedule, float32, dropout 0, ``segment`` aggregation (what the JAX
package's ``auto`` resolves to off the TPU).  Tolerances:

* host-side copies (``make_corpus``, ``build_dataset``, the batch schedule,
  the metrics): bit-equal;
* learning-rate schedule: rtol 1e-5, atol 1e-6·lr (optax computes it in
  float32: measured 1.8e-6 relative in the warmup ramp, 3.1e-11 absolute
  near the end of the cosine);
* global-norm clip: rtol 1e-6, atol 1e-8 (one float32 rounding);
* 5-step loss trajectory: rtol 1e-4 (measured at most 3.8e-6 relative);
* params after 5 steps: atol 3 learning rates (6e-3).  Adam turns a
  near-zero gradient into an update of about ±lr whose sign can differ
  between the frameworks; measured max |Δ| 5.8e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerrf_tpu.data.synth import make_corpus as j_make_corpus
from nerrf_tpu.graph import GraphConfig as JGraphConfig
from nerrf_tpu.models.joint import JointConfig as JJointConfig
from nerrf_tpu.models.joint import NerrfNet as JNerrfNet
from nerrf_tpu.train import data as jdata
from nerrf_tpu.train import loop as jloop
from nerrf_tpu.train import metrics as jmetrics
from nerrf_tpu_torch.convert import flax_to_state_dict, load_flax_params
from nerrf_tpu_torch.data import make_corpus
from nerrf_tpu_torch.graph import GraphConfig
from nerrf_tpu_torch.models import JointConfig, NerrfNet
from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
from nerrf_tpu_torch.train import data as tdata
from nerrf_tpu_torch.train import loop as tloop
from nerrf_tpu_torch.train import metrics as tmetrics

CORPUS = dict(n_traces=2, duration_sec=60.0, num_target_files=4,
              benign_rate_hz=20.0, base_seed=3)
GRAPH = dict(window_sec=45.0, stride_sec=20.0, max_nodes=64, max_edges=128)
SEQS = dict(seq_len=24, max_seqs=32)
LOSS_RTOL = 1e-4
PARAM_ATOL_LRS = 3.0


@pytest.fixture(scope="module")
def corpora():
    return make_corpus(**CORPUS), j_make_corpus(**CORPUS)


@pytest.fixture(scope="module")
def datasets(corpora):
    tr, jtr = corpora
    ds = tdata.build_dataset(tr, tdata.DatasetConfig(graph=GraphConfig(**GRAPH), **SEQS))
    jds = jdata.build_dataset(jtr, jdata.DatasetConfig(graph=JGraphConfig(**GRAPH), **SEQS))
    return ds, jds


def test_make_corpus_is_bit_equal(corpora):
    tr, jtr = corpora
    assert [t.name for t in tr] == [t.name for t in jtr]
    for a, b in zip(tr, jtr):
        for f in dataclasses.fields(a.events):
            np.testing.assert_array_equal(getattr(a.events, f.name),
                                          getattr(b.events, f.name), err_msg=f.name)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.victim_paths == b.victim_paths
    hard = make_corpus(6, duration_sec=30.0, num_target_files=(3, 6),
                       benign_rate_hz=(5.0, 10.0), hard_scenarios=True,
                       base_seed=11)
    jhard = j_make_corpus(6, duration_sec=30.0, num_target_files=(3, 6),
                          benign_rate_hz=(5.0, 10.0), hard_scenarios=True,
                          base_seed=11)
    for a, b in zip(hard, jhard):
        assert a.name == b.name and a.events.num_valid == b.events.num_valid
        np.testing.assert_array_equal(a.events.ts_ns, b.events.ts_ns)


def test_build_dataset_and_helpers_are_bit_equal(corpora, datasets):
    ds, jds = datasets
    assert ds.arrays.keys() == jds.arrays.keys()
    for k in ds.arrays:
        np.testing.assert_array_equal(ds.arrays[k], jds.arrays[k], err_msg=k)
    assert tdata.padding_waste_fractions(ds.arrays) == \
        jdata.padding_waste_fractions(jds.arrays)
    fit = tdata.fit_dataset_config(corpora[0], tdata.DatasetConfig())
    jfit = jdata.fit_dataset_config(corpora[1], jdata.DatasetConfig())
    assert dataclasses.asdict(fit) == dataclasses.asdict(jfit)
    a, b = ds.split(0.5, seed=2)
    ja, jb = jds.split(0.5, seed=2)
    both = tdata.WindowDataset.concatenate([a, b])
    jboth = jdata.WindowDataset.concatenate([ja, jb])
    assert len(a) == len(ja) and len(both) == len(ds)
    np.testing.assert_array_equal(both.arrays["edge_feat"], jboth.arrays["edge_feat"])


@pytest.mark.parametrize("n,steps,batch", [(6, 7, 4), (3, 5, 8), (40, 12, 8)])
def test_idx_schedule_is_bit_equal(n, steps, batch):
    cfg = tloop.TrainConfig(batch_size=batch, num_steps=steps, seed=5)
    jcfg = jloop.TrainConfig(batch_size=batch, num_steps=steps, seed=5)
    np.testing.assert_array_equal(tloop.make_idx_schedule(n, cfg),
                                  jloop.make_idx_schedule(n, jcfg))


def test_metrics_are_bit_equal():
    rng = np.random.default_rng(4)
    labels = rng.random(300) < 0.3
    scores = np.round(rng.normal(size=300) + labels, 1)  # ties on purpose
    assert tmetrics.roc_auc(labels, scores) == jmetrics.roc_auc(labels, scores)
    assert tmetrics.best_f1(labels, scores) == jmetrics.best_f1(labels, scores)
    assert tmetrics.f1_score(labels, scores > 0.5) == \
        jmetrics.f1_score(labels, scores > 0.5)


@pytest.mark.parametrize("steps,warmup", [(20, 50), (200, 50), (30, 0), (12000, 50)])
def test_lr_schedule_matches_optax(steps, warmup):
    cfg = tloop.TrainConfig(num_steps=steps, warmup_steps=warmup)
    jcfg = jloop.TrainConfig(num_steps=steps, warmup_steps=warmup)
    want = optax.warmup_cosine_decay_schedule(
        0.0, jcfg.learning_rate, jcfg.warmup_steps,
        max(jcfg.num_steps, jcfg.warmup_steps + 1))
    sched = tloop.lr_schedule(cfg)
    counts = sorted(set(range(0, min(steps, 300) + 5)) | {steps - 1, steps, steps + 7})
    got = np.array([sched(c) for c in counts])
    np.testing.assert_allclose(got, np.array([float(want(c)) for c in counts]),
                               rtol=1e-5, atol=1e-6 * jcfg.learning_rate)
    assert sched(0) == (0.0 if warmup else cfg.learning_rate)


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(9)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    grads = [rng.normal(size=s).astype(np.float32) * scale for s in shapes]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = tloop.clip_by_global_norm_(got, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                                         for g in grads)), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-8)


def _small_f32_segment():
    jc = JJointConfig().small
    tc = JointConfig().small
    jc = dataclasses.replace(
        jc, gnn=dataclasses.replace(jc.gnn, dtype=jnp.float32, dropout=0.0),
        lstm=dataclasses.replace(jc.lstm, dtype=jnp.float32, dropout=0.0))
    tc = dataclasses.replace(
        tc, gnn=dataclasses.replace(tc.gnn, dtype=torch.float32, dropout=0.0,
                                    aggregation="segment"),
        lstm=dataclasses.replace(tc.lstm, dtype=torch.float32, dropout=0.0))
    return jc, tc


def test_train_step_tracks_reference(datasets):
    # 5 steps of make_train_step on both sides from the same converted init,
    # batches and schedule (warmup 1: the first update runs at lr 0, then
    # the cosine from the peak)
    ds, jds = datasets
    jc, tc = _small_f32_segment()
    assert jc.gnn.resolved_aggregation(GRAPH["max_nodes"]) == "segment"
    kw = dict(batch_size=4, num_steps=5, warmup_steps=1, seed=0)
    jcfg = jloop.TrainConfig(model=jc, **kw)
    cfg = tloop.TrainConfig(model=tc, **kw)
    jmodel = JNerrfNet(jc)
    jstate = jloop.init_state(jmodel, jcfg, jds.arrays, jax.random.PRNGKey(0))
    init = jax.device_get(jstate.params)
    jstep = jloop.make_train_step(jmodel, jcfg)
    sched = tloop.make_idx_schedule(len(ds), cfg)
    model = load_flax_params(NerrfNet(tc), init)
    state = tloop.TrainState(model, tloop.make_tx(model, cfg))
    step = tloop.make_train_step(model, cfg)
    rng = jax.random.PRNGKey(1)
    want, got = [], []
    for s in range(cfg.num_steps):
        jstate, jl, _, rng = jstep(
            jstate, {k: jnp.asarray(v[sched[s]]) for k, v in jds.arrays.items()}, rng)
        state, loss, aux = step(
            state, {k: torch.from_numpy(v[sched[s]]) for k, v in ds.arrays.items()})
        want.append(float(jl))
        got.append(float(loss))
        assert set(aux) == {"edge_loss", "node_loss", "seq_loss"}
    assert state.step == cfg.num_steps
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    ref = flax_to_state_dict(jax.device_get(jstate.params))
    start = flax_to_state_dict(init)
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL_LRS * cfg.learning_rate, err_msg=name)
        moved = max(moved, float((p.detach() - start[name]).abs().max()))
    assert moved > cfg.learning_rate  # the run trained: params left the init


def test_train_nerrfnet_end_to_end_on_cpu(datasets):
    ds, _ = datasets
    tc = JointConfig().small
    cfg = tloop.TrainConfig(model=tc, batch_size=4, num_steps=3, eval_every=2,
                            warmup_steps=1)
    lines = []
    reset_launches()
    res = tloop.train_nerrfnet(ds, cfg=cfg, log=lines.append,
                               device="cpu")
    assert LAUNCHES == {k: 0 for k in LAUNCHES}, "the CPU runs the plain versions"
    assert [h["step"] for h in res.history] == [0, 2]
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert res.state.step == 3 and res.steps_per_sec > 0
    for k in ("edge_auc", "node_auc", "seq_auc", "seq_f1", "node_f1"):
        assert np.isfinite(res.metrics[k]), k
    assert res.metrics["num_edges_eval"] == float(ds.arrays["edge_mask"].sum())
    assert "gnn aggregation=fused" in lines[0]
