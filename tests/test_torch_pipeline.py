"""The port's host copies and its detection slice against the JAX package.

* Host copies (``schema``, ``data``, ``graph``, ``train.data``): the same
  seed and config give bit-equal arrays in both packages.
* The slice: ``nerrf_tpu_torch.pipeline.model_detect(device="cpu")`` against
  ``nerrf_tpu.pipeline.model_detect`` on a small simulated attack trace, with
  the reference's small float32 weights converted by
  ``nerrf_tpu_torch.convert``.  File and process scores agree within
  atol 1e-5 (probabilities; the logits agree within 1e-4, see
  test_torch_models.py), and the same files are flagged at 0.5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerrf_tpu import pipeline as jpipeline
from nerrf_tpu import tracing as jtracing
from nerrf_tpu.data import SimConfig as JSimConfig
from nerrf_tpu.data import load_trace_jsonl as jload_trace_jsonl
from nerrf_tpu.data import simulate_trace as jsimulate_trace
from nerrf_tpu.graph import GraphConfig as JGraphConfig
from nerrf_tpu.models.joint import JointConfig as JJointConfig
from nerrf_tpu.models.joint import NerrfNet as JNerrfNet
from nerrf_tpu.schema.events import events_to_jsonl
from nerrf_tpu.train.data import DatasetConfig as JDatasetConfig
from nerrf_tpu.train.data import windows_of_trace as jwindows_of_trace
from nerrf_tpu.train.loop import _MODEL_INPUTS
from nerrf_tpu_torch import pipeline, tracing
from nerrf_tpu_torch.convert import load_flax_params
from nerrf_tpu_torch.data import SimConfig, load_trace_jsonl, simulate_trace
from nerrf_tpu_torch.graph import GraphConfig
from nerrf_tpu_torch.models import JointConfig, NerrfNet
from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
from nerrf_tpu_torch.schema.events import EventArrays
from nerrf_tpu_torch.train.data import DatasetConfig, windows_of_trace

SCORE_ATOL = 1e-5

SIMS = {
    "attack": dict(duration_sec=60.0, attack=True, attack_start_sec=20.0,
                   num_target_files=4, benign_rate_hz=20.0, seed=2),
    "benign": dict(duration_sec=45.0, attack=False, num_target_files=3,
                   benign_rate_hz=30.0, seed=9),
    "stealth": dict(duration_sec=60.0, attack=True, attack_start_sec=15.0,
                    num_target_files=5, benign_rate_hz=15.0, seed=4,
                    scenario="inplace-stealth"),
}


def _ds_pair(max_nodes=64, max_edges=128, seq_len=24, max_seqs=32):
    g = dict(window_sec=45.0, stride_sec=20.0, max_nodes=max_nodes,
             max_edges=max_edges)
    return (JDatasetConfig(graph=JGraphConfig(**g), seq_len=seq_len, max_seqs=max_seqs),
            DatasetConfig(graph=GraphConfig(**g), seq_len=seq_len, max_seqs=max_seqs))


def _assert_traces_equal(want, got):
    for f in dataclasses.fields(EventArrays):
        a, b = getattr(want.events, f.name), getattr(got.events, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)
    assert len(got.strings) == len(want.strings)
    assert [got.strings.lookup(i) for i in range(len(got.strings))] == \
        [want.strings.lookup(i) for i in range(len(want.strings))]
    np.testing.assert_array_equal(got.strings.features(), want.strings.features())
    if want.labels is None:
        assert got.labels is None
    else:
        np.testing.assert_array_equal(got.labels, want.labels)
    if want.ground_truth is None:
        assert got.ground_truth is None
    else:
        assert dataclasses.asdict(got.ground_truth) == dataclasses.asdict(want.ground_truth)


@pytest.mark.parametrize("sim", sorted(SIMS))
def test_simulate_trace_is_bit_equal(sim):
    want = jsimulate_trace(JSimConfig(**SIMS[sim]))
    got = simulate_trace(SimConfig(**SIMS[sim]))
    _assert_traces_equal(want, got)
    assert got.victim_paths == want.victim_paths


def test_load_trace_jsonl_is_bit_equal(tmp_path):
    tr = jsimulate_trace(JSimConfig(**SIMS["attack"]))
    path = tmp_path / "trace.jsonl"
    path.write_text(events_to_jsonl(tr.events, tr.strings))
    _assert_traces_equal(jload_trace_jsonl(path), load_trace_jsonl(path))


@pytest.mark.parametrize("sim", sorted(SIMS))
def test_windows_of_trace_is_bit_equal(sim):
    jds, ds = _ds_pair()
    want = jwindows_of_trace(jsimulate_trace(JSimConfig(**SIMS[sim])), jds)
    got = windows_of_trace(simulate_trace(SimConfig(**SIMS[sim])), ds)
    assert len(got) == len(want) and len(got) >= 2
    for w, g in zip(want, got):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_model_inputs_order_matches_reference():
    assert pipeline.MODEL_INPUTS == _MODEL_INPUTS


@pytest.fixture(scope="module")
def small_detector():
    """The reference's small float32 NerrfNet with its params, and the port's
    with the same params converted."""
    trace = jsimulate_trace(JSimConfig(**SIMS["attack"]))
    jds, _ = _ds_pair()
    jc = JJointConfig().small
    jc = dataclasses.replace(
        jc, gnn=dataclasses.replace(jc.gnn, dtype=jnp.float32),
        lstm=dataclasses.replace(jc.lstm, dtype=jnp.float32))
    jmodel = JNerrfNet(jc)
    one = jwindows_of_trace(trace, jds)[0]
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *[jnp.asarray(one[k]) for k in _MODEL_INPUTS])["params"]
    tc = JointConfig().small
    tc = dataclasses.replace(
        tc, gnn=dataclasses.replace(tc.gnn, dtype=torch.float32),
        lstm=dataclasses.replace(tc.lstm, dtype=torch.float32))
    tmodel = load_flax_params(NerrfNet(tc), jax.device_get(params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("agg", ["max", "robust"])
def test_model_detect_matches_reference(small_detector, agg):
    # the small capacities force auto-capacity up a rung on both sides (the
    # rung each lands on is stamped on its bucket_pad span); the reference
    # routes that bucket to dense_adj, the port to its fused op
    jmodel, params, tmodel = small_detector
    jds, ds = _ds_pair(max_nodes=32, max_edges=64, max_seqs=8)
    want = jpipeline.model_detect(jsimulate_trace(JSimConfig(**SIMS["attack"])),
                                  params, jmodel, ds_cfg=jds, batch_size=2, agg=agg)
    reset_launches()
    got = pipeline.model_detect(simulate_trace(SimConfig(**SIMS["attack"])),
                                tmodel, ds_cfg=ds, batch_size=2, agg=agg,
                                device="cpu")
    assert LAUNCHES == {k: 0 for k in LAUNCHES}
    rung = [s.args for s in tracing.records() if s.name == "bucket_pad"][-1]
    assert rung == [s.args for s in jtracing.DEFAULT_TRACER.records()
                    if s.name == "bucket_pad"][-1]
    assert rung["max_nodes"] > 32 and rung["max_seqs"] > 8
    assert got.detector == want.detector and got.threshold == want.threshold
    assert got.file_scores.keys() == want.file_scores.keys()
    assert len(got.file_scores) >= 4
    for k, v in want.file_scores.items():
        assert abs(got.file_scores[k] - v) <= SCORE_ATOL, k
    assert got.proc_scores.keys() == want.proc_scores.keys()
    for k, v in want.proc_scores.items():
        assert abs(got.proc_scores[k] - v) <= SCORE_ATOL, k
    assert got.file_bytes == want.file_bytes
    assert got.flagged_files(0.5).keys() == want.flagged_files(0.5).keys()
    assert got.file_window_scores.keys() == want.file_window_scores.keys()
    for k, v in want.file_window_scores.items():
        np.testing.assert_allclose(got.file_window_scores[k], v, rtol=0,
                                   atol=SCORE_ATOL, err_msg=k)
