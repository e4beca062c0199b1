"""The port's held-out calibration and indicator detector against the JAX
package's, on the CPU.

* Host copies (``threshold_at_precision``, ``f1_at_threshold``,
  ``heuristic_detect``, ``attack_touched_files``, the calibration's cut
  picking on the same file scores): bit-equal.
* End to end: ``calibrate_file_thresholds`` of a briefly trained small
  float32 model (``segment`` aggregation, dropout 0), the reference's params
  converted for the port, over the same five simulated incidents (one
  standard attack, inplace-stealth, benign-comm, the benign trace and
  benign-mass-rename: the reference's set less its second standard attack
  and three families, to keep the JAX side's CPU forwards short).  Each
  incident's file scores agree within atol 1e-5 (the tolerance of
  test_torch_pipeline.py; measured 1.8e-7), the same rules reach a cut
  (here ``max`` does and ``robust`` does not), and the cuts agree within
  1e-5 with the same kind and recall (measured equal).  The run uses
  ``min_recall=0`` so that this model reaches a cut at all; the recall
  floor is held in the bit-equal cases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerrf_tpu import pipeline as jpipeline
from nerrf_tpu.data import SimConfig as JSimConfig
from nerrf_tpu.data import derive_event_labels as jderive_event_labels
from nerrf_tpu.data import load_trace_jsonl as jload_trace_jsonl
from nerrf_tpu.data import make_corpus as jmake_corpus
from nerrf_tpu.data import simulate_trace as jsimulate_trace
from nerrf_tpu.data import synth as jsynth
from nerrf_tpu.graph import GraphConfig as JGraphConfig
from nerrf_tpu.models import GraphSAGEConfig as JGraphSAGEConfig
from nerrf_tpu.models import LSTMConfig as JLSTMConfig
from nerrf_tpu.models.joint import JointConfig as JJointConfig
from nerrf_tpu.models.joint import NerrfNet as JNerrfNet
from nerrf_tpu.schema.events import events_to_jsonl
from nerrf_tpu.train import data as jdata
from nerrf_tpu.train import loop as jloop
from nerrf_tpu.train import metrics as jmetrics
from nerrf_tpu_torch import pipeline
from nerrf_tpu_torch.convert import load_flax_params
from nerrf_tpu_torch.data import SimConfig, derive_event_labels, load_trace_jsonl, simulate_trace
from nerrf_tpu_torch.data import synth
from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig, NerrfNet
from nerrf_tpu_torch.train import metrics

SCORE_ATOL = 1e-5
THRESHOLD_ATOL = 1e-5

SIMS = {
    "standard": dict(duration_sec=90.0, attack=True, attack_start_sec=30.0,
                     num_target_files=6, benign_rate_hz=15.0, seed=5),
    "benign": dict(duration_sec=60.0, attack=False, num_target_files=4,
                   benign_rate_hz=20.0, seed=6),
    "inplace-stealth": dict(duration_sec=90.0, attack=True, attack_start_sec=30.0,
                            num_target_files=6, benign_rate_hz=15.0, seed=7,
                            scenario="inplace-stealth"),
    "benign-mass-rename": dict(duration_sec=90.0, attack=False, num_target_files=6,
                               benign_rate_hz=15.0, seed=8,
                               scenario="benign-mass-rename"),
    "interleaved-backup": dict(duration_sec=90.0, attack=True, attack_start_sec=30.0,
                               num_target_files=6, benign_rate_hz=15.0, seed=9,
                               scenario="interleaved-backup"),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module.  Its models are a few units
    wide, so more threads buy nothing on the CPU, while in a suite whose
    workers share the cores every small parallel region of a forward waits
    for descheduled threads (the port's calibration sweep read 7 s alone
    and 222 s beside five busy pytest workers on an 8-core host, 59 s with
    one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the metrics ------------------------------------------------------------------

def _cases():
    rng = np.random.default_rng(11)
    labels = rng.random(400) < 0.25
    yield "separable", labels, np.where(labels, 0.6 + 0.4 * rng.random(400),
                                        0.55 * rng.random(400))
    yield "ties", labels, np.round(rng.normal(size=400) + 2 * labels, 1)
    yield "overlap", labels, rng.normal(size=400) + 0.8 * labels
    yield "no-positives", np.zeros(50, bool), rng.random(50)
    yield "one-top-positive", np.array([1, 0, 1, 0, 0]), np.array([0.9, 0.8, 0.1, 0.2, 0.3])
    yield "constant", labels[:20], np.full(20, 0.5)
    yield "empty", np.zeros(0, bool), np.zeros(0)


@pytest.mark.parametrize("name,labels,scores", list(_cases()), ids=lambda v: v
                         if isinstance(v, str) else "")
@pytest.mark.parametrize("target,min_recall", [(1.0, 0.0), (0.98, 0.0), (0.9, 0.5),
                                               (0.7, 0.99), (0.5, 0.3)])
def test_threshold_at_precision_is_bit_equal(name, labels, scores, target, min_recall):
    for rr in (False, True):
        got = metrics.threshold_at_precision(labels, scores, target, min_recall, rr)
        want = jmetrics.threshold_at_precision(labels, scores, target, min_recall, rr)
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("name,labels,scores", list(_cases()), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_f1_at_threshold_is_bit_equal(name, labels, scores):
    for t in (-1.0, 0.0, 0.5, 0.9, 2.0):
        assert metrics.f1_at_threshold(labels, scores, t) == \
            jmetrics.f1_at_threshold(labels, scores, t)


# -- the host detectors and labels ---------------------------------------------------

@pytest.fixture(scope="module")
def sims():
    return {k: (simulate_trace(SimConfig(**v)), jsimulate_trace(JSimConfig(**v)))
            for k, v in SIMS.items()}


@pytest.mark.parametrize("kind", list(SIMS))
def test_heuristic_detect_is_bit_equal(sims, kind):
    tr, jtr = sims[kind]
    got, want = pipeline.heuristic_detect(tr), jpipeline.heuristic_detect(jtr)
    assert got.file_scores == want.file_scores and len(got.file_scores) > 0
    assert got.proc_scores == want.proc_scores
    assert got.file_bytes == want.file_bytes
    assert got.detector == want.detector == "heuristic"


@pytest.mark.parametrize("kind", list(SIMS))
def test_attack_touched_files_is_bit_equal(sims, kind, tmp_path):
    tr, jtr = sims[kind]
    # victim_paths from the simulator
    got = pipeline.attack_touched_files(tr)
    assert got == jpipeline.attack_touched_files(jtr)
    assert (len(got[0]) > 0) == SIMS[kind]["attack"]
    # victim_paths None, labels kept: the ransom-extension derivation
    bare = dataclasses.replace(tr, victim_paths=None)
    jbare = dataclasses.replace(jtr, victim_paths=None)
    assert pipeline.attack_touched_files(bare) == jpipeline.attack_touched_files(jbare)
    # reloaded from its ND-JSON (victim_paths None): without labels, then
    # with the labels its ground truth derives
    path = tmp_path / "t.jsonl"
    path.write_text(events_to_jsonl(jtr.events, jtr.strings))
    re, jre = load_trace_jsonl(path), jload_trace_jsonl(path)
    assert re.victim_paths is None and re.labels is None
    assert pipeline.attack_touched_files(re) == jpipeline.attack_touched_files(jre) \
        == (set(), set())
    if tr.ground_truth is not None:
        re = dataclasses.replace(re, ground_truth=tr.ground_truth)
        jre = dataclasses.replace(jre, ground_truth=jtr.ground_truth)
        re.labels, jre.labels = derive_event_labels(re), jderive_event_labels(jre)
        assert pipeline.attack_touched_files(re) == jpipeline.attack_touched_files(jre)


# -- the cut picking on the same file scores ------------------------------------------

@pytest.fixture(scope="module")
def simulated_once():
    """Both packages' ``simulate_trace`` memoized for this module: the
    calibration simulates its nine incidents on every call."""
    mp = pytest.MonkeyPatch()
    for module in (synth, jsynth):
        cache, real = {}, module.simulate_trace

        def memo(cfg, name="", cache=cache, real=real):
            if (cfg, name) not in cache:
                cache[cfg, name] = real(cfg, name)
            return cache[cfg, name]

        mp.setattr(module, "simulate_trace", memo)
    yield
    mp.undo()


def _fake_detect(module, spread):
    """A stand-in for ``model_detect`` that scores the files of a trace from
    its own labels (attack-touched files high, the rest low, ``spread``
    their overlap), two windows a file, the same numbers in both packages."""

    def detect(trace, *args, **kwargs):
        _, touched = module.attack_touched_files(trace)
        paths = sorted(set(module._inode_to_path(trace).values()))
        rng = np.random.default_rng(len(paths))
        windows = {}
        for p in paths:
            u = rng.random(2)
            lo = 0.5 - spread if p in touched else 0.0
            windows[p] = [float(lo + 0.5 * x) for x in u]
        return module.DetectionResult(
            file_scores={p: max(w) for p, w in windows.items()}, proc_scores={},
            file_bytes={}, file_window_scores=windows)

    return detect


@pytest.mark.parametrize("spread,min_recall", [(-0.1, 0.5), (0.15, 0.5), (0.15, 0.0),
                                               (0.3, 0.9)],
                         ids=["separable", "overlap", "overlap-no-floor", "floor"])
def test_cut_picking_is_bit_equal_on_the_same_scores(simulated_once, monkeypatch, spread,
                                                      min_recall):
    monkeypatch.setattr(pipeline, "model_detect", _fake_detect(pipeline, spread))
    monkeypatch.setattr(jpipeline, "model_detect", _fake_detect(jpipeline, spread))
    log, jlog = [], []
    got = pipeline.calibrate_file_thresholds(None, min_recall=min_recall, log=log.append,
                                             device="cpu")
    want = jpipeline.calibrate_file_thresholds(None, None, min_recall=min_recall,
                                               log=jlog.append)
    assert got == want and log == jlog
    assert pipeline.calibrate_file_threshold(None, min_recall=min_recall,
                                             device="cpu") == want.get("max")
    if spread < 0:
        assert set(got) == {"max", "robust"}
        assert {c.kind for c in got.values()} == {"file-precision=1.0"}
    if min_recall == 0.9:
        assert got == {} and all("unreachable" in line for line in log)
    # the same nine incidents, less an excluded family
    sub = pipeline.calibrate_file_thresholds(
        None, min_recall=min_recall, exclude_scenarios=frozenset({"inplace-stealth"}),
        device="cpu")
    assert sub == jpipeline.calibrate_file_thresholds(
        None, None, min_recall=min_recall, exclude_scenarios=frozenset({"inplace-stealth"}))


def test_calibration_traces_are_the_references_incidents(simulated_once):
    traces = pipeline.calibration_traces()
    assert [t.name for t in traces] == [
        "calib-0-standard", "calib-1-standard", "calib-2-inplace-stealth",
        "calib-3-partial-encrypt", "calib-4-benign-comm", "calib-5-exfil-encrypt",
        "calib-6-standard", "calib-7-benign-mass-rename", "calib-8-benign-atomic-rewrite"]
    assert len(pipeline.calibration_traces(exclude_scenarios=frozenset({"standard"}))) == 6


# -- end to end ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """A small float32 model (GraphSAGE-T 16 × 2, LSTM 16 × 1) trained 30
    steps by the JAX package, and the port's with the same params
    converted."""
    jc = JJointConfig(
        gnn=JGraphSAGEConfig(hidden=16, num_layers=2, dropout=0.0, dtype=jnp.float32),
        lstm=JLSTMConfig(hidden=16, num_layers=1, dropout=0.0, dtype=jnp.float32))
    tc = JointConfig(
        gnn=GraphSAGEConfig(hidden=16, num_layers=2, dropout=0.0, dtype=torch.float32,
                            aggregation="segment"),
        lstm=LSTMConfig(hidden=16, num_layers=1, dropout=0.0, dtype=torch.float32))
    ds = jdata.build_dataset(
        jmake_corpus(3, duration_sec=120.0, num_target_files=8, benign_rate_hz=10.0,
                     base_seed=1),
        jdata.DatasetConfig(graph=JGraphConfig(max_nodes=128, max_edges=256),
                            seq_len=24, max_seqs=32))
    cfg = jloop.TrainConfig(model=jc, batch_size=4, num_steps=30, warmup_steps=5)
    jmodel = JNerrfNet(jc)
    state = jloop.init_state(jmodel, cfg, ds.arrays, jax.random.PRNGKey(0))
    step, rng = jloop.make_train_step(jmodel, cfg), jax.random.PRNGKey(1)
    for idx in jloop.make_idx_schedule(len(ds), cfg):
        state, _, _, rng = step(state, {k: jnp.asarray(v[idx])
                                        for k, v in ds.arrays.items()}, rng)
    params = jax.device_get(state.params)
    return jmodel, params, load_flax_params(NerrfNet(tc), params).eval()


def _recording(module, name, out):
    real = getattr(module, name)

    def detect(*args, **kwargs):
        det = real(*args, **kwargs)
        out.append(det)
        return det

    return detect


def test_calibration_end_to_end_matches_the_reference(simulated_once, trained, monkeypatch):
    jmodel, params, model = trained
    dets, jdets = [], []
    monkeypatch.setattr(pipeline, "model_detect", _recording(pipeline, "model_detect", dets))
    monkeypatch.setattr(jpipeline, "model_detect",
                        _recording(jpipeline, "model_detect", jdets))
    kw = dict(n_traces=1, min_recall=0.0, exclude_scenarios=frozenset(
        {"partial-encrypt", "exfil-encrypt", "benign-atomic-rewrite"}))
    got = pipeline.calibrate_file_thresholds(model, device="cpu", **kw)
    want = jpipeline.calibrate_file_thresholds(params, jmodel, **kw)
    assert len(dets) == len(jdets) == 5
    for det, jdet in zip(dets, jdets):
        assert det.file_scores.keys() == jdet.file_scores.keys()
        for k, v in jdet.file_scores.items():
            assert abs(det.file_scores[k] - v) <= SCORE_ATOL, k
    assert set(got) == set(want) and len(got) > 0
    for agg, cal in want.items():
        assert got[agg].kind == cal.kind and got[agg].recall == cal.recall
        assert abs(got[agg].threshold - cal.threshold) <= THRESHOLD_ATOL, agg
