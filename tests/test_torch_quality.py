"""The port's detection-quality plane (nerrf_tpu_torch.quality) against the
JAX package's, on the CPU.

* Host copies (``quality/sketch.py``, ``quality/monitor.py`` and the numpy
  parts of ``quality/profile.py``): the source is the reference's, and the
  same seeded inputs give bit-equal sketches, PSI, profiles and monitor
  snapshots.
* The profile builder, float32: `build_reference_profile` on converted
  weights against the reference's at a tiny model (2 GNN layers, width 16,
  two 30 s traces): every node probability within 1e-4, each quantile of
  every sketch within one bin, PSI between the two profiles ≤ 1e-3.
* The checkpoint: ``quality_profile.json`` written as the reference writes
  it, ``load_quality_profile``, and `calibrate_and_resave` shipping the
  profile at the calibrated operating point.
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerrf_tpu import quality as jquality
from nerrf_tpu.data import SimConfig as JSimConfig
from nerrf_tpu.data import simulate_trace as jsimulate_trace
from nerrf_tpu.models.joint import JointConfig as JJointConfig
from nerrf_tpu.models.joint import NerrfNet as JNerrfNet
from nerrf_tpu.observability import MetricsRegistry as JMetricsRegistry
from nerrf_tpu.quality import profile as jprofile
from nerrf_tpu.quality import sketch as jsketch
from nerrf_tpu.serve import config as jconfig
from nerrf_tpu.serve import service as jservice
from nerrf_tpu.train import checkpoint as jck
from nerrf_tpu_torch import pipeline, quality
from nerrf_tpu_torch.convert import load_flax_params
from nerrf_tpu_torch.data import SimConfig, simulate_trace
from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig, NerrfNet
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
from nerrf_tpu_torch.quality import profile, sketch
from nerrf_tpu_torch.serve import ServeConfig
from nerrf_tpu_torch.train import checkpoint as ck

ROOT = pathlib.Path(__file__).resolve().parent.parent
BUCKET = (128, 256, 32)
# probabilities, port vs JAX package, float32 (the profile builder's bound)
PROB_ATOL = 1e-4
PSI_MAX = 1e-3
WINDOWING = dict(buckets=(BUCKET,), window_sec=15.0, stride_sec=5.0)


def _port_source(rel):
    """The port's copy of ``rel`` as the reference would read: the package
    name swapped back and the copy's one-line note taken out."""
    text = (ROOT / "nerrf_tpu_torch" / rel).read_text()
    text = text.replace(f"\nA host copy of ``nerrf_tpu/{rel}``, kept identical.\n", "")
    return text.replace("nerrf_tpu_torch.", "nerrf_tpu.")


@pytest.mark.parametrize("rel", ["quality/sketch.py", "quality/monitor.py"])
def test_host_copies_are_the_references_source(rel):
    assert _port_source(rel) == (ROOT / "nerrf_tpu" / rel).read_text()


def _values(rng, n, kind):
    if kind == "score":
        return rng.beta(0.6, 0.9, n)
    return np.floor(rng.lognormal(5.0, 1.5, n))


@pytest.mark.parametrize("kind", ["score", "count"])
def test_sketch_and_psi_bit_equal(kind):
    rng = np.random.default_rng(11)
    edges = sketch.SCORE_EDGES if kind == "score" else sketch.COUNT_EDGES
    assert edges == (jsketch.SCORE_EDGES if kind == "score" else jsketch.COUNT_EDGES)
    assert (sketch.FRACTION_EDGES, sketch.COUNT_EDGES) == \
        (jsketch.FRACTION_EDGES, jsketch.COUNT_EDGES)
    a, b = _values(rng, 700, kind), _values(rng, 500, kind) * 1.3
    ta, tb = sketch.Sketch.empty(edges), sketch.Sketch.empty(edges)
    ja, jb = jsketch.Sketch.empty(edges), jsketch.Sketch.empty(edges)
    for vals, t, j in ((a, ta, ja), (b, tb, jb)):
        t.observe(vals)
        j.observe(vals)
    assert ta.to_dict() == ja.to_dict() and tb.to_dict() == jb.to_dict()
    assert ta.quantiles() == ja.quantiles()
    assert ta.merge(tb).to_dict() == ja.merge(jb).to_dict()
    assert sketch.psi(ta, tb) == jsketch.psi(ja, jb) > 0
    tfeat = {"x": ta, "y": tb}
    jfeat = {"x": ja, "y": jb}
    assert sketch.top_drifting(tfeat, {"x": tb, "y": ta}) == \
        jsketch.top_drifting(jfeat, {"x": jb, "y": ja})
    assert sketch.Sketch.from_dict(ta.to_dict()).to_dict() == ja.to_dict()


def _windows(seed, n=24, slots=64):
    """Seeded scored windows: (probs, mask, node_type, nodes, edges, files)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        real = int(rng.integers(4, slots))
        mask = np.zeros(slots, np.float32)
        mask[:real] = 1
        out.append((rng.beta(0.5, 0.8, slots).astype(np.float32), mask,
                    rng.integers(0, 2, slots).astype(np.int32),
                    int(rng.integers(real, 4 * real)),
                    int(rng.integers(real, 8 * real)), int(rng.integers(1, real))))
    return out


def _profiles(seed, threshold=0.62):
    t = profile.ProfileBuilder(threshold, margin_eps=0.05)
    j = jprofile.ProfileBuilder(threshold, margin_eps=0.05)
    for probs, mask, ntype, n, e, f in _windows(seed):
        t.observe_window(probs, mask, ntype, nodes=n, edges=e, files=f)
        j.observe_window(probs, mask, ntype, nodes=n, edges=e, files=f)
    return t.finish(), j.finish()


def test_profile_builder_and_merge_bit_equal(tmp_path):
    (t1, j1), (t2, j2) = _profiles(1), _profiles(2)
    assert t1.to_dict() == j1.to_dict() and t1.summary() == j1.summary()
    assert profile.merge_profiles(t1, t2).to_dict() == \
        jprofile.merge_profiles(j1, j2).to_dict()
    assert (profile.PROFILE_SCHEMA, profile.PROFILE_FILENAME, profile.FEATURE_EDGES) == \
        (jprofile.PROFILE_SCHEMA, jprofile.PROFILE_FILENAME, jprofile.FEATURE_EDGES)
    w = _windows(3)[0]
    assert profile.window_features(w[1], w[2], *w[3:]) == \
        jprofile.window_features(w[1], w[2], *w[3:])
    (tmp_path / profile.PROFILE_FILENAME).write_text(json.dumps(t1.to_dict()))
    assert profile.load_profile(tmp_path).to_dict() == \
        jprofile.load_profile(tmp_path).to_dict()
    with pytest.raises(ValueError, match="different operating points"):
        profile.merge_profiles(t1, _profiles(2, threshold=0.5)[0])


def test_quality_monitor_snapshot_bit_equal():
    tref, jref = _profiles(1)
    treg, jreg = MetricsRegistry(namespace="t"), JMetricsRegistry(namespace="t")
    tmon = quality.QualityMonitor(quality.QualityConfig(min_windows=8),
                                  registry=treg)
    jmon = jquality.QualityMonitor(jquality.QualityConfig(min_windows=8),
                                   registry=jreg)
    tmon.set_reference(tref.to_dict(), version=3)
    jmon.set_reference(jref.to_dict(), version=3)
    for i, (probs, mask, ntype, n, e, f) in enumerate(_windows(5, n=40)):
        for mon in (tmon, jmon):
            mon.observe_window(f"s{i % 2}", "128n/256e/32s", probs, mask.astype(bool),
                               ntype, nodes=n, edges=e, files=f,
                               alerted=bool((probs[mask > 0] >= 0.62).any()))
    assert tmon.snapshot() == jmon.snapshot()
    assert treg.render() == jreg.render()


# -- the profile builder on the model, float32 ---------------------------------


@pytest.fixture(scope="module")
def tiny_models():
    """The reference's tiny float32 NerrfNet with its params, and the port's
    with the same params converted."""
    jcfg = jconfig.ServeConfig(buckets=(BUCKET,))
    jc = JJointConfig().small
    jc = dataclasses.replace(
        jc, gnn=dataclasses.replace(jc.gnn, hidden=16, num_layers=2, dtype=jnp.float32),
        lstm=dataclasses.replace(jc.lstm, hidden=16, dtype=jnp.float32))
    jmodel = JNerrfNet(jc)
    params = jax.device_get(jservice.init_untrained_params(jmodel, jcfg, seed=0))
    tc = JointConfig(gnn=GraphSAGEConfig(hidden=16, num_layers=2, dtype=torch.float32),
                     lstm=LSTMConfig(hidden=16, num_layers=1, dtype=torch.float32))
    tmodel = load_flax_params(NerrfNet(tc), params).eval()
    return jmodel, params, tmodel


def _trace_kw(seed):
    return dict(duration_sec=30.0, attack=seed % 2 == 0, attack_start_sec=10.0,
                num_target_files=4, benign_rate_hz=6.0, seed=seed)


def _recording(builder_cls, monkeypatch, sink):
    real = builder_cls.observe_window

    def observe(self, probs, node_mask, *a, **kw):
        sink.append(np.asarray(probs)[np.asarray(node_mask).astype(bool)])
        return real(self, probs, node_mask, *a, **kw)

    monkeypatch.setattr(builder_cls, "observe_window", observe)


def test_reference_profile_matches_the_reference(tiny_models, monkeypatch):
    jmodel, params, tmodel = tiny_models
    ds_cfg = ServeConfig(**WINDOWING).dataset_config(BUCKET)
    jds_cfg = jconfig.ServeConfig(**WINDOWING).dataset_config(BUCKET)
    got_p, want_p = [], []
    _recording(profile.ProfileBuilder, monkeypatch, got_p)
    _recording(jprofile.ProfileBuilder, monkeypatch, want_p)
    reset_launches()
    got = profile.build_reference_profile(
        tmodel, [simulate_trace(SimConfig(**_trace_kw(s))) for s in (2, 3)],
        ds_cfg=ds_cfg, threshold=0.55, batch_size=4)
    assert LAUNCHES == {k: 0 for k in LAUNCHES}  # the plain versions on the CPU
    want = jprofile.build_reference_profile(
        params, jmodel, [jsimulate_trace(JSimConfig(**_trace_kw(s))) for s in (2, 3)],
        ds_cfg=jds_cfg, threshold=0.55, batch_size=4)
    assert got.windows == want.windows >= 6
    assert got.node_scores == want.node_scores
    assert len(got_p) == len(want_p) == got.windows
    for g, w in zip(got_p, want_p):
        np.testing.assert_allclose(g, w, rtol=0, atol=PROB_ATOL)
    # the structural features come from the host lowering: bit-equal
    assert {k: v.to_dict() for k, v in got.features.items()} == \
        {k: v.to_dict() for k, v in want.features.items()}
    edges = got.score.edges
    for (q, gv), wv in zip(got.score.quantiles().items(), want.score.quantiles().values()):
        gi, wi = np.searchsorted(edges, gv), np.searchsorted(edges, wv)
        assert abs(int(gi) - int(wi)) <= 1, q
    assert sketch.psi(want.score, got.score) <= PSI_MAX
    assert abs(got.margin_hits - want.margin_hits) <= max(2, want.margin_hits // 50)
    assert got.alert_windows == want.alert_windows


# -- the checkpoint's sidecar ---------------------------------------------------


def test_checkpoint_writes_the_references_profile_sidecar(tmp_path):
    tp, _ = _profiles(4)
    tc = JointConfig().small
    jc = JJointConfig().small
    ck.save_checkpoint(tmp_path / "port", {"w": torch.ones(2)}, tc,
                       quality_profile=tp.to_dict())
    jck.save_checkpoint(tmp_path / "ref", {"w": np.ones(2, np.float32)}, jc,
                        quality_profile=tp.to_dict())
    name = profile.PROFILE_FILENAME
    assert (tmp_path / "port" / name).read_text() == (tmp_path / "ref" / name).read_text()
    assert ck.load_quality_profile(tmp_path / "port") == \
        jck.load_quality_profile(tmp_path / "ref") == tp.to_dict()
    ck.save_checkpoint(tmp_path / "bare", {"w": torch.ones(2)}, tc)
    assert ck.load_quality_profile(tmp_path / "bare") is None
    (tmp_path / "bare" / name).write_text("{not json")
    with pytest.raises(ValueError, match="corrupt quality profile"):
        ck.load_quality_profile(tmp_path / "bare")


def test_calibrate_and_resave_ships_the_profile(tiny_models, tmp_path, monkeypatch):
    *_, tmodel = tiny_models
    cal = pipeline.Calibration(threshold=0.61237, kind="file-precision=1.0",
                               recall=0.5)
    monkeypatch.setattr(pipeline, "calibrate_file_thresholds",
                        lambda model, log=None, device=None: {"max": cal})
    short = [simulate_trace(SimConfig(**_trace_kw(s))) for s in (2, 3)]
    monkeypatch.setattr(ck, "profile_traces", lambda: short)
    ck.save_checkpoint(tmp_path / "m", tmodel.state_dict(), tmodel.cfg)
    logs = []
    got = ck.calibrate_and_resave(tmp_path / "m", tmodel, log=logs.append, device="cpu")
    assert got["node_threshold"] == 0.6124
    prof = ck.load_quality_profile(tmp_path / "m")
    assert prof["threshold"] == 0.6124 and prof["windows"] >= 2
    assert any(m.startswith("quality profile:") for m in logs)
    # a failing build is logged and leaves the calibrated checkpoint whole
    monkeypatch.setattr(ck, "profile_traces", lambda: 1 / 0)
    ck.calibrate_and_resave(tmp_path / "m", tmodel, log=logs.append, device="cpu")
    assert "without a drift baseline" in logs[-1]
    assert ck.load_quality_profile(tmp_path / "m") is None
    assert ck.load_calibration(tmp_path / "m")["node_threshold"] == 0.6124
