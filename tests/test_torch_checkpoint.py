"""The port's checkpoints (nerrf_tpu_torch.train.checkpoint) against the JAX
package's (nerrf_tpu.train.checkpoint), on the CPU.

* Format: ``params.pt`` (the state dict, bit-equal after a round trip) and
  ``model_config.json``, whose text equals the reference's for the same
  config, calibration and provenance.
* The reference's load gates and publish rules, as its tests hold them
  (tests/test_train.py, tests/test_registry.py): schema version, feature
  layout, one-line errors for a missing or corrupt sidecar, the
  temp-then-rename publish under a crash, the parked ``.old`` recovery.
* Carry: a reference (orbax) checkpoint, read by the reference's loader and
  converted with ``convert.flax_to_state_dict``, saved and loaded by the
  port, detects as the reference does: file scores within atol 1e-5 (the
  tolerance of test_torch_pipeline.py).  The sidecar records no dtype, in
  the reference too: both sides load the default-dtype (bfloat16) config,
  and this float32 comparison replaces the dtype after the load on both.
* A calibrated checkpoint hot-swaps into ``OnlineDetectionService`` with
  its ``node_threshold``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerrf_tpu import config as jconfig
from nerrf_tpu import pipeline as jpipeline
from nerrf_tpu.data import SimConfig as JSimConfig
from nerrf_tpu.data import simulate_trace as jsimulate_trace
from nerrf_tpu.models import GraphSAGEConfig as JGraphSAGEConfig
from nerrf_tpu.models import LSTMConfig as JLSTMConfig
from nerrf_tpu.models.joint import JointConfig as JJointConfig
from nerrf_tpu.models.joint import NerrfNet as JNerrfNet
from nerrf_tpu.serve import config as jserve_config
from nerrf_tpu.serve import service as jservice
from nerrf_tpu.train import checkpoint as jck
from nerrf_tpu_torch import config, pipeline
from nerrf_tpu_torch.convert import flax_to_state_dict
from nerrf_tpu_torch.data import SimConfig, Trace, simulate_trace
from nerrf_tpu_torch.flight import journal
from nerrf_tpu_torch.models import (
    GraphSAGEConfig,
    JointConfig,
    LSTMConfig,
    NerrfNet,
    build_nerrfnet,
)
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.serve import OnlineDetectionService, ServeConfig
from nerrf_tpu_torch.train import checkpoint as ck

SCORE_ATOL = 1e-5
BUCKET = (256, 512, 64)
SERVE_CFG = dict(buckets=(BUCKET,), batch_size=4, window_sec=15.0, stride_sec=5.0)
SIM = dict(duration_sec=60.0, attack=True, attack_start_sec=20.0,
           num_target_files=4, benign_rate_hz=20.0, seed=2)


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


def _model(seed=0, cfg=None):
    return build_nerrfnet(cfg or JointConfig().small, seed=seed, device="cpu")


def _assert_same_state(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].device.type == "cpu", k
        assert torch.equal(got[k], want[k].cpu()), k


# -- the format ------------------------------------------------------------------

def test_save_load_round_trip_is_bit_equal(tmp_path):
    cfg = JointConfig(gnn=GraphSAGEConfig(hidden=16, num_layers=2, aggregation="fused"),
                      lstm=LSTMConfig(hidden=16, num_layers=1, impl="rnn"))
    model = _model(cfg=cfg)
    ck.save_checkpoint(tmp_path / "m", model.state_dict(), cfg)
    assert sorted(os.listdir(tmp_path / "m")) == ["model_config.json", "params.pt"]
    sd, cfg2 = ck.load_checkpoint(tmp_path / "m")
    _assert_same_state(sd, model.state_dict())
    assert cfg2 == cfg
    loaded = NerrfNet(cfg2)
    loaded.load_state_dict(sd, strict=True)
    assert ck.load_calibration(tmp_path / "m") == {}


@pytest.mark.parametrize("kind", ["small", "flagship", "fused-rnn-unfused"])
def test_sidecar_text_equals_the_reference(tmp_path, kind):
    jc, tc = JJointConfig(), JointConfig()
    if kind == "small":
        jc, tc = jc.small, tc.small
    elif kind == "fused-rnn-unfused":
        jc = JJointConfig(gnn=JGraphSAGEConfig(hidden=8, num_layers=1, dropout=0.0,
                                               aggregation="fused"),
                          lstm=JLSTMConfig(hidden=8, num_layers=1, impl="rnn"),
                          fuse=False)
        tc = JointConfig(gnn=GraphSAGEConfig(hidden=8, num_layers=1, dropout=0.0,
                                             aggregation="fused"),
                         lstm=LSTMConfig(hidden=8, num_layers=1, impl="rnn"),
                         fuse=False)
    cal = {"node_threshold": 0.9123, "node_threshold_kind": "file-precision=1.0",
           "node_threshold_recall": 0.75}
    prov = {"parent_version": 3, "trigger": "drift"}
    jck.save_checkpoint(tmp_path / "ref", {"w": np.ones((2, 2), np.float32)}, jc,
                        calibration=cal, provenance=prov)
    ck.save_checkpoint(tmp_path / "port", {"w": torch.ones(2, 2)}, tc,
                       calibration=cal, provenance=prov)
    want = (tmp_path / "ref" / "model_config.json").read_text()
    assert (tmp_path / "port" / "model_config.json").read_text() == want
    assert ck.load_calibration(tmp_path / "port") == jck.load_calibration(tmp_path / "ref")
    _, jcfg = jck.load_checkpoint(tmp_path / "ref")
    _, tcfg = ck.load_checkpoint(tmp_path / "port")
    assert config.to_dict(tcfg) == jconfig.to_dict(jcfg)
    assert (ck.SCHEMA_VERSION, ck.MIN_SCHEMA_VERSION) == \
        (jck.SCHEMA_VERSION, jck.MIN_SCHEMA_VERSION)


# -- the load gates ----------------------------------------------------------------

def _saved(tmp_path, **kw):
    path = tmp_path / "m"
    ck.save_checkpoint(path, _model().state_dict(), JointConfig().small, **kw)
    sidecar = path / "model_config.json"
    return path, sidecar, json.loads(sidecar.read_text())


def test_schema_version_gate(tmp_path):
    path, sidecar, meta = _saved(tmp_path)
    assert meta["schema_version"] == ck.SCHEMA_VERSION
    meta["schema_version"] = ck.SCHEMA_VERSION + 1
    sidecar.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="newer version"):
        ck.load_checkpoint(path)
    meta["schema_version"] = ck.MIN_SCHEMA_VERSION - 1
    sidecar.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="oldest supported"):
        ck.load_checkpoint(path)
    # unstamped: falls through to the feature gate, which passes here ...
    del meta["schema_version"]
    sidecar.write_text(json.dumps(meta))
    _, cfg = ck.load_checkpoint(path)
    assert cfg == JointConfig().small
    # ... and gives its own message when the layout is unstamped too
    del meta["features"]
    sidecar.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="predates feature-layout"):
        ck.load_checkpoint(path)


def test_feature_layout_gate(tmp_path):
    path, sidecar, meta = _saved(tmp_path)
    assert meta["features"] == {"node": 24, "edge": 13, "seq": 12}
    meta["features"]["node"] = 22
    sidecar.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="retrain: feature layout changed"):
        ck.load_checkpoint(path)
    del meta["features"]
    sidecar.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="predates feature-layout"):
        ck.load_checkpoint(path)


def test_missing_and_corrupt_sidecars_raise_one_line_errors(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    for load in (ck.load_checkpoint, ck.load_calibration):
        with pytest.raises(FileNotFoundError, match="not a checkpoint"):
            load(empty)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "model_config.json").write_text("{not json")
    with pytest.raises(ValueError, match="corrupt checkpoint sidecar.*not valid JSON"):
        ck.load_checkpoint(bad)
    (bad / "model_config.json").write_bytes(b'{"gnn": "\xff\xfe"}')
    with pytest.raises(ValueError, match="corrupt checkpoint sidecar.*not valid UTF-8"):
        ck.load_checkpoint(bad)
    path, sidecar, meta = _saved(tmp_path)
    del meta["lstm"]
    sidecar.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="missing or malformed model-config field"):
        ck.load_checkpoint(path)
    for err in (FileNotFoundError, ValueError):
        # one line each: nothing chained behind it
        try:
            ck.load_checkpoint(empty if err is FileNotFoundError else path)
        except err as e:
            assert "\n" not in str(e) and e.__cause__ is None and e.__suppress_context__


def test_calibration_round_trip_and_default(tmp_path):
    path, _, meta = _saved(tmp_path, calibration={"node_threshold": 0.9})
    assert ck.load_calibration(path) == {"node_threshold": 0.9}
    assert "provenance" not in meta
    ck.save_checkpoint(path, _model().state_dict(), JointConfig().small)
    assert ck.load_calibration(path) == {}


# -- the publish ----------------------------------------------------------------------

def test_save_is_atomic_under_a_crash(tmp_path, monkeypatch):
    path = tmp_path / "model"
    first = _model(seed=1)
    ck.save_checkpoint(path, first.state_dict(), JointConfig().small)
    before = (path / "model_config.json").read_text()

    def crashing_save(obj, f, *a, **kw):
        with open(f, "wb") as fh:  # a torn write, then the crash
            fh.write(b"PK\x03\x04")
        raise OSError("disk full mid-save")

    monkeypatch.setattr(ck.torch, "save", crashing_save)
    with pytest.raises(OSError, match="disk full"):
        ck.save_checkpoint(path, _model(seed=2).state_dict(), JointConfig().small)
    monkeypatch.undo()
    # the previous checkpoint is whole and no temp directory is left behind
    sd, _ = ck.load_checkpoint(path)
    _assert_same_state(sd, first.state_dict())
    assert (path / "model_config.json").read_text() == before
    assert sorted(os.listdir(tmp_path)) == ["model"]
    # the next save over the survivor still works
    third = _model(seed=3)
    ck.save_checkpoint(path, third.state_dict(), JointConfig().small)
    _assert_same_state(ck.load_checkpoint(path)[0], third.state_dict())


def test_save_recovers_the_parked_previous_checkpoint(tmp_path):
    path = tmp_path / "model"
    ck.save_checkpoint(path, _model(seed=1).state_dict(), JointConfig().small)
    # a crash between the two final renames: the only good copy is parked
    os.rename(path, tmp_path / ".model.old")
    os.makedirs(tmp_path / ".model.tmp")
    assert not path.exists()
    second = _model(seed=2)
    ck.save_checkpoint(path, second.state_dict(), JointConfig().small)
    _assert_same_state(ck.load_checkpoint(path)[0], second.state_dict())
    assert sorted(os.listdir(tmp_path)) == ["model"]


# -- carry from the reference's format ---------------------------------------------

def test_reference_checkpoint_carried_into_the_port_detects_alike(tmp_path):
    jc = JJointConfig().small
    jc = dataclasses.replace(jc, gnn=dataclasses.replace(jc.gnn, dtype=jnp.float32),
                             lstm=dataclasses.replace(jc.lstm, dtype=jnp.float32))
    jmodel = JNerrfNet(jc)
    params = jservice.init_untrained_params(
        jmodel, jserve_config.ServeConfig(buckets=(BUCKET,)), seed=0)
    jck.save_checkpoint(tmp_path / "ref", params, jc)
    jparams, jloaded = jck.load_checkpoint(tmp_path / "ref")
    tcfg = config.from_dict(JointConfig, jconfig.to_dict(jloaded))
    ck.save_checkpoint(tmp_path / "port", flax_to_state_dict(jax.device_get(jparams)), tcfg)
    assert (tmp_path / "port" / "model_config.json").read_text() == \
        (tmp_path / "ref" / "model_config.json").read_text()
    sd, cfg = ck.load_checkpoint(tmp_path / "port")
    # the sidecar holds no dtype: float32 replaced after the load, both sides
    assert jloaded.gnn.dtype == jnp.bfloat16 and cfg.gnn.dtype == torch.bfloat16
    jloaded = dataclasses.replace(
        jloaded, gnn=dataclasses.replace(jloaded.gnn, dtype=jnp.float32),
        lstm=dataclasses.replace(jloaded.lstm, dtype=jnp.float32))
    cfg = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn, dtype=torch.float32),
                              lstm=dataclasses.replace(cfg.lstm, dtype=torch.float32))
    model = NerrfNet(cfg)
    model.load_state_dict(sd, strict=True)
    want = jpipeline.model_detect(jsimulate_trace(JSimConfig(**SIM)), jparams,
                                  JNerrfNet(jloaded))
    got = pipeline.model_detect(simulate_trace(SimConfig(**SIM)), model.eval(),
                                device="cpu")
    assert got.file_scores.keys() == want.file_scores.keys() and len(want.file_scores) >= 4
    for k, v in want.file_scores.items():
        assert abs(got.file_scores[k] - v) <= SCORE_ATOL, k
    assert got.proc_scores.keys() == want.proc_scores.keys()
    for k, v in want.proc_scores.items():
        assert abs(got.proc_scores[k] - v) <= SCORE_ATOL, k


def _unlabelled(trace, name):
    return Trace(events=trace.events, strings=trace.strings, ground_truth=None,
                 labels=None, name=name)


def test_calibrated_checkpoint_hot_swaps_into_serve_with_its_threshold(tmp_path):
    live, new = _model(seed=0), _model(seed=1)
    ck.save_checkpoint(tmp_path / "m", new.state_dict(), new.cfg,
                       calibration={"node_threshold": 0.9})
    sd, cfg = ck.load_checkpoint(tmp_path / "m")
    assert cfg == live.cfg
    cal = ck.load_calibration(tmp_path / "m")
    scfg = ServeConfig(**SERVE_CFG)
    reg = MetricsRegistry(namespace="test")
    svc = OnlineDetectionService(live, scfg, registry=reg,
                                 journal=journal.EventJournal(registry=reg),
                                 device="cpu").start()
    tr = simulate_trace(SimConfig(**SIM))
    try:
        svc.swap_params(sd, version=2, threshold=cal["node_threshold"])
        svc.join("s")
        svc.feed("s", tr.events, tr.strings)
        det = svc.leave("s", timeout=60.0)
    finally:
        svc.stop()
    assert det.detector == "serve[max]@v2" and det.threshold == 0.9
    loaded = NerrfNet(cfg)
    loaded.load_state_dict(sd, strict=True)
    want = pipeline.model_detect(_unlabelled(tr, "s"), loaded.eval(),
                                 ds_cfg=scfg.dataset_config(BUCKET),
                                 auto_capacity=False, batch_size=scfg.batch_size,
                                 threshold=cal["node_threshold"], device="cpu")
    assert det.file_scores == want.file_scores and det.threshold == want.threshold
    assert det.flagged_files() == want.flagged_files()
