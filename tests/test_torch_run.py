"""The port's experiment runner (nerrf_tpu_torch.train.run) against the JAX
package's (nerrf_tpu.train.run), on the CPU: the held-out quality parity.

One tiny experiment JSON (GraphSAGE-T 16 × 2, LSTM 16 × 1, float32,
dropout 0, ``segment`` aggregation, 20 steps, calibration on) goes through
both runners.  Its corpus is 3 traces with ``eval_fraction`` 0.34, so the
held-out trace is ``corpus-2-atk`` (``make_corpus`` spreads attacks
Bresenham-style: at 4 traces and 0.25 the held-out trace is benign).  The
port's ``init_state`` is replaced in the test by the reference's init,
converted, so both runs start from the same params and follow the same
batch schedule.

Tolerances, from the measured gap: every held-out metric in
``metrics.json`` (4 decimals) read equal on both sides; the limit is
METRIC_ATOL = 2e-4, two units of the 4th decimal, since a value on a
rounding boundary may round either way after float32 training.  The
calibration (both runners over the same five of the nine incidents,
CALIBRATION_SUBSET): the same rules reached, the cuts within 1e-5 (the
model is too briefly trained to reach one; the cut picking is held
bit-equal in test_torch_calibration.py).
"""

import contextlib
import dataclasses
import functools
import io
import json

import jax
import numpy as np
import pytest
import torch

from nerrf_tpu import config as jconfig
from nerrf_tpu import pipeline as jpipeline
from nerrf_tpu.train import loop as jloop
from nerrf_tpu.train import run as jrun
from nerrf_tpu_torch import config, pipeline
from nerrf_tpu_torch.convert import load_flax_params
from nerrf_tpu_torch.models import NerrfNet
from nerrf_tpu_torch.pipeline import make_eval_fn
from nerrf_tpu_torch.train import checkpoint as ck
from nerrf_tpu_torch.train import loop as tloop
from nerrf_tpu_torch.train import run
from nerrf_tpu_torch.train.data import build_dataset

METRIC_ATOL = 2e-4
# both runners calibrate over five of the nine incidents (one standard
# attack, inplace-stealth, benign-comm, the benign trace, benign-mass-
# rename), to keep the JAX side's CPU forwards short
CALIBRATION_SUBSET = dict(n_traces=1, exclude_scenarios=frozenset(
    {"partial-encrypt", "exfil-encrypt", "benign-atomic-rewrite"}))
THRESHOLD_ATOL = 1e-5
HELD_OUT = ("edge_auc", "node_auc", "seq_auc", "seq_f1", "node_f1")


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


def _experiment(tmp, **train):
    exp = {
        "name": "tiny-parity", "description": "held-out parity of the two runners",
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
                  "batch_size": 4, "num_steps": 20, "warmup_steps": 5,
                  "eval_every": 10, "seed": 0, **train},
        # never generated: both runners fall back to the in-memory corpus
        "corpus_dir": str(tmp / "corpus-not-generated"),
    }
    path = tmp / f"tiny-{len(list(tmp.glob('tiny-*.json')))}.json"
    path.write_text(json.dumps(exp))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runs")
    path = _experiment(tmp)
    init = {}
    real_init = jloop.init_state

    def recording_init(model, cfg, sample, rng):
        state = real_init(model, cfg, sample, rng)
        init.setdefault("params", jax.device_get(state.params))  # the run's own
        return state

    def reference_init(cfg, device=None):
        model = NerrfNet(cfg.model).to(device)
        load_flax_params(model, init["params"]).train()
        return tloop.TrainState(model=model, optimizer=tloop.make_tx(model, cfg))

    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stderr(log):
        mp.setattr(jloop, "init_state", recording_init)
        mp.setattr(tloop, "init_state", reference_init)
        for module in (jpipeline, pipeline):
            mp.setattr(module, "calibrate_file_thresholds", functools.partial(
                module.calibrate_file_thresholds, **CALIBRATION_SUBSET))
        want = jrun.run_experiment(str(path), tmp / "ref")
        got = run.run_experiment(str(path), tmp / "port", device="cpu")
    return dict(path=path, ref=tmp / "ref", port=tmp / "port", want=want, got=got,
                log=log.getvalue())


def test_held_out_quality_matches_the_reference(runs):
    got, want = runs["got"], runs["want"]
    exp = config.Experiment.load(runs["path"])
    assert [t.name for t in exp.build_corpus()[1]] == ["corpus-2-atk"]
    assert got["metrics"].keys() == want["metrics"].keys()
    for k in HELD_OUT:
        assert abs(got["metrics"][k] - want["metrics"][k]) <= METRIC_ATOL, k
    assert got["metrics"]["node_auc"] != 0.5  # the split holds both classes
    for k in ("num_edges_eval", "num_seqs_eval"):
        assert got["metrics"][k] == want["metrics"][k]
    assert got["gates"] == want["gates"] == {
        "edge_auc>=0.90": want["metrics"]["edge_auc"] >= 0.90,
        "seq_f1>=0.95": want["metrics"]["seq_f1"] >= 0.95}
    cal, jcal = got["calibration"] or {}, want["calibration"] or {}
    assert cal.keys() == jcal.keys()
    for k, v in jcal.items():
        if isinstance(v, float):
            assert abs(cal[k] - v) <= THRESHOLD_ATOL, k
        else:
            assert cal[k] == v, k
    # both fell back from the ungenerated corpus_dir with the same line, and
    # calibrated over the same incidents
    for key in ("falling back", "file-threshold calibration[max]"):
        lines = [line for line in runs["log"].splitlines() if key in line]
        assert len(lines) == 2 and lines[0] == lines[1], key
    assert "5 held-out incidents" in lines[0]


def test_artifacts_read_back(runs):
    port, ref = runs["port"], runs["ref"]
    # experiment.json is the input as the reference reads it
    assert jconfig.Experiment.load(port / "experiment.json") == \
        jconfig.Experiment.load(runs["path"])
    assert (port / "experiment.json").read_text() == (ref / "experiment.json").read_text()
    # metrics.json carries the reference's keys
    got = json.loads((port / "metrics.json").read_text())
    want = json.loads((ref / "metrics.json").read_text())
    assert got.keys() == want.keys() and got == runs["got"]
    assert (got["backend"], got["devices"], got["num_steps"]) == ("cpu", 1, 20)
    # the checkpoint: the reference's sidecar, and a model that reproduces
    # the held-out metrics (float32 replaced after the load: the sidecar
    # records no dtype)
    assert (port / "model" / "model_config.json").read_text() == \
        (ref / "model" / "model_config.json").read_text()
    sd, cfg = ck.load_checkpoint(port / "model")
    exp = config.Experiment.load(runs["path"])
    assert cfg.gnn.aggregation == "segment" and cfg.gnn.dtype == torch.bfloat16
    assert ck.load_calibration(port / "model") == (got["calibration"] or {})
    cfg = dataclasses.replace(
        cfg, gnn=dataclasses.replace(cfg.gnn, dtype=torch.float32),
        lstm=dataclasses.replace(cfg.lstm, dtype=torch.float32))
    assert cfg == exp.train.model
    model = NerrfNet(cfg)
    model.load_state_dict(sd, strict=True)
    eval_ds = build_dataset(exp.build_corpus()[1], exp.dataset)
    metrics = tloop.evaluate(make_eval_fn(model), eval_ds, exp.train.batch_size)
    assert {k: round(float(v), 4) for k, v in metrics.items()} == got["metrics"]


@pytest.mark.parametrize("option", [dict(ckpt_every=10), dict(publish_to="registry"),
                                    dict(compile_cache=object()), dict(metrics_port=0),
                                    dict(flight_dir="flight"), dict(archive_dir="archive")],
                         ids=lambda kw: next(iter(kw)))
def test_left_out_options_are_refused(tmp_path, option):
    with pytest.raises(NotImplementedError, match="is not ported"):
        run.run_experiment("toy-graphsage", tmp_path, device="cpu", **option)
    assert not list(tmp_path.iterdir())  # refused before any work


def test_telemetry_and_disk_corpus_are_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="trainwatch"):
        run.run_experiment(str(_experiment(tmp_path, telemetry=True)), tmp_path / "t",
                           device="cpu")
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "manifest.json").write_text("{}")
    exp = json.loads(_experiment(tmp_path).read_text())
    exp["corpus_dir"] = str(corpus)
    (tmp_path / "disk.json").write_text(json.dumps(exp))
    with pytest.raises(NotImplementedError, match="disk corpus"):
        run.run_experiment(str(tmp_path / "disk.json"), tmp_path / "d", device="cpu")


def test_main_exits_by_the_gates(tmp_path):
    # node head untrained: the calibration is skipped, as the reference skips it
    path = _experiment(tmp_path, node_loss_weight=0.0)
    rc = run.main(["--experiment", str(path), "--out", str(tmp_path / "a"),
                   "--steps", "2", "--device", "cpu"])
    report = json.loads((tmp_path / "a" / "metrics.json").read_text())
    assert report["num_steps"] == 2 and report["calibration"] is None
    assert set(report["gates"]) == {"edge_auc>=0.90", "seq_f1>=0.95"}
    assert rc == (0 if all(report["gates"].values()) else 1)
    # no head with a gate trained: no gate, exit 0
    path = _experiment(tmp_path, node_loss_weight=0.0, edge_loss_weight=0.0,
                       seq_loss_weight=0.0)
    assert run.main(["--experiment", str(path), "--out", str(tmp_path / "b"),
                     "--steps", "1", "--device", "cpu"]) == 0
    report = json.loads((tmp_path / "b" / "metrics.json").read_text())
    assert report["gates"] == {} and np.isfinite(report["metrics"]["edge_auc"])
