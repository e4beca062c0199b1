"""The port's model registry (nerrf_tpu_torch.registry) and serve's shadow
scoring against the JAX package's, on the CPU.

* Host copies (``registry/config.py``, ``registry/guardrails.py``): the
  source is the reference's, and seeded paired scores give bit-equal
  `ShadowStats` and verdicts.
* The store: the reference's publish / promote / rollback / status
  semantics over the port's checkpoints (``params.pt``), a torn port
  checkpoint and a reference-layout one both refused at publish.
* Shadow scoring, float32, converted weights: the port's service and the
  reference's fed the same stream with the same candidate staged give the
  same `ShadowStats` (decision flips exactly, drift within 1e-5 a node)
  and the same verdict, for a candidate the guardrails promote and one
  they veto.  A shadow that raises costs no live window.
* The lifecycle through `ModelManager`: shadow → auto-promotion → veto →
  rollback, the scorer bit-equal to `model_detect` with the serving
  version after each swap.
* The command line: ``models`` and ``serve-detect --registry
  --archive-dir``, ``train-detector --publish``, and `run_experiment`'s
  ``publish_to``.
"""

import contextlib
import dataclasses
import io
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerrf_tpu import registry as jregistry
from nerrf_tpu.data import SimConfig as JSimConfig
from nerrf_tpu.data import simulate_trace as jsimulate_trace
from nerrf_tpu.flight import journal as jjournal
from nerrf_tpu.models.joint import JointConfig as JJointConfig
from nerrf_tpu.models.joint import NerrfNet as JNerrfNet
from nerrf_tpu.observability import MetricsRegistry as JMetricsRegistry
from nerrf_tpu.serve import config as jconfig
from nerrf_tpu.serve import service as jservice
from nerrf_tpu.train import checkpoint as jck
from nerrf_tpu_torch import archive, cli, pipeline, registry
from nerrf_tpu_torch.convert import flax_to_state_dict, load_flax_params
from nerrf_tpu_torch.data import SimConfig, Trace, simulate_trace
from nerrf_tpu_torch.flight import journal
from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig, NerrfNet
from nerrf_tpu_torch.observability import DEFAULT_REGISTRY, MetricsRegistry
from nerrf_tpu_torch.schema.events import events_to_jsonl
from nerrf_tpu_torch.serve import OnlineDetectionService, ServeConfig
from nerrf_tpu_torch.train import checkpoint as ck
from nerrf_tpu_torch.train import run

ROOT = pathlib.Path(__file__).resolve().parent.parent
BUCKET = (128, 256, 32)
SERVE = dict(buckets=(BUCKET,), batch_size=4, window_sec=15.0, stride_sec=5.0)
# mean |Δp| a node, port vs JAX package, float32
DRIFT_ATOL = 1e-5
LIFECYCLE = dict(shadow_min_windows=8, canary_windows=4)


@pytest.mark.parametrize("rel", ["registry/config.py", "registry/guardrails.py"])
def test_host_copies_are_the_references_source(rel):
    text = (ROOT / "nerrf_tpu_torch" / rel).read_text()
    text = text.replace(f"\nA host copy of ``nerrf_tpu/{rel}``, kept identical.\n", "")
    assert text.replace("nerrf_tpu_torch.", "nerrf_tpu.") == \
        (ROOT / "nerrf_tpu" / rel).read_text()


@pytest.mark.parametrize("noise,want", [(0.002, "promote"), (0.2, "veto"),
                                        (0.0, "wait")])
def test_guardrail_verdicts_bit_equal(noise, want):
    rng = np.random.default_rng(7)
    cfg, jcfg = registry.RegistryConfig(**LIFECYCLE), jregistry.RegistryConfig(**LIFECYCLE)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    t, j = registry.make_stats(cfg, 0.6), jregistry.make_stats(jcfg, 0.6)
    for _ in range(8 if noise else 5):
        live = rng.uniform(0, 1, 64)
        shadow = np.clip(live + rng.normal(0, noise, 64), 0, 1)
        mask = rng.uniform(0, 1, 64) < 0.8
        t.observe(live, shadow, mask)
        j.observe(live, shadow, mask)
    assert t.snapshot() == j.snapshot()
    assert registry.evaluate(t, cfg) == jregistry.evaluate(j, jcfg)
    assert registry.evaluate(t, cfg)[0] == want


# -- the store ------------------------------------------------------------------


def _tiny_cfg():
    return JointConfig(gnn=GraphSAGEConfig(hidden=16, num_layers=2, dtype=torch.float32),
                       lstm=LSTMConfig(hidden=16, num_layers=1, dtype=torch.float32))


def test_store_semantics_match_the_reference(tmp_path):
    sd = {"w": torch.ones(2)}
    ck.save_checkpoint(tmp_path / "ck", sd, _tiny_cfg(), calibration={"node_threshold": 0.7})
    jck.save_checkpoint(tmp_path / "jck", {"w": np.ones(2, np.float32)},
                        JJointConfig().small, calibration={"node_threshold": 0.7})
    recs = {}
    for name, pkg, src in (("port", registry, "ck"), ("ref", jregistry, "jck")):
        reg = pkg.ModelRegistry(tmp_path / f"reg-{name}",
                                journal=(journal if name == "port" else jjournal)
                                .EventJournal())
        vs = [reg.publish("det", tmp_path / src) for _ in range(3)]
        steps = [reg.live("det"), reg.promote("det", 2), reg.promote("det", 3),
                 reg.rollback("det"), reg.rollback("det", 1)]
        status = reg.status("det")
        for s in steps[1:]:
            s.pop("promoted_at")
        for v in status["versions"]:
            v.pop("published_at"), v.pop("source")
        status["live"].pop("promoted_at")
        recs[name] = (vs, steps, status, reg.lineages(), reg.versions("det"),
                      reg.live_version("det"), reg.load("det")[2:])
        with pytest.raises(FileNotFoundError):
            reg.promote("det", 9)
        with pytest.raises(ValueError):
            reg.lineage_dir("../x")
    assert recs["port"] == recs["ref"]
    reg = registry.ModelRegistry(tmp_path / "reg-port")
    got_sd, got_cfg, cal, v = reg.load("det", 2)
    assert torch.equal(got_sd["w"], sd["w"]) and cal == {"node_threshold": 0.7} and v == 2
    assert ck.architecture(got_cfg) == ck.architecture(_tiny_cfg())
    assert reg.executables_dir("det", 2) is None
    with pytest.raises(NotImplementedError, match="A.7"):
        reg.publish("det", tmp_path / "ck", executables=tmp_path / "exe")


def test_publish_refuses_a_torn_or_foreign_checkpoint(tmp_path):
    ck.save_checkpoint(tmp_path / "ck", {"w": torch.ones(2)}, _tiny_cfg())
    assert registry.validate_checkpoint_dir(tmp_path / "ck")["gnn"]["hidden"] == 16
    (tmp_path / "ck" / ck.PARAMS_FILENAME).unlink()  # a torn copy
    reg = registry.ModelRegistry(tmp_path / "reg", journal=journal.EventJournal())
    with pytest.raises(FileNotFoundError, match="params.pt"):
        reg.publish("det", tmp_path / "ck")
    # the reference's layout (an orbax params/ directory) is not the port's
    jck.save_checkpoint(tmp_path / "jck", {"w": np.ones(2, np.float32)}, JJointConfig().small)
    with pytest.raises(FileNotFoundError, match="params.pt"):
        registry.validate_checkpoint_dir(tmp_path / "jck")
    assert reg.versions("det") == [] and not list((tmp_path / "reg").rglob("v*"))


# -- shadow scoring against the reference's service ---------------------------


@pytest.fixture(scope="module")
def models():
    """The reference's tiny float32 NerrfNet, the live params and two
    candidates: one near the live weights, one far from them."""
    jcfg = jconfig.ServeConfig(**SERVE)
    jc = JJointConfig().small
    jc = dataclasses.replace(
        jc, gnn=dataclasses.replace(jc.gnn, hidden=16, num_layers=2, dtype=jnp.float32),
        lstm=dataclasses.replace(jc.lstm, hidden=16, dtype=jnp.float32))
    jmodel = JNerrfNet(jc)
    live = jax.device_get(jservice.init_untrained_params(jmodel, jcfg, seed=0))
    rng = np.random.default_rng(3)

    def moved(scale):
        return jax.tree_util.tree_map(
            lambda x: (x + rng.normal(0, scale, x.shape)).astype(x.dtype), live)

    return jmodel, jcfg, {"live": live, "near": moved(1e-3), "far": moved(0.3)}


def _trace(seed=3):
    kw = dict(duration_sec=60.0, attack=True, attack_start_sec=20.0,
              num_target_files=6, benign_rate_hz=6.0, seed=seed)
    return simulate_trace(SimConfig(**kw)), jsimulate_trace(JSimConfig(**kw))


class _Judge:
    """The manager's side of shadow scoring: the paired statistics only."""

    lineage = "det"

    def __init__(self, pkg, version, threshold=None):
        self.cfg = pkg.RegistryConfig(**LIFECYCLE)
        self.stats = pkg.make_stats(self.cfg, threshold)
        self.shadow_version = version
        self.logs = []

    def observe_shadow(self, live, shadow, mask, version):
        assert version == self.shadow_version
        self.stats.observe(live, shadow, mask)

    def _log(self, msg):
        self.logs.append(msg)


def _feed(svc, sid, trace, size=150):
    svc.join(sid)
    ev = trace.events
    for i in range(0, len(ev), size):
        block = type(ev)(**{f.name: getattr(ev, f.name)[i:i + size]
                            for f in dataclasses.fields(ev)})
        svc.feed(sid, block, trace.strings)
    return svc.leave(sid, timeout=60.0)


def _port_service(model, reg=None, **kw):
    reg = reg or MetricsRegistry(namespace="t")
    return OnlineDetectionService(model, ServeConfig(**SERVE), registry=reg,
                                  journal=journal.EventJournal(registry=reg),
                                  device="cpu", **kw)


def _port_model(params):
    return load_flax_params(NerrfNet(_tiny_cfg()), params).eval()


def _shadow_runs(svc, pkg, candidates, trace):
    """One stream a candidate through a started ``svc``, each staged as
    version 2, 3, ...; returns each candidate's judge and detection."""
    out = {}
    try:
        for i, (name, weights) in enumerate(candidates.items()):
            judge = _Judge(pkg, 2 + i)
            svc.attach_manager(judge)
            svc.start_shadow(weights, 2 + i)
            out[name] = (judge, _feed(svc, f"s{i}", trace))
            svc.stop_shadow()
    finally:
        svc.stop()
    return out


def test_shadow_stats_and_verdicts_match_the_reference(models):
    jmodel, jcfg, params = models
    tr, jtr = _trace()
    jreg = JMetricsRegistry(namespace="t")
    jsvc = jservice.OnlineDetectionService(
        params["live"], jmodel, cfg=jcfg, registry=jreg,
        journal=jjournal.EventJournal(registry=jreg)).start()
    want = _shadow_runs(jsvc, jregistry, {c: params[c] for c in ("near", "far")}, jtr)
    svc = _port_service(_port_model(params["live"])).start()
    svc.attach_manager(_Judge(registry, 2))
    svc.start_shadow(flax_to_state_dict(params["near"]), 2)
    assert svc.ready()[2]["shadow_version"] == "v2"
    got = _shadow_runs(svc, registry, {c: flax_to_state_dict(params[c])
                                       for c in ("near", "far")}, tr)
    offline = _offline(_port_model(params["live"]), tr, "s0").file_scores
    for name, verdict in (("near", "promote"), ("far", "veto")):
        (judge, det), (jjudge, _) = got[name], want[name]
        g, w = judge.stats, jjudge.stats
        assert (g.windows, g.nodes, g.disagreements) == (w.windows, w.nodes, w.disagreements)
        assert g.windows >= LIFECYCLE["shadow_min_windows"]
        assert abs(g.drift_sum - w.drift_sum) <= DRIFT_ATOL * w.nodes
        assert registry.evaluate(g, judge.cfg)[0] == \
            jregistry.evaluate(w, jjudge.cfg)[0] == verdict
        # the shadow never reaches the live result
        assert det.detector == "serve[max]" and det.file_scores == offline


def _offline(model, trace, sid, threshold=None):
    tr = Trace(events=trace.events, strings=trace.strings, ground_truth=None,
               labels=None, name=sid)
    cfg = ServeConfig(**SERVE)
    return pipeline.model_detect(tr, model, ds_cfg=cfg.dataset_config(BUCKET),
                                 auto_capacity=False, batch_size=cfg.batch_size,
                                 threshold=threshold, device="cpu")


def test_a_raising_shadow_costs_no_live_window(models):
    _, _, params = models
    model = _port_model(params["live"])
    reg = MetricsRegistry(namespace="t")
    svc = _port_service(model, reg)
    judge = _Judge(registry, 5)
    svc.attach_manager(judge)
    svc.start_shadow(flax_to_state_dict(params["near"]), 5)

    def broken(batch):
        raise RuntimeError("shadow forward failed")

    svc._shadow = (broken, 5)
    svc.start()
    tr, _ = _trace()
    try:
        det = _feed(svc, "s0", tr)
    finally:
        svc.stop()
    windows = reg.value("serve_windows_scored_total")
    # one failure a batch, the warmup's included; every window scored
    assert windows > 0 and reg.value("registry_shadow_failures_total") >= \
        1 + windows // SERVE["batch_size"]
    assert judge.stats.windows == 0 and judge.logs
    assert det.file_scores == _offline(model, tr, "s0").file_scores


def test_manager_promotes_vetoes_and_rolls_back(models, tmp_path):
    _, _, params = models
    for name in ("live", "near", "far"):
        ck.save_checkpoint(tmp_path / name, flax_to_state_dict(params[name]), _tiny_cfg())
    store = registry.ModelRegistry(tmp_path / "reg", journal=journal.EventJournal())
    store.promote("det", store.publish("det", tmp_path / "live"))
    reg = MetricsRegistry(namespace="t")
    jr = journal.EventJournal(registry=reg)
    man = registry.ModelManager(store, "det", cfg=registry.RegistryConfig(**LIFECYCLE),
                                registry=reg, journal=jr)
    sd, cfg, cal, version = man.boot()
    assert version == 1 and cal == {}
    model = NerrfNet(_tiny_cfg())
    model.load_state_dict(sd)
    svc = OnlineDetectionService(model.eval(), ServeConfig(**SERVE), registry=reg,
                                 journal=jr, device="cpu").start()
    man.attach(svc)
    tr, _ = _trace()
    dets, actions = {}, []
    try:
        store.publish("det", tmp_path / "near")                 # v2
        actions.append(man.poll()["action"])                    # shadow v2
        _feed(svc, "a", tr)
        actions.append(man.poll()["action"])                    # auto-promote
        dets[2] = _feed(svc, "b", tr)
        store.publish("det", tmp_path / "far")                  # v3
        actions.append(man.poll()["action"])                    # shadow v3
        _feed(svc, "c", tr)
        actions.append(man.poll()["action"])                    # veto
        store.rollback("det")                                   # LIVE → v1
        actions.append(man.poll()["action"])                    # swap back
        dets[1] = _feed(svc, "d", tr)
        assert svc.ready()[2] == {"model_version": "v1", "lineage": "det"}
    finally:
        man.close()
        svc.stop()
    assert actions == ["shadow_start", "auto_promote", "shadow_start", "veto", "swap"]
    assert reg.value("registry_promotions_total",
                     labels={"lineage": "det", "kind": "auto"}) == 1
    assert reg.value("registry_shadow_vetoes_total", labels={"lineage": "det"}) == 1
    for v, det in dets.items():
        assert det.detector == f"serve[max]@v{v}"
        want = _offline(_port_model(params["live" if v == 1 else "near"]), tr,
                        "b" if v == 2 else "d")
        assert det.file_scores == want.file_scores
        assert det.file_window_scores == want.file_window_scores


# -- the command line -----------------------------------------------------------


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cks")
    torch.manual_seed(0)
    for name in ("a", "b"):
        model = NerrfNet(_tiny_cfg())
        ck.save_checkpoint(tmp / name, model.state_dict(), model.cfg)
    tr, _ = _trace()
    (tmp / "t.jsonl").write_text(events_to_jsonl(tr.events, tr.strings))
    return tmp


@pytest.mark.parametrize("sub", ["publish", "list", "promote", "rollback", "status"])
def test_models_commands(checkpoints, tmp_path, sub):
    R = ["--registry", tmp_path / "R", "--lineage", "det"]
    assert _run(["models", "publish", *R, "--model-dir", checkpoints / "a",
                 "--promote"])[0] == 0
    argv = {"publish": ["models", "publish", *R, "--model-dir", checkpoints / "b",
                        "--source", "test"],
            "list": ["models", "list", "--registry", tmp_path / "R"],
            "promote": ["models", "promote", *R, "--version", "1"],
            "rollback": ["models", "rollback", *R, "--version", "1"],
            "status": ["models", "status", *R]}[sub]
    rc, out, err = _run(argv)
    assert rc == 0, err
    doc = json.loads(out)
    if sub == "publish":
        assert doc["published"] == 2 and doc["executables"] is False
    elif sub == "list":
        assert doc["lineages"]["det"]["live"]["version"] == 1
    elif sub in ("promote", "rollback"):
        assert doc["live"]["version"] == 1
    else:
        assert [v["live"] for v in doc["versions"]] == [True]


def test_serve_detect_boots_from_the_registry_and_archives(checkpoints, tmp_path):
    R = tmp_path / "R"
    assert _run(["models", "publish", "--registry", R, "--lineage", "det",
                 "--model-dir", checkpoints / "a", "--promote"])[0] == 0
    # the summary reads the process-wide registry, which earlier serves in
    # this process have counted into
    before = DEFAULT_REGISTRY.value("serve_windows_scored_total") or 0
    rc, out, err = _run(["serve-detect", "--device", "cpu", "--registry", R,
                         "--lineage", "det", "--trace", checkpoints / "t.jsonl",
                         "--buckets", "128x256x32", "--metrics-port", "-1",
                         "--archive-dir", tmp_path / "A", "--out", tmp_path / "o"])
    assert rc == 0, err
    summary = json.loads(out)
    assert summary["model_version"] == "v1"
    stream = next(iter(summary["streams"].values()))
    assert stream["detector"] == "serve[max]@v1" and stream["error"] is None
    assert archive.verify_archive(tmp_path / "A")["ok"]
    rc, out, err = _run(["report", tmp_path / "A", "--json"])
    assert rc == 0, err
    assert json.loads(out)["slo"]["windows_scored"] == summary["windows_scored"] - before > 0


def test_quality_commands(tmp_path):
    from nerrf_tpu_torch.quality import ProfileBuilder

    rng = np.random.default_rng(0)
    for name, shift in (("a", 0.0), ("b", 0.3)):
        b = ProfileBuilder(0.5)
        for _ in range(20):
            mask = np.ones(32, np.float32)
            b.observe_window(np.clip(rng.uniform(0, 1, 32) + shift, 0, 1), mask,
                             rng.integers(0, 2, 32), nodes=32, edges=40, files=8)
        ck.save_checkpoint(tmp_path / name, {"w": torch.ones(1)}, _tiny_cfg(),
                           quality_profile=b.finish().to_dict())
    rc, out, _ = _run(["quality", "show", tmp_path / "a"])
    assert rc == 0 and out.startswith("quality profile (schema v1): 20 windows")
    rc, out, _ = _run(["quality", "compare", tmp_path / "a", tmp_path / "b", "--json"])
    assert rc == 0 and json.loads(out)["score_psi"] > 0.25
    assert _run(["quality", "compare", tmp_path / "a", tmp_path / "b",
                 "--psi-threshold", "0.25"])[0] == 1
    assert _run(["quality", "show", tmp_path / "nowhere"])[0] == 2


def test_train_detector_publishes_the_calibrated_checkpoint(tmp_path, monkeypatch):
    import nerrf_tpu_torch.data as tdata
    import nerrf_tpu_torch.train as ttrain
    from nerrf_tpu_torch.train import loop

    model = NerrfNet(_tiny_cfg())
    monkeypatch.setattr(tdata, "make_corpus", lambda n, **kw: list(range(n)))
    monkeypatch.setattr(ttrain, "build_dataset", lambda traces, cfg: traces)
    monkeypatch.setattr(loop, "train_nerrfnet", lambda *a, **kw: types.SimpleNamespace(
        metrics={"edge_auc": 0.95, "seq_f1": 0.9}, steps_per_sec=1.0,
        state=types.SimpleNamespace(model=model)))
    monkeypatch.setattr(ck, "calibrate_and_resave", lambda path, m, **kw: ck.save_checkpoint(
        path, m.state_dict(), m.cfg, calibration={"node_threshold": 0.8}))
    rc, _, err = _run(["train-detector", "--device", "cpu", "--model-dir", tmp_path / "m",
                       "--publish", tmp_path / "R", "--lineage", "det", "--steps", "3"])
    assert rc == 0, err
    assert "published" in err and "det/v1" in err
    store = registry.ModelRegistry(tmp_path / "R")
    assert store.versions("det") == [1] and store.live("det") is None
    assert store.load("det", 1)[2] == {"node_threshold": 0.8}


def test_run_experiment_publishes_to_the_registry(tmp_path):
    exp = {
        "name": "tiny-publish", "description": "publish_to",
        "corpus": {"num_traces": 3, "attack_fraction": 0.5, "base_seed": 42,
                   "duration_sec": 45.0, "num_target_files": 6,
                   "benign_rate_hz": 10.0, "eval_fraction": 0.34},
        "dataset": {"graph": {"window_sec": 45.0, "stride_sec": 15.0,
                              "max_nodes": 128, "max_edges": 256},
                    "seq_len": 24, "max_seqs": 32, "min_events": 4},
        "train": {"model": {"gnn": {"hidden": 8, "num_layers": 1, "dropout": 0.0,
                                    "dtype": "float32", "aggregation": "segment"},
                            "lstm": {"hidden": 8, "num_layers": 1, "dropout": 0.0,
                                     "dtype": "float32"},
                            "fuse": True},
                  "batch_size": 4, "num_steps": 2, "warmup_steps": 1,
                  "eval_every": 10, "seed": 0},
    }
    (tmp_path / "e.json").write_text(json.dumps(exp))
    report = run.run_experiment(str(tmp_path / "e.json"), tmp_path / "out",
                                calibrate=False, publish_to=str(tmp_path / "R"),
                                lineage="det", device="cpu")
    assert report["published_version"] == 1
    assert json.loads((tmp_path / "out" / "metrics.json").read_text()) == report
    store = registry.ModelRegistry(tmp_path / "R")
    assert store.status("det")["versions"][0]["source"] == \
        "nerrf_tpu_torch.train.run --experiment tiny-publish"
