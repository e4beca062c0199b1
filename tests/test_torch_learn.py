"""The port's continuous-learning plane (nerrf_tpu_torch.learn) against the
JAX package's (nerrf_tpu.learn), on the CPU, with a tiny float32 model
(GraphSAGE-T 16 × 2, LSTM 16 × 1).

* `ReplayWriter` fed the same windows of the same simulated trace (a
  reservoir quota small enough that its seeded draws decide): the same
  records, ``replay_fingerprint``, ``replay_stats`` and, bit for bit,
  ``build_replay_dataset`` arrays and ``replay_batches``; the disposition
  join is last-wins in both.
* The supervisor's launch discipline with an injected ``retrain_fn``
  (debounce, the wrong trigger, single-flight, cooldown, an error, a closed
  supervisor): the same launches, outcomes and journal records.
* One real retrain of the port on the CPU (3 steps) over a replay buffer
  and two synth traces, published into a model registry: its provenance
  (in the checkpoint sidecar and the registry's status) equals the one the
  reference's supervisor computes on the same buffer and synth config.  The
  reference's trainer, checkpoint writer and registry are stand-ins there:
  the provenance is computed from the data, not from the weights, and a
  JAX training compile would cost more than the rest of the file.
* A retrain at a learning rate of 1e12 aborts under the health monitor and
  publishes nothing.
* Serve with ``attach_learn`` and ``attach_flight`` on one stream, against
  the reference service on the same stream with the same weights: the same
  replay records (scores within PROB_ATOL), SLO counts and p99 bundle.
* The kernels' launch counters stay exact when several threads count at
  once.
"""

import dataclasses
import json
import sys
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerrf_tpu import learn as jlearn
from nerrf_tpu.data import SimConfig as JSimConfig
from nerrf_tpu.data import simulate_trace as jsimulate_trace
from nerrf_tpu.flight import EventJournal as JEventJournal
from nerrf_tpu.flight import FlightConfig as JFlightConfig
from nerrf_tpu.flight import FlightRecorder as JFlightRecorder
from nerrf_tpu.models import GraphSAGEConfig as JGraphSAGEConfig
from nerrf_tpu.models import JointConfig as JJointConfig
from nerrf_tpu.models import LSTMConfig as JLSTMConfig
from nerrf_tpu.models import NerrfNet as JNerrfNet
from nerrf_tpu.observability import MetricsRegistry as JMetricsRegistry
from nerrf_tpu.serve import config as jconfig
from nerrf_tpu.serve import service as jservice
from nerrf_tpu.train import checkpoint as jck
from nerrf_tpu.train import elastic as jelastic
from nerrf_tpu.train.data import windows_of_trace as jwindows_of_trace
from nerrf_tpu.train.loop import model_inputs as jmodel_inputs
from nerrf_tpu_torch import learn
from nerrf_tpu_torch.convert import load_flax_params
from nerrf_tpu_torch.data import SimConfig, simulate_trace
from nerrf_tpu_torch.flight import EventJournal, FlightConfig, FlightRecorder
from nerrf_tpu_torch.models import (GraphSAGEConfig, JointConfig, LSTMConfig,
                                    NerrfNet, build_nerrfnet)
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.ops import LAUNCHES, kernels, reset_launches
from nerrf_tpu_torch.registry import ModelRegistry
from nerrf_tpu_torch.serve import OnlineDetectionService, ServeConfig
from nerrf_tpu_torch.train.checkpoint import save_checkpoint
from nerrf_tpu_torch.trainwatch import TrainHealthConfig

BUCKET = (256, 512, 64)
WINDOWING = dict(buckets=(BUCKET,), batch_size=4, window_sec=15.0, stride_sec=5.0)
WINDOW_NS, STRIDE_NS = 15_000_000_000, 5_000_000_000
# node probabilities, port vs JAX package, float32 (test_torch_quality's bound)
PROB_ATOL = 1e-4
PKGS = {
    "ref": SimpleNamespace(learn=jlearn, Journal=JEventJournal,
                           Registry=JMetricsRegistry, SimConfig=JSimConfig,
                           simulate_trace=jsimulate_trace, ServeConfig=jconfig.ServeConfig,
                           device={}),
    "port": SimpleNamespace(learn=learn, Journal=EventJournal, Registry=MetricsRegistry,
                            SimConfig=SimConfig, simulate_trace=simulate_trace,
                            ServeConfig=ServeConfig, device={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread while a test runs (the models are a few units
    wide, and other test processes share the host)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sim(seed, duration=60.0, drift=0.0):
    return dict(duration_sec=duration, attack=True, attack_start_sec=duration / 3,
                num_target_files=4, benign_rate_hz=6.0, seed=seed, drift=drift)


def _windows(trace, n):
    t0 = int(trace.events.ts_ns[trace.events.valid].min())
    return [(i, t0 + i * STRIDE_NS, t0 + i * STRIDE_NS + WINDOW_NS) for i in range(n)]


def _scored(tid, stream, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros(8, bool)
    mask[:int(rng.integers(1, 8))] = True
    return SimpleNamespace(trace_id=tid, stream=f"{stream}#1", bucket=BUCKET,
                           model_version=1, node_mask=mask,
                           probs=rng.random(8).astype(np.float32),
                           nodes=int(rng.integers(4, 60)),
                           edges=int(rng.integers(4, 90)), files=3)


def _fill_replay(pkg, out_dir, quota=3):
    """Two streams × 8 windows through ``pkg``'s ReplayWriter (quota 3: the
    reservoir's seeded draws decide windows 4-8), one window discarded as
    failed, then the dispositions."""
    writer = pkg.learn.ReplayWriter(
        pkg.learn.ReplayConfig(out_dir=str(out_dir), per_stream_quota=quota, seed=5),
        registry=pkg.Registry(namespace="t"))
    for k, stream in enumerate(("s0", "s1")):
        tr = pkg.simulate_trace(pkg.SimConfig(**_sim(3 + k)))
        for idx, lo, hi in _windows(tr, 8):
            tid = f"t-{stream}-{idx}"
            writer.observe_admit(tid, stream, idx, lo, hi, tr.events, tr.strings)
            if (k, idx) == (1, 2):
                writer.discard(tid)
            writer.observe_scored(_scored(tid, stream, 10 * k + idx))
    stats = writer.stats()
    writer.close()
    for tid, label in (("t-s0-1", "tp"), ("t-s1-0", "tp"), ("t-s0-1", "fp")):
        pkg.learn.append_disposition(out_dir, tid, label, note="test")
    return stats


def _replay_view(pkg, out_dir):
    lrn = pkg.learn
    ds_cfg = pkg.ServeConfig(**WINDOWING).dataset_config(BUCKET)
    ds, info = lrn.build_replay_dataset(out_dir, ds_cfg, seed=2, limit=7)
    stats = lrn.replay_stats(out_dir)
    stats.pop("disk_bytes")  # each record carries its own wall-clock stamp
    return {
        "records": [{k: v for k, v in r.items() if k != "t_wall"}
                    for r in lrn.iter_replay(out_dir)],
        "dispositions": {k: {f: v for f, v in r.items() if f != "t_wall"}
                         for k, r in lrn.load_dispositions(out_dir).items()},
        "fingerprint": lrn.replay_fingerprint(out_dir),
        "stats": stats, "info": info, "arrays": ds.arrays,
        "batches": list(lrn.replay_batches(ds, 3, seed=4)),
    }


def _assert_same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        assert got == want


def test_replay_buffer_equals_the_references(tmp_path):
    stats = {name: _fill_replay(pkg, tmp_path / name) for name, pkg in PKGS.items()}
    assert stats["port"] == {**stats["ref"], "disk_bytes": stats["port"]["disk_bytes"]}
    got, want = (_replay_view(PKGS[n], tmp_path / n) for n in ("port", "ref"))
    _assert_same(got, want)
    assert 6 < got["stats"]["windows"] < 15 and got["info"]["windows"] == 7
    assert got["dispositions"]["t-s0-1"]["label"] == "fp"   # last wins
    assert "t-s1-2" not in {r["trace_id"] for r in got["records"]}   # discarded


# -- the supervisor ------------------------------------------------------------------


def _discipline(pkg):
    """The supervisor's launch decisions over one record sequence, with an
    injected retrain held open by a gate."""
    reg = pkg.Registry(namespace="t")
    journal = pkg.Journal(registry=reg)
    gate = threading.Event()
    seen, steps = [], []

    def retrain_fn(seq):
        seen.append(seq)
        gate.wait(30)
        return "published"

    def make(fn, **over):
        over.setdefault("debounce_window_sec", 600.0)
        return pkg.learn.RetrainSupervisor(
            store=None, model_cfg=None, cfg=pkg.learn.RetrainConfig(**over),
            registry=reg, journal=journal, retrain_fn=fn, **pkg.device)

    def state(sup, tag):
        steps.append((tag, sup.launches, sup.active, sup.last_outcome))

    sup = make(retrain_fn, debounce_triggers=2, cooldown_sec=3600.0)
    try:
        journal.record("bundle", trigger="quality_drift", path="a")
        state(sup, "one trigger")
        journal.record("bundle", trigger="p99_breach", path="b")
        journal.record("admission_drop", reason="x")
        state(sup, "wrong trigger and kind")
        journal.record("bundle", trigger="quality_drift", path="c")
        state(sup, "debounced")
        for _ in range(3):
            journal.record("bundle", trigger="quality_drift", path="d")
        state(sup, "single flight")
        gate.set()
        assert sup.wait(30)
        state(sup, "finished")
        for _ in range(2):
            journal.record("bundle", trigger="quality_drift", path="e")
        state(sup, "cooldown")
    finally:
        gate.set()
        sup.close(timeout=30)
    sup = make(lambda seq: "published", cooldown_sec=0.0)
    journal.record("bundle", trigger="quality_drift", path="f")
    assert sup.wait(30)
    journal.record("bundle", trigger="quality_drift", path="g")
    assert sup.wait(30)
    state(sup, "no cooldown")
    sup.close(timeout=30)

    def boom(seq):
        raise RuntimeError("boom")

    sup = make(boom)
    journal.record("bundle", trigger="quality_drift", path="h")
    assert sup.wait(30)
    state(sup, "error")
    sup.close(timeout=30)
    journal.record("bundle", trigger="quality_drift", path="i")
    state(sup, "closed")
    records = [(r.kind, dict(r.data)) for r in journal.tail()
               if r.kind.startswith("retrain")]
    counts = {o: reg.value("retrain_runs_total", labels={"outcome": o})
              for o in ("published", "error")}
    return steps, seen, records, counts, reg.value("retrain_active")


def test_supervisor_discipline_equals_the_references():
    got = _discipline(PKGS["port"])
    assert got == _discipline(PKGS["ref"])
    steps, seen, _, counts, active = got
    assert [s[1] for s in steps] == [0, 0, 1, 1, 1, 1, 2, 1, 1]
    assert len(seen) == 1 and counts == {"published": 3, "error": 1} and active == 0.0


def test_supervisor_refusals():
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.7"):
        learn.RetrainSupervisor(None, None, learn.RetrainConfig(aot_export=True),
                                device="cpu")
    with pytest.raises(NotImplementedError, match=r"B\.D1"):
        learn.RetrainSupervisor(None, None, compile_cache=object(), device="cpu")


# -- a real retrain, and a diverged one ------------------------------------------------


def _tiny_cfg():
    return JointConfig(
        gnn=GraphSAGEConfig(hidden=16, num_layers=2, dropout=0.0, dtype=torch.float32),
        lstm=LSTMConfig(hidden=16, num_layers=1, dropout=0.0, dtype=torch.float32))


RETRAIN = dict(lineage="default", num_steps=3, batch_size=4, save_every=3, seed=2,
               replay_limit=6, synth_traces=2, synth_duration_sec=40.0,
               synth_drift=0.8, synth_num_target_files=4, synth_benign_rate_hz=6.0)


@pytest.fixture(scope="module")
def replay_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("replay")
    _fill_replay(PKGS["port"], out)
    return out


def _port_world(tmp, cfg):
    reg = MetricsRegistry(namespace="t")
    journal = EventJournal(registry=reg)
    store = ModelRegistry(tmp / "registry", journal=journal)
    save_checkpoint(tmp / "v1", build_nerrfnet(cfg, seed=0, device="cpu").state_dict(), cfg)
    store.publish("default", tmp / "v1", source="test v1")
    store.promote("default", 1)
    return reg, journal, store


def _run_retrain(sup, journal):
    """Fire the drift trigger, wait the retrain out; (outcome, trigger seq)."""
    seq = journal.record("bundle", trigger="quality_drift", path="injected").seq
    assert sup.wait(300)
    sup.close(timeout=30)
    return sup.last_outcome, seq


class _RefStandIns:
    """The reference supervisor's trainer, checkpoint writer and registry,
    recording what they are given."""

    def __init__(self):
        self.saved, self.published = [], []

    def train_elastic(self, train_ds, cfg=None, **kw):
        self.train = (len(train_ds), cfg.num_steps, cfg.batch_size, cfg.seed)
        return SimpleNamespace(state=SimpleNamespace(params=None),
                               metrics={"edge_auc": 0.5}, steps_per_sec=1.0)

    def save_checkpoint(self, out, params, model_cfg, provenance=None, **kw):
        self.saved.append(provenance)

    def live_version(self, lineage):
        return 1

    def publish(self, lineage, path, source=None):
        self.published.append((lineage, source))
        return 2


def test_retrain_publishes_with_the_references_provenance(tmp_path, replay_dir,
                                                          monkeypatch):
    cfg = _tiny_cfg()
    reg, journal, store = _port_world(tmp_path, cfg)
    ds_cfg = ServeConfig(**WINDOWING).dataset_config(BUCKET)
    sup = learn.RetrainSupervisor(
        store, cfg, learn.RetrainConfig(replay_dir=str(replay_dir),
                                        out_dir=str(tmp_path / "retrain"), **RETRAIN),
        ds_cfg=ds_cfg, registry=reg, journal=journal, device="cpu")
    outcome, seq = _run_retrain(sup, journal)
    assert outcome == "published"

    ref = _RefStandIns()
    monkeypatch.setattr(jelastic, "train_elastic", ref.train_elastic)
    monkeypatch.setattr(jck, "save_checkpoint", ref.save_checkpoint)
    jreg = JMetricsRegistry(namespace="t")
    jjournal = JEventJournal(registry=jreg)
    jsup = jlearn.RetrainSupervisor(
        ref, None, jlearn.RetrainConfig(replay_dir=str(replay_dir),
                                        out_dir=str(tmp_path / "ref-retrain"), **RETRAIN),
        ds_cfg=jconfig.ServeConfig(**WINDOWING).dataset_config(BUCKET),
        registry=jreg, journal=jjournal)
    joutcome, jseq = _run_retrain(jsup, jjournal)
    assert joutcome == "published"

    # each supervisor stamps its own journal's trigger record (the port's
    # journal also holds the registry's publish and promote records)
    [want] = ref.saved
    assert want.pop("trigger_seq") == jseq
    status = store.status("default")
    assert [v["version"] for v in status["versions"]] == [1, 2]
    assert store.live_version("default") == 1   # promotion is the guardrails' call
    meta = json.loads((store.version_dir("default", 2) / "model_config.json").read_text())
    assert meta["provenance"] == status["versions"][1]["provenance"]
    assert meta["provenance"] == {**want, "trigger_seq": seq}
    assert want["replay_windows"] == 6 and want["synth_windows"] > 0
    assert want["parent_version"] == 1 and want["steps"] == 3
    # the journal's account of the run, but for its timing and its metric
    drop = ("wall_sec", "steps_per_sec", "edge_auc")

    def account(j):
        return [(r.kind, {k: v for k, v in r.data.items()
                          if k not in drop + ("trigger_seq",)})
                for r in j.tail() if r.kind.startswith("retrain")]

    assert account(journal) == account(jjournal)
    assert reg.value("retrain_runs_total", labels={"outcome": "published"}) == 1


def test_diverged_retrain_publishes_nothing(tmp_path, replay_dir):
    cfg = _tiny_cfg()
    reg, journal, store = _port_world(tmp_path, cfg)
    sup = learn.RetrainSupervisor(
        store, cfg, learn.RetrainConfig(
            replay_dir=str(replay_dir), out_dir=str(tmp_path / "retrain"),
            **{**RETRAIN, "num_steps": 6, "save_every": 2, "learning_rate": 1e12}),
        ds_cfg=ServeConfig(**WINDOWING).dataset_config(BUCKET),
        registry=reg, journal=journal, device="cpu",
        monitor_cfg=TrainHealthConfig(journal_every=2, stall_after_sec=3600.0))
    assert _run_retrain(sup, journal)[0] == "aborted"
    [aborted] = journal.tail(kinds=("retrain_aborted",))
    assert aborted.data["parent_version"] == 1 and aborted.data["step"] is not None
    assert [v["version"] for v in store.status("default")["versions"]] == [1]
    assert reg.value("retrain_runs_total", labels={"outcome": "aborted"}) == 1


# -- serve with the learn and flight planes attached ----------------------------------


def _models():
    jc = JJointConfig(
        gnn=JGraphSAGEConfig(hidden=16, num_layers=2, dropout=0.0, dtype=jnp.float32),
        lstm=JLSTMConfig(hidden=16, num_layers=1, dropout=0.0, dtype=jnp.float32))
    jmodel = JNerrfNet(jc)
    # jitted: an eager flax init of the model takes several times longer
    ds_cfg = jconfig.ServeConfig(**WINDOWING).dataset_config(BUCKET)
    one = jwindows_of_trace(jsimulate_trace(JSimConfig(**_sim(1, duration=30.0))),
                            ds_cfg)[0]
    params = jax.device_get(jax.jit(
        lambda key: jmodel.init(key, *jmodel_inputs(one), deterministic=True)["params"])(
            jax.random.PRNGKey(0)))
    return jmodel, params, load_flax_params(NerrfNet(_tiny_cfg()), params).eval()


def _serve_planes(name, tmp, make_service):
    pkg = PKGS[name]
    reg = pkg.Registry(namespace="t")
    journal = pkg.Journal(registry=reg)
    svc = make_service(reg, journal)
    writer = pkg.learn.ReplayWriter(
        pkg.learn.ReplayConfig(out_dir=str(tmp / name / "replay"), per_stream_quota=4),
        registry=reg)
    flight_cls = FlightRecorder if name == "port" else JFlightRecorder
    cfg_cls = FlightConfig if name == "port" else JFlightConfig
    rec = flight_cls(cfg_cls(out_dir=str(tmp / name / "flight"), p99_breach_sec=0.0,
                             p99_min_count=4),
                     registry=reg, journal=journal, slo=svc.slo, info=svc.flight_info)
    svc.attach_learn(writer)
    svc.attach_flight(rec)
    svc.start()
    tr = pkg.simulate_trace(pkg.SimConfig(**_sim(7)))
    try:
        svc.join("s0")
        ev = tr.events
        for i in range(0, len(ev), 150):
            block = type(ev)(**{f.name: getattr(ev, f.name)[i:i + 150]
                                for f in dataclasses.fields(ev)})
            svc.feed("s0", block, tr.strings)
        svc.leave("s0", timeout=120.0)
    finally:
        svc.stop()
        rec.close()
        writer.close()
    records = list(pkg.learn.iter_replay(tmp / name / "replay"))
    slo = {s: {k: v[k] for k in ("count", "breaches")}
           for s, v in svc.slo.snapshot()["per_stream"].items()}
    bundles = [r.data["trigger"] for r in journal.tail(kinds=("bundle",))]
    [p99] = journal.tail(kinds=("bundle",))
    man = json.loads((tmp / name / "flight" / p99.data["path"].rsplit("/", 1)[-1]
                      / "manifest.json").read_text())
    # the config fingerprint hashes the port's ServeConfig, which lacks the
    # device-time plane's fields (ROADMAP A.6)
    lineage = {k: v for k, v in man["lineage"].items() if k != "config_fingerprint"}
    return records, slo, bundles, {k: man["context"][k] for k in ("windows", "stream")}, \
        lineage, reg.value("serve_windows_scored_total")


def test_serve_tees_replay_and_slo_as_the_reference(tmp_path):
    jmodel, params, tmodel = _models()

    def port_service(reg, journal):
        return OnlineDetectionService(tmodel, ServeConfig(**WINDOWING), registry=reg,
                                      journal=journal, device="cpu")

    def ref_service(reg, journal):
        return jservice.OnlineDetectionService(
            params, jmodel, cfg=jconfig.ServeConfig(**WINDOWING), registry=reg,
            journal=journal)

    got = _serve_planes("port", tmp_path, port_service)
    want = _serve_planes("ref", tmp_path, ref_service)
    records, wrecords = got[0], want[0]
    assert len(records) == len(wrecords) > 4
    for r, w in zip(records, wrecords):
        fixed = {k: v for k, v in r.items() if k not in ("t_wall", "max_prob")}
        assert fixed == {k: v for k, v in w.items() if k not in ("t_wall", "max_prob")}
        assert abs(r["max_prob"] - w["max_prob"]) <= PROB_ATOL
    assert got[1:] == want[1:]
    assert got[1]["s0"]["count"] == got[5] > 4
    assert got[2] == ["p99_breach"] and got[3] == {"windows": 4, "stream": "s0"}


# -- the launch counters across threads ----------------------------------------------


def test_launch_counts_from_threads_sum_exactly():
    """Several threads count launches at once, with the interpreter switching
    threads every microsecond: the counters lose no increment."""
    reset_launches()
    threads, per = 8, 4000
    names = list(LAUNCHES)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def count(k):
            for i in range(per):
                kernels.count_launch(LAUNCHES, names[(k + i) % len(names)])

        ts = [threading.Thread(target=count, args=(k,)) for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(prev)
    assert sum(LAUNCHES.values()) == threads * per
    assert LAUNCHES == {n: threads * per // len(names) for n in names}
    reset_launches()
    assert LAUNCHES == {n: 0 for n in names}
