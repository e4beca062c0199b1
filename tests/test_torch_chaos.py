"""The port's chaos plane (``nerrf_tpu_torch.chaos``) against the JAX
package's, on the CPU.

* The catalog (``SITES``, ``SITE_MODES``, ``KEY_STABLE_SITES``) equals the
  reference's, and the same plan checked with the same keys gives the same
  firing ledger from both packages' controllers.
* Every case of ``tests/test_chaos.py`` against the port's code paths (the
  gRPC drain, the micro-batcher, the service's quarantine and watchdog, the
  registry store, the flight recorder, the alert sink), at the same sizes,
  but two: the compile-cache point becomes its refusal (the port has no
  compile cache, ROADMAP A.7: a plan naming it is refused in one line), and
  the soak bench's smoke becomes one small serve survival run (poison,
  latency and wire errors over two streams and a resident drain, isolation
  exact, an unfaulted stream bit-equal to ``model_detect``).
* ``train.nonfinite_grad`` halts a streamed ``train_nerrfnet`` at the armed
  step with one ``train_divergence`` bundle.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from nerrf_tpu import chaos as jchaos
from nerrf_tpu.flight.journal import EventJournal as JEventJournal
from nerrf_tpu.observability import MetricsRegistry as JMetricsRegistry
from nerrf_tpu_torch import chaos
from nerrf_tpu_torch.chaos import points
from nerrf_tpu_torch.flight.journal import EventJournal
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.serve import MicroBatcher, ServeConfig, WindowRequest
from test_torch_shed import make_port_service_shell

BUCKET = (128, 256, 32)


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread while a test runs: the CPU is shared with other
    test processes, and small tensor ops would wait on a thread pool."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _always_disarm():
    """No test may leak an armed plan into the rest of the suite."""
    yield
    chaos.disarm()
    jchaos.disarm()


def _arm(faults, seed=0, registry=None, journal=None):
    return chaos.arm(chaos.FaultPlan(seed=seed, faults=tuple(faults)),
                     registry=registry or MetricsRegistry(namespace="test"),
                     journal=journal or EventJournal())


def _req(stream, idx, trace_id=None):
    sample = {"node_mask": np.zeros(BUCKET[0], np.bool_),
              "node_type": np.zeros(BUCKET[0], np.int32),
              "node_key": np.zeros(BUCKET[0], np.int64)}
    now = time.perf_counter()
    return WindowRequest(stream=stream, window_idx=idx, lo_ns=0, hi_ns=1,
                         bucket=BUCKET, sample=sample, t_admit=now,
                         deadline=now + 10,
                         trace_id=trace_id or f"w-{stream}-{idx}")


def _batcher(cfg=None, registry=None, journal=None, score=None,
             on_scored=None, on_failed=None):
    cfg = cfg or ServeConfig(buckets=(BUCKET,), batch_size=4,
                             batch_close_sec=10.0)
    mb = MicroBatcher(
        score_fn=score or (lambda b: np.zeros(b["node_mask"].shape)),
        cfg=cfg, registry=registry or MetricsRegistry(namespace="test"),
        journal=journal or EventJournal(),
        on_scored=on_scored, on_failed=on_failed)
    mb.mark_warm(BUCKET)
    return mb


# -- the catalog and the controller, against the reference ---------------------

def test_catalog_is_the_references():
    assert chaos.SITES == jchaos.SITES
    assert chaos.SITE_MODES == jchaos.SITE_MODES
    assert points.KEY_STABLE_SITES == jchaos.points.KEY_STABLE_SITES
    assert chaos.PLAN_ENV == jchaos.PLAN_ENV
    # every site but the compile cache's is reachable in the port
    assert set(points.UNWIRED_SITES) == {"compilecache.corrupt_payload"}


def test_same_plan_same_keys_same_ledger_as_the_reference():
    faults = [
        dict(site="serve.poison_window", prob=0.4, match={"stream": "s1"}),
        dict(site="ingest.wire_error", every=5, match={"target": "t0"}),
        dict(site="serve.device_latency", mode="stall", every=4,
             delay_sec=0.2),
        dict(site="alerts.slow_consumer", mode="stall", at=1, delay_sec=0.3),
        dict(site="flight.disk_full", at=1, max_fires=1),
        dict(site="train.nonfinite_grad", mode="corrupt", prob=0.3),
    ]
    checks = []
    for i in range(96):
        checks.append(("serve.poison_window", f"w-{i:04x}",
                       {"stream": f"s{i % 3}", "window_idx": i}))
        checks.append(("ingest.wire_error", None,
                       {"stream": "w0", "target": f"t{i % 2}"}))
        checks.append(("serve.device_latency", None, {"bucket": "b"}))
        checks.append(("alerts.slow_consumer", None, {}))
        checks.append(("flight.disk_full", None, {"trigger": "drop_burst"}))
        checks.append(("train.nonfinite_grad", str(i), {"step": i}))
    ledgers = []
    for pkg, reg, jrn in ((chaos, MetricsRegistry, EventJournal),
                          (jchaos, JMetricsRegistry, JEventJournal)):
        plan = pkg.FaultPlan(seed=42, faults=tuple(pkg.FaultSpec(**f)
                                                   for f in faults))
        ctl = pkg.ChaosController(plan, registry=reg(namespace="t"),
                                  journal=jrn())
        verdicts = [ctl.check(site, key, dict(ctx)) is not None
                    for site, key, ctx in checks]
        ledgers.append((verdicts, list(ctl.fired)))
    assert ledgers[0] == ledgers[1]
    assert sum(ledgers[0][0]) > 20


# -- plan schema + validation --------------------------------------------------

def test_plan_json_roundtrip_and_validation():
    plan = chaos.FaultPlan.from_json(json.dumps({
        "seed": 9,
        "faults": [
            {"site": "serve.poison_window", "prob": 0.5,
             "match": {"stream": "s1"}},
            {"site": "ingest.wire_error", "every": 3},
        ]}))
    plan.validate(tuple(chaos.SITES))
    assert plan.seed == 9
    again = chaos.FaultPlan.from_dict(plan.to_dict())
    assert again == plan

    with pytest.raises(ValueError, match="unknown fault site"):
        chaos.FaultPlan(faults=(chaos.FaultSpec(site="nope", at=1),)) \
            .validate(tuple(chaos.SITES))
    with pytest.raises(ValueError, match="no trigger"):
        chaos.FaultSpec(site="ingest.wire_error").validate()
    with pytest.raises(ValueError, match="prob"):
        chaos.FaultSpec(site="ingest.wire_error", prob=1.5).validate()
    with pytest.raises(ValueError, match="unknown field"):
        chaos.FaultPlan.from_dict(
            {"faults": [{"site": "ingest.wire_error", "evrey": 3}]})
    with pytest.raises(ValueError, match="JSON object"):
        chaos.FaultPlan.from_json('[{"site": "ingest.wire_error"}]')


def test_disarmed_points_are_noops():
    assert not chaos.armed()
    assert chaos.check("serve.poison_window", key="k") is None
    chaos.inject("ingest.wire_error", stream="s0")  # must not raise
    payload = b"payload-bytes"
    assert chaos.mangle("registry.corrupt_sidecar", payload) is payload


def test_seeded_plan_replays_deterministically():
    faults = (chaos.FaultSpec(site="serve.poison_window", prob=0.5),
              chaos.FaultSpec(site="ingest.wire_error", prob=0.3),)
    keys = [f"w-{i:04x}" for i in range(64)]

    def fired_set(seed):
        ctl = _arm(faults, seed=seed)
        for k in keys:
            ctl.check("serve.poison_window", k, {"stream": "s"})
        for _ in range(64):  # unkeyed: the per-spec counter is the key
            ctl.check("ingest.wire_error", None, {})
        chaos.disarm()
        return [(s, k) for s, k, _ in ctl.fired]

    a, b = fired_set(seed=7), fired_set(seed=7)
    assert a == b and len(a) > 0
    assert fired_set(seed=8) != a
    ctl = _arm(faults, seed=7)
    first = {k: ctl.check("serve.poison_window", k, {}) is not None
             for k in keys}
    second = {k: ctl.check("serve.poison_window", k, {}) is not None
              for k in keys}
    assert first == second


def test_trigger_shapes_at_every_bounds():
    ctl = _arm([chaos.FaultSpec(site="ingest.wire_error", at=3),
                chaos.FaultSpec(site="ingest.wire_stall", every=2,
                                max_fires=2, mode="stall")])
    hits = [ctl.check("ingest.wire_error", None, {}) is not None
            for _ in range(6)]
    assert hits == [False, False, True, False, False, False]
    stalls = [ctl.check("ingest.wire_stall", None, {}) is not None
              for _ in range(8)]
    assert stalls == [False, True, False, True, False, False, False, False]


def test_fault_injected_journaled_and_counted():
    reg = MetricsRegistry(namespace="test")
    jrn = EventJournal(registry=reg)
    _arm([chaos.FaultSpec(site="serve.poison_window",
                          match={"stream": "s1"})],
         registry=reg, journal=jrn)
    assert [r.kind for r in jrn.tail()] == ["chaos_armed"]
    with pytest.raises(chaos.ChaosFault):
        chaos.inject("serve.poison_window", key="w-abc", stream="s1",
                     window_idx=4)
    recs = jrn.tail(kinds=("fault_injected",))
    assert len(recs) == 1
    assert recs[0].stream == "s1" and recs[0].window_id == 4
    assert recs[0].trace_id == "w-abc"
    assert recs[0].data["site"] == "serve.poison_window"
    assert reg.value("chaos_faults_injected_total",
                     labels={"site": "serve.poison_window"}) == 1
    chaos.disarm()
    assert jrn.tail()[-1].kind == "chaos_disarmed"


def test_plan_rejects_mode_the_site_cannot_execute():
    with pytest.raises(ValueError, match="phantom"):
        chaos.validate_plan(chaos.FaultPlan(faults=(
            chaos.FaultSpec(site="serve.device_latency", at=1),)))
    with pytest.raises(ValueError, match="phantom"):
        chaos.arm(chaos.FaultPlan(faults=(
            chaos.FaultSpec(site="registry.corrupt_sidecar", at=1),)))
    assert not chaos.armed()
    chaos.validate_plan(chaos.FaultPlan(faults=(
        chaos.FaultSpec(site="registry.corrupt_sidecar", mode="corrupt",
                        at=1),
        chaos.FaultSpec(site="serve.device_latency", mode="stall", at=1),
        chaos.FaultSpec(site="serve.device_error", at=1),)))


def test_plan_rejects_counter_triggers_on_key_stable_sites():
    for bad in (chaos.FaultSpec(site="serve.poison_window", every=8),
                chaos.FaultSpec(site="serve.poison_window", at=3)):
        with pytest.raises(ValueError, match="hop windows"):
            chaos.validate_plan(chaos.FaultPlan(faults=(bad,)))
    chaos.validate_plan(chaos.FaultPlan(faults=(
        chaos.FaultSpec(site="serve.poison_window", prob=0.5,
                        match={"stream": "s1"}),)))


@pytest.mark.parametrize("mode", ["corrupt", "error"])
def test_compile_cache_point_is_refused_naming_its_item(mode):
    """The port has no compile cache (ROADMAP A.7): the point stays in the
    catalog, but a plan naming it, in any mode, is refused in one line at
    validation and at arming — armed, it could never fire."""
    plan = chaos.FaultPlan(faults=(
        chaos.FaultSpec(site="compilecache.corrupt_payload", mode=mode, at=1),
        chaos.FaultSpec(site="serve.device_error", at=1)))
    for fn in (chaos.validate_plan, chaos.arm):
        with pytest.raises(ValueError) as e:
            fn(plan)
        assert "ROADMAP A.7" in str(e.value) and "\n" not in str(e.value)
    assert not chaos.armed()
    # the reference's own plan validates there
    jchaos.validate_plan(jchaos.FaultPlan(faults=(
        jchaos.FaultSpec(site="compilecache.corrupt_payload",
                         mode="corrupt", at=1),)))


# -- ingest wire faults --------------------------------------------------------

def _replay_server():
    from nerrf_tpu_torch.data.synth import SimConfig, simulate_trace
    from nerrf_tpu_torch.ingest.service import TraceReplayServer

    tr = simulate_trace(SimConfig(duration_sec=20.0, attack=False,
                                  benign_rate_hz=6.0, seed=3))
    srv = TraceReplayServer(tr.events, tr.strings, batch_size=16)
    srv.start()
    return tr, srv


def test_ingest_wire_error_armed_and_disarmed():
    from nerrf_tpu_torch.ingest.service import TrackerClient

    tr, srv = _replay_server()
    try:
        ev, _ = TrackerClient(f"127.0.0.1:{srv.port}").stream(timeout=30.0)
        assert ev.num_valid == tr.events.num_valid
        jrn = EventJournal()
        _arm([chaos.FaultSpec(site="ingest.wire_error", at=2)], journal=jrn)
        got = []
        with pytest.raises(chaos.ChaosFault):
            for block, _s in TrackerClient(
                    f"127.0.0.1:{srv.port}").iter_blocks(
                    timeout=30.0, stream="s9"):
                got.append(block)
        assert len(got) == 1  # the frame before the fault delivered
        rec = jrn.tail(kinds=("fault_injected",))[-1]
        assert rec.stream == "s9"
        assert rec.data["target"] == f"127.0.0.1:{srv.port}"
    finally:
        srv.stop()


def test_ingest_wire_stall_delays_but_delivers():
    from nerrf_tpu_torch.ingest.service import TrackerClient

    tr, srv = _replay_server()
    try:
        _arm([chaos.FaultSpec(site="ingest.wire_stall", mode="stall",
                              at=1, delay_sec=0.3)])
        t0 = time.perf_counter()
        ev, _ = TrackerClient(f"127.0.0.1:{srv.port}").stream(timeout=30.0)
        assert time.perf_counter() - t0 >= 0.3
        assert ev.num_valid == tr.events.num_valid  # slow, not lossy
    finally:
        srv.stop()


# -- batcher: poison bisection + device faults ---------------------------------

def test_bisection_isolates_exactly_the_poisoned_window():
    scored, failed = [], []
    jrn = EventJournal()
    reg = MetricsRegistry(namespace="test")
    cfg = ServeConfig(buckets=(BUCKET,), batch_size=8, batch_close_sec=10.0)
    mb = _batcher(cfg=cfg, registry=reg, journal=jrn,
                  on_scored=scored.extend,
                  on_failed=lambda reqs, exc: failed.extend(reqs))
    _arm([chaos.FaultSpec(site="serve.poison_window",
                          match={"stream": "s2", "window_idx": 1})],
         registry=reg, journal=jrn)
    for i in range(8):
        mb.submit(_req(f"s{i % 4}", i // 4))
    assert mb.drain_once() == 1
    assert [(r.stream, r.window_idx) for r in failed] == [("s2", 1)]
    assert len(scored) == 7
    assert ("s2", 1) not in {(s.stream, s.window_idx) for s in scored}
    assert reg.value("serve_recompiles_total",
                     labels={"bucket": "128n/256e/32s"}) == 0
    assert reg.value("serve_poison_bisections_total",
                     labels={"bucket": "128n/256e/32s"}) >= 1
    kinds = [r.kind for r in jrn.tail()]
    assert "batch_bisect" in kinds and "batch_failed" in kinds


def test_bisection_disabled_fails_whole_cohort():
    failed = []
    cfg = ServeConfig(buckets=(BUCKET,), batch_size=4,
                      batch_close_sec=10.0, bisect_failed_batches=False)
    mb = _batcher(cfg=cfg, on_failed=lambda reqs, exc: failed.extend(reqs))
    _arm([chaos.FaultSpec(site="serve.poison_window",
                          match={"stream": "s0", "window_idx": 0})])
    for i in range(4):
        mb.submit(_req(f"s{i}", 0))
    mb.drain_once()
    assert len(failed) == 4


def test_device_error_and_latency_points():
    scored, failed, calls = [], [], []

    def score(b):
        calls.append(len(b["node_mask"]))
        return np.zeros(b["node_mask"].shape)

    mb = _batcher(score=score, on_scored=scored.extend,
                  on_failed=lambda reqs, exc: failed.extend(reqs))
    _arm([chaos.FaultSpec(site="serve.device_latency", mode="stall",
                          at=1, delay_sec=0.25),
          chaos.FaultSpec(site="serve.device_error", at=2)])
    for i in range(4):
        mb.submit(_req("s0", i))
    t0 = time.perf_counter()
    mb.drain_once()
    assert time.perf_counter() - t0 >= 0.25
    for i in range(4, 8):
        mb.submit(_req("s0", i))
    mb.drain_once()
    assert len(scored) == 8 and not failed  # transient: retries recovered
    # the error point raises before the score function: one call fewer
    # than the scoring attempts (1 + the failed batch + its two halves)
    assert len(calls) == 3


# -- service: quarantine + watchdog + the bundle regression --------------------

def _fake_service(cfg, registry=None, score=None, journal=None):
    svc, registry = make_port_service_shell(cfg, registry=registry,
                                            journal=journal)
    score = score or (lambda batch:
                      np.full(batch["node_mask"].shape, 0.9, np.float64))
    svc._batcher = MicroBatcher(score_fn=score, cfg=cfg, registry=registry,
                                on_scored=svc._on_scored,
                                on_failed=svc._on_failed,
                                journal=svc._journal)
    for b in cfg.buckets:
        svc._batcher.mark_warm(b)
    svc._batcher.start()
    svc._admission_open = True
    return svc, registry


def _stream_blocks(seed=5, duration=60.0, size=250):
    from nerrf_tpu_torch.data.synth import SimConfig, simulate_trace

    tr = simulate_trace(SimConfig(duration_sec=duration, attack=True,
                                  attack_start_sec=duration / 3,
                                  num_target_files=4, benign_rate_hz=6.0,
                                  seed=seed))
    ev = tr.events
    blocks = [type(ev)(**{f.name: getattr(ev, f.name)[i:i + size]
                          for f in dataclasses.fields(ev)})
              for i in range(0, len(ev), size)]
    return tr, blocks


def _feed_stream(svc, sid, seed=5, duration=60.0):
    tr, blocks = _stream_blocks(seed=seed, duration=duration)
    for blk in blocks:
        svc.feed(sid, blk, tr.strings)


def _feed_interleaved(svc, feeds):
    data = {sid: _stream_blocks(seed=seed) for sid, seed in feeds.items()}
    for i in range(max(len(b) for _, b in data.values())):
        for sid, (tr, blocks) in data.items():
            if i < len(blocks):
                svc.feed(sid, blocks[i], tr.strings)


def test_stream_quarantined_after_strikes_sheds_then_releases():
    cfg = ServeConfig(buckets=((256, 512, 64),), batch_size=4,
                      batch_close_sec=0.05, window_sec=10.0, stride_sec=5.0,
                      quarantine_strikes=2, quarantine_release_sec=1.0)
    svc, reg = _fake_service(cfg)
    jrn = svc._journal
    _arm([chaos.FaultSpec(site="serve.poison_window",
                          match={"stream": "bad"})],
         registry=reg, journal=jrn)
    try:
        svc.join("bad")
        svc.join("good")
        _feed_interleaved(svc, {"bad": 5, "good": 6})
        deadline = time.perf_counter() + 20.0
        while time.perf_counter() < deadline:
            with svc._lock:
                if "bad" in svc._quarantined:
                    break
            time.sleep(0.05)
        with svc._lock:
            assert "bad" in svc._quarantined
            assert svc._strikes["bad"] >= 2
        _feed_stream(svc, "bad", seed=7)
        assert reg.value("serve_admission_dropped_total",
                         labels={"reason": "quarantined"}) > 0
        kinds = {r.kind for r in jrn.tail()}
        assert "stream_quarantined" in kinds
        assert "device_batch_failed" in kinds
        det = svc.leave("good", timeout=20.0)
        assert det.detector == "serve[max]"
        good_failed = [r for r in jrn.tail(kinds=("device_batch_failed",))
                       if r.stream == "good"]
        assert good_failed == []
        chaos.disarm()
        time.sleep(cfg.quarantine_release_sec + 0.1)
        before = reg.value("serve_windows_admitted_total")
        _feed_stream(svc, "bad", seed=8)
        assert "stream_released" in {r.kind for r in jrn.tail()}
        with svc._lock:
            assert "bad" not in svc._quarantined
            assert svc._strikes["bad"] == 0
        assert reg.value("serve_stream_strikes",
                         labels={"stream": "bad"}) == 0.0
        assert reg.value("serve_windows_admitted_total") > before
    finally:
        svc.stop(drain=False)


def test_strikes_key_on_base_stream_across_reconnect_sessions():
    cfg = ServeConfig(buckets=(BUCKET,), batch_size=4,
                      batch_close_sec=10.0, quarantine_strikes=2)
    svc, reg = _fake_service(cfg)
    jrn = svc._journal
    try:
        boom = chaos.ChaosFault("injected")
        for sid, idx in (("p", 0), ("p#1", 0)):
            r = _req(sid, idx)
            r.poison = True  # as the batcher stamps a proven isolation
            svc._on_failed([r], boom)
        with svc._lock:
            assert svc._strikes == {"p": 2}
            assert "p" in svc._quarantined
        rec = jrn.tail(kinds=("stream_quarantined",))[-1]
        assert rec.stream == "p"
        assert reg.value("serve_windows_quarantined_total",
                         labels={"stream": "p"}) == 2
        assert reg.value("serve_windows_quarantined_total",
                         labels={"stream": "p#1"}) == 0
        svc.join("p#2")
        _feed_stream(svc, "p#2", seed=13)
        assert reg.value("serve_admission_dropped_total",
                         labels={"reason": "quarantined"}) > 0
    finally:
        svc.stop(drain=False)


def test_device_wide_failure_strikes_no_stream():
    cfg = ServeConfig(buckets=((256, 512, 64),), batch_size=4,
                      batch_close_sec=0.05, window_sec=10.0, stride_sec=5.0,
                      quarantine_strikes=1)
    svc, reg = _fake_service(cfg)
    jrn = svc._journal
    _arm([chaos.FaultSpec(site="serve.device_error", every=1)],
         registry=reg, journal=jrn)
    try:
        svc.join("s0")
        svc.join("s1")
        _feed_interleaved(svc, {"s0": 5, "s1": 6})
        svc.leave("s0", timeout=20.0)
        recs = jrn.tail(kinds=("device_batch_failed",))
        assert recs
        assert all(r.data["poison"] is False for r in recs)
        with svc._lock:
            assert svc._quarantined == {}
            assert svc._strikes == {}
        assert "stream_quarantined" not in {r.kind for r in jrn.tail()}
    finally:
        svc.stop(drain=False)


def test_watchdog_tolerates_slow_bisection_progress():
    def slow_score(batch):
        time.sleep(0.2)
        return np.zeros(batch["node_mask"].shape)

    cfg = ServeConfig(buckets=(BUCKET,), batch_size=8,
                      batch_close_sec=0.02, scorer_wedge_sec=0.4)
    jrn = EventJournal()
    reg = MetricsRegistry(namespace="test")
    scored, failed = [], []
    mb = _batcher(cfg=cfg, registry=reg, journal=jrn, score=slow_score,
                  on_scored=scored.extend,
                  on_failed=lambda reqs, exc: failed.extend(reqs))
    _arm([chaos.FaultSpec(site="serve.poison_window",
                          match={"stream": "s0", "window_idx": 0})],
         registry=reg, journal=jrn)
    mb.start()
    try:
        for i in range(8):
            mb.submit(_req(f"s{i % 4}", i // 4))
        deadline = time.perf_counter() + 20.0
        while len(scored) + len(failed) < 8 \
                and time.perf_counter() < deadline:
            time.sleep(0.05)
        assert len(scored) == 7 and len(failed) == 1
        assert not mb.wedged
        assert "scorer_wedged" not in {r.kind for r in jrn.tail()}
    finally:
        mb.stop(drain=False)


def test_intermittent_device_fault_confirm_retry_delivers_not_strikes():
    calls = []
    scored, failed = [], []

    def flaky_score(batch):
        calls.append(1)
        if len(calls) in (1, 2, 4):
            raise RuntimeError("intermittent device fault")
        return np.zeros(batch["node_mask"].shape)

    cfg = ServeConfig(buckets=(BUCKET,), batch_size=4,
                      batch_close_sec=10.0)
    jrn = EventJournal()
    mb = _batcher(cfg=cfg, journal=jrn, score=flaky_score,
                  on_scored=scored.extend,
                  on_failed=lambda reqs, exc: failed.extend(reqs))
    for i in range(4):
        mb.submit(_req(f"s{i}", 0))
    mb.drain_once()
    assert failed == []
    assert len(scored) == 4
    assert "device_batch_failed" not in {r.kind for r in jrn.tail()}
    assert "batch_failed" in {r.kind for r in jrn.tail()}


def test_serve_detect_bad_chaos_plan_is_one_line_refusal(tmp_path, capsys):
    from nerrf_tpu_torch import cli

    bad = tmp_path / "bad.json"
    bad.write_text('{"faults": [{"site": "not.a.site", "at": 1}]}')
    rc = cli.main(["serve-detect", "--trace", str(bad),  # never reached
                   "--chaos-plan", str(bad), "--device", "cpu",
                   "--metrics-port", "-1"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "INVALID" in err and err.count("\n") == 1
    assert not chaos.armed()


def test_injected_device_fault_dumps_exactly_one_bundle(tmp_path):
    from nerrf_tpu_torch.flight import FlightConfig, FlightRecorder

    cfg = ServeConfig(buckets=((256, 512, 64),), batch_size=2,
                      batch_close_sec=0.02, window_sec=10.0, stride_sec=5.0,
                      quarantine_strikes=0)
    svc, reg = _fake_service(cfg)
    jrn = svc._journal
    recorder = FlightRecorder(
        FlightConfig(out_dir=str(tmp_path / "bundles"), p99_breach_sec=None,
                     drop_burst_n=3, drop_burst_sec=30.0,
                     min_interval_sec=600.0),
        registry=reg, journal=jrn, slo=svc.slo, log=None)
    _arm([chaos.FaultSpec(site="serve.device_error", every=1)],
         registry=reg, journal=jrn)
    try:
        svc.join("s0")
        _feed_stream(svc, "s0", seed=9)
        svc.leave("s0", timeout=20.0)
        recs = jrn.tail(kinds=("device_batch_failed",))
        assert len(recs) >= 3
        assert all(r.trace_id for r in recs)
        assert reg.value("serve_windows_failed_total",
                         labels={"reason": "ChaosFault",
                                 "stream": "s0"}) >= 3
        bundles = [p for p in (tmp_path / "bundles").iterdir()
                   if p.name.startswith("bundle-")]
        assert len(bundles) == 1
        assert bundles[0].name.endswith("drop_burst")
    finally:
        recorder.close()
        svc.stop(drain=False)


def test_scorer_watchdog_wedges_fails_ready_and_unblocks_leave():
    release = threading.Event()

    def wedging_score(batch):
        release.wait(timeout=30.0)
        return np.zeros(batch["node_mask"].shape)

    cfg = ServeConfig(buckets=((256, 512, 64),), batch_size=2,
                      batch_close_sec=0.02, window_sec=10.0, stride_sec=5.0,
                      scorer_wedge_sec=0.3)
    svc, reg = _fake_service(cfg, score=wedging_score)
    jrn = svc._journal
    try:
        assert "serve_scorer_wedged" in reg.render()
        assert reg.value("serve_scorer_wedged") == 0.0
        svc.join("s0")
        _feed_stream(svc, "s0", seed=11)
        deadline = time.perf_counter() + 10.0
        while not svc._batcher.wedged and time.perf_counter() < deadline:
            time.sleep(0.05)
        assert svc._batcher.wedged
        ok, reason, _ = svc.ready()
        assert not ok and "wedged" in reason
        assert reg.value("serve_scorer_wedged") == 1.0
        t0 = time.perf_counter()
        svc.leave("s0", timeout=30.0)
        assert time.perf_counter() - t0 < 5.0
        release.set()
        deadline = time.perf_counter() + 10.0
        while svc._batcher.wedged and time.perf_counter() < deadline:
            time.sleep(0.05)
        assert not svc._batcher.wedged
        kinds = [r.kind for r in jrn.tail()]
        assert "scorer_wedged" in kinds and "scorer_recovered" in kinds
        ok, _, _ = svc.ready()
        assert ok
    finally:
        release.set()
        svc.stop(drain=False)


def test_reconnect_backoff_grows_and_is_counted():
    cfg = ServeConfig(buckets=((256, 512, 64),), batch_size=4,
                      batch_close_sec=0.02, window_sec=10.0, stride_sec=5.0)
    svc, reg = _fake_service(cfg)
    jrn = svc._journal
    tr, srv = _replay_server()
    _arm([chaos.FaultSpec(site="ingest.wire_error", every=1)],
         registry=reg, journal=jrn)
    try:
        run = svc.connect("s0", f"127.0.0.1:{srv.port}", timeout=10.0,
                          follow=True, reconnect_sec=0.05,
                          reconnect_max_sec=0.4)
        deadline = time.perf_counter() + 20.0
        while time.perf_counter() < deadline:
            if len(jrn.tail(kinds=("reconnect",))) >= 4:
                break
            time.sleep(0.05)
        recs = jrn.tail(kinds=("reconnect",))
        assert len(recs) >= 4
        assert all(r.data["healthy"] is False for r in recs)
        delays = [r.data["delay_sec"] for r in recs[:4]]
        assert delays[2] > delays[0]
        assert max(delays) <= 0.4
        assert reg.value("serve_reconnects_total",
                         labels={"stream": "s0"}) >= 4
        # the wire faults carry the session's stream name
        assert {r.stream.split("#")[0] for r in
                jrn.tail(kinds=("fault_injected",))} == {"s0"}
        svc.stop(drain=False)
        assert run.done.wait(timeout=10.0)
    finally:
        srv.stop()
        svc.stop(drain=False)


# -- registry faults -----------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from nerrf_tpu_torch.models import JointConfig, build_nerrfnet
    from nerrf_tpu_torch.train.checkpoint import save_checkpoint

    cfg = JointConfig().small
    ckpt = tmp_path_factory.mktemp("chaos-ckpt") / "ckpt"
    save_checkpoint(ckpt, build_nerrfnet(cfg, seed=0, device="cpu").state_dict(),
                    cfg)
    return ckpt


def test_registry_store_io_fault_leaves_no_partial_version(checkpoint,
                                                           tmp_path):
    from nerrf_tpu_torch.registry import ModelRegistry

    store = ModelRegistry(tmp_path / "reg", journal=EventJournal())
    assert store.publish("lin", checkpoint) == 1  # disarmed: publish works
    _arm([chaos.FaultSpec(site="registry.store_io", at=1)])
    with pytest.raises(chaos.ChaosFault):
        store.publish("lin", checkpoint)
    assert store.versions("lin") == [1]
    assert not [p for p in store.lineage_dir("lin").iterdir()
                if p.name.startswith(".publish.tmp")]
    chaos.disarm()
    assert store.publish("lin", checkpoint) == 2


def test_registry_corrupt_sidecar_fails_load_with_one_line_error(checkpoint,
                                                                 tmp_path):
    from nerrf_tpu_torch.registry import ModelRegistry

    store = ModelRegistry(tmp_path / "reg", journal=EventJournal())
    _arm([chaos.FaultSpec(site="registry.corrupt_sidecar", mode="corrupt",
                          at=1)])
    v = store.publish("lin", checkpoint)
    chaos.disarm()
    with pytest.raises(ValueError, match="corrupt checkpoint sidecar"):
        store.load("lin", v)


# -- flight recorder disk-full -------------------------------------------------

def test_flight_disk_full_fails_open_and_retries(tmp_path):
    from nerrf_tpu_torch.flight import FlightConfig, FlightRecorder

    reg = MetricsRegistry(namespace="test")
    jrn = EventJournal(registry=reg)
    rec = FlightRecorder(
        FlightConfig(out_dir=str(tmp_path / "b"), p99_breach_sec=None,
                     min_interval_sec=600.0),
        registry=reg, journal=jrn, log=None)
    _arm([chaos.FaultSpec(site="flight.disk_full", at=1, max_fires=1)],
         registry=reg, journal=jrn)
    try:
        assert rec.trigger("manual", "first dump hits ENOSPC") is None
        out = tmp_path / "b"
        assert not out.exists() or not any(out.iterdir())  # no .tmp orphan
        path = rec.trigger("manual", "retry")
        assert path is not None and (tmp_path / "b").exists()
        assert len([p for p in out.iterdir()
                    if p.name.startswith("bundle-")]) == 1
    finally:
        rec.close()


# -- alert sink slow consumer --------------------------------------------------

def test_alert_sink_slow_consumer_stalls_drain_only():
    from nerrf_tpu_torch.serve.alerts import AlertSink, WindowAlert

    sink = AlertSink(slots=4, registry=MetricsRegistry(namespace="test"),
                     journal=EventJournal())
    _arm([chaos.FaultSpec(site="alerts.slow_consumer", mode="stall",
                          at=1, delay_sec=0.3)])
    t0 = time.perf_counter()
    sink.emit(WindowAlert(stream="s", window_idx=0, lo_ns=0, hi_ns=1,
                          max_prob=0.9, hot=[], t_admit=0.0, t_scored=0.0,
                          late=False))
    assert time.perf_counter() - t0 < 0.25  # the producer is not stalled
    t0 = time.perf_counter()
    alerts = sink.drain()
    assert time.perf_counter() - t0 >= 0.3
    assert len(alerts) == 1  # slow, not lossy


# -- training: the nonfinite-gradient point ------------------------------------

def test_nonfinite_grad_point_halts_the_streamed_run_with_one_bundle(
        tmp_path, monkeypatch):
    from nerrf_tpu_torch import trainwatch
    from nerrf_tpu_torch.data import make_corpus
    from nerrf_tpu_torch.flight import FlightConfig, FlightRecorder
    from nerrf_tpu_torch.graph import GraphConfig
    from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig
    from nerrf_tpu_torch.train import data as tdata
    from nerrf_tpu_torch.train import loop as tloop

    monkeypatch.setenv("NERRF_RESIDENT_MAX_BYTES", "0")  # the streamed flavor
    ds = tdata.build_dataset(
        make_corpus(n_traces=2, duration_sec=60.0, num_target_files=4,
                    benign_rate_hz=20.0, base_seed=3),
        tdata.DatasetConfig(graph=GraphConfig(window_sec=45.0, stride_sec=20.0,
                                              max_nodes=64, max_edges=128),
                            seq_len=24, max_seqs=32))
    tiny = JointConfig(
        gnn=GraphSAGEConfig(hidden=16, num_layers=2, dtype=torch.float32,
                            aggregation="segment"),
        lstm=LSTMConfig(hidden=16, num_layers=1, dtype=torch.float32))
    cfg = tloop.TrainConfig(model=tiny, batch_size=2, num_steps=6,
                            warmup_steps=1, eval_every=1, telemetry=True)
    reg = MetricsRegistry(namespace="test")
    jrn = EventJournal(registry=reg)
    mon = trainwatch.TrainHealthMonitor(registry=reg, journal=jrn)
    rec = FlightRecorder(FlightConfig(out_dir=str(tmp_path / "b"),
                                      p99_breach_sec=None),
                         registry=reg, journal=jrn, log=None)
    mon.attach_flight(rec)
    ctl = _arm([chaos.FaultSpec(site="train.nonfinite_grad", mode="corrupt",
                                match={"step": 3})],
               registry=reg, journal=jrn)
    try:
        res = tloop.train_nerrfnet(ds, cfg=cfg, device="cpu", monitor=mon)
    finally:
        rec.close()
    assert [(s, k) for s, k, _ in ctl.fired] == [("train.nonfinite_grad", "3")]
    assert res.metrics == {} and [h["step"] for h in res.history] == [0, 1, 2, 3]
    assert mon.diverged[0] == 3 and "non-finite" in mon.diverged[1]
    bundles = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert len(bundles) == 1 and bundles[0].endswith("train_divergence")


# -- the soak's smoke: a small serve survival run ------------------------------

def test_serve_survives_poison_latency_and_wire_faults():
    """Two streams and a resident (follow-mode) drain through the port's
    service on the CPU under the chaos bench's plan at a small size: the
    poison aimed at one stream is isolated exactly, no other stream loses a
    window, the drain reconnects, every stream ends error-free, and an
    unfaulted stream stays bit-equal to ``model_detect``."""
    from nerrf_tpu_torch.data.loaders import Trace
    from nerrf_tpu_torch.data.synth import SimConfig, simulate_trace
    from nerrf_tpu_torch.ingest.service import TraceReplayServer
    from nerrf_tpu_torch.models import JointConfig
    from nerrf_tpu_torch.pipeline import model_detect
    from nerrf_tpu_torch.serve import OnlineDetectionService, init_untrained_model

    bucket = (256, 512, 128)
    cfg = ServeConfig(buckets=(bucket,), batch_size=4, batch_close_sec=0.1,
                      window_sec=15.0, stride_sec=5.0, stream_queue_slots=512,
                      window_deadline_sec=2.0, bisect_failed_batches=True,
                      quarantine_strikes=16, scorer_wedge_sec=60.0)
    model = init_untrained_model(JointConfig().small, cfg, device="cpu")
    reg = MetricsRegistry(namespace="chaos")
    jrn = EventJournal(capacity=8192, registry=reg)
    svc = OnlineDetectionService(model, cfg, registry=reg, journal=jrn,
                                 device="cpu")
    svc.start()
    traces, servers = [], []
    for i, attack in enumerate((True, False)):
        tr = simulate_trace(SimConfig(duration_sec=25.0, attack=attack,
                                      attack_start_sec=8.0, num_target_files=4,
                                      benign_rate_hz=6.0, seed=2000 + 131 * i))
        traces.append(tr)
        servers.append(TraceReplayServer(tr.events, tr.strings, batch_size=64))
    wire_tr = simulate_trace(SimConfig(duration_sec=12.5, attack=False,
                                       benign_rate_hz=6.0, seed=9999))
    servers.append(TraceReplayServer(wire_tr.events, wire_tr.strings,
                                     batch_size=32))
    ports = [srv.start() for srv in servers]
    wire = f"127.0.0.1:{ports[2]}"
    ctl = _arm([chaos.FaultSpec(site="serve.poison_window", prob=0.4,
                                match={"stream": "s0"}),
                chaos.FaultSpec(site="ingest.wire_error", every=5,
                                match={"target": wire}),
                chaos.FaultSpec(site="serve.device_latency", mode="stall",
                                every=4, delay_sec=0.05)],
               seed=42, registry=reg, journal=jrn)
    try:
        runs = [svc.connect(f"s{i}", f"127.0.0.1:{ports[i]}", timeout=60.0)
                for i in range(2)]
        wire_run = svc.connect("w0", wire, timeout=60.0, follow=True,
                               reconnect_sec=0.05, reconnect_max_sec=0.5)
        for r in runs:
            assert r.done.wait(timeout=120.0)
        svc.stop(drain=True)
        assert wire_run.done.wait(timeout=60.0)
    finally:
        chaos.disarm()
        svc.stop(drain=False)
        for srv in servers:
            srv.stop()
    records = jrn.tail()
    assert [r.error for r in runs] == [None, None]
    poisoned = sorted({k for s, k, _ in ctl.fired if s == "serve.poison_window"})
    isolated = sorted({r.trace_id for r in records
                       if r.kind == "device_batch_failed"})
    assert poisoned and isolated == poisoned
    assert {r.stream for r in records if r.kind == "device_batch_failed"} == {"s0"}
    assert reg.value("serve_reconnects_total", labels={"stream": "w0"}) > 0
    assert any(s == "serve.device_latency" for s, _, _ in ctl.fired)
    offline = model_detect(
        Trace(events=traces[1].events, strings=traces[1].strings,
              ground_truth=None, labels=None, name="s1"),
        model, ds_cfg=cfg.dataset_config(bucket), auto_capacity=False,
        batch_size=cfg.batch_size, device="cpu")
    served = runs[1].result
    assert served.file_scores == offline.file_scores
    assert served.file_window_scores == offline.file_window_scores
    assert served.proc_scores == offline.proc_scores
    assert served.threshold == offline.threshold
