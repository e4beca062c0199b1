"""The port's online serve scorer (nerrf_tpu_torch.serve) against the JAX
package's, on the CPU (``device="cpu"``: the kernels' plain versions).

* Host copies (``ServeConfig`` and its bucket helpers, ``StreamWindower``,
  ``calibrated_severity``, ``MetricsRegistry``, the journal's
  ``make_trace_id``/``fingerprint``, ``warmup_batches``): equal, or
  bit-equal, on the same inputs.
* The micro-batcher and the service's admission/demux with a fake score
  function (model-free, as the reference's tests run them): packing,
  isolation, backpressure, leave, rejection, alert sink, poison bisection.
* Parity, with the reference's small float32 weights converted by
  ``convert.load_flax_params``: a stream through the port's service is
  bit-equal to the port's ``model_detect`` (alone, and with two streams
  sharing batches), and within atol 1e-5 on probabilities of the JAX
  ``OnlineDetectionService`` (the tolerance of test_torch_pipeline.py).
* Hot swap and the device rule.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerrf_tpu import observability as jobs
from nerrf_tpu import pipeline as jpipeline
from nerrf_tpu.data import SimConfig as JSimConfig
from nerrf_tpu.data import simulate_trace as jsimulate_trace
from nerrf_tpu.flight import journal as jjournal
from nerrf_tpu.models.joint import JointConfig as JJointConfig
from nerrf_tpu.models.joint import NerrfNet as JNerrfNet
from nerrf_tpu.serve import alerts as jalerts
from nerrf_tpu.serve import config as jconfig
from nerrf_tpu.serve import service as jservice
from nerrf_tpu.serve import windower as jwindower
from nerrf_tpu_torch import observability, pipeline
from nerrf_tpu_torch.convert import load_flax_params
from nerrf_tpu_torch.data import SimConfig, Trace, simulate_trace
from nerrf_tpu_torch.flight import journal
from nerrf_tpu_torch.models import JointConfig, NerrfNet
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.ops import LAUNCHES, reset_launches
from nerrf_tpu_torch.serve import (
    MicroBatcher,
    OnlineDetectionService,
    ServeConfig,
    StreamWindower,
    WindowRequest,
    bucket_tag,
    init_untrained_model,
    select_bucket,
)
from nerrf_tpu_torch.serve import alerts, config, service

BUCKET_A = (128, 256, 32)
BUCKET_B = (256, 512, 64)
# probabilities, port vs JAX package (as test_torch_pipeline.py)
SCORE_ATOL = 1e-5
# the reference's fields of the planes the port has not taken (ROADMAP A.6)
NOT_PORTED_FIELDS = {"quality_monitoring", "slo_aware_shedding",
                     "shed_headroom_margin", "devtime_window_sec",
                     "devtime_accounting"}
PARITY_CFG = dict(buckets=(BUCKET_B,), batch_size=4, window_sec=15.0,
                  stride_sec=5.0)


def _blocks(trace, size=200):
    ev = trace.events
    for i in range(0, len(ev), size):
        yield type(ev)(**{f.name: getattr(ev, f.name)[i:i + size]
                          for f in dataclasses.fields(ev)})


def _sim_cfg(seed=3, duration=60.0, attack=True, files=6, rate=6.0):
    return dict(duration_sec=duration, attack=attack,
                attack_start_sec=duration / 3, num_target_files=files,
                benign_rate_hz=rate, seed=seed)


def _sim(**kw):
    return simulate_trace(SimConfig(**_sim_cfg(**kw)))


def _unlabelled(trace, name):
    return Trace(events=trace.events, strings=trace.strings,
                 ground_truth=None, labels=None, name=name)


def _small_cpu_model(seed=0):
    return init_untrained_model(JointConfig().small, ServeConfig(buckets=(BUCKET_B,)),
                                seed=seed, device="cpu")


def _fake_service(cfg, registry=None, score=None, start=True):
    """The port's service with a stub score function on its batcher: covers
    windowing, admission, packing and demux without a forward."""
    registry = registry or MetricsRegistry(namespace="test")
    svc = OnlineDetectionService(_small_cpu_model(), cfg, registry=registry,
                                 journal=journal.EventJournal(registry=registry),
                                 device="cpu")
    score = score or (lambda batch:
                      np.full(batch["node_mask"].shape, 0.9, np.float64))
    svc._batcher = MicroBatcher(score_fn=score, cfg=cfg, registry=registry,
                                on_scored=svc._on_scored,
                                on_failed=svc._on_failed,
                                journal=svc._journal)
    for b in cfg.buckets:
        svc._batcher.mark_warm(b)
    if start:
        svc._batcher.start()
        svc._admission_open = True
    return svc, registry


# -- host copies ---------------------------------------------------------------

def test_serve_config_defaults_match_reference():
    want = {f.name: f for f in dataclasses.fields(jconfig.ServeConfig)}
    got = {f.name: f for f in dataclasses.fields(config.ServeConfig)}
    assert set(got) == set(want) - NOT_PORTED_FIELDS
    ref, port = jconfig.ServeConfig(), config.ServeConfig()
    for name in got:
        assert getattr(port, name) == getattr(ref, name), name
    assert port.occupancy == ref.occupancy
    assert pipeline.DETECTOR_WARMUP_BUCKETS == jpipeline.DETECTOR_WARMUP_BUCKETS
    assert pipeline._GRAPH_WARMUP_RUNGS == jpipeline._GRAPH_WARMUP_RUNGS
    assert pipeline._SEQ_WARMUP_RUNGS == jpipeline._SEQ_WARMUP_RUNGS
    assert port.buckets == ref.buckets


LADDERS = [
    (BUCKET_A, BUCKET_B, (1024, 2048, 128)),
    ((256, 512, 64), (256, 512, 128), (1024, 2048, 256)),
    ((16, 16, 8),),
    jconfig.ServeConfig().buckets,
]


@pytest.mark.parametrize("ladder", LADDERS, ids=lambda l: f"{len(l)}rungs")
def test_bucket_helpers_match_reference(ladder):
    needs = [(n, e, s) for n in (1, 16, 100, 200, 256, 999, 1024, 4096, 5000)
             for e in (1, 200, 512, 2048, 9000) for s in (0, 10, 64, 500)]
    for need in needs:
        assert config.select_bucket(*need, ladder) == \
            jconfig.select_bucket(*need, ladder), need
    port_cfg = config.ServeConfig(buckets=ladder, window_sec=15.0,
                                  stride_sec=5.0, seq_len=24, min_events=3)
    ref_cfg = jconfig.ServeConfig(buckets=ladder, window_sec=15.0,
                                  stride_sec=5.0, seq_len=24, min_events=3)
    for b in ladder:
        assert config.bucket_tag(b) == jconfig.bucket_tag(b)
        assert dataclasses.asdict(port_cfg.dataset_config(b)) == \
            dataclasses.asdict(ref_cfg.dataset_config(b))


def _assert_events_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)


@pytest.mark.parametrize("size,shuffle", [(137, False), (100, True)])
def test_windower_matches_reference(size, shuffle):
    kw = _sim_cfg(seed=11, duration=80.0)
    tr, jtr = simulate_trace(SimConfig(**kw)), jsimulate_trace(JSimConfig(**kw))
    blocks, jblocks = list(_blocks(tr, size)), list(_blocks(jtr, size))
    if shuffle:  # an out-of-order source: late events, full-array fallback
        blocks[0], blocks[1] = blocks[1], blocks[0]
        jblocks[0], jblocks[1] = jblocks[1], jblocks[0]
    w = StreamWindower(window_sec=15.0, stride_sec=5.0)
    jw = jwindower.StreamWindower(window_sec=15.0, stride_sec=5.0)
    closed, jclosed = [], []
    for b, jb in zip(blocks, jblocks):
        closed.append(w.feed(b, tr.strings))
        jclosed.append(jw.feed(jb, jtr.strings))
    assert closed == jclosed
    assert w.flush() == jw.flush()
    assert w.late_events == jw.late_events
    assert (w.late_events > 0) == shuffle
    assert w.windows_emitted == jw.windows_emitted
    windows = [c for block in jclosed for c in block]
    for _, lo, hi in windows[::3]:
        _assert_events_equal(w.window_view(lo, hi), jw.window_view(lo, hi))
    _assert_events_equal(w.events, jw.events)


def test_calibrated_severity_matches_reference():
    grid = np.linspace(-0.25, 1.25, 31)
    for p in grid:
        for t in grid:
            assert alerts.calibrated_severity(p, t) == \
                jalerts.calibrated_severity(p, t), (p, t)


def _drive_registry(reg):
    reg.counter_inc("requests_total", help="requests\nserved")
    reg.counter_inc("requests_total", 2.5, labels={"code": "200"})
    reg.counter_inc("requests_total", labels={"code": 'a"b\\c\nd'})
    reg.gauge_set("depth", 3.0, labels={"bucket": "256n/512e/64s"}, help="depth")
    reg.gauge_set("depth", 7.0, labels={"bucket": "256n/512e/64s"})
    for v in (0.0005, 0.02, 0.3, 4.0, 99.0):
        reg.histogram_observe("latency_seconds", v, help="latency")
    for v in (1.0, 3.0, 8.0):
        reg.histogram_observe("occupancy", v, buckets=(1.0, 2.0, 4.0, 8.0),
                              labels={"bucket": "b"})
    with pytest.warns(UserWarning):
        reg.histogram_observe("occupancy", 2.0, buckets=(1.0, 2.0))
    reg.remove_series("depth", labels={"bucket": "gone"})


def test_metrics_registry_matches_reference():
    reg, jreg = MetricsRegistry(namespace="t"), jobs.MetricsRegistry(namespace="t")
    _drive_registry(reg)
    _drive_registry(jreg)
    assert reg.render() == jreg.render()
    assert reg.snapshot() == jreg.snapshot()
    for stat in ("sum", "count", "mean"):
        assert reg.value("occupancy", labels={"bucket": "b"}, stat=stat) == \
            jreg.value("occupancy", labels={"bucket": "b"}, stat=stat)
    assert reg.value("requests_total", labels={"code": "200"}) == 2.5
    assert isinstance(observability.DEFAULT_REGISTRY, MetricsRegistry)


def test_journal_helpers_match_reference():
    for stream, idx, lo in (("s0", 0, 0), ("a#3", 17, 1_700_000_000_000_000_000)):
        assert journal.make_trace_id(stream, idx, lo) == \
            jjournal.make_trace_id(stream, idx, lo)
    for obj in ("x", (1, 2.5, None), {"b": [1, 2]}, ((256, 512, 64),)):
        assert journal.fingerprint(obj) == jjournal.fingerprint(obj)
    assert journal.KNOWN_KINDS == jjournal.KNOWN_KINDS
    j = journal.EventJournal(capacity=2, registry=MetricsRegistry())
    jj = jjournal.EventJournal(capacity=2, registry=jobs.MetricsRegistry())
    for jr in (j, jj):
        jr.record("config", batch_size=4)
        jr.record("admission_drop", stream="s", window_id=1, trace_id="w-1",
                  reason="oversize")
        jr.record("batch_close", bucket="b", occupancy=2)
    strip = lambda r: {k: v for k, v in r.to_dict().items()
                       if k not in ("t_wall", "t_perf")}
    assert [strip(r) for r in j.tail()] == [strip(r) for r in jj.tail()]


def test_warmup_batches_match_reference():
    port = list(service.warmup_batches(config.ServeConfig()))
    ref = list(jservice.warmup_batches(jconfig.ServeConfig()))
    assert [t for _, t, _ in port] == [t for _, t, _ in ref]
    assert [b for b, _, _ in port] == [b for b, _, _ in ref]
    for (_, tag, got), (_, _, want) in zip(port, ref):
        assert service.batch_signature(got) == jservice.batch_signature(want), tag
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{tag} {k}")


def test_warmup_detector_runs_one_forward_per_bucket():
    model = _small_cpu_model()
    buckets = (BUCKET_A, BUCKET_B)
    reset_launches()
    times = pipeline.warmup_detector(model, buckets, batch_size=2)
    assert list(times) == [bucket_tag(b) for b in buckets]
    assert all(t >= 0 for t in times.values())
    assert LAUNCHES == {k: 0 for k in LAUNCHES}


# -- bucket selection, batcher, admission (fake score function) ----------------

def test_select_bucket_first_fit_and_soft_seq_overflow():
    ladder = (BUCKET_A, BUCKET_B, (1024, 2048, 128))
    assert select_bucket(100, 200, 10, ladder) == BUCKET_A
    assert select_bucket(200, 200, 10, ladder) == BUCKET_B
    assert select_bucket(100, 200, 500, ladder) == BUCKET_A
    assert select_bucket(
        200, 200, 500,
        ((256, 512, 64), (256, 512, 128), (1024, 2048, 256))) \
        == (256, 512, 128)
    assert select_bucket(999, 1000, 10, ladder) == (1024, 2048, 128)
    assert select_bucket(5000, 10, 10, ladder) is None


def test_admission_closed_after_stop_drops_counted():
    cfg = ServeConfig(buckets=(BUCKET_B,), batch_size=4,
                      batch_close_sec=0.02, window_sec=10.0, stride_sec=5.0)
    svc, reg = _fake_service(cfg)
    svc.join("s0")
    tr = _sim(seed=37, duration=60.0, files=4, rate=6.0)
    blocks = list(_blocks(tr, size=250))
    svc.feed("s0", blocks[0], tr.strings)
    svc.stop(drain=True)
    for b in blocks[1:]:
        svc.feed("s0", b, tr.strings)  # post-stop: drop, don't queue
    assert reg.value("serve_admission_dropped_total",
                     labels={"reason": "closed"}) > 0
    t0 = time.perf_counter()
    det = svc.leave("s0", timeout=30.0)  # must NOT wait the 30 s
    assert time.perf_counter() - t0 < 5.0
    assert det.detector == "serve[max]"
    assert not svc.ready()[0]


def _req(stream, idx, bucket, now=None):
    sample = {"node_mask": np.zeros(bucket[0], np.bool_),
              "node_type": np.zeros(bucket[0], np.int32),
              "node_key": np.zeros(bucket[0], np.int64)}
    now = time.perf_counter() if now is None else now
    return WindowRequest(stream=stream, window_idx=idx, lo_ns=0, hi_ns=1,
                         bucket=bucket, sample=sample, t_admit=now,
                         deadline=now + 10)


def test_batcher_packs_same_bucket_cross_stream_deterministically():
    cfg = ServeConfig(buckets=(BUCKET_A, BUCKET_B), batch_size=4,
                      batch_close_sec=10.0)  # close only on occupancy here
    reg = MetricsRegistry(namespace="test")
    got = []
    mb = MicroBatcher(score_fn=lambda b: np.zeros(b["node_mask"].shape),
                      cfg=cfg, registry=reg, on_scored=got.extend,
                      journal=journal.EventJournal(registry=reg))
    mb.mark_warm(BUCKET_A), mb.mark_warm(BUCKET_B)
    order = [("s0", 0, BUCKET_A), ("s1", 0, BUCKET_B), ("s0", 1, BUCKET_B),
             ("s1", 1, BUCKET_A), ("s0", 2, BUCKET_A), ("s1", 2, BUCKET_B),
             ("s1", 3, BUCKET_A), ("s0", 3, BUCKET_B)]
    for stream, idx, bucket in order:
        mb.submit(_req(stream, idx, bucket))
    assert mb.drain_once() == 2
    assert len(got) == 8
    by_batch = {}
    for s in got:
        by_batch.setdefault(tuple(s.bucket), []).append((s.stream, s.window_idx))
    assert by_batch[BUCKET_A] == [("s0", 0), ("s1", 1), ("s0", 2), ("s1", 3)]
    assert by_batch[BUCKET_B] == [("s1", 0), ("s0", 1), ("s1", 2), ("s0", 3)]
    assert reg.value("serve_batch_occupancy",
                     labels={"bucket": "128n/256e/32s"}, stat="mean") == 4.0
    assert reg.value("serve_batches_total",
                     labels={"bucket": "128n/256e/32s",
                             "cause": "occupancy"}) == 1
    assert reg.value("serve_recompiles_total",
                     labels={"bucket": "128n/256e/32s"}) == 0


def test_queue_depth_gauge_is_locked_post_close_count():
    cfg = ServeConfig(buckets=(BUCKET_B,), batch_size=4, batch_close_sec=10.0)
    reg = MetricsRegistry(namespace="test")
    mb = MicroBatcher(score_fn=lambda b: np.zeros(b["node_mask"].shape),
                      cfg=cfg, registry=reg,
                      journal=journal.EventJournal(registry=reg))
    mb.mark_warm(BUCKET_B)
    now = time.perf_counter()
    for i in range(5):
        mb.submit(_req("s", i, BUCKET_B, now))
    assert mb.drain_once() == 1
    assert reg.value("serve_queue_depth",
                     labels={"bucket": bucket_tag(BUCKET_B)}) == 1.0
    assert mb.queue_depth(BUCKET_B) == 1


def test_unwarmed_bucket_counts_a_recompile():
    cfg = ServeConfig(buckets=(BUCKET_B,), batch_size=4, batch_close_sec=10.0)
    reg = MetricsRegistry(namespace="test")
    mb = MicroBatcher(score_fn=lambda b: np.zeros(b["node_mask"].shape),
                      cfg=cfg, registry=reg,
                      journal=journal.EventJournal(registry=reg))
    mb.submit(_req("s", 0, BUCKET_B))
    assert mb.drain_once(force=True) == 1
    assert reg.value("serve_recompiles_total",
                     labels={"bucket": bucket_tag(BUCKET_B)}) == 1


def test_stalled_stream_cannot_delay_another_buckets_batch_close():
    cfg = ServeConfig(buckets=(BUCKET_A, BUCKET_B), batch_size=8,
                      batch_close_sec=0.05, window_sec=15.0, stride_sec=5.0)
    svc, reg = _fake_service(cfg)
    try:
        svc.join("stalled")
        svc.join("live")
        tr = _sim(seed=5, duration=45.0, files=3, rate=4.0)
        blocks = list(_blocks(tr, size=150))
        svc.feed("stalled", blocks[0], tr.strings)
        t0 = time.perf_counter()
        for b in blocks:
            svc.feed("live", b, tr.strings)
        det = svc.leave("live", timeout=10.0)
        waited = time.perf_counter() - t0
        assert det.detector == "serve[max]"
        assert svc._streams.get("live") is None  # clean leave
        assert reg.value("serve_windows_scored_total") >= 1
        assert waited < 5.0
        causes = [c for c in ("deadline", "occupancy", "flush")
                  if reg.value("serve_batches_total",
                               labels={"bucket": "128n/256e/32s", "cause": c})
                  or reg.value("serve_batches_total",
                               labels={"bucket": "256n/512e/64s", "cause": c})]
        assert causes, "no batch ever closed"
    finally:
        svc.stop(drain=False)


def test_drop_oldest_under_sustained_overload():
    gate = threading.Event()

    def slow_score(batch):
        gate.wait(timeout=30.0)
        return np.zeros(batch["node_mask"].shape)

    cfg = ServeConfig(buckets=(BUCKET_B,), batch_size=8,
                      batch_close_sec=10.0,  # nothing closes during the test
                      stream_queue_slots=2, window_sec=10.0, stride_sec=5.0)
    svc, reg = _fake_service(cfg, score=slow_score)
    try:
        svc.join("s0")
        tr = _sim(seed=9, duration=120.0, files=4, rate=6.0)
        for b in _blocks(tr, size=400):
            svc.feed("s0", b, tr.strings)
        h = svc._streams["s0"]
        assert h.admitted > 4
        assert h.dropped == h.admitted - 2          # all but the newest two
        assert len(h.live) == 2
        assert sorted(h.live) == [h.windower.windows_emitted - 2,
                                  h.windower.windows_emitted - 1]
        assert reg.value("serve_admission_dropped_total",
                         labels={"reason": "backpressure"}) == h.dropped
    finally:
        gate.set()
        svc.stop(drain=False)


def test_stream_leave_mid_batch_is_clean_and_isolated():
    release = threading.Event()
    calls = []

    def gated_score(batch):
        calls.append(1)
        if len(calls) > 1:
            release.wait(timeout=5.0)
        return np.full(batch["node_mask"].shape, 0.9)

    cfg = ServeConfig(buckets=(BUCKET_B,), batch_size=2,
                      batch_close_sec=0.02, window_sec=10.0, stride_sec=5.0)
    svc, reg = _fake_service(cfg, score=gated_score)
    try:
        svc.join("leaver")
        svc.join("stayer")
        tr = _sim(seed=13, duration=60.0, files=4, rate=6.0)
        for b in _blocks(tr, size=300):
            svc.feed("leaver", b, tr.strings)
        time.sleep(0.2)  # first batch through, second wedged in gated_score
        det = svc.leave("leaver", timeout=0.5)
        assert det.detector == "serve[max]"
        assert "leaver" not in svc._streams
        assert reg.value("serve_admission_dropped_total",
                         labels={"reason": "leave"}) > 0
        release.set()
        for b in _blocks(tr, size=300):
            svc.feed("stayer", b, tr.strings)
        det2 = svc.leave("stayer", timeout=10.0)
        assert len(det2.file_window_scores) > 0
    finally:
        release.set()
        svc.stop(drain=False)


def test_alert_sink_bounded_overflow_counted():
    cfg = ServeConfig(buckets=(BUCKET_B,), batch_size=4,
                      batch_close_sec=0.02, window_sec=10.0, stride_sec=5.0,
                      alert_queue_slots=2)
    svc, reg = _fake_service(cfg)  # fake score: every window is hot (0.9)
    try:
        svc.join("s0")
        tr = _sim(seed=17, duration=80.0, files=4, rate=6.0)
        for b in _blocks(tr, size=300):
            svc.feed("s0", b, tr.strings)
        svc.leave("s0", timeout=10.0)
        scored = reg.value("serve_windows_scored_total")
        assert scored > 2
        assert len(svc.sink) == 2  # bounded: only the newest alerts kept
        assert reg.value("serve_demux_overflows_total") == scored - 2
        a = svc.sink.drain()[-1]
        assert a.max_prob == pytest.approx(0.9)
        assert a.severity == pytest.approx(0.8)
        assert a.hot and a.hot[0][0] in ("file", "proc")
        assert svc.sink.detections["s0"].detector == "serve[max]"
    finally:
        svc.stop(drain=False)


def test_oversize_window_rejected_not_resized():
    cfg = ServeConfig(buckets=((16, 16, 8),), batch_size=2,
                      batch_close_sec=0.02, window_sec=30.0, stride_sec=15.0)
    svc, reg = _fake_service(cfg)
    try:
        h = svc.join("s0")
        tr = _sim(seed=19, duration=90.0, files=8, rate=10.0)
        for b in _blocks(tr, size=400):
            svc.feed("s0", b, tr.strings)
        svc.leave("s0", timeout=5.0)
        rejected = reg.value("serve_admission_dropped_total",
                             labels={"reason": "oversize"})
        assert rejected > 0 and h.rejected == rejected and h.dropped == 0
        assert reg.value("serve_recompiles_total",
                         labels={"bucket": "16n/16e/8s"}) == 0
    finally:
        svc.stop(drain=False)


def test_raising_alert_sink_never_wedges_leave():
    cfg = ServeConfig(buckets=(BUCKET_B,), batch_size=4,
                      batch_close_sec=0.02, window_sec=10.0, stride_sec=5.0)
    svc, reg = _fake_service(cfg)  # fake score: every window is hot
    svc.sink.emit = lambda alert: (_ for _ in ()).throw(
        RuntimeError("operator console down"))
    try:
        svc.join("s0")
        tr = _sim(seed=11, duration=60.0, files=4, rate=6.0)
        for b in _blocks(tr, size=300):
            svc.feed("s0", b, tr.strings)
        t0 = time.perf_counter()
        det = svc.leave("s0", timeout=30.0)
        assert time.perf_counter() - t0 < 10.0  # resolved, not timed out
    finally:
        svc.stop(drain=False)
    assert reg.value("serve_windows_scored_total") > 0
    assert det.file_scores
    drops = [r for r in svc._journal.tail()
             if r.kind == "demux_drop" and r.data.get("reason") == "emit_error"]
    assert drops and "RuntimeError" in drops[0].data["error"]



def test_concurrent_streams_account_for_every_window():
    """More feeder threads than cores, with a short interpreter switch
    interval: every admitted window is scored exactly once and lands in its
    own stream's result, and the shared counters lose no update."""
    import os
    import sys

    cfg = ServeConfig(buckets=(BUCKET_A, BUCKET_B), batch_size=4,
                      batch_close_sec=0.005, window_sec=10.0, stride_sec=5.0)
    svc, reg = _fake_service(cfg)
    n_streams = 2 * (os.cpu_count() or 4)
    traces = {f"s{i}": _sim(seed=100 + i, duration=40.0, files=3, rate=5.0)
              for i in range(n_streams)}
    dets, errors = {}, []

    def actor(sid):
        try:
            svc.join(sid)
            for b in _blocks(traces[sid], size=60):
                svc.feed(sid, b, traces[sid].strings)
            dets[sid] = svc.leave(sid, timeout=60.0)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=actor, args=(sid,)) for sid in traces]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
    finally:
        sys.setswitchinterval(interval)
        svc.stop(drain=False)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    scored = reg.value("serve_windows_scored_total")
    assert scored == reg.value("serve_windows_admitted_total") > n_streams
    assert reg.value("serve_admission_dropped_total",
                     labels={"reason": "backpressure"}) == 0
    occupancy = sum(reg.value("serve_batch_occupancy", labels={"bucket": bucket_tag(b)})
                    for b in cfg.buckets)
    assert occupancy == scored
    for b in cfg.buckets:
        assert svc._batcher.queue_depth(b) == 0
    assert sorted(dets) == sorted(traces) and not svc._streams
    # each stream's result equals the same stream served alone
    alone, _ = _fake_service(cfg)
    try:
        for sid, tr in traces.items():
            alone.join(sid)
            for b in _blocks(tr, size=60):
                alone.feed(sid, b, tr.strings)
            det = alone.leave(sid, timeout=60.0)
            assert det.file_window_scores == dets[sid].file_window_scores, sid
            assert det.proc_scores == dets[sid].proc_scores, sid
    finally:
        alone.stop(drain=False)

def test_poison_window_is_bisected_out_and_its_siblings_score():
    """One window of a shared batch makes the forward raise: bisection
    pins it, a confirm re-run fails it again, it is struck as poison, and
    every other window of the batch scores."""
    cfg = ServeConfig(buckets=(BUCKET_B,), batch_size=4, batch_close_sec=10.0,
                      quarantine_strikes=1)
    reg = MetricsRegistry(namespace="test")
    svc, _ = _fake_service(cfg, registry=reg, start=False)
    calls = []

    def score(batch):
        calls.append(int(batch["node_mask"].any(axis=1).sum()))
        if batch["node_key"][:, 0].tolist().count(7):
            raise FloatingPointError("non-finite logits")
        return np.full(batch["node_mask"].shape, 0.25)

    svc._batcher._score_fn = score
    for sid in ("a", "b"):
        svc._streams[sid] = service.StreamHandle(sid, cfg)
    reqs = []
    for i, (sid, key) in enumerate((("a", 1), ("b", 7), ("a", 3), ("b", 4))):
        r = _req(sid, i, BUCKET_B)
        r.sample["node_mask"][0] = True
        r.sample["node_key"][0] = key
        r.trace_id = f"w-{i}"
        svc._streams[sid].live[i] = r
        svc._batcher.submit(r)
        reqs.append(r)
    assert svc._batcher.drain_once() == 1
    # whole batch, halves [a0 b1] / [a2 b3], quarters [a0] / [b1], confirm [b1]
    assert calls == [4, 2, 1, 1, 2, 1]
    assert reg.value("serve_batch_failures_total",
                     labels={"bucket": bucket_tag(BUCKET_B)}) == 4
    assert reg.value("serve_windows_scored_total") == 3
    assert reqs[1].poison and not any(r.poison for r in reqs[::2] + reqs[3:])
    a, b = svc._streams["a"], svc._streams["b"]
    assert [s.window_idx for s in a.scored] == [0, 2] and a.failed == 0
    assert [s.window_idx for s in b.scored] == [3] and b.failed == 1
    assert not a.live and not b.live
    assert reg.value("serve_windows_failed_total",
                     labels={"reason": "FloatingPointError", "stream": "b"}) == 1
    assert svc._quarantined.keys() == {"b"}
    kinds = [r.kind for r in svc._journal.tail()]
    assert kinds.count("batch_bisect") == 2
    assert "device_batch_failed" in kinds and "stream_quarantined" in kinds


# -- parity with the port's model_detect and the JAX package's service ---------

@pytest.fixture(scope="module")
def small_models():
    """The reference's small float32 NerrfNet and its untrained params at
    the parity config, and the port's with the same params converted."""
    jcfg = jconfig.ServeConfig(**PARITY_CFG)
    jc = JJointConfig().small
    jc = dataclasses.replace(
        jc, gnn=dataclasses.replace(jc.gnn, dtype=jnp.float32),
        lstm=dataclasses.replace(jc.lstm, dtype=jnp.float32))
    jmodel = JNerrfNet(jc)
    params = jservice.init_untrained_params(jmodel, jcfg, seed=0)
    tc = JointConfig().small
    tc = dataclasses.replace(
        tc, gnn=dataclasses.replace(tc.gnn, dtype=torch.float32),
        lstm=dataclasses.replace(tc.lstm, dtype=torch.float32))
    tmodel = load_flax_params(NerrfNet(tc), jax.device_get(params))
    return jmodel, params, tmodel, jcfg


def _serve(model, cfg, traces, interleave=False, registry=None, **kw):
    """Replay ``traces`` ({stream: trace}) through a started service in
    blocks of 150 events; returns the detections, the registry and the
    window log."""
    registry = registry or MetricsRegistry(namespace="test")
    log = []
    svc = OnlineDetectionService(model, cfg, registry=registry,
                                 journal=journal.EventJournal(registry=registry),
                                 window_log=log, device="cpu", **kw)
    svc.start()
    dets = {}
    try:
        for sid in traces:
            svc.join(sid)
        blocks = {sid: list(_blocks(tr, size=150)) for sid, tr in traces.items()}
        if interleave:
            for i in range(max(len(b) for b in blocks.values())):
                for sid in traces:
                    if i < len(blocks[sid]):
                        svc.feed(sid, blocks[sid][i], traces[sid].strings)
        else:
            for sid in traces:
                for b in blocks[sid]:
                    svc.feed(sid, b, traces[sid].strings)
        for sid in traces:
            dets[sid] = svc.leave(sid, timeout=60.0)
    finally:
        svc.stop()
    return dets, registry, log, svc


def _offline(model, trace, sid, cfg):
    return pipeline.model_detect(_unlabelled(trace, sid), model,
                                 ds_cfg=cfg.dataset_config(BUCKET_B),
                                 auto_capacity=False,
                                 batch_size=cfg.batch_size, device="cpu")


def _assert_bit_equal(det, offline):
    assert det.file_scores == offline.file_scores
    assert det.file_window_scores == offline.file_window_scores
    assert det.proc_scores == offline.proc_scores
    assert det.file_bytes == offline.file_bytes
    assert det.threshold == offline.threshold


@pytest.fixture(scope="module")
def jax_single_stream(small_models):
    """One stream through the JAX package's OnlineDetectionService on the
    CPU (one compile of the bucket's program)."""
    jmodel, params, _, jcfg = small_models
    kw = _sim_cfg(seed=3)
    tr = jsimulate_trace(JSimConfig(**kw))
    svc = jservice.OnlineDetectionService(
        params, jmodel, cfg=jcfg, registry=jobs.MetricsRegistry(namespace="test"),
        journal=jjournal.EventJournal(registry=jobs.MetricsRegistry()))
    svc.start()
    try:
        svc.join("s0")
        for b in _blocks(tr, size=150):
            svc.feed("s0", b, tr.strings)
        det = svc.leave("s0", timeout=120.0)
    finally:
        svc.stop()
    return det


def test_single_stream_bit_parity_with_model_detect(small_models, jax_single_stream):
    *_, tmodel, _ = small_models
    cfg = ServeConfig(**PARITY_CFG)
    tr = _sim(seed=3)
    reset_launches()
    dets, reg, log, svc = _serve(tmodel, cfg, {"s0": tr})
    assert LAUNCHES == {k: 0 for k in LAUNCHES}
    det = dets["s0"]
    _assert_bit_equal(det, _offline(tmodel, tr, "s0", cfg))
    assert det.detector == "serve[max]"
    assert len(det.file_scores) >= 4
    assert list(svc.warmup_seconds) == [bucket_tag(BUCKET_B)]
    assert reg.value("serve_recompiles_total",
                     labels={"bucket": bucket_tag(BUCKET_B)}) == 0
    assert reg.value("serve_batch_failures_total",
                     labels={"bucket": bucket_tag(BUCKET_B)}) == 0
    assert len(log) == reg.value("serve_windows_scored_total") > 0
    # the JAX package's service on the same stream
    want = jax_single_stream
    assert det.detector == want.detector and det.threshold == want.threshold
    assert det.file_scores.keys() == want.file_scores.keys()
    for k, v in want.file_scores.items():
        assert abs(det.file_scores[k] - v) <= SCORE_ATOL, k
    assert det.proc_scores.keys() == want.proc_scores.keys()
    for k, v in want.proc_scores.items():
        assert abs(det.proc_scores[k] - v) <= SCORE_ATOL, k
    assert det.file_bytes == want.file_bytes
    assert det.file_window_scores.keys() == want.file_window_scores.keys()
    for k, v in want.file_window_scores.items():
        np.testing.assert_allclose(det.file_window_scores[k], v, rtol=0,
                                   atol=SCORE_ATOL, err_msg=k)


def test_two_streams_share_batches_with_parity(small_models):
    *_, tmodel, _ = small_models
    cfg = dataclasses.replace(ServeConfig(**PARITY_CFG), batch_close_sec=0.25)
    traces = {"a": _sim(seed=23, duration=45.0),
              "b": _sim(seed=29, duration=45.0, attack=False)}
    dets, reg, _, _ = _serve(tmodel, cfg, traces, interleave=True)
    tag = bucket_tag(BUCKET_B)
    assert reg.value("serve_batch_occupancy", labels={"bucket": tag},
                     stat="mean") > 1.0
    assert reg.value("serve_recompiles_total", labels={"bucket": tag}) == 0
    for sid, tr in traces.items():
        _assert_bit_equal(dets[sid], _offline(tmodel, tr, sid, cfg))


# -- hot swap -----------------------------------------------------------------

def test_swap_flips_versions_at_one_batch_boundary(small_models):
    *_, tmodel, _ = small_models
    other = NerrfNet(tmodel.cfg)
    other.load_state_dict({k: v + 0.01 * (i % 3)
                           for i, (k, v) in enumerate(tmodel.state_dict().items())})
    cfg = ServeConfig(**PARITY_CFG)
    reg = MetricsRegistry(namespace="test")
    log = []
    svc = OnlineDetectionService(tmodel, cfg, registry=reg, window_log=log,
                                 journal=journal.EventJournal(registry=reg),
                                 device="cpu").start()
    tr = _sim(seed=3)
    blocks = list(_blocks(tr, size=150))
    try:
        h = svc.join("mixed")
        for b in blocks[:len(blocks) // 2]:
            svc.feed("mixed", b, tr.strings)
        deadline = time.monotonic() + 30.0
        while h.live and time.monotonic() < deadline:  # first half scored
            time.sleep(0.01)
        svc.swap_params(other.state_dict(), version=2)
        for b in blocks[len(blocks) // 2:]:
            svc.feed("mixed", b, tr.strings)
        mixed = svc.leave("mixed", timeout=60.0)
        svc.join("v2")
        for b in blocks:
            svc.feed("v2", b, tr.strings)
        v2 = svc.leave("v2", timeout=60.0)
    finally:
        svc.stop()
    versions = [v for s, _, _, _, v in log if s == "mixed"]
    assert None in versions and 2 in versions
    flip = versions.index(2)
    assert set(versions[:flip]) == {None} and set(versions[flip:]) == {2}
    # each batch was scored by one version: the batch closes that held the
    # flip's windows hold no window of the other version
    by_tid = {s.trace_id: s.model_version for s in h.scored}
    for rec in svc._journal.tail(kinds=("batch_close",)):
        assert len({by_tid[t] for t in rec.data["trace_ids"] if t in by_tid}) <= 1
    assert mixed.detector == "serve[max]"
    assert v2.detector == "serve[max]@v2"
    assert svc.live_version == 2
    _assert_bit_equal(v2, _offline(other, tr, "v2", cfg))


def test_incompatible_swap_raises_and_leaves_the_live_model(small_models):
    *_, tmodel, _ = small_models
    cfg = ServeConfig(**PARITY_CFG)
    svc = OnlineDetectionService(tmodel, cfg, registry=MetricsRegistry(),
                                 journal=journal.EventJournal(registry=MetricsRegistry()),
                                 device="cpu")
    live, live_fn = svc._model, svc._eval_fn
    wider = dataclasses.replace(
        tmodel.cfg, gnn=dataclasses.replace(tmodel.cfg.gnn, hidden=tmodel.cfg.gnn.hidden * 2))
    with pytest.raises(ValueError, match="cannot hot-swap: gnn"):
        svc.swap_params(NerrfNet(wider).state_dict(), version=2)
    sd = dict(tmodel.state_dict())
    sd.pop("gnn.final_ln.bias")
    with pytest.raises(ValueError, match="missing 'gnn.final_ln.bias'"):
        svc.swap_params(sd, version=3)
    sd = dict(tmodel.state_dict())
    sd["lstm.head.weight"] = sd["lstm.head.weight"].double()
    with pytest.raises(ValueError, match="lstm.head.weight"):
        svc.swap_params(sd, version=4)
    assert svc._model is live and svc._eval_fn is live_fn
    assert svc.live_version is None


# -- the device rule -----------------------------------------------------------

def test_service_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    model = _small_cpu_model()
    cfg = ServeConfig(buckets=(BUCKET_B,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OnlineDetectionService(model, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_untrained_model(JointConfig().small, cfg)
    assert OnlineDetectionService(model, cfg, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="the model lies on cpu"):
        OnlineDetectionService(model, cfg, device="cuda")

