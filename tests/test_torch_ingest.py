"""The port's live feed (nerrf_tpu_torch.ingest: trace_pb2, bridge, service;
graph.store; serve's ``connect``) against the JAX package's, on the CPU.

* ``trace_pb2`` is the reference's file byte for byte, and both import into
  one process (one ``trace.proto`` descriptor in the default pool).
* Ring records and ``EventBatch`` frames encode to the same bytes, and each
  of the port's two decoders (the native ``libnerrf_ingest.so``, built into
  the port's own directory, and the Python one) decodes them as the
  reference's Python decoder does.  The reference's native engine is never
  asked for here: it would build into ``native/build/``, where the JAX
  package's own tests build.
* ``TraceStore`` queries equal the reference's, on both of the port's
  engines, and a store the port's native engine wrote reads alike in the
  reference's Python engine.
* The wire both ways: the port's ``TraceReplayServer`` to the reference's
  ``TrackerClient``, the reference's server to the port's client, each
  bit-equal; the reflection answers are the same bytes.
* Serve ``connect``ed to the port's server gives a result bit-equal to
  ``model_detect`` on the trace, and its alerts reach an attached router;
  ``follow`` reconnects as ``<id>#<n>`` with growing backoff, journaled.
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch

from nerrf_tpu.graph.store import TraceStore as JTraceStore
from nerrf_tpu.ingest import bridge as jbridge
from nerrf_tpu.ingest import service as jservice
from nerrf_tpu.ingest import trace_pb2 as jtrace_pb2
from nerrf_tpu.schema import EventArrays as JEventArrays
from nerrf_tpu.schema import StringTable as JStringTable
from nerrf_tpu_torch.data import SimConfig, Trace, simulate_trace
from nerrf_tpu_torch.flight.journal import EventJournal
from nerrf_tpu_torch.graph import TraceStore
from nerrf_tpu_torch.ingest import bridge, service, trace_pb2
from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, LSTMConfig, build_nerrfnet
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.pipeline import fit_capacity, model_detect
from nerrf_tpu_torch.respond import RespondConfig, ResponseRouter
from nerrf_tpu_torch.serve import OnlineDetectionService, ServeConfig, StreamRun
from nerrf_tpu_torch.train.data import DatasetConfig

FIELDS = ("ts_ns", "pid", "tid", "comm_id", "syscall", "path_id", "new_path_id",
          "flags", "ret_val", "bytes", "inode", "mode", "uid", "gid", "valid")
ENGINES = ("native", "python")


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread while a test runs: the serve scorer, the router's
    worker and the caller each run small torch ops at once, and with a
    thread pool per caller on a host shared by other test processes they
    oversubscribe the cores (a 1.7 s test took 125 s in six processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trace():
    return simulate_trace(SimConfig(duration_sec=60.0, attack=True,
                                    attack_start_sec=20.0, num_target_files=4,
                                    benign_rate_hz=20.0, seed=2))


def _jax(trace):
    """The same events and strings as the reference's types."""
    strings = JStringTable()
    for s in trace.strings.strings():
        strings.intern(s)
    return JEventArrays(**{f: getattr(trace.events, f) for f in FIELDS}), strings


def _resolved(events, strings) -> dict:
    """Columns with every string id replaced by its string: equal for two
    decoders whose intern pools number alike, and for two that do not."""
    out = {f: np.asarray(getattr(events, f)) for f in FIELDS}
    for f in ("comm_id", "path_id", "new_path_id"):
        out[f] = [strings.lookup(int(i)) for i in out[f]]
    return out


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for f in a:
        if isinstance(a[f], list):
            assert a[f] == b[f], f
        else:
            assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), f


def _bridge(engine: str) -> bridge.IngestBridge:
    b = bridge.IngestBridge(use_native=engine == "native")
    assert b.is_native == (engine == "native")
    return b


# -- wire schema and decoders -------------------------------------------------


def test_trace_pb2_is_the_references_and_both_load():
    assert (bridge._NATIVE_DIR.parent / "nerrf_tpu" / "ingest" / "trace_pb2.py"
            ).read_bytes() == open(trace_pb2.__file__, "rb").read()
    assert trace_pb2.DESCRIPTOR.serialized_pb == jtrace_pb2.DESCRIPTOR.serialized_pb
    msg = trace_pb2.EventBatch()
    msg.events.add(pid=7, path="/srv/a")
    assert jtrace_pb2.EventBatch.FromString(msg.SerializeToString()).events[0].pid == 7


@pytest.mark.parametrize("engine", ENGINES)
def test_ring_records_decode_as_the_references(trace, engine):
    jev, jst = _jax(trace)
    buf = bridge.encode_ring_records(trace.events, trace.strings)
    assert buf == jbridge.encode_ring_records(jev, jst)
    with _bridge(engine) as b:
        got = b.decode_ring(buf, boot_epoch_ns=123)
        table = b.string_table()
    ref = jbridge.IngestBridge(use_native=False)
    want = ref.decode_ring(buf, boot_epoch_ns=123)
    _assert_same(_resolved(got, table), _resolved(want, ref.string_table()))
    with pytest.raises(ValueError, match="multiple of"):
        _bridge(engine).decode_ring(buf[:-1])


@pytest.mark.parametrize("engine", ENGINES)
def test_batch_frames_decode_as_the_references(trace, engine):
    jev, jst = _jax(trace)
    frames = bridge.events_to_batch_frames(trace.events, trace.strings, 64)
    assert frames == jbridge.events_to_batch_frames(jev, jst, 64)
    b, ref = _bridge(engine), jbridge.IngestBridge(use_native=False)
    for frame in frames:
        _assert_same(_resolved(b.decode_batch(frame), b.string_table()),
                     _resolved(ref.decode_batch(frame), ref.string_table()))
    b.close()


# -- the trace store ----------------------------------------------------------


def _blocks(trace, size=97):
    ev = trace.events
    for i in range(0, len(ev), size):
        yield type(ev)(**{f.name: getattr(ev, f.name)[i:i + size]
                          for f in dataclasses.fields(ev)})


@pytest.mark.parametrize("engine", ENGINES)
def test_trace_store_query_equals_the_references(tmp_path, trace, engine):
    jev, jst = _jax(trace)
    ts = trace.events.ts_ns
    lo, hi = int(ts[len(ts) // 4]), int(ts[3 * len(ts) // 4])
    with TraceStore(tmp_path / "port", bucket_sec=10.0,
                    use_native=engine == "native") as st, \
            JTraceStore(tmp_path / "jax", bucket_sec=10.0, use_native=False) as jst_:
        assert st.is_native == (engine == "native")
        for blk in _blocks(trace):
            st.append(blk, trace.strings)
        jst_.append(jev, jst)
        st.flush()
        jst_.flush()
        assert st.num_segments == jst_.num_segments
        for a, b in ((0, 2 ** 63 - 1), (lo, hi)):
            assert st.query_count(a, b) == jst_.query_count(a, b)
            _assert_same(_resolved(*st.query(a, b)), _resolved(*jst_.query(a, b)))
    # the port's files read alike in the reference's Python engine
    with JTraceStore(tmp_path / "port", use_native=False) as again, \
            JTraceStore(tmp_path / "jax", use_native=False) as want:
        _assert_same(_resolved(*again.query(lo, hi)), _resolved(*want.query(lo, hi)))


# -- the wire, both ways ------------------------------------------------------


@pytest.fixture
def servers(trace):
    """The port's and the reference's replay servers on 127.0.0.1:0."""
    jev, jst = _jax(trace)
    port_srv = service.TraceReplayServer(trace.events, trace.strings, batch_size=50)
    ref_srv = jservice.TraceReplayServer(jev, jst, batch_size=50)
    port_srv.start()
    ref_srv.start()
    yield port_srv, ref_srv
    port_srv.stop()
    ref_srv.stop()


def test_wire_is_bit_equal_both_ways(trace, servers):
    port_srv, ref_srv = servers
    assert port_srv._frames == ref_srv._frames
    want = _resolved(trace.events, trace.strings)
    # the port's server → the reference's client (its Python decoder)
    jclient = jservice.TrackerClient(f"127.0.0.1:{port_srv.port}",
                                     bridge=jbridge.IngestBridge(use_native=False))
    _assert_same(_resolved(*jclient.stream(timeout=30.0)), want)
    # the reference's server → the port's client (its native decoder)
    client = service.TrackerClient(f"127.0.0.1:{ref_srv.port}",
                                   bridge=_bridge("native"))
    got = client.stream(timeout=30.0)
    assert client.bridge.is_native
    _assert_same(_resolved(*got), want)
    blocks = list(service.TrackerClient(f"127.0.0.1:{port_srv.port}",
                                        bridge=_bridge("python"))
                  .iter_blocks(max_events=120, timeout=30.0))
    assert [len(b) for b, _ in blocks] == [50, 50, 50]


@pytest.mark.parametrize("slots", [None, 3])
def test_subscriber_queue_drops_on_full_as_the_references(trace, slots):
    """The live-source fan-out queue: bounded at ``queue_slots`` (100 by
    default, the reference daemon's), ``put_nowait`` on a full one raises
    ``queue.Full`` (the caller counts it in ``frames_dropped``), and a
    replay drains through gRPC's flow control with nothing dropped."""
    import queue

    jev, jst = _jax(trace)
    kw = {} if slots is None else {"queue_slots": slots}
    srv = service.TraceReplayServer(trace.events, trace.strings, batch_size=50, **kw)
    ref = jservice.TraceReplayServer(jev, jst, batch_size=50, **kw)
    q = srv.subscriber_queue()
    assert q.maxsize == ref.subscriber_queue().maxsize == (slots or 100)
    assert srv.frames_dropped == ref.frames_dropped == 0
    for frame in srv._frames[:q.maxsize]:
        q.put_nowait(frame)
    if len(srv._frames) > q.maxsize:
        with pytest.raises(queue.Full):
            q.put_nowait(srv._frames[q.maxsize])
    srv.start()
    try:
        got = service.TrackerClient(f"127.0.0.1:{srv.port}",
                                    bridge=_bridge("python")).stream(timeout=30.0)
    finally:
        srv.stop()
    _assert_same(_resolved(*got), _resolved(trace.events, trace.strings))
    assert srv.frames_dropped == 0


def test_reflection_answers_are_the_references():
    reqs = [service._ld(7, b""), service._ld(4, b"nerrf.trace.Tracker"),
            service._ld(4, b"google.protobuf.Timestamp"),
            service._ld(3, b"trace.proto"), service._ld(3, b"nope.proto"),
            service._ld(5, b"x")]
    for req in reqs:
        assert service.reflection_response(req) == jservice.reflection_response(req)


# -- serve over the wire ------------------------------------------------------


def _small_model():
    cfg = JointConfig(gnn=GraphSAGEConfig(hidden=16, num_layers=2, dtype=torch.float32),
                      lstm=LSTMConfig(hidden=16, num_layers=1, dtype=torch.float32))
    return build_nerrfnet(cfg, seed=0, device="cpu")


def test_connected_serve_is_bit_equal_to_model_detect_and_feeds_the_router(
        trace, servers):
    port_srv, _ = servers
    model = _small_model()
    ds = fit_capacity(trace, DatasetConfig())
    bucket = (ds.graph.max_nodes, ds.graph.max_edges, ds.max_seqs)
    # threshold 0: every scored window alerts, so the router sees traffic
    cfg = ServeConfig(buckets=(bucket,), batch_size=4, threshold=0.0)
    reg, jr = MetricsRegistry(), EventJournal(registry=MetricsRegistry())
    rcfg = RespondConfig(num_simulations=16, batch_slots=(1, 2, 4), severity_min=0.6)
    router = ResponseRouter(rcfg, registry=reg, journal=jr, device="cpu").start()
    svc = OnlineDetectionService(model, cfg, registry=reg, journal=jr, device="cpu")
    svc.attach_respond(router)
    svc.start()
    try:
        run = svc.connect("w0", f"127.0.0.1:{port_srv.port}", timeout=30.0)
        assert isinstance(run, StreamRun)
        assert run.done.wait(120.0) and run.error is None
        assert router.drain(timeout=120.0)
    finally:
        svc.stop()
        router.stop(timeout=60.0)
    want = model_detect(Trace(events=trace.events, strings=trace.strings,
                              ground_truth=None, labels=None, name="w0"),
                        model, ds_cfg=cfg.dataset_config(bucket), auto_capacity=False,
                        batch_size=cfg.batch_size, threshold=cfg.threshold, device="cpu")
    for f in ("file_scores", "file_window_scores", "proc_scores", "file_bytes",
              "threshold"):
        assert getattr(run.result, f) == getattr(want, f), f
    alerts = svc.sink.drain()
    assert alerts and reg.value("serve_alerts_emitted_total",
                                labels={"stream": "w0"}) == len(alerts)
    admitted = reg.value("respond_incidents_total", labels={"outcome": "admitted"})
    below = reg.value("respond_incidents_total", labels={"outcome": "below_min"})
    assert admitted + below == len(alerts)
    assert admitted == sum(a.severity >= rcfg.severity_min for a in alerts)
    results = router.results()
    assert len(results) == admitted
    # alert incidents carry ino: pseudo-targets and no snapshot context:
    # fail closed, rejected with the journaled reason
    assert all(not vp.verified and "no snapshot context" in vp.reason
               for vp in results)
    assert all(p.startswith("ino:") for vp in results
               for p in vp.incident.domain.file_paths)
    assert router.stats()["recompiles"] == 0


def test_follow_reconnects_with_growing_backoff(trace):
    # a dead endpoint that no other process can take over: a port held by a
    # bound socket that never listens refuses every connection, so every
    # session ends with no block
    dead = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    dead.bind(("127.0.0.1", 0))
    port = dead.getsockname()[1]
    reg, jr = MetricsRegistry(), EventJournal(registry=MetricsRegistry())
    ds = fit_capacity(trace, DatasetConfig())
    cfg = ServeConfig(buckets=((ds.graph.max_nodes, ds.graph.max_edges, ds.max_seqs),),
                      batch_size=2, warmup_on_start=False)
    svc = OnlineDetectionService(_small_model(), cfg, registry=reg, journal=jr,
                                 device="cpu").start()
    try:
        run = svc.connect("w1", f"127.0.0.1:{port}", timeout=5.0, follow=True,
                          reconnect_sec=0.01, reconnect_max_sec=0.05)
        for _ in range(200):
            if len(jr.tail(kinds=("reconnect",))) >= 4:
                break
            run.done.wait(0.05)
    finally:
        svc.stop()
        dead.close()
    assert run.done.wait(30.0)
    recs = jr.tail(kinds=("reconnect",))
    assert len(recs) >= 4
    assert [r.data["session"] for r in recs] == list(range(1, len(recs) + 1))
    assert not any(r.data["healthy"] for r in recs)
    assert all(r.data["error"] for r in recs)
    # session k sleeps its ceiling times a jitter in [0.5, 1); the ceiling
    # doubles from 0.01 s until it reaches the 0.05 s cap (delays rounded to
    # the millisecond)
    for k, r in enumerate(recs):
        ceiling = min(0.01 * 2 ** k, 0.05)
        assert 0.5 * ceiling - 5e-4 <= r.data["delay_sec"] <= ceiling + 5e-4, (k, r.data)
    assert reg.value("serve_reconnects_total", labels={"stream": "w1"}) == len(recs)
