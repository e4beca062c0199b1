"""The port's host planes under the CLI against the JAX package's, on the CPU:
tracing (``nerrf_tpu_torch.tracing``), the metrics endpoint
(``observability.MetricsServer``) and the dataset files
(``data.datasets``).  All three are host copies, so every comparison is an
equality:

* tracing: ``stage_summary`` and ``format_stage_table`` equal to the
  reference's on one Chrome-trace file; the port's ``chrome_trace()`` of a
  few spans (two threads, nesting, attributes) loads in the reference's
  ``load_chrome_trace`` with the same events, in µs relative to the tracer's
  epoch; every span lands in ``stage_latency_seconds{stage}``; ``enabled``
  follows ``set_enabled``;
* ``MetricsServer``: ``/metrics`` bodies byte-equal to the reference's for
  the same registry contents, ``/healthz`` and ``/readyz`` codes and bodies
  (the uptime aside) equal, 404 elsewhere;
* datasets: trace CSV, ground-truth CSV and corpus directories byte-equal
  to the reference's and read back to the same events; Parquet only where
  ``pyarrow`` imports.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from nerrf_tpu import observability as jobs
from nerrf_tpu import tracing as jtracing
from nerrf_tpu.data import datasets as jdatasets
from nerrf_tpu.data import SimConfig as JSimConfig
from nerrf_tpu.data import simulate_trace as jsimulate_trace
from nerrf_tpu_torch import observability, tracing
from nerrf_tpu_torch.data import SimConfig, datasets, simulate_trace

EVENT_FIELDS = ("ts_ns", "pid", "tid", "comm_id", "syscall", "path_id",
                "new_path_id", "flags", "ret_val", "bytes", "inode", "mode",
                "uid", "gid", "valid")


# -- tracing --------------------------------------------------------------------


def _spans(tracer):
    """A few spans on two threads, one nested, one with attributes."""
    with tracer.span("graph_lower", nodes=12) as sp:
        sp.args["edges"] = 30
        with tracer.span("bucket_pad"):
            pass
    with tracer.span("graph_lower"):
        pass

    def worker():
        with tracer.span("serve_demux", windows=2):
            pass

    t = threading.Thread(target=worker, name="demux-thread")
    t.start()
    t.join(10)
    assert not t.is_alive()


def test_chrome_trace_loads_in_the_reference(tmp_path):
    reg = observability.MetricsRegistry()
    tracer = tracing.Tracer(registry=reg)
    _spans(tracer)
    path = tracer.write(tmp_path / "sub" / "t.json")
    doc = json.loads((tmp_path / "sub" / "t.json").read_text())
    assert doc["otherData"]["producer"] == "nerrf_tpu_torch.tracing"
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["name"] == "thread_name"}
    assert "demux-thread" in names
    got = jtracing.load_chrome_trace(path)
    assert [e["name"] for e in got] == ["bucket_pad", "graph_lower", "graph_lower",
                                        "serve_demux"]
    recs = tracer.records()
    for e, sp in zip(got, recs):
        assert e["ts"] == round((sp.t0 - tracer._t0_perf) * 1e6, 3)
        assert e["dur"] == round(sp.dur * 1e6, 3)
        assert e["tid"] == sp.tid
    assert got[1]["args"] == {"nodes": 12, "edges": 30}
    # the nested span lies inside its parent
    assert got[1]["ts"] <= got[0]["ts"] and \
        got[0]["ts"] + got[0]["dur"] <= got[1]["ts"] + got[1]["dur"]
    for stage, n in (("graph_lower", 2), ("bucket_pad", 1), ("serve_demux", 1)):
        assert reg.value(tracing.STAGE_HISTOGRAM, labels={"stage": stage},
                         stat="count") == n
    tracer.clear()
    assert tracer.records() == []


def test_stage_table_and_summary_equal_the_references(tmp_path):
    tracer = tracing.Tracer(registry=observability.MetricsRegistry())
    _spans(tracer)
    path = tracer.write(tmp_path / "t.json")
    events = tracing.load_chrome_trace(path)
    assert events == jtracing.load_chrome_trace(path)
    assert tracing.stage_summary(events) == jtracing.stage_summary(events)
    assert tracing.wall_clock_us(events) == jtracing.wall_clock_us(events)
    assert tracing.coverage(events) == jtracing.coverage(events)
    assert tracing.format_stage_table(events) == jtracing.format_stage_table(events)
    # a bare event list and a file with overlapping, clipped spans
    bare = [{"name": "a", "ph": "X", "ts": 0, "dur": 10},
            {"name": "b", "ph": "X", "ts": 5, "dur": 10},
            {"name": "a", "ph": "X", "ts": 30, "dur": 4},
            {"name": "m", "ph": "M"}]
    (tmp_path / "bare.json").write_text(json.dumps(bare))
    events = tracing.load_chrome_trace(tmp_path / "bare.json")
    assert events == jtracing.load_chrome_trace(tmp_path / "bare.json")
    assert tracing.format_stage_table(events) == jtracing.format_stage_table(events)
    for lo, hi in ((None, None), (2.0, 20.0), (40.0, 50.0)):
        assert tracing.coverage(events, lo, hi) == jtracing.coverage(events, lo, hi)


def test_enabled_follows_set_enabled(monkeypatch):
    monkeypatch.setattr(tracing.DEFAULT_TRACER, "enabled", False)
    assert not tracing.enabled()
    tracing.set_enabled(True)
    assert tracing.enabled() and tracing.DEFAULT_TRACER.enabled
    tracing.set_enabled(False)
    assert not tracing.enabled()
    with tracing.device_annotation("region"), tracing.span("x", device=True):
        pass
    assert tracing.records()[-1].name == "x"


# -- the metrics endpoint -------------------------------------------------------


def _drive(reg):
    reg.counter_inc("requests_total", 3, labels={"code": "200"}, help="requests")
    reg.gauge_set("queue_depth", 7, help="depth")
    for v in (0.001, 0.2, 3.0):
        reg.histogram_observe("latency_seconds", v, labels={"stage": "a"})


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def _probe_bodies(server_cls, registry):
    checks = {"none": None, "ready": lambda: True,
              "booting": lambda: (False, "warmup in progress", {"model_version": None}),
              "broken": lambda: 1 / 0}
    out = {}
    for name, check in checks.items():
        srv = server_cls(registry=registry, port=0, ready_check=check)
        try:
            code, ctype, body = _get(srv.port, "/readyz")
            doc = json.loads(body)
            assert doc.pop("uptime_sec") >= 0
            out[name] = (code, ctype, doc)
            code, ctype, body = _get(srv.port, "/healthz")
            doc = json.loads(body)
            assert doc.pop("uptime_sec") >= 0
            out[name + "/healthz"] = (code, ctype, doc)
            out[name + "/404"] = _get(srv.port, "/nope")[0]
            out[name + "/metrics"] = _get(srv.port, "/metrics")
        finally:
            srv.close()
    return out


def test_metrics_server_answers_as_the_references():
    reg, jreg = observability.MetricsRegistry(), jobs.MetricsRegistry()
    _drive(reg)
    _drive(jreg)
    got = _probe_bodies(observability.MetricsServer, reg)
    want = _probe_bodies(jobs.MetricsServer, jreg)
    assert got == want
    assert got["none"][0] == 200 and got["booting"][0] == 503
    assert got["broken"][2]["reason"].startswith("ZeroDivisionError")
    assert got["none/404"] == 404
    assert "nerrf_requests_total{code=\"200\"} 3" in got["none/metrics"][2]


# -- dataset files ----------------------------------------------------------------


SIM = dict(duration_sec=40.0, attack=True, attack_start_sec=10.0,
           num_target_files=3, benign_rate_hz=6.0, seed=11)


@pytest.fixture(scope="module")
def traces():
    return (simulate_trace(SimConfig(**SIM), name="t11"),
            jsimulate_trace(JSimConfig(**SIM), name="t11"))


def _same_events(a, b):
    for f in EVENT_FIELDS:
        np.testing.assert_array_equal(getattr(a.events, f), getattr(b.events, f),
                                      err_msg=f)
    assert a.strings.strings() == b.strings.strings()
    np.testing.assert_array_equal(a.labels, b.labels)


def test_trace_csv_round_trip_is_the_references(tmp_path, traces):
    tr, jtr = traces
    p = datasets.write_trace_csv(tr, tmp_path / "port" / "t.csv")
    jp = jdatasets.write_trace_csv(jtr, tmp_path / "ref" / "t.csv")
    assert p.read_bytes() == jp.read_bytes()
    g = datasets.write_ground_truth_csv(tr.ground_truth, tmp_path / "port" / "gt.csv")
    jg = jdatasets.write_ground_truth_csv(jtr.ground_truth, tmp_path / "ref" / "gt.csv")
    assert g.read_bytes() == jg.read_bytes()
    back, jback = datasets.load_trace_csv(p), jdatasets.load_trace_csv(jp)
    _same_events(back, jback)
    assert back.name == jback.name == "t"
    # the CSV carries the trace itself: its valid events come back unchanged
    assert int(back.events.num_valid) == int(tr.events.num_valid)


def test_corpus_directory_is_the_references(tmp_path, traces):
    tr, jtr = traces
    benign = simulate_trace(SimConfig(**{**SIM, "attack": False, "seed": 12}), name="b12")
    jbenign = jsimulate_trace(JSimConfig(**{**SIM, "attack": False, "seed": 12}),
                              name="b12")
    out = datasets.export_corpus([tr, benign], tmp_path / "port")
    jout = jdatasets.export_corpus([jtr, jbenign], tmp_path / "ref")
    files = sorted(p.relative_to(out) for p in out.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(jout) for p in jout.rglob("*") if p.is_file())
    for rel in files:
        assert (out / rel).read_bytes() == (jout / rel).read_bytes(), rel
    for a, b in zip(datasets.load_corpus(out), jdatasets.load_corpus(jout)):
        _same_events(a, b)
        assert (a.ground_truth is None) == (b.ground_truth is None)


def test_parquet_round_trip_is_the_references(tmp_path, traces):
    pytest.importorskip("pyarrow")
    tr, jtr = traces
    p = datasets.write_trace_parquet(tr, tmp_path / "port.parquet")
    jp = jdatasets.write_trace_parquet(jtr, tmp_path / "ref.parquet")
    _same_events(datasets.load_trace_parquet(p), jdatasets.load_trace_parquet(jp))
    _same_events(datasets.load_trace_parquet(jp), datasets.load_trace_csv(
        datasets.write_trace_csv(tr, tmp_path / "t.csv")))


def test_toy_trace_and_its_main_are_the_references(tmp_path, capsys):
    assert datasets.main(["toy", "--out", str(tmp_path / "port")]) == 0
    assert jdatasets.main(["toy", "--out", str(tmp_path / "ref")]) == 0
    for name in ("toy_trace.csv", "toy_ground_truth.csv"):
        assert (tmp_path / "port" / "traces" / name).read_bytes() == \
            (tmp_path / "ref" / "traces" / name).read_bytes()
