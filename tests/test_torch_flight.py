"""The port's flight plane (nerrf_tpu_torch.flight) against the JAX
package's (nerrf_tpu.flight), on the CPU.

* Host copies: ``flight/slo.py`` is the reference's source, and
  ``flight/doctor.py`` is too but for the profiler capture's directory,
  which the port reads from the manifest (``torch_trace``, the
  reference's is ``jax_trace``); so is ``learn/replay.py``.  Each is
  compared as text with the reference, the package name swapped back and
  the copy's note taken out.
* `SLOTracker`: the same seeded observations (five streams through a
  three-stream bound, a trailing set of 16, breaches) give the same
  snapshot, exemplars, trailing p99s, ``slo_breach`` records and metrics.
* The recorder's triggers (p99 breach, drop burst, guardrail veto, shadow
  disagreement, quality drift, the rate limit, atomic and bounded bundles,
  a failed dump, the crash handlers): each scenario runs against both
  packages, and the bundles left on disk (names without their time stamp,
  files, manifests without time and environment, journal tails without
  times) and the recorders' counters are equal.
* The manifest's environment names PyTorch, not jax.  The p99 bundle's
  opt-in profiler capture: a ``torch_trace/`` trace holding the scorer
  thread's ops, taken while scoring goes on; none without the opt-in; a
  profiler that cannot start (another session active) journals
  ``profile_failed`` and the bundle still ships; the doctor renders the
  inventory.
* The doctor: one bundle rendered by both doctors, text and ``--json``,
  equal; ``quality show`` of a bundle equal between the two CLIs.
"""

import contextlib
import io
import json
import os
import pathlib
import re
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from nerrf_tpu import cli as jcli
from nerrf_tpu import flight as jflight
from nerrf_tpu.flight import doctor as jdoctor
from nerrf_tpu.flight import recorder as jrecorder
from nerrf_tpu.observability import MetricsRegistry as JMetricsRegistry
from nerrf_tpu.tracing import Tracer as JTracer
from nerrf_tpu_torch import cli, flight
from nerrf_tpu_torch.flight import doctor, recorder
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.tracing import Tracer

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKGS = {
    "ref": SimpleNamespace(flight=jflight, recorder=jrecorder, doctor=jdoctor,
                           Registry=JMetricsRegistry, Tracer=JTracer),
    "port": SimpleNamespace(flight=flight, recorder=recorder, doctor=doctor,
                            Registry=MetricsRegistry, Tracer=Tracer),
}
# the reference's profiler inventory in read_bundle and its report line, and
# the port's: the port reads the capture's directory from the manifest
DOCTOR_PROFILE = (('''    # optional embedded jax.profiler capture (the flight recorder's
    # opt-in profile_on_p99_sec action): inventory only — the trace
    # itself loads in Perfetto/TensorBoard, not here.  trace_summary is
    # jax-free and devtime's package init is lazy, so the offline doctor
    # shares the ONE inventory implementation without touching jax
    from nerrf_tpu.devtime.capture import trace_summary

    out["profile"] = trace_summary(os.path.join(root, "jax_trace"))
''', '''    # optional embedded torch.profiler capture (the flight recorder's
    # opt-in profile_on_p99_sec action), in the dir the manifest names:
    # inventory only — the trace itself loads in Perfetto/TensorBoard,
    # not here.  trace_summary imports no torch and devtime's package
    # init is lazy, so the offline doctor stays light
    from nerrf_tpu.devtime.capture import trace_summary

    pdir = (manifest.get("profile") or {}).get("dir")
    out["profile"] = (trace_summary(os.path.join(root, pdir))
                      if pdir else None)
'''), ('''            f"bytes in jax_trace/"''', '''            f"bytes in {man_prof['dir']}/"'''))
NOTES = {
    "flight/slo.py": "\nA host copy of ``nerrf_tpu/flight/slo.py``, kept identical.\n",
    "learn/replay.py": "\nA host copy of ``nerrf_tpu/learn/replay.py``, kept identical.\n",
    "flight/doctor.py": ("\nA host copy of ``nerrf_tpu/flight/doctor.py``, kept identical "
                         "but for\nthe profiler capture's directory, which the manifest "
                         "names.\n"),
}
KNOWN_TRIGGERS = ("p99_breach", "drop_burst", "guardrail_veto",
                  "shadow_disagreement", "quality_drift", "exception")


@pytest.mark.parametrize("rel", sorted(NOTES))
def test_host_copies_are_the_references_source(rel):
    port = (ROOT / "nerrf_tpu_torch" / rel).read_text()
    assert port.count(NOTES[rel]) == 1
    port = port.replace(NOTES[rel], "").replace("nerrf_tpu_torch.", "nerrf_tpu.")
    ref = (ROOT / "nerrf_tpu" / rel).read_text()
    if rel == "flight/doctor.py":
        for ref_text, port_text in DOCTOR_PROFILE:
            assert ref.count(ref_text) == 1
            ref = ref.replace(ref_text, port_text)
    assert port == ref


# -- the SLO tracker --------------------------------------------------------------


def _no_times(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in ("t_wall", "t_perf")}


def _slo_run(pkg):
    reg = pkg.Registry(namespace="t")
    journal = pkg.flight.EventJournal(registry=reg)
    slo = pkg.flight.SLOTracker(0.05, registry=reg, journal=journal,
                                trailing=16, max_streams=3)
    rng = np.random.default_rng(19)
    for i in range(120):
        stream = f"s{int(rng.integers(0, 5))}"
        stages = dict(zip(("queue", "pack", "device", "demux"),
                          rng.exponential(0.008, 4)))
        stages["pack"] -= 0.01  # clock jitter below zero is clamped
        slo.observe(stream, f"w-{i}", i, stages=stages,
                    e2e_sec=float(sum(stages.values())))
    return {
        "snapshot": slo.snapshot(),
        "exemplars": {s: slo.exemplar(s) for s in ("s0", "s1", "s2", "s3", "s4")},
        "p99": {s: slo.trailing_p99(s) for s in ("s0", "s1", "s2", "s3", "s4")},
        "breaches": [_no_times(r.to_dict()) for r in journal.tail(kinds=("slo_breach",))],
        "metrics": reg.render(),
    }


def test_slo_tracker_equals_the_references():
    got, want = _slo_run(PKGS["port"]), _slo_run(PKGS["ref"])
    assert got == want
    assert len(got["snapshot"]["per_stream"]) == 3 and got["breaches"]


# -- the recorder's triggers -------------------------------------------------------


class _BrokenTracer:
    def chrome_trace(self):
        raise OSError("disk full")


def _world(pkg, tmp, slo=None, quality=None, **cfg_kw):
    reg = pkg.Registry(namespace="t")
    journal = pkg.flight.EventJournal(registry=reg)
    cfg_kw.setdefault("out_dir", str(tmp / "bundles"))
    cfg_kw.setdefault("min_interval_sec", 300.0)
    rec = pkg.flight.FlightRecorder(
        pkg.flight.FlightConfig(**cfg_kw), registry=reg, journal=journal,
        tracer=pkg.Tracer(registry=reg), slo=slo, quality=quality,
        info=lambda: {"lineage": "default", "model_version": "v2"})
    return rec, journal, reg


def _p99(pkg, tmp):
    rec, journal, reg = _world(pkg, tmp, p99_breach_sec=0.5, p99_min_count=8)
    journal.record("batch_close", bucket="b", occupancy=4, trace_ids=["w-slow"])
    for i in range(7):
        rec.observe_window("s0", f"w-{i}", 2.5)      # under the min-count gate
    for _ in range(9):
        rec.observe_window("s0", "w-slow", 2.5)
    return rec, reg


def _drop_burst(pkg, tmp):
    rec, journal, reg = _world(pkg, tmp, drop_burst_n=5, drop_burst_sec=10.0)
    for i in range(4):
        journal.record("admission_drop", stream="s0", window_id=i,
                       reason="backpressure")
    journal.record("demux_drop", stream="s0", window_id=4, reason="sink_full")
    for i in range(2):  # a device fault sheds like overload: suppressed repeats
        journal.record("device_batch_failed", stream="s1", window_id=i,
                       reason="RuntimeError: x")
    return rec, reg


def _veto_and_disagreement(pkg, tmp):
    rec, journal, reg = _world(pkg, tmp, disagreement_spike=0.3,
                               disagreement_min_windows=8)
    journal.record("registry_veto", lineage="default", version=3,
                   reason="disagreement_rate 0.41 > 0.25")
    journal.record("registry_shadow_stats", lineage="default", version=4,
                   windows=1, disagreement_rate=0.9, score_drift=0.4)
    journal.record("registry_shadow_stats", lineage="default", version=4,
                   windows=64, disagreement_rate=0.55, score_drift=0.2)
    journal.record("registry_shadow_stats", lineage="default", version=4,
                   windows=96, disagreement_rate=0.01, score_drift=0.0)
    return rec, reg


def _quality_drift(pkg, tmp):
    snapshot = {"version": "v1", "windows_observed": 70,
                "reference": {"windows": 40, "node_scores": 900},
                "per_stream": {"s0": {"windows": 30, "score_psi": 0.4}}}
    rec, journal, reg = _world(pkg, tmp, quality=lambda: snapshot,
                               quality_psi_breach=0.25, quality_min_windows=10,
                               quality_breach_records=2, min_interval_sec=0.0)
    # (psi, windows): a gated breach, a breach, a reset, then two streaks
    for psi, windows in ((0.9, 5), (0.3, 20), (0.1, 30), (0.3, 40), (0.26, 50),
                         (0.5, 60), (0.7, 70)):
        journal.record("quality_stats", windows=windows, worst_score_psi=psi,
                       worst_feature_psi=None if windows % 20 else psi / 2)
    return rec, reg


def _retention(pkg, tmp):
    rec, journal, reg = _world(pkg, tmp, max_bundles=3, min_interval_sec=0.0)
    reg.counter_inc("windows_total", 7, help="windows")
    journal.record("config", config_fingerprint="abc123")
    for i in range(6):
        rec.trigger("p99_breach", f"incident {i}", context={"i": i})
    return rec, reg


def _rate_limit_and_failed_dump(pkg, tmp):
    rec, journal, reg = _world(pkg, tmp, min_interval_sec=3600.0)
    tracer, rec._tracer = rec._tracer, _BrokenTracer()
    assert rec.trigger("p99_breach", "spike") is None  # failed, not consumed
    rec._tracer = tracer
    assert rec.trigger("p99_breach", "spike sustained") is not None
    assert rec.trigger("p99_breach", "still breaching") is None  # suppressed
    return rec, reg


def _exceptions(pkg, tmp):
    rec, journal, reg = _world(pkg, tmp, min_interval_sec=0.0)
    uninstall = pkg.flight.install_crash_handlers(rec)
    try:
        def die():
            raise ValueError("thread died at 2am")

        t = threading.Thread(target=die, name="scorer")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        try:
            raise RuntimeError("main thread died in the summary writer")
        except RuntimeError as e:
            pkg.recorder.journal_exception(journal, type(e), e, e.__traceback__, "main")
    finally:
        uninstall()
    t = threading.Thread(target=lambda: 1 / 0)  # uninstalled: not journaled
    t.start()
    t.join(timeout=10)
    return rec, reg


SCENARIOS = {
    "p99_breach": _p99,
    "drop_burst": _drop_burst,
    "veto_and_disagreement": _veto_and_disagreement,
    "quality_drift": _quality_drift,
    "retention": _retention,
    "rate_limit_and_failed_dump": _rate_limit_and_failed_dump,
    "exceptions": _exceptions,
}


def _bundle_summary(root: pathlib.Path) -> list:
    """Every entry under ``root``: a bundle's name without its time stamp,
    its files, its manifest without time and environment, its journal tail
    without times (paths under ``root`` written relative to it, a bundle's
    UTC stamp in a path written as ``<utc>``: the two packages' dumps may
    fall in two seconds)."""
    out = []
    for name in sorted(os.listdir(root)) if root.exists() else []:
        path = root / name
        if not name.startswith("bundle-"):
            out.append({"entry": name})
            continue
        man = json.loads((path / "manifest.json").read_text())
        for key in ("created_unix", "created_utc", "env"):
            man.pop(key)
        records = [_no_times(json.loads(line))
                   for line in (path / "journal.jsonl").read_text().splitlines()]
        quality = path / "quality.json"
        out.append({"bundle": name.split("-", 2)[2],
                    "files": sorted(os.listdir(path)), "manifest": man,
                    "records": records,
                    "quality": json.loads(quality.read_text()) if quality.exists() else None})
    text = json.dumps(out).replace(str(root), "<root>")
    return json.loads(re.sub(r"bundle-\d{8}T\d{6}-", "bundle-<utc>-", text))


def _scenario(name, pkg_name, tmp):
    root = tmp / pkg_name
    rec, reg = SCENARIOS[name](PKGS[pkg_name], root)
    rec.close()
    counts = {t: (reg.value("flight_bundles_total", labels={"trigger": t}),
                  reg.value("flight_triggers_suppressed_total", labels={"trigger": t}))
              for t in KNOWN_TRIGGERS}
    return _bundle_summary(root / "bundles"), counts


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_recorder_triggers_equal_the_references(name, tmp_path):
    got = _scenario(name, "port", tmp_path)
    assert got == _scenario(name, "ref", tmp_path)
    bundles = [b for b in got[0] if "bundle" in b]
    assert bundles, "every scenario leaves a bundle"
    for b in bundles:
        assert {"manifest.json", "journal.jsonl", "trace.json",
                "metrics.prom"} <= set(b["files"])
    assert not [b for b in got[0] if b.get("entry", "").endswith(".tmp")]
    want = {"p99_breach": 1, "drop_burst": 1, "veto_and_disagreement": 2,
            "quality_drift": 2, "retention": 3, "rate_limit_and_failed_dump": 1,
            "exceptions": 2}[name]
    assert len(bundles) == want


def test_manifest_environment_names_the_port(tmp_path):
    rec, _, _ = _world(PKGS["port"], tmp_path)
    path = rec.trigger("guardrail_veto", "v3 vetoed")
    rec.close()
    env = json.loads(pathlib.Path(path, "manifest.json").read_text())["env"]
    assert env["pid"] == os.getpid() and env["python"]
    assert env["torch_version"] and env["device"] == "cpu"
    assert not [k for k in env if k.startswith(("jax", "flax"))]


def test_profile_capture_is_refused_with_its_item(tmp_path):
    # the refusal is lifted with the device-time plane: the opt-in builds a
    # recorder, and the reference's default (no capture) stays
    rec = flight.FlightRecorder(flight.FlightConfig(out_dir=str(tmp_path),
                                                    profile_on_p99_sec=1.0))
    rec.close()
    assert flight.FlightConfig().profile_on_p99_sec == \
        jflight.FlightConfig().profile_on_p99_sec == 0.0


def _breach_while_scoring(tmp_path, profile_sec):
    """A p99 breach fired from a scorer thread that keeps scoring (a matmul
    a batch) until the recorder has closed; returns the one bundle."""
    import torch

    reg = MetricsRegistry(namespace="t")
    journal = flight.EventJournal(registry=reg)
    rec = flight.FlightRecorder(
        flight.FlightConfig(out_dir=str(tmp_path / "bundles"), p99_breach_sec=0.1,
                            p99_min_count=4, min_interval_sec=300.0,
                            profile_on_p99_sec=profile_sec),
        registry=reg, journal=journal)
    fired, done = threading.Event(), threading.Event()

    def scorer():
        a = torch.ones(16, 16)
        for _ in range(6):
            rec.observe_window("s0", "tid-1", 1.0)
        fired.set()
        while not done.wait(0.002):
            torch.mm(a, a)

    t = threading.Thread(target=scorer, name="scorer")
    t.start()
    try:
        assert fired.wait(30.0)
        rec.close()  # waits for the capture thread's bundle
    finally:
        done.set()
        t.join(timeout=30.0)
    assert not t.is_alive()
    bundles = sorted((tmp_path / "bundles").glob("bundle-*"))
    assert len(bundles) == 1 and bundles[0].name.endswith("p99_breach")
    return bundles[0], journal


def test_p99_bundle_embeds_a_torch_trace_of_the_scoring_thread(tmp_path):
    path, journal = _breach_while_scoring(tmp_path, 0.3)
    bundle = doctor.read_bundle(path)
    assert bundle["missing"] == []
    assert bundle["profile"]["files"] == 1 and bundle["profile"]["bytes"] > 0
    man = bundle["manifest"]["profile"]
    assert man["dir"] == "torch_trace" and man["seconds"] == 0.3
    (trace,) = (path / "torch_trace").iterdir()
    assert trace.name.endswith(".pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    # the scorer kept scoring while the profiler watched: its matmuls are in
    assert any(e.get("name") == "aten::mm" for e in events)
    kinds = [r.kind for r in bundle["records"]]
    assert "profile_capture" in kinds and "profile_failed" not in kinds
    report = doctor.format_report(bundle)
    assert "profiler trace: 1 file(s)" in report
    assert "bytes in torch_trace/ (0.3s capture on the breach)" in report


def test_p99_bundle_without_optin_has_no_trace(tmp_path):
    path, _ = _breach_while_scoring(tmp_path, 0.0)
    assert not (path / "torch_trace").exists()
    bundle = doctor.read_bundle(path)
    assert bundle["profile"] is None and bundle["manifest"]["profile"] is None
    assert "profiler trace:" not in doctor.format_report(bundle)


def test_profile_capture_failure_still_ships_the_bundle(tmp_path):
    import torch

    # another torch.profiler session is active: a second one would stop it
    # and record nothing, so the capture refuses to start
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        path, _ = _breach_while_scoring(tmp_path, 0.2)
    bundle = doctor.read_bundle(path)
    assert bundle["missing"] == [] and bundle["profile"] is None
    assert "error" in bundle["manifest"]["profile"]
    failed = [r for r in bundle["records"] if r.kind == "profile_failed"]
    assert len(failed) == 1 and failed[0].data["phase"] == "start"
    assert "already active" in failed[0].data["error"]
    assert "profiler trace: profiler capture failed" in doctor.format_report(bundle)


# -- the doctor ----------------------------------------------------------------------


class _Archive:
    def position(self):
        return {"dir": "/a", "segment": "seg-00000001.jsonl.open",
                "journal_seq": {"lo": 1, "hi": 9}}


def _rich_bundle(tmp):
    """One port bundle whose journal reaches every doctor section."""
    reg = MetricsRegistry(namespace="t")
    journal = flight.EventJournal(registry=reg)
    tracer = Tracer(registry=reg)
    slo = flight.SLOTracker(0.5, registry=reg, journal=journal)
    with tracer.span("serve_batch_close", bucket="256n/512e/128s"):
        pass
    journal.record("config", config_fingerprint="cfg123")
    journal.record("compile", program="serve", source="live", seconds=0.5)
    journal.record("batch_close", bucket="256n/512e/128s", cause="deadline",
                   occupancy=3, padding=5, trace_ids=["w-aaa", "w-bbb"])
    journal.record("admission_drop", stream="s1", window_id=7, trace_id="w-ccc",
                   reason="backpressure")
    journal.record("train_start", config_fingerprint="c", model_fingerprint="m",
                   steps=20, seed=1)
    journal.record("train_health", step=4, loss=0.5, grad_norm=1.5,
                   update_ratio=1e-3, steps_per_sec=3.0, data_wait_fraction=0.1,
                   nonfinite={"loss": 1.0})
    journal.record("plan_rejected", stream="s1", window_id=2, reason="no context")
    journal.record("fleet_shed", stream="s2", victim="s2", burn_ratio=0.9,
                   reason="pressure")
    journal.record("retrain_triggered", trigger_seq=7, parent_version=1,
                   replay_fingerprint="abcd1234")
    journal.record("retrain_done", trigger_seq=7, lineage="default", version=2,
                   parent_version=1, replay_fingerprint="abcd1234", edge_auc=0.93,
                   wall_sec=12.5, steps_per_sec=4.0)
    journal.record("alert_disposition", trace_id="w-aaa", label="tp")
    slo.observe("s1", "w-bbb", 2, stages={"queue": 0.4, "device": 0.3}, e2e_sec=0.8)
    quality = {"version": "v1", "windows_observed": 12, "margin_mass": 0.1,
               "reference": {"windows": 40, "node_scores": 900, "threshold": 0.5,
                             "margin_mass": 0.2, "margin_eps": 0.05},
               "per_stream": {"s1": {"windows": 12, "scores": 300, "score_psi": 0.31,
                                     "alert_rate_z": 2.5,
                                     "score_quantiles": {"p50": 0.1, "p90": 0.5,
                                                         "p99": 0.9}}},
               "features": {"nodes": {"psi": 0.2}, "edges": {"psi": 0.4}}}
    rec = flight.FlightRecorder(
        flight.FlightConfig(out_dir=str(tmp / "bundles")), registry=reg,
        journal=journal, tracer=tracer, slo=slo, quality=lambda: quality,
        archive=_Archive(), info=lambda: {"lineage": "default", "model_version": "v2"})
    path = rec.trigger("quality_drift", "PSI 0.31 >= 0.25", context={"windows": 12})
    rec.close()
    return path


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


def test_doctor_renders_a_bundle_as_the_reference_does(tmp_path):
    path = _rich_bundle(tmp_path)
    got = doctor.format_report(doctor.read_bundle(path))
    assert got == jdoctor.format_report(jdoctor.read_bundle(path))
    for section in ("incident timeline", "compile provenance", "per-stage attribution",
                    "SLO state", "detection quality", "training health:",
                    "fleet (controller", "respond (incident-response",
                    "learn (continuous-learning", "archive context"):
        assert section in got, section
    assert "1 triggered → 1 published" in got and "v1 → v2" in got
    rc, out, _ = _run(cli.main, ["doctor", path, "--json"])
    jrc, jout, _ = _run(jcli.main, ["doctor", path, "--json"])
    assert rc == jrc == 0 and json.loads(out) == json.loads(jout)
    rc, out, _ = _run(cli.main, ["doctor", path, "--tail", "3"])
    assert rc == 0 and out.strip() == doctor.format_report(
        doctor.read_bundle(path), tail=3)
    # quality show of a bundle: the doctor's drift table, as the reference's
    rc, out, _ = _run(cli.main, ["quality", "show", path])
    jrc, jout, _ = _run(jcli.main, ["quality", "show", path])
    assert rc == jrc == 0 and out == jout and "score_psi" in out
