"""The port's command line (``python -m nerrf_tpu_torch.cli``) against the
JAX package's (``nerrf_tpu.cli``), on the CPU.  The reference runs with
``--no-probe`` (its backend probe waits up to 75 s) and ``--planner host``
(no JAX compile of its device search); the port with ``--device cpu``.

* ``--help`` lists the reference's subcommands, in its order.
* ``simulate`` (``--files 4``, one seed, one incident path, the clock
  pinned because the simulator stamps wall-clock times): the victim tree,
  the snapshot store and ``trace.jsonl`` byte-equal; ``incident.json``
  equal but ``created`` and ``attack_seconds``.
* ``status``: the same JSON from both on an empty, an attacked, a planned
  and a recovered incident.
* ``undo`` (heuristic, and with a small converted checkpoint) on two copies
  of one incident: the flagged files equal (the detect log line and the
  heuristic's flagged set), the set of reverted paths in ``plan.json``
  equal, the restored victim trees equal file for file, ``report.json``
  verified.  The plan's action order is not compared: each CLI fits its
  own value net from its own init (flax's draws vs a ``torch.Generator``'s),
  and ``test_torch_planner.py`` shows the two planners agree under one
  value function, not under two fits.  The checkpoint's node head is biased
  to flag every file, so that the bfloat16 forwards of the two packages
  (the sidecar holds no dtype) cannot split a file at the cut.
* ``trace``: the port's table equals the reference's on the port's own
  ``--trace-out`` file, and both refuse an unreadable or empty file alike.
* ``serve`` + ``ingest`` over 127.0.0.1: every event comes back from the
  store unchanged.
* ``serve-detect --out``: the stream's detection equals the port's
  ``model_detect`` on the same trace, bit for bit (itself held against the
  reference by ``test_torch_serve.py`` and ``test_torch_pipeline.py``).
* ``respond --no-verify``: every plan unverified, with the reference's
  reason; ``RespondConfig`` has the reference's fields and defaults.
* Every unported subcommand and flag exits 2 naming its ROADMAP item; each
  tensor-touching subcommand raises without CUDA unless given
  ``--device cpu``.
* The device-time plane's lifted refusals: ``profile costs --smoke
  --no-train --json`` prints the reference's keys (the cross-check's two
  fields named for the profiler that fills them) and its serve FLOPs, with
  ``peaks`` and ``measured`` null on the CPU; ``profile capture`` writes a
  trace; ``serve-detect --profiler-port`` answers ``GET /capture`` in
  process and ``profile capture --target`` pulls from it;
  ``--profile-on-breach-sec`` reaches the flight recorder.
* The chaos and tune planes' lifted refusals: ``chaos sites`` prints the
  reference's catalog, ``chaos example`` the reference's plan less its
  compile-cache spec, ``chaos validate`` refuses that spec naming A.7;
  ``tune`` writes a loadable artifact and refuses an empty corpus;
  ``serve-detect --tuned`` serves the artifact's rung with its routing, bit
  for bit ``model_detect`` in the routed mode; ``--chaos-plan`` (over
  ``$NERRF_CHAOS_PLAN``) and ``$NERRF_CHAOS_PLAN`` arm a plan whose point
  fires, and disarm it when the command returns.
"""

import contextlib
import dataclasses
import hashlib
import inspect
import io
import json
import shutil
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from nerrf_tpu import cli as jcli
from nerrf_tpu.data import SimConfig as JSimConfig
from nerrf_tpu.data import simulate_trace as jsimulate_trace
from nerrf_tpu.models import JointConfig as JJointConfig
from nerrf_tpu.models import NerrfNet as JNerrfNet
from nerrf_tpu.respond import RespondConfig as JRespondConfig
from nerrf_tpu.respond import router as jrouter
from nerrf_tpu.serve.config import ServeConfig as JServeConfig
from nerrf_tpu.train import checkpoint as jck
from nerrf_tpu.train.data import windows_of_trace as jwindows_of_trace
from nerrf_tpu.train.loop import model_inputs as jmodel_inputs
from nerrf_tpu_torch import cli
from nerrf_tpu_torch.convert import flax_to_state_dict
from nerrf_tpu_torch.data import SimConfig, datasets, simulate_trace
from nerrf_tpu_torch.data.loaders import load_trace_jsonl
from nerrf_tpu_torch.graph import TraceStore
from nerrf_tpu_torch.ingest.service import TraceReplayServer
from nerrf_tpu_torch.models import JointConfig, build_nerrfnet
from nerrf_tpu_torch.pipeline import heuristic_detect, model_detect
from nerrf_tpu_torch.respond import RespondConfig
from nerrf_tpu_torch.schema.events import events_to_jsonl
from nerrf_tpu_torch.serve import ServeConfig
from nerrf_tpu_torch.train.checkpoint import save_checkpoint

FILES, SEED, SIMS = 4, 3, 32
BUCKET = (256, 512, 64)
EVENT_FIELDS = ("ts_ns", "pid", "tid", "comm_id", "syscall", "path_id",
                "new_path_id", "flags", "ret_val", "bytes", "inode", "mode",
                "uid", "gid", "valid")
UNVERIFIED = "verification disabled (cfg.verify=False) — plan is UNVERIFIED"


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread while a test runs (serve's scorer and the
    caller would oversubscribe a host shared by other test processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(main, argv):
    """(exit code, stdout, stderr) of one CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


def _tree(root):
    """relative path → sha256 of every file under ``root``."""
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _simulate(main, inc):
    rc, _, _ = _run(main, ["simulate", "--incident", inc, "--files", FILES,
                           "--seed", SEED])
    assert rc == 0


# -- the parser -----------------------------------------------------------------


def _subcommands(main):
    out = io.StringIO()
    with pytest.raises(SystemExit), contextlib.redirect_stdout(out):
        main(["--help"])
    text = out.getvalue()
    return text[text.index("{") + 1:text.index("}")].split(",")


def test_help_lists_the_reference_subcommands():
    want = _subcommands(jcli.main)
    assert _subcommands(cli.main) == want
    assert len(want) == 21


# -- simulate and status --------------------------------------------------------


def test_simulate_is_byte_equal_to_the_references(tmp_path, monkeypatch):
    inc = tmp_path / "inc"
    got = {}
    for name, main in (("ref", jcli.main), ("port", cli.main)):
        with monkeypatch.context() as m:
            m.setattr(time, "time_ns", lambda: 1_700_000_000_000_000_000)
            _simulate(main, inc)
        got[name] = ({p: (inc / p).read_bytes() for p in _tree(inc)},
                     json.loads((inc / "incident.json").read_text()))
        shutil.rmtree(inc)
    (files, meta), (jfiles, jmeta) = got["port"], got["ref"]
    assert sorted(files) == sorted(jfiles)
    assert any(p.startswith("store/manifests/") for p in files)
    assert sum(p.startswith("victim/") for p in files) == FILES + 1   # + the note
    for p in files:
        if p != "incident.json":
            assert files[p] == jfiles[p], p
    for k in ("created", "attack_seconds"):
        meta.pop(k), jmeta.pop(k)
    assert meta == jmeta and meta["files_encrypted"] == FILES
    # a second simulate into a seeded victim tree refuses, as the reference's
    _simulate(cli.main, inc)
    assert _run(cli.main, ["simulate", "--incident", inc])[0] == 2


@pytest.fixture(scope="module")
def undone(tmp_path_factory):
    """Two copies of one incident, undone by the reference's CLI (``ref``)
    and the port's (``port``), heuristic detection, the host planner."""
    root = tmp_path_factory.mktemp("undo")
    out = {}
    for name, main, extra in (
            ("ref", jcli.main, ["--no-probe"]),
            ("port", cli.main, ["--device", "cpu"])):
        inc = root / name
        _simulate(main, inc)
        rc, _, err = _run(main, ["undo", "--incident", inc, "--planner", "host",
                                 "--simulations", SIMS, *extra])
        out[name] = dict(inc=inc, rc=rc, log=err)
    return out


def _detect_line(log):
    return next(ln for ln in log.splitlines() if "detect[" in ln)


def _reverted(inc):
    plan = json.loads((inc / "plan.json").read_text())
    victim = inc / "victim"
    return {str(p.relative_to(victim)) for p in
            (type(victim)(a["target"]) for a in plan["actions"]
             if a["kind"] == "revert_file")}


def _assert_same_undo(port, ref):
    assert port["rc"] == ref["rc"] == 0
    assert _detect_line(port["log"]) == _detect_line(ref["log"])
    assert _reverted(port["inc"]) == _reverted(ref["inc"])
    assert _tree(port["inc"] / "victim") == _tree(ref["inc"] / "victim")
    for u in (port, ref):
        report = json.loads((u["inc"] / "report.json").read_text())
        assert report["verified"] and report["files_restored"] >= FILES
        assert json.loads((u["inc"] / "gate.json").read_text())["approved"]


def test_heuristic_undo_matches_the_references(undone):
    port, ref = undone["port"], undone["ref"]
    _assert_same_undo(port, ref)
    flagged = [sorted(p.rsplit("/", 1)[-1] for p in heuristic_detect(
        load_trace_jsonl(u["inc"] / "trace.jsonl")).flagged_files())
        for u in (port, ref)]
    assert flagged[0] == flagged[1] and len(flagged[0]) >= FILES


@pytest.fixture(scope="module")
def stages(tmp_path_factory, undone):
    """An incident directory at each state ``status`` tells apart; planned
    by the port's device search (its plain version on the CPU), traced."""
    root = tmp_path_factory.mktemp("status")
    _simulate(cli.main, root / "attacked")
    _simulate(cli.main, root / "planned")
    trace_out = root / "planned.trace.json"
    rc, _, _ = _run(cli.main, ["undo", "--incident", root / "planned", "--dry-run",
                               "--simulations", SIMS, "--device", "cpu",
                               "--trace-out", trace_out])
    assert rc == 0
    return {"empty": root / "nothing", "attacked": root / "attacked",
            "planned": root / "planned", "recovered": undone["port"]["inc"],
            "trace_out": trace_out}


@pytest.mark.parametrize("state", ["empty", "attacked", "planned", "recovered"])
def test_status_equals_the_references(stages, state):
    got = [_run(main, ["status", "--incident", stages[state]])
           for main in (cli.main, jcli.main)]
    assert got[0] == got[1]
    assert got[0][0] == 0 and json.loads(got[0][1])["state"] == state


def test_model_undo_matches_the_references(tmp_path):
    # the reference's untrained small model, its init jitted (eager, the
    # Pallas interpret-mode init takes 20 s on the CPU)
    jc = JJointConfig().small
    sample = jwindows_of_trace(
        jsimulate_trace(JSimConfig(duration_sec=20.0, attack=False,
                                   num_target_files=2, benign_rate_hz=4.0, seed=1)),
        JServeConfig(buckets=(BUCKET,)).dataset_config(BUCKET))[0]
    inputs = jmodel_inputs({k: np.asarray(v) for k, v in sample.items()})
    params = jax.device_get(jax.jit(lambda key: JNerrfNet(jc).init(
        key, *inputs, deterministic=True))(jax.random.PRNGKey(0))["params"])
    params["gnn"]["node_head"]["bias"] = params["gnn"]["node_head"]["bias"] + 20.0
    jck.save_checkpoint(tmp_path / "ref_model", params, jc)
    save_checkpoint(tmp_path / "port_model", flax_to_state_dict(params),
                    JointConfig().small)
    out = {}
    for name, main, extra in (
            ("ref", jcli.main, ["--no-probe"]),
            ("port", cli.main, ["--device", "cpu"])):
        inc = tmp_path / name
        _simulate(main, inc)
        rc, _, err = _run(main, ["undo", "--incident", inc, "--planner", "host",
                                 "--simulations", SIMS,
                                 "--model-dir", tmp_path / f"{name}_model", *extra])
        out[name] = dict(inc=inc, rc=rc, log=err)
    _assert_same_undo(out["port"], out["ref"])
    assert "detect[model[max]]" in _detect_line(out["port"]["log"])


# -- trace ----------------------------------------------------------------------


def test_trace_subcommand_equals_the_references(stages, tmp_path):
    path = stages["trace_out"]
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "mcts_plan" for e in events)
    got = _run(cli.main, ["trace", "--file", path])
    assert got == _run(jcli.main, ["trace", "--file", path])
    assert got[0] == 0 and "mcts_plan" in got[1]
    (tmp_path / "empty.json").write_text(json.dumps({"traceEvents": []}))
    (tmp_path / "bad.json").write_text("not json")
    for name, rc in (("empty.json", 1), ("bad.json", 2), ("missing.json", 2)):
        for main in (cli.main, jcli.main):
            assert _run(main, ["trace", "--file", tmp_path / name])[0] == rc


# -- serve, ingest, serve-detect, respond, warmup -------------------------------


@pytest.fixture(scope="module")
def small_trace(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace")
    tr = simulate_trace(SimConfig(duration_sec=40.0, attack=True, attack_start_sec=10.0,
                                  num_target_files=3, benign_rate_hz=5.0, seed=5))
    (root / "s5.jsonl").write_text(events_to_jsonl(tr.events, tr.strings))
    datasets.write_trace_csv(tr, root / "s5.csv")
    return tr, root


def _resolved(events, strings):
    out = {f: np.asarray(getattr(events, f)) for f in EVENT_FIELDS}
    for f in ("comm_id", "path_id", "new_path_id"):
        out[f] = [strings.lookup(int(i)) for i in out[f]]
    return out


def test_serve_and_ingest_return_every_event(small_trace, tmp_path, monkeypatch):
    tr, root = small_trace
    ports = []
    start = TraceReplayServer.start
    monkeypatch.setattr(TraceReplayServer, "start",
                        lambda self: ports.append(start(self)) or ports[-1])
    # `serve --duration 4` sleeps 4 s and then stops its server; ingest has
    # to connect and drain inside that window, and its first call builds
    # the native store library, which under load can outlast it.  The serve
    # thread's sleep waits instead for ingest to return (at most 120 s).
    ingested = threading.Event()

    class _Clock:
        def __getattr__(self, name):
            return getattr(time, name)

        @staticmethod
        def sleep(seconds):
            if threading.current_thread() is served:
                ingested.wait(120)
            else:
                time.sleep(seconds)

    monkeypatch.setattr(cli, "time", _Clock())
    rcs = []
    served = threading.Thread(target=lambda: rcs.append(cli.main([
        "serve", "--trace", str(root / "s5.csv"), "--address", "127.0.0.1:0",
        "--duration", "4", "--metrics-port", "-1"])))
    served.start()
    deadline = time.monotonic() + 30
    while not ports and time.monotonic() < deadline:
        time.sleep(0.02)
    assert ports, "the replay server did not start"
    try:
        rc, out, _ = _run(cli.main, ["ingest", "--target", f"127.0.0.1:{ports[0]}",
                                     "--store-dir", tmp_path / "store",
                                     "--metrics-port", "0"])
    finally:
        ingested.set()
    served.join(30)
    assert not served.is_alive() and rcs == [0]
    assert rc == 0
    summary = json.loads(out)
    n = int(tr.events.num_valid)
    assert summary["events"] == n and summary["segments_live"] > 0
    with TraceStore(tmp_path / "store") as st:
        got = st.query(0, 2 ** 63 - 1)
    assert int(got[0].num_valid) == n
    want = _resolved(tr.events, tr.strings)
    have = _resolved(*got)
    for f in EVENT_FIELDS:
        if isinstance(want[f], list):
            assert have[f][:n] == want[f][:n], f
        else:
            np.testing.assert_array_equal(have[f][:n], want[f][:n], err_msg=f)


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("model") / "m"
    save_checkpoint(path, build_nerrfnet(JointConfig().small, seed=0,
                                         device="cpu").state_dict(),
                    JointConfig().small)
    return path


def test_serve_detect_is_bit_equal_to_model_detect(small_trace, tiny_model_dir,
                                                   tmp_path):
    tr, root = small_trace
    rc, out, _ = _run(cli.main, [
        "serve-detect", "--device", "cpu", "--model-dir", tiny_model_dir,
        "--trace", root / "s5.jsonl", "--buckets", "x".join(map(str, BUCKET)),
        "--metrics-port", "-1", "--out", tmp_path / "out", "--no-aot-cache",
        "--no-probe"])
    assert rc == 0
    summary = json.loads(out)
    assert summary["recompiles_after_warmup"] == 0
    (stream, entry), = summary["streams"].items()
    assert entry["done"] and entry["error"] is None
    got = json.loads((tmp_path / "out" / f"detect_{stream.replace(':', '_')}.json")
                     .read_text())
    model = cli._load_model(tiny_model_dir, torch.device("cpu"))
    cfg = ServeConfig(buckets=(BUCKET,))
    want = model_detect(load_trace_jsonl(root / "s5.jsonl"), model,
                        ds_cfg=cfg.dataset_config(BUCKET), auto_capacity=False,
                        batch_size=cfg.batch_size, device="cpu")
    assert got["file_scores"] == want.file_scores
    assert got["proc_scores"] == {str(k): v for k, v in want.proc_scores.items()}
    assert got["threshold"] == want.threshold and got["detector"] == "serve[max]"
    assert (tmp_path / "out" / "alerts.jsonl").exists()


def test_respond_no_verify_surfaces_unverified_plans(tmp_path):
    # the reference's reason, as its router writes it
    src = inspect.getsource(jrouter.ResponseRouter)
    assert all(half in src for half in UNVERIFIED.split(" — "))
    rc, out, _ = _run(cli.main, ["respond", "--device", "cpu", "--family",
                                 "mass-rename", "--no-verify", "--sims", "16",
                                 "--work-dir", tmp_path])
    assert rc == 0
    report = json.loads(out)
    assert report["drained"] and report["stats"]["recompiles"] == 0
    (fam, plan), = report["families"].items()
    assert fam == "mass-rename" and not plan["verified"]
    assert plan["reason"] == UNVERIFIED and plan["actions"] > 0
    assert _run(cli.main, ["respond", "--device", "cpu", "--family", "nope"])[0] == 2


def test_respond_config_verify_round_trips():
    fields = [(f.name, f.default) for f in dataclasses.fields(RespondConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(JRespondConfig)]
    cfg = dataclasses.replace(RespondConfig(), verify=False)
    assert not cfg.verify and RespondConfig().verify
    assert dataclasses.replace(cfg, verify=True) == RespondConfig()


def test_warmup_on_the_cpu(tiny_model_dir):
    rc, out, _ = _run(cli.main, ["warmup", "--device", "cpu", "--no-probe",
                                 "--model-dir", tiny_model_dir,
                                 "--buckets", "x".join(map(str, BUCKET))])
    assert rc == 0
    got = json.loads(out)
    assert set(got) == {"detector", "planner_seconds", "wall_seconds"}
    assert list(got["detector"]) == ["256n/512e/64s"]


def test_train_detector_checks_its_traces_first(tmp_path):
    rc, _, err = _run(cli.main, ["train-detector", "--model-dir", tmp_path / "m",
                                 "--traces", "4", "--device", "cpu"])
    assert rc == 2 and "--traces must be" in err and not (tmp_path / "m").exists()


# -- what the port refuses, and the device rule ---------------------------------


@pytest.mark.parametrize("name", sorted(cli.UNPORTED_COMMANDS))
def test_unported_subcommands_exit_2_naming_their_item(name):
    item = cli.UNPORTED_COMMANDS[name][2]
    for argv in ([name], [name, "sub", "--flag", "x", "--json"]):
        rc, out, err = _run(cli.main, argv)
        assert rc == 2 and out == ""
        assert err.count("\n") == 1 and f"(ROADMAP {item})" in err


REFUSED_FLAGS = {
    "--aot-cache": ["train-detector", "--aot-cache", "C"],
    "sd --aot-cache": ["serve-detect", "--aot-cache", "C"],
    "models --aot": ["models", "publish", "--registry", "R", "--lineage", "l",
                     "--model-dir", "M", "--aot"],
    # with no bundle the reference runs its environment doctor (a JAX probe)
    "doctor": ["doctor", "--json"],
}


@pytest.mark.parametrize("flag", sorted(REFUSED_FLAGS))
def test_unported_flags_exit_2_naming_their_item(flag, tmp_path):
    argv = REFUSED_FLAGS[flag]
    if argv[0] == "train-detector":
        argv = argv + ["--model-dir", tmp_path / "m"]
    rc, out, err = _run(cli.main, argv)
    assert rc == 2 and out == ""
    assert err.count("\n") == 1 and flag.split()[-1] in err
    assert "(ROADMAP A.6)" in err or "(ROADMAP A.7)" in err
    assert not (tmp_path / "m").exists()


# -- the lifted refusals: the flight and learn planes' commands --------------------


def _replay_buffer(trace, out):
    from nerrf_tpu_torch.learn import ReplayConfig, ReplayWriter
    from nerrf_tpu_torch.observability import MetricsRegistry

    writer = ReplayWriter(ReplayConfig(out_dir=str(out)),
                          registry=MetricsRegistry(namespace="t"))
    t0 = int(trace.events.ts_ns[trace.events.valid].min())
    for i in range(3):
        lo, hi = t0 + i * 5_000_000_000, t0 + i * 5_000_000_000 + 15_000_000_000
        writer.observe_admit(f"t-{i}", "s0", i, lo, hi, trace.events, trace.strings)
        writer.observe_scored(SimpleNamespace(
            trace_id=f"t-{i}", stream="s0", bucket=BUCKET, model_version=1,
            node_mask=np.ones(4, bool), probs=np.full(4, 0.25, np.float32),
            nodes=4, edges=6, files=2))
    writer.close()


def _bundle_and_archive(root):
    from nerrf_tpu_torch.archive import ArchiveConfig, ArchiveWriter
    from nerrf_tpu_torch.flight import EventJournal, FlightConfig, FlightRecorder
    from nerrf_tpu_torch.observability import MetricsRegistry

    reg = MetricsRegistry(namespace="t")
    journal = EventJournal(registry=reg)
    archive = ArchiveWriter(ArchiveConfig(out_dir=str(root / "archive")),
                            registry=reg, journal=journal)
    rec = FlightRecorder(FlightConfig(out_dir=str(root / "flight")), registry=reg,
                         journal=journal, archive=archive)
    journal.record("admission_drop", stream="s0", window_id=1, reason="backpressure")
    bundle = rec.trigger("guardrail_veto", "v2 vetoed")
    rec.close()
    archive.close()
    return bundle, root / "archive"


def _health_run(tmp_path, monkeypatch, flag, value):
    """train-detector with one training-health flag; the trainer stands in
    (training is test_torch_train's): it sees the armed monitor, reports a
    non-finite loss, and returns no metrics, as a halted run does."""
    from nerrf_tpu_torch.train import loop

    seen = {}

    def stand_in(train_ds, eval_ds, cfg, log=None, monitor=None, device=None):
        seen.update(monitor=monitor, telemetry=cfg.telemetry, ready=monitor.ready()[0])
        monitor.observe_step(0, float("nan"))
        return SimpleNamespace(metrics={}, steps_per_sec=0.0, state=None)

    monkeypatch.setattr(loop, "train_nerrfnet", stand_in)
    rc, _, err = _run(cli.main, ["train-detector", "--model-dir", tmp_path / "m",
                                 "--traces", "6", "--device", "cpu", flag, value])
    assert rc == 1 and "halted without metrics" in err
    assert seen["monitor"] is not None and seen["telemetry"] and not seen["ready"]
    assert seen["monitor"].diverged is not None and not (tmp_path / "m").exists()


def _lifted_alerts(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    from nerrf_tpu_torch.learn import load_dispositions

    rc, out, _ = _run(cli.main, ["alerts", "label", "t-9", "tp", "--note", "exfil",
                                 "--replay-dir", tmp_path])
    assert rc == 0 and json.loads(out)["trace_id"] == "t-9"
    assert load_dispositions(tmp_path)["t-9"]["note"] == "exfil"


def _lifted_replay_export(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    _replay_buffer(small_trace[0], tmp_path / "replay")
    rc, out, _ = _run(cli.main, ["alerts", "label", "t-1", "tp", "--replay-dir",
                                 tmp_path / "replay"])
    assert rc == 0
    rc, out, _ = _run(cli.main, ["archive", "export", tmp_path / "replay", "--replay",
                                 "--seed", "1", "--batch-size", "2",
                                 "--out", tmp_path / "replay.npz"])
    doc = json.loads(out)
    assert rc == 0 and doc["stats"]["windows"] == 3 and doc["batches"] == 2
    assert doc["dataset"]["labeled_tp"] == 1 and doc["bucket"] == list(BUCKET)
    assert np.load(tmp_path / "replay.npz")["node_mask"].shape[0] == 3
    (tmp_path / "empty").mkdir()
    assert _run(cli.main, ["archive", "export", tmp_path / "empty", "--replay"])[0] == 1


def _lifted_doctor(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    bundle, archive = _bundle_and_archive(tmp_path)
    rc, out, _ = _run(cli.main, ["doctor", bundle])
    assert rc == 0 and "trigger=guardrail_veto" in out and "archive context" in out
    rc, out, _ = _run(cli.main, ["doctor", archive, "--json"])
    assert rc == 0 and json.loads(out)
    assert _run(cli.main, ["doctor", tmp_path / "nothing"])[0] == 2


def _lifted_metrics_port(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    _health_run(tmp_path, monkeypatch, "--metrics-port", "0")


def _lifted_flight_dir(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    _health_run(tmp_path, monkeypatch, "--flight-dir", tmp_path / "flight")
    [bundle] = [p for p in (tmp_path / "flight").iterdir() if p.name.startswith("bundle-")]
    rc, out, _ = _run(cli.main, ["doctor", bundle])
    assert rc == 0 and "trigger=train_divergence" in out and "training health:" in out


def _lifted_archive_dir(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    from nerrf_tpu_torch.archive import is_archive_dir

    _health_run(tmp_path, monkeypatch, "--archive-dir", tmp_path / "archive")
    assert is_archive_dir(tmp_path / "archive")
    assert _run(cli.main, ["report", tmp_path / "archive", "--json"])[0] == 0


def _lifted_serve_flight_dir(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    import sys

    hooks = (sys.excepthook, threading.excepthook)
    rc, out, _ = _run(cli.main, [
        "serve-detect", "--device", "cpu", "--model-dir", tiny_model_dir,
        "--trace", small_trace[1] / "s5.jsonl", "--buckets", "x".join(map(str, BUCKET)),
        "--metrics-port", "-1", "--flight-dir", tmp_path / "flight"])
    assert rc == 0 and json.loads(out)["windows_scored"] > 0
    assert (tmp_path / "flight" / "faulthandler.log").exists()
    assert (sys.excepthook, threading.excepthook) == hooks  # uninstalled


def _lifted_profile(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    from nerrf_tpu import serve as jserve

    monkeypatch.setenv("NERRF_NO_COMPILE_CACHE", "1")
    # the reference's untrained params as shapes: its cost table is a shape
    # trace, and its eager init would run the model op by op
    real_init = jserve.init_untrained_params
    monkeypatch.setattr(jserve, "init_untrained_params", lambda model, cfg, seed=0:
                        jax.eval_shape(lambda: real_init(model, cfg, seed)))
    rc, out, _ = _run(cli.main, ["profile", "costs", "--smoke", "--no-train", "--json",
                                 "--device", "cpu"])
    jrc, jout, _ = _run(jcli.main, ["profile", "costs", "--smoke", "--no-train",
                                    "--json", "--no-probe"])
    assert rc == jrc == 0
    got, want = json.loads(out), json.loads(jout)
    assert set(got) == set(want)
    assert got["backend"] == want["backend"] == "cpu"
    assert got["peaks"] is None and want["peaks"] is None
    assert set(got["programs"]) == set(want["programs"]) == {"serve_eval[64n/128e/32s]"}
    (row,), (jrow,) = got["programs"].values(), want["programs"].values()
    # the reference's XLA cross-check fields, named for what fills the port's
    renamed = {"xla_flops": "profiler_flops", "xla_bytes": "profiler_device_sec"}
    assert set(row) == {renamed.get(k, k) for k in jrow}
    assert row["flops"] == jrow["flops"] == 986497024.0
    assert row["measured"] is None and jrow["measured"] is None
    assert row["profiler_flops"] is None and row["profiler_device_sec"] is None
    rc, out, _ = _run(cli.main, ["profile", "capture", "--smoke", "--seconds", "0.1",
                                 "--device", "cpu", "--out", tmp_path / "cap"])
    assert rc == 0 and json.loads(out)["files"] == 1
    (trace,) = (tmp_path / "cap").iterdir()
    assert any(e.get("name", "").startswith("aten::")
               for e in json.loads(trace.read_text())["traceEvents"])


def _lifted_profiler_port(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    from nerrf_tpu_torch.devtime import capture

    answers = {}

    class Answering(capture.ProfilerServer):
        """The serve pod's capture server, asked for a capture while the
        pod boots and scores (a thread of its own, joined on close)."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            answers["host"] = k.get("host")
            self._asker = threading.Thread(target=self._ask)
            self._asker.start()

        def _ask(self):
            answers["trace"] = capture.fetch_capture(f"127.0.0.1:{self.port}", 0.2,
                                                     tmp_path / "pulled")

        def close(self):
            self._asker.join(timeout=60.0)
            super().close()

    monkeypatch.setattr(capture, "ProfilerServer", Answering)
    rc, out, _ = _run(cli.main, [
        "serve-detect", "--device", "cpu", "--model-dir", tiny_model_dir,
        "--trace", small_trace[1] / "s5.jsonl", "--buckets", "x".join(map(str, BUCKET)),
        "--metrics-port", "-1", "--profiler-port", "0"])
    assert rc == 0 and json.loads(out)["windows_scored"] > 0
    assert answers["host"] == "0.0.0.0"
    assert json.loads(open(answers["trace"]).read())["traceEvents"]
    # the client side: profile capture --target against a capture server
    with capture.ProfilerServer(port=0) as srv:
        rc, out, _ = _run(cli.main, ["profile", "capture", "--target",
                                     f"127.0.0.1:{srv.port}", "--seconds", "0.1",
                                     "--out", tmp_path / "target"])
        assert rc == 0 and json.loads(out)["files"] == 1
        rc, _, err = _run(cli.main, ["profile", "capture", "--target",
                                     f"127.0.0.1:{srv.port}", "--seconds", "0",
                                     "--out", tmp_path / "bad"])
        assert rc == 1 and "HTTP Error 400" in err


def _lifted_profile_on_breach(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    from nerrf_tpu_torch import flight

    seen = []

    class Spy(flight.FlightRecorder):
        def __init__(self, cfg, *a, **k):
            seen.append(cfg)
            super().__init__(cfg, *a, **k)

    monkeypatch.setattr(flight, "FlightRecorder", Spy)
    rc, out, err = _run(cli.main, [
        "serve-detect", "--device", "cpu", "--model-dir", tiny_model_dir,
        "--trace", small_trace[1] / "s5.jsonl", "--buckets", "x".join(map(str, BUCKET)),
        "--metrics-port", "-1", "--flight-dir", tmp_path / "flight",
        "--profile-on-breach-sec", "0.5"])
    assert rc == 0 and json.loads(out)["windows_scored"] > 0
    assert [c.profile_on_p99_sec for c in seen] == [0.5]
    assert "+0.5s profiler trace per p99 breach" in err


def _lifted_chaos(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    rc, out, _ = _run(cli.main, ["chaos", "sites", "--json"])
    jrc, jout, _ = _run(jcli.main, ["chaos", "sites", "--json"])
    assert rc == jrc == 0 and out == jout and len(json.loads(out)) == 11
    rc, out, _ = _run(cli.main, ["chaos", "sites"])
    assert rc == 0 and out == _run(jcli.main, ["chaos", "sites"])[1]
    # the example is the reference's less its compile-cache spec (A.7)
    rc, out, _ = _run(cli.main, ["chaos", "example"])
    want = json.loads(_run(jcli.main, ["chaos", "example"])[1])
    dropped = [f for f in want["faults"] if f["site"] == "compilecache.corrupt_payload"]
    assert rc == 0 and len(dropped) == 1
    assert json.loads(out) == dict(want, faults=[f for f in want["faults"]
                                                 if f not in dropped])
    (tmp_path / "ex.json").write_text(out)
    rc, out, _ = _run(cli.main, ["chaos", "validate", tmp_path / "ex.json"])
    assert rc == 0 and json.loads(out)["valid"] and json.loads(out)["faults"] == 3
    (tmp_path / "ref.json").write_text(json.dumps(want))
    rc, _, err = _run(cli.main, ["chaos", "validate", tmp_path / "ref.json"])
    assert rc == 1 and "INVALID" in err and "ROADMAP A.7" in err and err.count("\n") == 1
    (tmp_path / "bad.json").write_text('{"faults": [{"site": "nope", "at": 1}]}')
    assert _run(cli.main, ["chaos", "validate", tmp_path / "bad.json"])[0] == 1


def _golden_corpus():
    from test_tune import golden_corpus

    return golden_corpus()


def _lifted_tune(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    from nerrf_tpu_torch.tune import load_artifact, tune

    corpus = tmp_path / "corpus.json"
    corpus.write_text(json.dumps(_golden_corpus()))
    rc, out, _ = _run(cli.main, ["tune", corpus, "--out", tmp_path / "t.json",
                                 "--model-dir", tiny_model_dir, "--max-rungs", "2"])
    art = load_artifact(tmp_path / "t.json")
    assert rc == 0 and out == "" and len(art["buckets"]) <= 2
    assert art["fit"]["hidden"] == JointConfig().small.gnn.hidden
    # the default ladder's four graph rungs, traced on meta
    assert art["fit"]["analytic_points"] == 4
    (tmp_path / "empty.json").write_text(json.dumps(dict(_golden_corpus(),
                                                         windows_observed=0)))
    rc, _, err = _run(cli.main, ["tune", tmp_path / "empty.json"])
    assert rc == 1 and "refusing to tune" in err
    rc, out, _ = _run(cli.main, ["tune", corpus])
    assert rc == 0 and json.loads(out) == tune(_golden_corpus())


def _lifted_tuned(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    from nerrf_tpu_torch.tune import build_artifact, save_artifact

    save_artifact(tmp_path / "t.json", build_artifact(
        (BUCKET,), ((BUCKET[0], "segment"),), {}, {}))
    rc, out, err = _run(cli.main, [
        "serve-detect", "--device", "cpu", "--model-dir", tiny_model_dir,
        "--trace", small_trace[1] / "s5.jsonl", "--buckets", "1024x2048x128",
        "--metrics-port", "-1", "--tuned", tmp_path / "t.json",
        "--out", tmp_path / "out"])
    assert rc == 0 and json.loads(out)["windows_scored"] > 0
    assert "tuned ladder from" in err and "[[256, 'segment']]" in err
    # the tuned rung replaced --buckets, and the routing reached the model:
    # the stream's detection is model_detect's at that rung in segment mode
    model = cli._load_model(tiny_model_dir, torch.device("cpu"))
    seg = build_nerrfnet(dataclasses.replace(model.cfg, gnn=dataclasses.replace(
        model.cfg.gnn, aggregation="segment")), device="cpu")
    seg.load_state_dict(model.state_dict())
    want = model_detect(load_trace_jsonl(small_trace[1] / "s5.jsonl"), seg.eval(),
                        ds_cfg=ServeConfig(buckets=(BUCKET,)).dataset_config(BUCKET),
                        auto_capacity=False, batch_size=8, device="cpu")
    [got] = (tmp_path / "out").glob("detect_*.json")
    assert json.loads(got.read_text())["file_scores"] == want.file_scores
    (tmp_path / "bad.json").write_text("{}")
    rc, _, err = _run(cli.main, ["serve-detect", "--device", "cpu", "--tuned",
                                 tmp_path / "bad.json", "--metrics-port", "-1"])
    assert rc == 2 and "not a tuned-ladder artifact" in err


def _chaos_serve(tmp_path, small_trace, tiny_model_dir, *extra):
    from nerrf_tpu_torch import chaos
    from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

    site = {"site": "serve.device_latency"}
    before = DEFAULT_REGISTRY.value("chaos_faults_injected_total", labels=site)
    rc, out, err = _run(cli.main, [
        "serve-detect", "--device", "cpu", "--model-dir", tiny_model_dir,
        "--trace", small_trace[1] / "s5.jsonl", "--buckets", "x".join(map(str, BUCKET)),
        "--metrics-port", "-1", *extra])
    assert rc == 0 and json.loads(out)["windows_scored"] > 0
    assert "chaos: armed 1 fault spec(s)" in err
    assert DEFAULT_REGISTRY.value("chaos_faults_injected_total", labels=site) > before
    assert not chaos.armed()  # disarmed when the command returned


def _latency_plan(path):
    path.write_text(json.dumps({"seed": 3, "faults": [
        {"site": "serve.device_latency", "mode": "stall", "every": 1,
         "delay_sec": 0.01}]}))
    return path


def _lifted_chaos_plan(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    # --chaos-plan wins over the environment's plan
    monkeypatch.setenv("NERRF_CHAOS_PLAN", str(tmp_path / "missing.json"))
    _chaos_serve(tmp_path, small_trace, tiny_model_dir,
                 "--chaos-plan", _latency_plan(tmp_path / "p.json"))
    (tmp_path / "bad.json").write_text('{"faults": [{"site": "serve.device_latency", '
                                       '"at": 1}]}')
    rc, _, err = _run(cli.main, ["serve-detect", "--device", "cpu", "--chaos-plan",
                                 tmp_path / "bad.json", "--metrics-port", "-1"])
    assert rc == 2 and "INVALID" in err and err.count("\n") == 1


def _lifted_chaos_env(tmp_path, monkeypatch, small_trace, tiny_model_dir):
    monkeypatch.setenv("NERRF_CHAOS_PLAN", str(_latency_plan(tmp_path / "p.json")))
    _chaos_serve(tmp_path, small_trace, tiny_model_dir)


LIFTED = {
    "alerts": _lifted_alerts,
    "chaos": _lifted_chaos,
    "tune": _lifted_tune,
    "sd --tuned": _lifted_tuned,
    "sd --chaos-plan": _lifted_chaos_plan,
    "$NERRF_CHAOS_PLAN": _lifted_chaos_env,
    "archive --replay": _lifted_replay_export,
    "doctor": _lifted_doctor,
    "--metrics-port": _lifted_metrics_port,
    "--flight-dir": _lifted_flight_dir,
    "--archive-dir": _lifted_archive_dir,
    "sd --flight-dir": _lifted_serve_flight_dir,
    "profile": _lifted_profile,
    "--profiler-port": _lifted_profiler_port,
    "--profile-on-breach-sec": _lifted_profile_on_breach,
}


@pytest.mark.parametrize("name", sorted(LIFTED))
def test_lifted_commands_run(name, tmp_path, monkeypatch, small_trace, tiny_model_dir):
    """The subcommands and flags the flight, learn, device-time, chaos and
    tune planes lifted from the refusal tables run and exit as the
    reference's do."""
    assert name not in cli.UNPORTED_COMMANDS
    assert not [f for c, f, *_ in cli.UNPORTED_FLAGS if f"{c} {f}".endswith(name)]
    LIFTED[name](tmp_path, monkeypatch, small_trace, tiny_model_dir)


def test_unknown_arguments_of_a_ported_subcommand_stay_an_error():
    with pytest.raises(SystemExit):
        cli.main(["status", "--incident", "x", "--bogus"])


TENSOR_COMMANDS = {
    "train-detector": lambda p: ["train-detector", "--model-dir", p / "m"],
    "undo": lambda p: ["undo", "--incident", p / "inc"],
    "warmup": lambda p: ["warmup"],
    "serve-detect": lambda p: ["serve-detect", "--trace", p / "t.jsonl",
                               "--metrics-port", "-1"],
    "respond": lambda p: ["respond", "--work-dir", p / "w"],
}


@pytest.mark.parametrize("name", sorted(TENSOR_COMMANDS))
def test_tensor_subcommands_raise_without_cuda(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([str(a) for a in TENSOR_COMMANDS[name](tmp_path)])
    assert not any(tmp_path.iterdir())
