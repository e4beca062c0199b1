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
    rcs = []
    served = threading.Thread(target=lambda: rcs.append(cli.main([
        "serve", "--trace", str(root / "s5.csv"), "--address", "127.0.0.1:0",
        "--duration", "4", "--metrics-port", "-1"])))
    served.start()
    deadline = time.monotonic() + 30
    while not ports and time.monotonic() < deadline:
        time.sleep(0.02)
    assert ports, "the replay server did not start"
    rc, out, _ = _run(cli.main, ["ingest", "--target", f"127.0.0.1:{ports[0]}",
                                 "--store-dir", tmp_path / "store",
                                 "--metrics-port", "0"])
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
    "--publish": ["train-detector", "--publish", "R"],
    "--aot-cache": ["train-detector", "--aot-cache", "C"],
    "--metrics-port": ["train-detector", "--metrics-port", "0"],
    "--flight-dir": ["train-detector", "--flight-dir", "F"],
    "--archive-dir": ["train-detector", "--archive-dir", "A"],
    "sd --registry": ["serve-detect", "--registry", "R"],
    "sd --tuned": ["serve-detect", "--tuned", "T"],
    "sd --flight-dir": ["serve-detect", "--flight-dir", "F"],
    "sd --archive-dir": ["serve-detect", "--archive-dir", "A"],
    "sd --chaos-plan": ["serve-detect", "--chaos-plan", "P"],
    "sd --profiler-port": ["serve-detect", "--profiler-port", "9000"],
    "sd --profile-on-breach-sec": ["serve-detect", "--profile-on-breach-sec", "2"],
    "sd --aot-cache": ["serve-detect", "--aot-cache", "C"],
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


def test_chaos_plan_from_the_environment_is_refused(monkeypatch):
    monkeypatch.setenv("NERRF_CHAOS_PLAN", "plan.json")
    rc, _, err = _run(cli.main, ["serve-detect", "--device", "cpu"])
    assert rc == 2 and "$NERRF_CHAOS_PLAN" in err and "(ROADMAP A.6)" in err
    # unknown arguments of a ported subcommand stay an error
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
