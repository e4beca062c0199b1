"""The port's rollback path (nerrf_tpu_torch.rollback, pipeline.build_undo_domain)
against the JAX package's, on the CPU.

The rollback modules are host copies: on one seeded M0 incident
(``run_recovery_bench``'s 25 files of 300-700 KB), driven once through each
package in the same directory, the seeded bytes, the snapshot manifest, the
attack's trace arrays (timestamps relative to the first event: the
simulator stamps them from the wall clock), the detection, the undo domain,
the plan (the device search with the heuristic value: the port's plain
version against the reference's XLA program), the sandbox gate's result and
the executor's report (durations aside) are the same.  The port's undo run
is verified, loses no byte and reverts no clean file.
"""

import pathlib
import shutil

import numpy as np
import pytest

import nerrf_tpu.pipeline as jpipeline
import nerrf_tpu.planner as jplanner
import nerrf_tpu.rollback as jrollback
import nerrf_tpu.rollback.filesim as jfilesim
import nerrf_tpu_torch.pipeline as pipeline
import nerrf_tpu_torch.planner as planner
import nerrf_tpu_torch.rollback as rollback
import nerrf_tpu_torch.rollback.filesim as filesim
from nerrf_tpu_torch.rollback.sandbox import FirecrackerDriver

M0 = dict(num_files=25, min_file_bytes=300_000, max_file_bytes=700_000)
SIMS = 200
TIMINGS = ("duration_seconds", "files_per_sec", "mb_per_sec")


def _undo(tmp, pipe, plan_mod, rb, fsim, kind):
    """seed → snapshot → attack → detect → domain → plan → gate → execute
    in ``tmp/victim``, the recovery bench's order; returns what each step
    gave and the victim's files before the attack."""
    victim = tmp / "victim"
    if victim.exists():
        shutil.rmtree(victim)
    cfg = rb.FileSimConfig(**M0)
    fsim.seed_files(victim, cfg)
    originals = {p.name: p.read_bytes() for p in victim.iterdir()}
    store = rb.SnapshotStore(tmp / f"store-{kind}")
    manifest = store.snapshot(victim, "pre-attack")
    trace, encrypted = rb.run_file_attack(victim, cfg)
    detection = pipe.heuristic_detect(trace)
    domain = pipe.build_undo_domain(detection, manifest, root=str(victim))
    kw = {} if kind == "ref" else {"device": "cpu"}
    plan = plan_mod.make_planner(domain, None, plan_mod.MCTSConfig(num_simulations=SIMS),
                                 kind="device", **kw).plan()
    before = sorted(p.name for p in victim.iterdir())
    gate = rb.SandboxGate(store, manifest).rehearse(plan, victim, trace=trace)
    untouched = sorted(p.name for p in victim.iterdir()) == before
    report = rb.RollbackExecutor(store, manifest, victim).execute(plan)
    residual = store.diff(manifest, victim)
    return dict(originals=originals, manifest=manifest, trace=trace, encrypted=encrypted,
                detection=detection, domain=domain, plan=plan, gate=gate,
                untouched=untouched, report=report, residual=residual, victim=victim)


def _no_timing(d):
    return {k: v for k, v in d.items() if k not in TIMINGS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("m0")
    ref = _undo(tmp, jpipeline, jplanner, jrollback, jfilesim, "ref")
    port = _undo(tmp, pipeline, planner, rollback, filesim, "port")
    return ref, port


def test_seeded_files_and_manifest_equal(runs):
    ref, port = runs
    assert port["originals"] == ref["originals"] and len(port["originals"]) == 25
    m, jm = port["manifest"], ref["manifest"]
    assert m.files == jm.files and m.root == jm.root


def test_attack_trace_arrays_equal(runs):
    ref, port = runs
    ev, jev = port["trace"].events, ref["trace"].events
    cols, jcols = ev.columns(), jev.columns()
    assert set(cols) == set(jcols)
    for k in cols:
        got, want = cols[k], jcols[k]
        if k == "ts_ns":
            got, want = got - got[0], want - want[0]
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert list(port["trace"].strings.strings()) == list(ref["trace"].strings.strings())
    np.testing.assert_array_equal(port["trace"].labels, ref["trace"].labels)
    assert [p.name for p in port["encrypted"]] == [p.name for p in ref["encrypted"]]


def test_detection_domain_and_plan_equal(runs):
    ref, port = runs
    assert port["detection"].file_scores == ref["detection"].file_scores
    assert port["detection"].proc_scores == ref["detection"].proc_scores
    d, jd = port["domain"], ref["domain"]
    assert d.file_paths == jd.file_paths and d.proc_names == jd.proc_names
    for name in ("file_scores", "file_loss_mb", "proc_scores"):
        np.testing.assert_array_equal(getattr(d, name), getattr(jd, name))
    key = lambda p: [(a.kind.name, a.target, a.score, a.loss_mb) for a in p.actions]  # noqa: E731
    assert key(port["plan"]) == key(ref["plan"])
    assert port["plan"].rollouts == ref["plan"].rollouts == SIMS


def test_gate_and_report_equal(runs):
    ref, port = runs
    g, jg = port["gate"].to_dict(), ref["gate"].to_dict()
    g["rehearsal"], jg["rehearsal"] = _no_timing(g["rehearsal"]), _no_timing(jg["rehearsal"])
    assert g == jg
    assert _no_timing(port["report"].to_dict()) == _no_timing(ref["report"].to_dict())
    assert port["report"].details == ref["report"].details


def test_port_undo_run_verified_without_loss(runs):
    _, port = runs
    assert port["gate"].approved, port["gate"].reason
    assert port["untouched"]  # the gate rehearsed on a clone
    rep = port["report"]
    assert rep.verified and rep.files_failed == 0 and rep.files_restored == 25
    assert port["residual"] == {"README_LOCKBIT.txt": "extra"}
    for name, data in port["originals"].items():
        assert (port["victim"] / name).read_bytes() == data
    attacked = {e.name[: -len(".lockbit3")] for e in port["encrypted"]}
    restored = [d["target"] for d in rep.details if d["result"] == "restored"]
    assert all(p.rsplit("/", 1)[-1] in attacked for p in restored)


_STUB_FIRECRACKER = """#!{python}
import http.server, json, socketserver, sys

sock = sys.argv[sys.argv.index("--api-sock") + 1]
log = open({log!r}, "a")


class Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _answer(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n).decode() if n else ""
        log.write(json.dumps([self.command, self.path,
                              json.loads(body) if body else None]) + "\\n")
        log.flush()
        self.send_response(204)
        self.send_header("Content-Length", "0")
        self.send_header("Connection", "close")
        self.end_headers()

    do_GET = do_PUT = do_PATCH = _answer

    def log_message(self, *a):
        pass


class Server(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
    def get_request(self):
        return super().get_request()[0], ("127.0.0.1", 0)


Server(sock, Handler).serve_forever()
"""


def test_firecracker_driver_gated(tmp_path):
    import json
    import sys

    assert not FirecrackerDriver.available()
    with pytest.raises(RuntimeError):
        FirecrackerDriver().rehearse()
    # boot_clone against a stub `firecracker` that serves the API on
    # --api-sock: the reference's sequence (machine-config, boot-source, the
    # rootfs drive, InstanceStart), and its bodies
    stub, log = tmp_path / "firecracker", tmp_path / "calls.jsonl"
    stub.write_text(_STUB_FIRECRACKER.format(python=sys.executable, log=str(log)))
    stub.chmod(0o755)
    driver = FirecrackerDriver(firecracker_bin=str(stub), kernel_image="/img/vmlinux",
                               api_socket=str(tmp_path / "fc.sock"))
    proc, api = driver.boot_clone("/img/rootfs.ext4", vcpus=2, mem_mib=512,
                                  socket_wait_sec=30.0)
    try:
        calls = [tuple(json.loads(line)) for line in log.read_text().splitlines()]
    finally:
        proc.kill()
        proc.wait()
    assert calls == [
        ("PUT", "/machine-config", {"vcpu_count": 2, "mem_size_mib": 512}),
        ("PUT", "/boot-source", {"kernel_image_path": "/img/vmlinux",
                                 "boot_args": "console=ttyS0 reboot=k panic=1"}),
        ("PUT", "/drives/rootfs", {"drive_id": "rootfs", "path_on_host": "/img/rootfs.ext4",
                                   "is_root_device": True, "is_read_only": False}),
        ("PUT", "/actions", {"action_type": "InstanceStart"}),
    ]
    assert api.socket_path == str(tmp_path / "fc.sock")
    # the driver is the reference's, the package name aside
    port_src = pathlib.Path(rollback.sandbox.__file__).read_text()
    ref_src = pathlib.Path(jrollback.sandbox.__file__).read_text()
    tail = "class FirecrackerDriver"
    assert (port_src[port_src.index(tail):].replace("nerrf_tpu_torch", "nerrf_tpu")
            == ref_src[ref_src.index(tail):])
    with pytest.raises(ValueError, match="kernel_image"):
        FirecrackerDriver().boot_clone("rootfs.img")


def test_gate_replay_catches_untraced_side_effect(tmp_path):
    cfg = rollback.FileSimConfig(num_files=6, min_file_bytes=4096, max_file_bytes=16384)
    victim = tmp_path / "v"
    filesim.seed_files(victim, cfg)
    store = rollback.SnapshotStore(tmp_path / "store")
    m = store.snapshot(victim, "pre")
    trace, encrypted = rollback.run_file_attack(victim, cfg)
    encrypted[0].unlink()  # off-trace
    plan = planner.UndoPlan(
        actions=[planner.UndoAction(planner.ActionKind.REVERT_FILE, str(p), 0.95)
                 for p in encrypted[1:]],
        expected_reward=1.0, rollouts=0, rollouts_per_sec=0.0, planning_seconds=0.0)
    gate = rollback.SandboxGate(store, m).rehearse(plan, victim, trace=trace)
    assert not gate.approved
    assert any("missing-from-victim" in v for v in gate.replay_divergence.values())
