"""The port's respond tier (nerrf_tpu_torch.respond: config, incidents,
verify, router, scenarios) and its chaos plan copy (nerrf_tpu_torch.chaos)
against the JAX package's, on the CPU (the search kernel's plain version).

* ``hash01``, ``corrupt_payload``, ``schedule`` and the fault-plan JSON are
  equal; the reference's recorded plans parse to the same dicts.
* ``stage_incident`` writes the same files (names and sha256) and emits the
  same events and strings for each family (wall clock pinned, roots
  stripped).
* ``Incident.from_alert`` / ``from_detection`` build equal domains; the
  incident queue evicts and journals alike.
* The routers, each fed the four families and the no-context incident
  before ``start()`` (so nothing depends on arrival timing), plan the same
  actions and rewards in one wave and verify or reject alike.
"""

import hashlib
import json
import pathlib
import time

import numpy as np
import pytest
import torch

from nerrf_tpu import chaos as jchaos
from nerrf_tpu.flight.journal import EventJournal as JEventJournal
from nerrf_tpu.observability import MetricsRegistry as JMetricsRegistry
from nerrf_tpu.pipeline import heuristic_detect as jheuristic_detect
from nerrf_tpu import respond as jrespond
from nerrf_tpu.serve.alerts import WindowAlert as JWindowAlert
from nerrf_tpu_torch import chaos
from nerrf_tpu_torch import respond
from nerrf_tpu_torch.flight.journal import EventJournal
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.pipeline import heuristic_detect
from nerrf_tpu_torch.planner import MCTSConfig
from nerrf_tpu_torch.serve.alerts import WindowAlert

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = 6        # the reference bench's files per staged incident
SEED = 11        # its family seed; the no-context incident uses 23
# one slot above the wave, so one search program a package; the queue is
# filled before start(), so the whole corpus is one wave
CFG = dict(num_simulations=32, batch_close_sec=0.05, batch_slots=(8,))
NO_CONTEXT = "no snapshot context bound for this stream — cannot replay"


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


# -- chaos/plan.py ------------------------------------------------------------


def test_hash01_and_corrupt_payload_equal():
    keys = [f"t-{i}" for i in range(1000)]
    for seed, site in ((0, "respond.family"), (7, "respond.at"), (42, "x")):
        got = [chaos.hash01(seed, site, k) for k in keys]
        assert got == [jchaos.plan.hash01(seed, site, k) for k in keys]
    payload = bytes(range(256)) * 5
    for flip in (1, 16, 4096):
        assert chaos.corrupt_payload(payload, 3, "s", flip) == \
            jchaos.corrupt_payload(payload, 3, "s", flip)
    assert chaos.corrupt_payload(b"", 3, "s") == b""


def _plan_fixtures():
    """The reference's own plans: its chaos bench record, the plan schema
    in its docs and the one in its module docstring."""
    bench = json.loads((ROOT / "benchmarks" / "results" /
                        "chaos_bench_cpu.json").read_text())["plan"]
    doc = (ROOT / "docs" / "chaos.md").read_text()
    block = doc.split("```json", 1)[1].split("```", 1)[0]
    src = (ROOT / "nerrf_tpu" / "chaos" / "plan.py").read_text()
    example = src.split("replayable:\n", 1)[1].split("\n\nTriggers", 1)[0]
    return [json.dumps(bench), block, example]


@pytest.mark.parametrize("text", _plan_fixtures(), ids=["bench", "docs", "docstring"])
def test_fault_plan_json_round_trips_alike(text):
    got, want = chaos.FaultPlan.from_json(text), jchaos.FaultPlan.from_json(text)
    assert got.to_dict() == want.to_dict()
    assert chaos.FaultPlan.from_dict(got.to_dict()) == got
    got.validate()
    for bad in ('[{"site": "x"}]', '{"faults": [{"site": "x", "evrey": 3}]}',
                '{"faults": [{"every": 3}]}'):
        with pytest.raises(ValueError) as e_got:
            chaos.FaultPlan.from_json(bad)
        with pytest.raises(ValueError) as e_want:
            jchaos.FaultPlan.from_json(bad)
        assert str(e_got.value) == str(e_want.value)
    with pytest.raises(ValueError, match="no trigger"):
        chaos.FaultSpec(site="ingest.wire_error").validate()


# -- config -------------------------------------------------------------------


def test_respond_config_is_the_references_with_the_planners_mcts_config():
    cfg, jcfg = respond.RespondConfig(), jrespond.RespondConfig()
    assert type(cfg.mcts_config()) is MCTSConfig
    assert cfg.mcts_config() == MCTSConfig(**vars(jcfg.mcts_config()))
    assert cfg.fingerprint() == jcfg.fingerprint()
    assert respond.schedule(7, 40) == [
        respond.ScheduledIncident(**vars(s)) for s in jrespond.schedule(7, 40)]


# -- scenarios ----------------------------------------------------------------


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """Every family at the bench's seed, and the no-context incident, staged
    by both packages under the same pinned wall clock."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time_ns", lambda: 1_760_000_000_000_000_000)
        for name, mod in (("port", respond), ("jax", jrespond)):
            work = tmp_path_factory.mktemp(name)
            runs = {fam: mod.stage_incident(work, fam, seed=SEED, files=FILES)
                    for fam in respond.FAMILIES}
            runs["no-context"] = mod.stage_incident(work, respond.FAMILIES[0],
                                                    seed=23, files=FILES)
            out[name] = (work, runs)
    return out


def _tree(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _strip(strings, work) -> list:
    return [s.replace(str(work), "<work>") for s in strings.strings()]


@pytest.mark.parametrize("family", respond.FAMILIES + ("no-context",))
def test_stage_incident_same_bytes_events_and_strings(staged, family):
    (pw, port), (jw, ref) = staged["port"], staged["jax"]
    got, want = port[family], ref[family]
    assert got.family == want.family and got.leaves_behind == want.leaves_behind
    assert _tree(got.victim_root) == _tree(want.victim_root)
    assert got.manifest.files == want.manifest.files
    ev, jev = got.trace.events, want.trace.events
    for f in ("ts_ns", "pid", "tid", "comm_id", "syscall", "path_id",
              "new_path_id", "flags", "ret_val", "bytes", "inode", "mode",
              "uid", "gid", "valid"):
        assert np.array_equal(getattr(ev, f), getattr(jev, f)), f
    assert _strip(got.trace.strings, pw) == _strip(want.trace.strings, jw)
    assert np.array_equal(got.trace.labels, want.trace.labels)
    gt, jgt = got.trace.ground_truth, want.trace.ground_truth
    assert (gt.start_ns, gt.end_ns, gt.attack_family, gt.scale) == \
        (jgt.start_ns, jgt.end_ns, jgt.attack_family, jgt.scale)


# -- incidents ----------------------------------------------------------------


def _domain_fields(d, work=None) -> dict:
    fix = (lambda p: p.replace(str(work), "<work>")) if work else (lambda p: p)
    return dict(files=[fix(p) for p in d.file_paths], procs=list(d.proc_names),
                fs=d.file_scores.tolist(), fl=d.file_loss_mb.tolist(),
                ps=d.proc_scores.tolist(), max_steps=d.max_steps,
                dtypes=(d.file_scores.dtype, d.file_loss_mb.dtype,
                        d.proc_scores.dtype))


@pytest.mark.parametrize("hot", [
    [("file", 101, 0.95), ("proc", 4001, 0.9), ("file", 7, 0.61)],
    [("proc", 4001, 0.9)],
    [("file", i, 0.5 + i / 100) for i in range(20)],
], ids=["mixed", "proc-only", "clamped"])
def test_incident_from_alert_equal(hot):
    kw = dict(stream="s0#2", window_idx=3, lo_ns=0, hi_ns=1, max_prob=0.95,
              hot=hot, t_admit=0.0, t_scored=0.0, late=False, trace_id="t-1",
              severity=0.8)
    got = respond.Incident.from_alert(WindowAlert(**kw), max_files=16, max_procs=4)
    want = jrespond.Incident.from_alert(JWindowAlert(**kw), max_files=16,
                                        max_procs=4)
    assert _domain_fields(got.domain) == _domain_fields(want.domain)
    assert (got.trace_id, got.stream, got.window_idx, got.severity, got.context) == \
        (want.trace_id, want.stream, want.window_idx, want.severity, None)


@pytest.mark.parametrize("family", respond.FAMILIES)
def test_incident_from_detection_equal(staged, family):
    (pw, port), (jw, ref) = staged["port"], staged["jax"]
    got = respond.Incident.from_detection(
        family, heuristic_detect(port[family].trace),
        context=port[family].verify_context(), max_files=128, max_procs=16)
    want = jrespond.Incident.from_detection(
        family, jheuristic_detect(ref[family].trace),
        context=ref[family].verify_context(), max_files=128, max_procs=16)
    assert _domain_fields(got.domain, pw) == _domain_fields(want.domain, jw)
    assert got.window_idx == want.window_idx == -1


def test_incident_queue_evicts_oldest_and_journals_alike():
    recs = []
    for pkg, queue_cls, alert_cls, journal_cls, reg_cls in (
            (respond, respond.IncidentQueue, WindowAlert, EventJournal, MetricsRegistry),
            (jrespond, jrespond.IncidentQueue, JWindowAlert, JEventJournal,
             JMetricsRegistry)):
        reg, jr = reg_cls(), journal_cls(registry=reg_cls())
        q = queue_cls(slots=3, registry=reg, journal=jr)
        admitted = []
        for i in range(5):
            a = alert_cls(stream=f"s{i}", window_idx=i, lo_ns=0, hi_ns=1,
                          max_prob=0.9, hot=[("file", i, 0.9)], t_admit=0.0,
                          t_scored=0.0, late=False, trace_id=f"t-{i}",
                          severity=0.5 + i / 10)
            admitted.append(q.put(pkg.Incident.from_alert(a)))
        taken = [inc.trace_id for inc in q.take(10)]
        recs.append((admitted, taken, len(q),
                     [(r.kind, r.stream, r.window_id, r.trace_id, r.data)
                      for r in jr.tail()],
                     reg.value("respond_incidents_total",
                               labels={"outcome": "evicted"})))
    assert recs[0] == recs[1]
    assert recs[0][0] == [True, True, True, False, False]
    assert recs[0][1] == ["t-2", "t-3", "t-4"]


# -- the router ---------------------------------------------------------------


def _route(mod, runs, reg, jr, **kw):
    """The bench's corpus through a router whose queue is filled before
    start(): one wave, then drain."""
    router = mod.ResponseRouter(mod.RespondConfig(**CFG), registry=reg,
                                journal=jr, **kw)
    for fam in respond.FAMILIES:
        router.submit_detection(fam, mod_detect(mod)(runs[fam].trace),
                                context=runs[fam].verify_context())
    router.submit_detection("no-context", mod_detect(mod)(runs["no-context"].trace),
                            context=None)
    router.start()
    try:
        assert router.drain(timeout=300.0)
    finally:
        router.stop(timeout=60.0)
    assert router._thread is None
    return router


def mod_detect(mod):
    return heuristic_detect if mod is respond else jheuristic_detect


def test_router_decisions_equal_the_references(staged):
    (pw, port), (jw, ref) = staged["port"], staged["jax"]
    reg, jr = MetricsRegistry(), EventJournal(registry=MetricsRegistry())
    got = _route(respond, port, reg, jr, device="cpu")
    want = _route(jrespond, ref, JMetricsRegistry(),
                  JEventJournal(registry=JMetricsRegistry()))
    by = lambda r: {vp.incident.stream: vp for vp in r.results()}  # noqa: E731
    g, w = by(got), by(want)
    assert sorted(g) == sorted(w) == sorted(respond.FAMILIES + ("no-context",))
    for stream in g:
        a, b = g[stream], w[stream]
        acts = lambda p, work: [(x.kind.name, x.target.replace(str(work), "<work>"))  # noqa: E731
                                for x in p.actions]
        assert acts(a.plan, pw) == acts(b.plan, jw), stream
        assert a.plan.expected_reward == pytest.approx(
            b.plan.expected_reward, rel=1e-6), stream
        assert a.plan.rollouts == b.plan.rollouts
        assert (a.verified, a.reason) == (b.verified, b.reason), stream
        if a.verified:
            assert a.gate.rehearsal.files_restored == b.gate.rehearsal.files_restored
    assert all(g[f].verified for f in respond.FAMILIES)
    assert not g["no-context"].verified and g["no-context"].reason == NO_CONTEXT
    stats = got.stats()
    ref = {k: v for k, v in want.stats().items() if k != "warmup_programs"}
    assert stats == {**ref, "warmup_seconds": stats["warmup_seconds"]}
    assert stats["batches"] == 1 and stats["planned"] == 5
    assert stats["recompiles"] == 0
    rejects = jr.tail(kinds=("plan_rejected",))
    assert [r.data["reason"] for r in rejects] == [NO_CONTEXT]
    kinds = {r.kind for r in jr.tail()}
    assert {"incident_enqueued", "plan_emitted", "plan_verified",
            "plan_rejected"} <= kinds
    assert reg.value("respond_plans_total", labels={"outcome": "verified"}) == 4.0
    assert reg.value("respond_plan_seconds", stat="count") == 1.0


def test_router_batches_a_filled_queue_by_slot_and_survives_a_failure(staged):
    """Six incidents queued before start() with slots (1, 2, 4): a wave of
    four, then one of two.  A wave that raises is journaled, its incidents
    leave the in-flight count, and the loop plans the next."""
    _, port = staged["port"]
    reg, jr = MetricsRegistry(), EventJournal(registry=MetricsRegistry())
    cfg = respond.RespondConfig(num_simulations=16, batch_close_sec=0.05,
                                batch_slots=(1, 2, 4), severity_min=0.5)
    router = respond.ResponseRouter(cfg, registry=reg, journal=jr, device="cpu")
    det = heuristic_detect(port["log-tamper"].trace)
    for i in range(6):
        router.submit_detection(f"s{i}", det, context=port["log-tamper"].verify_context())
    below = WindowAlert(stream="s9", window_idx=0, lo_ns=0, hi_ns=1, max_prob=0.6,
                        hot=[("file", 1, 0.6)], t_admit=0.0, t_scored=0.0,
                        late=False, trace_id="t-9", severity=0.2)
    assert not router.offer_alert(below)
    router.start()
    try:
        assert router.drain(timeout=300.0)
        stats = router.stats()
        assert (stats["batches"], stats["planned"], stats["verified"]) == (2, 6, 6)
        assert stats["recompiles"] == 0 and stats["queue_depth"] == 0
        sizes = [r.data["batch"] for r in jr.tail(kinds=("plan_emitted",))]
        assert sizes == [4] * 4 + [2] * 2

        def boom(domains):
            raise RuntimeError("planner down")

        router.planner.plan_batch = boom
        router.submit_detection("s7", det, context=None)
        assert router.drain(timeout=60.0)
        del router.planner.plan_batch
        router.submit_detection("s8", det, context=None)
        assert router.drain(timeout=300.0)
    finally:
        router.stop(timeout=60.0)
    assert router._thread is None
    errs = jr.tail(kinds=("exception",))
    assert len(errs) == 1 and "planner down" in errs[0].data["what"]
    assert [vp.incident.stream for vp in router.results()][-1] == "s8"
    assert reg.value("respond_incidents_total", labels={"outcome": "below_min"}) == 1.0
