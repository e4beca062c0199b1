"""The port's fleet control plane (nerrf_tpu_torch.fleet) against the JAX
package's, on the CPU.

* ``stable_slot``, ``slot_map`` and ``parse_gauge`` give the reference's
  answers on the same inputs, and ``FleetConfig`` refuses the same bands.
* Every controller scenario of the reference's own fleet tests is driven
  through both controllers with the same fake pool script: their returns,
  ``decisions``, journal records (timestamps aside), pool actuations and
  rendered metrics are equal.
* ``ReplicaSet`` makes the reference's calls on its replicas under a fake
  spawn, the cap re-checked under the lock included.
* Two real children (``python -m nerrf_tpu_torch.fleet.replica --device
  cpu``): a known-cost replica speaks the reference's protocol, its stats
  carry the reference's keys plus ``launches`` (all zero: the sleeper
  launches nothing), its /metrics the headroom gauge; a real-model replica
  holds bit-parity with ``model_detect``.
* ``--compile-cache`` exits 2 naming ROADMAP A.7, for a replica and for the
  daemon.
"""

import threading
import time
from types import SimpleNamespace

import pytest

from nerrf_tpu.fleet import controller as jcontroller
from nerrf_tpu.fleet import replica as jreplica
from nerrf_tpu.flight.journal import EventJournal as JEventJournal
from nerrf_tpu.observability import MetricsRegistry as JMetricsRegistry
from nerrf_tpu_torch.fleet import controller, replica
from nerrf_tpu_torch.flight.journal import EventJournal
from nerrf_tpu_torch.observability import MetricsRegistry

PORT = (controller, MetricsRegistry, EventJournal)
REF = (jcontroller, JMetricsRegistry, JEventJournal)
HEADROOM = "nerrf_capacity_headroom_streams"
CHILD_ENV = {"OMP_NUM_THREADS": "1"}


# -- placement and scrapes ----------------------------------------------------

STREAMS = ["a", "b", "c", "s7", "s7#3", "s7#9", "load0", "load1", "#x", ""]
REPLICAS = [[], ["r0"], ["r1", "r0"], ["r0", "r1", "r2"], ["z", "r10", "r9", "a"]]


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7])
@pytest.mark.parametrize("stream", STREAMS)
def test_stable_slot_is_the_references(stream, n):
    assert controller.stable_slot(stream, n) == jcontroller.stable_slot(stream, n)
    assert controller._base_stream(stream) == jcontroller._base_stream(stream)


@pytest.mark.parametrize("reps", REPLICAS, ids=lambda r: ",".join(r) or "none")
def test_slot_map_is_the_references(reps):
    for streams in (STREAMS, list(reversed(STREAMS)), [], [f"s{i}" for i in range(20)]):
        assert controller.slot_map(streams, reps) == jcontroller.slot_map(streams, reps)


SCRAPE = ("# HELP nerrf_capacity_headroom_streams x\n"
          "# TYPE nerrf_capacity_headroom_streams gauge\n"
          "garbage-line-no-space\n"
          "nerrf_capacity_headroom_streams_other 9\n"
          'nerrf_fleet_headroom_streams{replica="r0"} 2.5\n'
          "nerrf_capacity_headroom_streams 3.25\n")


@pytest.mark.parametrize("text,name,labels", [
    (SCRAPE, HEADROOM, None),
    (SCRAPE, "nerrf_fleet_headroom_streams", {"replica": "r0"}),
    (SCRAPE, "nerrf_fleet_headroom_streams", {"replica": "r1"}),
    (SCRAPE, "nope", None),
    (None, HEADROOM, None),
    ("", HEADROOM, None),
    (f"{HEADROOM} NaN-ish x\n", HEADROOM, None),
    (f"{HEADROOM} nan\n", HEADROOM, None),
    (f"{HEADROOM}\n{HEADROOM} 1e-3\n", HEADROOM, None),
    (f"{HEADROOM}{{a=\"b\"}} 4\n", HEADROOM, {"a": "b"}),
    ("half-written nerrf_capacity_head", HEADROOM, None),
], ids=["plain", "labelled", "other-label", "absent", "none", "empty", "two-spaces",
        "nan", "bare-name-first", "braces", "torn"])
def test_parse_gauge_is_the_references(text, name, labels):
    got = controller.parse_gauge(text, name, labels=labels)
    want = jcontroller.parse_gauge(text, name, labels=labels)
    assert (got is None and want is None) or got == want or (got != got and want != want)


@pytest.mark.parametrize("below,above", [(4.0, 4.0), (5.0, 4.0), (1.5, 4.0), (0.0, 0.1)])
def test_fleet_config_band_check_is_the_references(below, above):
    outcomes = []
    for mod in (controller, jcontroller):
        try:
            mod.FleetConfig(scale_out_below=below, scale_in_above=above)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (below < above)


# -- the controller over a fake pool ------------------------------------------

class FakePool:
    """The five-method pool protocol with settable per-replica headroom."""

    def __init__(self, headrooms, streams=()):
        self.headrooms = dict(headrooms)  # name → float | None
        self._streams = list(streams)
        self.applied = []  # (mapping, moved) actuation log
        self._seq = len(self.headrooms)

    def replicas(self):
        return {name: SimpleNamespace(
                    scrape=lambda h=h: None if h is None else f"{HEADROOM} {h}\n",
                    ready=lambda: True)
                for name, h in self.headrooms.items()}

    def streams(self):
        return list(self._streams)

    def scale_out(self):
        name = f"r{self._seq}"
        self._seq += 1
        self.headrooms[name] = 10.0  # fresh replica: all slack
        return name

    def scale_in(self, name):
        self.headrooms.pop(name, None)

    def apply_slots(self, mapping, moved):
        self.applied.append((dict(mapping), list(moved)))


class Run:
    """One controller of one package over its own pool, registry, journal."""

    def __init__(self, pkg, pool, **over):
        mod, reg_cls, jrn_cls = pkg
        self.pool = pool
        self.reg = reg_cls(namespace="t")
        self.jrn = jrn_cls(registry=self.reg)
        cfg = mod.FleetConfig(**{"scale_out_below": 1.5, "scale_in_above": 4.0,
                                 "scale_out_sustain": 2, "scale_in_sustain": 3,
                                 "cooldown_sec": 10.0, "max_replicas": 3, **over})
        self.ctl = mod.FleetController(pool, cfg=cfg, registry=self.reg, journal=self.jrn)
        self.returns = []

    def poll(self, now):
        d = self.ctl.poll_once(now=now)
        self.returns.append(d)
        return d

    def record(self):
        return {"returns": self.returns,
                "decisions": list(self.ctl.decisions),
                "journal": [(r.kind, r.stream, r.window_id, r.trace_id, r.data)
                            for r in self.jrn.tail()],
                "applied": self.pool.applied,
                "headrooms": self.pool.headrooms,
                "metrics": self.reg.render()}


def _sustain(pkg):
    run = Run(pkg, FakePool({"r0": 1.2}))
    run.poll(0.0)
    run.poll(1.0)
    return [run]


def _band_interior(pkg):
    run = Run(pkg, FakePool({"r0": 1.2}))
    for i, h in enumerate([1.2, 2.0, 1.2, 3.9, 1.4, 2.0] * 4):
        run.pool.headrooms["r0"] = h
        run.poll(float(i))
    run2 = Run(pkg, FakePool({"r0": 5.0, "r1": 5.0}))
    for i, h in enumerate([5.0, 5.0, 2.0, 5.0, 5.0, 2.0] * 3):
        run2.pool.headrooms["r1"] = h
        run2.poll(float(i))
    return [run, run2]


def _cooldown(pkg):
    run = Run(pkg, FakePool({"r0": 1.0}), max_replicas=4)
    run.poll(0.0)
    run.poll(1.0)
    run.pool.headrooms["r1"] = 1.0
    for t in (2.0, 3.0, 4.0, 10.9, 12.0):
        run.poll(t)
    return [run]


def _scale_in_min_replicas(pkg):
    run = Run(pkg, FakePool({"r0": 9.0, "r1": 9.0}), scale_in_sustain=3)
    for t in (0.0, 1.0, 2.0, 20.0, 21.0, 22.0, 23.0):
        run.poll(t)
    return [run]


def _worst_replica(pkg):
    run = Run(pkg, FakePool({"r0": 9.0, "r1": 1.0, "r2": None}), max_replicas=4)
    run.poll(0.0)
    run.poll(1.0)
    run2 = Run(pkg, FakePool({"r0": None}))
    for t in (0.0, 1.0, 2.0):
        run2.poll(t)
    return [run, run2]


def _stale_idle_gauge(pkg):
    streams = [s for s in ("a", "b", "c", "d", "e", "f")
               if controller.stable_slot(s, 2) == 0][:2]
    run = Run(pkg, FakePool({"r0": 9.0, "r1": 1.0}, streams=streams), scale_in_sustain=2)
    for t in (0.0, 1.0, 2.0):
        run.poll(t)
    return [run]


def _rebalance(pkg):
    run = Run(pkg, FakePool({"r0": 1.2}, streams=["a", "b", "c", "d"]))
    for t in (0.0, 1.0, 2.0):
        run.poll(t)
    return [run]


SCENARIOS = {"sustain": _sustain, "band_interior": _band_interior,
             "cooldown": _cooldown, "scale_in_min_replicas": _scale_in_min_replicas,
             "worst_replica_dead_scrapes": _worst_replica,
             "stale_idle_gauge": _stale_idle_gauge, "rebalance": _rebalance}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_controller_decides_as_the_reference(scenario):
    port = [r.record() for r in SCENARIOS[scenario](PORT)]
    ref = [r.record() for r in SCENARIOS[scenario](REF)]
    assert port == ref
    kinds = [d["kind"] for run in port for d in run["decisions"]]
    # each scenario's point, as the reference's own tests read it
    want = {"sustain": ["fleet_scale"], "band_interior": [],
            "cooldown": ["fleet_scale", "fleet_scale"],
            "scale_in_min_replicas": ["fleet_scale"],
            "worst_replica_dead_scrapes": ["fleet_scale"],
            "stale_idle_gauge": ["fleet_scale"],
            "rebalance": ["fleet_scale", "fleet_rebalance"]}[scenario]
    assert kinds == want
    if scenario == "stale_idle_gauge":
        d = port[0]["decisions"][-1]
        assert d["replica"] == "r1" and d["evidence"]["idle_replicas"] == ["r1"]


def test_controller_thread_lifecycle_is_bounded():
    firsts = []
    for pkg in (PORT, REF):
        run = Run(pkg, FakePool({"r0": 2.0}), poll_sec=0.05)
        run.ctl.start()
        try:
            deadline = time.monotonic() + 5.0
            while not run.ctl.decisions and time.monotonic() < deadline:
                run.pool.headrooms["r0"] = 1.0
                time.sleep(0.02)
        finally:
            run.ctl.stop()
        assert run.ctl.decisions
        assert not any(t.name == "nerrf-fleet-controller" for t in threading.enumerate())
        firsts.append(run.ctl.decisions[0])
    assert firsts[0] == firsts[1]
    assert firsts[0]["direction"] == "out" and firsts[0]["replica"] == "r1"


# -- ReplicaSet under a fake spawn --------------------------------------------

class FakeReplica:
    def __init__(self, name, log):
        self.name = name
        self.log = log
        log.append(("spawn", name))

    def cmd(self, op, **kw):
        self.log.append(("cmd", self.name, op, tuple(sorted(kw.items()))))
        return {"ok": True}

    def stop(self):
        self.log.append(("stop", self.name))
        return {"ok": True, "name": self.name}


def _replica_set_script(mod):
    log = []
    holder = {}

    def spawn(name):
        rep = FakeReplica(name, log)
        if name == "r1":
            # a racing scale_out fills the last slot while r1 boots outside
            # the lock: r1 must see the cap under the lock and stop itself
            log.append(("race", holder["rs"].scale_out()))
        return rep

    rs = mod.ReplicaSet(spawn, max_replicas=2)
    holder["rs"] = rs
    log.append(("out", rs.scale_out()))
    log.append(("out", rs.scale_out()))
    log.append(("out", rs.scale_out()))
    log.append(("replicas", sorted(rs.replicas())))
    for s, rate in (("a", 6.0), ("b", 2.0), ("c", 1.0)):
        rs.add_stream(s, rate)
    log.append(("streams", rs.streams()))
    rs.apply_slots({"a": "r0", "b": "r2", "c": "r0"}, [])
    rs.apply_slots({"a": "r2", "b": "r2", "c": "r0"}, ["a"])
    rs.apply_slots({"a": "r2", "b": "r2", "c": "gone"}, [])
    rs.remove_stream("b")
    rs.apply_slots({"a": "r2", "c": "r0"}, [])
    rs.scale_in("r2")
    rs.apply_slots({"a": "r0", "c": "r0"}, ["a"])
    rs.scale_in("nope")
    log.append(("stop_all", rs.stop_all()))
    log.append(("after", rs.scale_out(), sorted(rs.replicas())))
    return log


def test_replica_set_calls_as_the_reference():
    got = _replica_set_script(replica)
    assert got == _replica_set_script(jreplica)
    assert ("stop", "r1") in got and ("race", "r2") in got


def test_replica_args_are_the_references_plus_device():
    want = jreplica.replica_args(buckets="160x320x64", synthetic_cost=0.05,
                                 archive_dir="A")
    got = replica.replica_args(buckets="160x320x64", synthetic_cost=0.05,
                               archive_dir="A", device="cpu")
    i = got.index("--device")
    assert got[i:i + 2] == ["--device", "cpu"]
    assert got[:i] + got[i + 2:] == want
    assert replica.replica_args()[replica.replica_args().index("--device") + 1] == "cuda"


# -- real children ------------------------------------------------------------

def _reference_stats_keys():
    """The keys of the reference's stats reply, from its own `_stats` over a
    service stand-in (no JAX program runs)."""
    reg = JMetricsRegistry()
    svc = SimpleNamespace(devtime=None, warmup_source={}, ready=lambda: (True, "ok"),
                          slo=SimpleNamespace(snapshot=lambda: {}))
    cfg = SimpleNamespace(buckets=((256, 512, 64),))
    return set(jreplica._stats(svc, cfg, reg, JEventJournal(registry=reg)))


def _wait_for(fn, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.25)
    return fn()


@pytest.fixture(scope="module")
def children():
    """The two real children, booted at once: a known-cost replica and a
    real-model one, both ``--device cpu``."""
    specs = {"known_cost": dict(synthetic_cost=0.01, devtime_window_sec=8.0),
             "real_model": dict(synthetic_cost=0.0, deadline_sec=5.0)}
    booted, errors = {}, []

    def boot(name):
        try:
            booted[name] = replica.ReplicaProcess(
                name, args=replica.replica_args(device="cpu", **specs[name]),
                env=CHILD_ENV)
        except Exception as e:  # noqa: BLE001 — raised below, after the join
            errors.append(e)

    threads = [threading.Thread(target=boot, args=(name,)) for name in specs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        if errors:
            raise errors[0]
        yield booted
    finally:
        for rep in booted.values():
            if rep.proc.poll() is None:
                rep.stop()


def test_known_cost_child_speaks_the_protocol(children):
    rep = children["known_cost"]
    try:
        assert rep.port > 0 and rep.pid == rep.proc.pid
        assert rep.cmd("ping") == {"ok": True, "ready": True}
        assert rep.ready()
        assert rep.cmd("assign", stream="a", rate_hz=6.0) == {"ok": True, "stream": "a"}
        assert _wait_for(lambda: rep.cmd("stats")["windows_scored"] >= 2, 30.0)
        text = _wait_for(lambda: (rep.scrape() or "") if HEADROOM + " " in (rep.scrape() or "")
                         else "", 30.0)
        assert controller.parse_gauge(text, HEADROOM) is not None
        stats = rep.cmd("stats")
        assert set(stats) == _reference_stats_keys() | {"launches"}
        assert stats["launches"] == {k: 0 for k in ("sage_aggregate", "gather_rows",
                                                    "segment_sum", "segment_sum_sorted",
                                                    "gather_rows_sorted")}
        assert stats["warmup_source"] == {"256n/512e/64s": "live"}
        assert stats["recompiles_after_warmup"] == 0
        assert rep.cmd("unassign", stream="a") == {"ok": True, "stream": "a"}
        assert rep.cmd("nope")["ok"] is False
    finally:
        final = rep.stop()
    assert rep.proc.returncode == 0
    assert final["ok"] and final["windows_scored"] >= stats["windows_scored"]
    assert set(final) == set(stats)


def test_real_model_child_holds_parity_with_model_detect(children):
    rep = children["real_model"]
    got = rep.cmd("parity", timeout=300.0)
    stats = rep.cmd("stats")
    assert got["ok"] and got["parity"] is True and got["windows"] > 0
    assert stats["recompiles_after_warmup"] == 0
    assert stats["warmup_source"] == {"256n/512e/64s": "live"}


@pytest.mark.parametrize("main", [replica.main, controller.main], ids=["replica", "daemon"])
def test_compile_cache_exits_2_naming_a7(main, capsys):
    assert main(["--compile-cache", "cache-dir"]) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "ROADMAP A.7" in err[0] and "--compile-cache" in err[0]
