"""SLO-aware shedding in the port's serve admission path, on the CPU.

The port of ``tests/test_fleet.py``'s four shedding tests: the REAL
admission path of ``nerrf_tpu_torch.serve.service`` with a stub score
function that never returns (the queues only grow), a pinned headroom
estimate (the pressure gate) and observed SLO burn (the ranking).  The
service is a shell built here (`make_port_service_shell`: every field the
admission, demux, failure and lifecycle paths touch, no model), as the
reference's tests build theirs.
"""

import dataclasses
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from nerrf_tpu_torch.data import SimConfig, simulate_trace
from nerrf_tpu_torch.flight.journal import EventJournal
from nerrf_tpu_torch.flight.slo import SLOTracker
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.serve import MicroBatcher, ServeConfig
from nerrf_tpu_torch.serve.alerts import AlertSink
from nerrf_tpu_torch.serve.service import OnlineDetectionService

BUCKET = (256, 512, 64)


def make_port_service_shell(cfg, registry=None, journal=None):
    """The port's `OnlineDetectionService` without a model: every field
    ``__init__`` sets, EXCEPT the batcher — each caller wires its own score
    function and starts it."""
    registry = registry or MetricsRegistry(namespace="test")
    svc = OnlineDetectionService.__new__(OnlineDetectionService)
    svc.cfg = cfg
    svc.device = None
    svc._model = None
    svc._eval_fn = None
    svc._reg = registry
    svc._journal = journal if journal is not None \
        else EventJournal(registry=registry)
    svc._slo = SLOTracker(cfg.window_deadline_sec, registry=registry,
                          journal=svc._journal)
    svc._flight = None
    svc.sink = AlertSink(cfg.alert_queue_slots, registry=registry,
                         journal=svc._journal)
    svc._lock = threading.Lock()
    svc._streams = {}
    svc._strikes = {}
    svc._quarantined = {}
    svc._warm = True
    svc._admission_open = False
    svc.warmup_seconds = {}
    svc._swap_lock = threading.Lock()
    svc._live_version = None
    svc._shadow = None
    svc._manager = None
    svc._boot_threshold = cfg.threshold
    svc._window_log = None
    svc._respond = None
    svc._quality = None
    svc._archive = None
    svc._learn = None
    svc._devtime = None
    svc._devtime_thread = None
    svc._devtime_stop = threading.Event()
    return svc, registry


def _blocks(trace, size=200):
    ev = trace.events
    for i in range(0, len(ev), size):
        yield type(ev)(**{f.name: getattr(ev, f.name)[i:i + size]
                          for f in dataclasses.fields(ev)})


def _sim(seed, duration=60.0, attack=True, files=6, rate=6.0):
    return simulate_trace(SimConfig(
        duration_sec=duration, attack=attack, attack_start_sec=duration / 3,
        num_target_files=files, benign_rate_hz=rate, seed=seed))


def _shed_service(slots=2, margin=1.0, headroom=0.2):
    """Real admission + stub batcher, scoring wedged so queues only grow;
    headroom pinned under the shed margin (fleet-wide pressure)."""
    gate = threading.Event()

    def wedged(batch):
        gate.wait(timeout=30.0)
        return np.zeros(batch["node_mask"].shape)

    cfg = ServeConfig(buckets=(BUCKET,), batch_size=8,
                      batch_close_sec=30.0, stream_queue_slots=slots,
                      window_sec=10.0, stride_sec=5.0,
                      shed_headroom_margin=margin)
    svc, reg = make_port_service_shell(cfg)
    svc._batcher = MicroBatcher(score_fn=wedged, cfg=cfg, registry=reg,
                                on_scored=svc._on_scored,
                                on_failed=svc._on_failed,
                                journal=svc._journal)
    for b in cfg.buckets:
        svc._batcher.mark_warm(b)
    svc._batcher.start()
    svc._admission_open = True
    svc._devtime = SimpleNamespace(
        last_estimate=SimpleNamespace(headroom_streams=headroom),
        observe_admit=lambda *a, **k: None,
        observe_batch=lambda *a, **k: None)
    return svc, reg, gate


def _burn(svc, stream, ratio):
    """Observe one window whose DEVICE stage burns `ratio` of the SLO
    budget — the stage the shed ranking scores (queue/pack burn is
    suffered behind the shared FIFO, not caused, so it must not rank)."""
    sec = svc.cfg.window_deadline_sec * ratio
    svc._slo.observe(stream, f"t-{stream}", 0, {"device": sec}, sec)


def _fill(svc, stream, seed):
    """Feed a stream until its bounded queue is full (scoring wedged)."""
    if stream not in svc._streams:
        svc.join(stream)
    tr = _sim(seed=seed, duration=120.0, files=4, rate=6.0)
    for b in _blocks(tr, size=400):
        svc.feed(stream, b, tr.strings)
    return tr


def test_shed_ranks_victims_by_budget_burn_not_arrival_order():
    svc, reg, gate = _shed_service(slots=2)
    try:
        _fill(svc, "burner", seed=9)
        burner_live_before = dict(svc._streams["burner"].live)
        # the fill itself overflows burner's own queue (classic
        # drop-oldest: no SLO burn observed yet, nobody else pays)
        burner_drops_own = svc._streams["burner"].dropped
        assert len(burner_live_before) == 2
        _burn(svc, "burner", 5.0)   # burner torches its budget
        _burn(svc, "healthy", 0.1)  # healthy well inside it
        _fill(svc, "healthy", seed=10)  # healthy overflows under pressure
        sheds = [r for r in svc._journal.tail() if r.kind == "fleet_shed"]
        assert sheds, "overflow under pressure must shed the burner"
        for r in sheds:
            assert r.stream == "burner"
            assert r.data["reason"] == "budget_burn"
            assert r.data["admitting"].startswith("healthy")
            # the victim is the TOP of the recorded burn ranking
            assert r.data["ranking"][0][0] == "burner"
            assert r.data["burn_ratio"] == pytest.approx(5.0, rel=0.01)
        # burner paid from its OLDEST window (drop-oldest inside the
        # victim); healthy kept everything, stretched past its own bound
        h_burn = svc._streams["burner"]
        h_heal = svc._streams["healthy"]
        assert h_burn.dropped - burner_drops_own == len(sheds)
        assert min(burner_live_before) not in h_burn.live
        assert h_heal.admitted > 2
        assert len(h_heal.live) > 2          # stretched beyond slots...
        assert len(h_heal.live) <= 4         # ...but hard-capped at 2x
        assert reg.value("fleet_shed_total",
                         labels={"stream": "burner",
                                 "reason": "budget_burn"}) == len(sheds)
        assert reg.value("serve_admission_dropped_total",
                         labels={"reason": "shed"}) == len(sheds)
        drops = [r for r in svc._journal.tail()
                 if r.kind == "admission_drop" and r.data["reason"] == "shed"]
        assert [(r.stream, r.window_id) for r in drops] == \
            [(r.stream, r.window_id) for r in sheds]
    finally:
        gate.set()
        svc.stop(drain=False)


def test_no_pressure_or_disabled_falls_back_to_drop_oldest():
    # slack headroom: classic per-stream drop-oldest, nobody else pays
    svc, reg, gate = _shed_service(slots=2, headroom=50.0)
    try:
        _fill(svc, "burner", seed=9)
        drops_before = svc._streams["burner"].dropped
        _burn(svc, "burner", 5.0)
        _fill(svc, "healthy", seed=10)
        assert not [r for r in svc._journal.tail()
                    if r.kind == "fleet_shed"]
        h = svc._streams["healthy"]
        assert len(h.live) == 2              # own bound, own victims
        assert h.dropped == h.admitted - 2
        assert svc._streams["burner"].dropped == drops_before
    finally:
        gate.set()
        svc.stop(drain=False)
    # shedding switched off: pressure alone changes nothing
    svc, reg, gate = _shed_service(slots=2)
    svc.cfg = dataclasses.replace(svc.cfg, slo_aware_shedding=False)
    try:
        _fill(svc, "burner", seed=9)
        _burn(svc, "burner", 5.0)
        _fill(svc, "healthy", seed=10)
        assert not [r for r in svc._journal.tail()
                    if r.kind == "fleet_shed"]
        assert len(svc._streams["healthy"].live) == 2
    finally:
        gate.set()
        svc.stop(drain=False)


def test_shed_never_picks_quarantined_or_lesser_burners():
    svc, _reg, gate = _shed_service(slots=2)
    try:
        _fill(svc, "burner", seed=9)
        drops_before = svc._streams["burner"].dropped
        _burn(svc, "burner", 5.0)
        svc._quarantined["burner"] = time.monotonic()  # exempt: already shed
        _burn(svc, "healthy", 0.1)
        _fill(svc, "healthy", seed=10)
        assert not [r for r in svc._journal.tail()
                    if r.kind == "fleet_shed"]
        assert svc._streams["burner"].dropped == drops_before
        # and a victim must burn STRICTLY more than the admitting stream:
        # the top burner overflowing its own queue gets the classic path
        del svc._quarantined["burner"]
        assert svc._select_shed_victim("burner") is None
        # ...while anyone burning less still finds the burner
        picked = svc._select_shed_victim("healthy")
        assert picked is not None and picked[0].id == "burner"
    finally:
        gate.set()
        svc.stop(drain=False)


def test_shed_ranking_scores_caused_device_burn_not_suffered_queue_wait():
    # on a saturated shared FIFO a healthy stream's TOTAL burn converges to
    # the deadline (it waits behind the burner's batches), so ranking on
    # the total would shed the victim of the pressure, not its cause —
    # only device occupancy may rank
    svc, _reg, gate = _shed_service(slots=2)
    try:
        _fill(svc, "burner", seed=9)
        _fill(svc, "waiter", seed=10)
        # waiter torches its whole budget QUEUED behind the shared FIFO
        # (suffered); burner's burn is modest but on the DEVICE (caused)
        svc._slo.observe("waiter", "t-w", 0, {"queue": 9.9}, 9.9)
        _burn(svc, "burner", 0.5)
        picked = svc._select_shed_victim("waiter")
        assert picked is not None and picked[0].id == "burner"
        assert dict(picked[2]).get("waiter") is None  # zero device burn
    finally:
        gate.set()
        svc.stop(drain=False)
