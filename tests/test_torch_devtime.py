"""The port's device-efficiency plane (nerrf_tpu_torch.devtime) against the
JAX package's (nerrf_tpu.devtime), on the CPU.

* The counterpart of each test of ``tests/test_devtime.py`` on the port's
  copies: card peaks (the H100 rows, exact match first, null for the CPU,
  ``meta`` and unknown cards), the cost model pinned to the warmup ladder,
  null for a matmul-free program, the train step's cost, the live
  accountant's gauges and snapshot, the headroom math, the fail-open
  capture plane and serve's observation path.  The three flight-recorder
  tests (the p99 bundle with and without the opt-in, the failed start)
  are in ``tests/test_torch_flight.py``.
* Parity from one module-scoped pair of models (``JointConfig().small``,
  the reference's params converted by ``convert.py``) at the bucket
  ``(64, 128, 32)``: the serve FLOPs equal the reference's analytic count
  exactly in ``segment`` and ``dense_adj`` (``fused`` equals ``segment``);
  the train step's FLOPs and both byte floors differ by pinned amounts,
  each named (the reference's scan transpose, PyTorch's ``bias_ih``
  buffer, the reference's counters and PRNG key).
* ``headroom.py`` is the reference's source (compared as text), and
  ``predict_headroom``/``HeadroomTracker`` give the reference's estimates
  on the same synthetic mixes.
* The shape trace: a ``meta`` operand takes the plain version (nothing is
  launched), another device type still raises; the full-width serve count
  equals ``chip_smoke.py``'s closed form.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from nerrf_tpu import devtime as jdevtime
from nerrf_tpu.models import JointConfig as JJointConfig
from nerrf_tpu.models import NerrfNet as JNerrfNet
from nerrf_tpu.serve import ServeConfig as JServeConfig
from nerrf_tpu.serve import init_untrained_params
from nerrf_tpu.serve.service import _tiny_trace
from nerrf_tpu.train.data import sample_spec
from nerrf_tpu.train.data import windows_of_trace as jwindows_of_trace
from nerrf_tpu.train.loop import TrainConfig as JTrainConfig
from nerrf_tpu.train.loop import make_eval_fn as jmake_eval_fn
from nerrf_tpu_torch import ops
from nerrf_tpu_torch.bench import flops as port_flops
from nerrf_tpu_torch.bench import mfu as port_mfu
from nerrf_tpu_torch.convert import load_flax_params
from nerrf_tpu_torch.devtime import (
    CHIP_TABLE,
    ChipPeaks,
    DeviceTimeAccountant,
    HeadroomTracker,
    ProgramCost,
    capture_trace,
    chip_peaks,
    default_peaks,
    predict_headroom,
    profiled,
    program_cost,
    resolve_kind,
    serve_program_costs,
    trace_summary,
    train_step_cost,
)
from nerrf_tpu_torch.devtime import peaks as port_peaks
from nerrf_tpu_torch.flight.journal import EventJournal
from nerrf_tpu_torch.models import JointConfig, NerrfNet
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.pipeline import warmup_trace
from nerrf_tpu_torch.serve import ServeConfig
from nerrf_tpu_torch.serve.config import bucket_tag
from nerrf_tpu_torch.serve.service import warmup_batches
from nerrf_tpu_torch.train.data import windows_of_trace
from nerrf_tpu_torch.train.loop import TrainConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
BUCKET = (64, 128, 32)
TAG = "64n/128e/32s"

# ---------------------------------------------------------------------------
# card peaks: exact-match-first resolution
# ---------------------------------------------------------------------------

# every name torch.cuda.get_device_name() gives the H100 parts, and the
# data sheet's dense bf16 TFLOP/s and HBM GB/s
PUBLISHED_KINDS = {
    "NVIDIA H100 80GB HBM3": (989.4, 3350.0),
    "NVIDIA H100 PCIe": (756.0, 2000.0),
    "NVIDIA H100 NVL": (835.0, 3900.0),
}


def test_peaks_exact_match_over_all_published_kinds():
    for kind, (tflops, gbps) in PUBLISHED_KINDS.items():
        got = resolve_kind(kind)
        assert got is not None, kind
        assert got is CHIP_TABLE[kind.lower()]
        assert (got.tflops_bf16, got.hbm_gbps) == (tflops, gbps), kind
        assert got.ridge_flops_per_byte > 0 and got.tflops_f32 > 0
        assert chip_peaks(kind) is got
    # the port states no figure for a TPU
    assert not [k for k in CHIP_TABLE if "tpu" in k]


def test_peaks_substring_fallback_prefers_longest_key(monkeypatch):
    # a decorated name lands on its row
    assert resolve_kind("NVIDIA H100 80GB HBM3 MIG 7g.80gb").kind == \
        "nvidia h100 80gb hbm3"
    # with a shorter key contained too, the LONGEST wins whatever the order
    table = {"nvidia h100": ChipPeaks("nvidia h100", 1.0, 1.0),
             **CHIP_TABLE}
    monkeypatch.setattr(port_peaks, "CHIP_TABLE", table)
    assert resolve_kind("NVIDIA H100 PCIe (rev a1)").tflops_bf16 == 756.0
    assert resolve_kind("NVIDIA H100 SXM5 64GB").kind == "nvidia h100"


def test_peaks_null_not_fake_for_unknown(monkeypatch):
    assert resolve_kind("") is None
    assert resolve_kind("cpu") is None
    assert resolve_kind("NVIDIA A100-SXM4-80GB") is None  # no row: no guess
    assert resolve_kind("NVIDIA H100") is None  # which part: no guess
    for dev in ("cpu", "meta", torch.device("cpu"), torch.device("meta")):
        assert chip_peaks(dev) is None
    # a CUDA device without CUDA: None, never a default
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_peaks(torch.device("cuda")) is None
    assert chip_peaks("cuda:0") is None
    assert default_peaks() is None


def test_bench_mfu_delegates_to_the_table():
    assert port_mfu.chip_peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert port_mfu.chip_peak_tflops(torch.device("cpu")) is None
    achieved, pct = port_mfu.mfu(989.4e12, 0.5, "NVIDIA H100 80GB HBM3")
    assert achieved == pytest.approx(494.7) and pct == pytest.approx(50.0)
    assert port_mfu.mfu(1e12, 1.0, "cpu") == (1.0, None)
    assert port_mfu.mfu(None, 1.0, "NVIDIA H100 PCIe") == (None, None)
    # the cross-check needs the card
    assert port_flops.profiler_flops(torch.mm, torch.ones(4, 4),
                                     torch.ones(4, 4)) == (None, None)


# ---------------------------------------------------------------------------
# cost model: pinned to the warmup ladder, and to the reference's count
# ---------------------------------------------------------------------------

def _with_aggregation(cfg, agg):
    return dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn,
                                                            aggregation=agg))


@pytest.fixture(scope="module")
def small_pair():
    """The reference's small model, its untrained params at the bucket, its
    eval function, and the port's model holding the same params."""
    jcfg = JServeConfig(buckets=(BUCKET,))
    jmodel = JNerrfNet(JJointConfig().small)
    # jitted: one compile instead of an eager init op by op (the values do
    # not enter a cost)
    params = jax.jit(lambda: init_untrained_params(jmodel, jcfg))()
    model = load_flax_params(NerrfNet(JointConfig().small),
                             jax.device_get(params)).eval()
    return SimpleNamespace(jcfg=jcfg, jmodel=jmodel, params=params,
                           cfg=ServeConfig(buckets=(BUCKET,)), model=model)


def _bias_ih_bytes(model):
    return sum(b.numel() * b.element_size()
               for name, b in model.named_buffers() if name.endswith("bias_ih"))


def test_serve_costs_cover_exactly_the_warmup_ladder(small_pair):
    """The cost model's program set IS the warmup set: every bucket
    `warmup_batches` yields gets a cost at the donor batch's exact shapes,
    which are the reference's `sample_spec`."""
    cfg = small_pair.cfg
    costs = serve_program_costs(small_pair.model, cfg)
    ladder = {tag: batch for _b, tag, batch in warmup_batches(cfg)}
    assert set(costs) == set(ladder) == {TAG}
    spec = sample_spec(small_pair.jcfg.dataset_config(BUCKET))
    batch = ladder[TAG]
    assert set(batch) == set(spec)
    for key, (shape, dtype) in spec.items():
        assert batch[key].shape == (cfg.batch_size,) + shape, key
        assert str(batch[key].dtype) == dtype, key
    cost = costs[TAG]
    assert cost.program == f"serve_eval[{TAG}]"
    assert cost.flops > 0 and cost.bytes_accessed > 0
    assert cost.intensity_flops_per_byte > 0
    assert cost.batch_slots == cfg.batch_size
    # the cross-check is opt-in, and needs the card
    assert cost.profiler_flops is None and cost.profiler_device_sec is None
    checked = serve_program_costs(small_pair.model, cfg, cross_check=True)
    assert checked[TAG].flops == cost.flops
    assert checked[TAG].profiler_flops is None


@pytest.mark.parametrize("agg", ["segment", "dense_adj"])
def test_serve_flops_equal_the_references(small_pair, agg):
    """The port's count equals the reference's analytic jaxpr count (its
    plain route: the CPU runs no Pallas kernel), exactly; ``fused`` issues
    the products ``segment`` does.  The byte floor differs by the LSTM
    cells' ``bias_ih``: a zero buffer the forward reads (PyTorch's LSTM
    layout), which the reference has no counterpart of."""
    jmodel = JNerrfNet(_with_aggregation(JJointConfig().small, agg))
    want = jdevtime.serve_program_costs(jmake_eval_fn(jmodel), small_pair.params,
                                        small_pair.jcfg)[TAG]
    got = serve_program_costs(small_pair.model.__class__(
        _with_aggregation(JointConfig().small, agg)), small_pair.cfg)[TAG]
    assert got.flops == want.flops == {"segment": 986497024.0,
                                       "dense_adj": 994885632.0}[agg]
    assert got.batch_slots == want.batch_slots
    assert want.bytes_accessed == 1654508.0
    assert got.bytes_accessed - want.bytes_accessed == \
        _bias_ih_bytes(small_pair.model) == 1024
    if agg == "segment":
        fused = serve_program_costs(small_pair.model.__class__(
            _with_aggregation(JointConfig().small, "fused")), small_pair.cfg)
        assert fused[TAG].flops == got.flops
        # the live model (the port's auto aggregation) and its meta copy
        assert serve_program_costs(small_pair.model, small_pair.cfg)[TAG].flops \
            == got.flops


def test_program_cost_null_not_fake_for_matmul_free_fn():
    cost = program_cost(lambda x: torch.sum(x) + 1.0,
                        np.ones((8, 8), np.float32), program="nop")
    assert cost is None
    assert port_flops.analytic_flops(lambda x: x * 2, torch.ones(3)) is None
    # a trace that fails is null too
    assert program_cost(lambda x: x.nonexistent(), np.ones(2, np.float32),
                        program="bad") is None


def _train_arrays(windows, jax_side):
    if jax_side:
        samples = jwindows_of_trace(_tiny_trace("devtime-test"),
                                    JServeConfig(buckets=(BUCKET,))
                                    .dataset_config(BUCKET))
    else:
        samples = windows(warmup_trace("devtime-test"),
                          ServeConfig(buckets=(BUCKET,)).dataset_config(BUCKET))
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def test_train_step_cost_at_dataset_shapes(small_pair):
    arrays = _train_arrays(windows_of_trace, jax_side=False)
    cost = train_step_cost(small_pair.model, TrainConfig(model=small_pair.model.cfg),
                           arrays)
    assert cost is not None
    assert cost.program == "train_step"
    assert cost.flops > 0 and cost.bytes_accessed > 0
    assert cost.batch_slots == min(TrainConfig().batch_size, len(arrays["node_feat"]))
    # a train step (fwd+bwd of a batch) must out-cost a single window's
    # share of the eval program at the same shapes
    eval_cost = serve_program_costs(small_pair.model, small_pair.cfg)[TAG]
    assert cost.flops > eval_cost.flops / eval_cost.batch_slots
    # memoized by (architecture, shapes): the same object again, at once
    assert train_step_cost(small_pair.model, TrainConfig(model=small_pair.model.cfg),
                           arrays) is cost


def test_train_step_cost_equals_the_references_but_pinned_terms(small_pair):
    """FLOPs: the reference issues one more recurrent product a BiLSTM
    layer — its scan transpose carries the cotangent into the zero initial
    carry (h₀), a [2, R, 4H] × [2, 4H, H] product, which autograd skips (h₀
    needs no gradient).  Bytes: the port reads the cells' ``bias_ih``
    buffer; the reference reads and writes three int32 counters (the step,
    Adam's and the schedule's counts) and a PRNG key (two uint32) that the
    port's step has no device copy of."""
    jarrays = _train_arrays(None, jax_side=True)
    arrays = _train_arrays(windows_of_trace, jax_side=False)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], jarrays[k])
    want = jdevtime.train_step_cost(small_pair.jmodel,
                                    JTrainConfig(model=small_pair.jmodel.cfg),
                                    jarrays)
    got = train_step_cost(small_pair.model, TrainConfig(model=small_pair.model.cfg),
                          arrays)
    assert got.batch_slots == want.batch_slots == 2
    lstm = small_pair.model.cfg.lstm
    rows = got.batch_slots * BUCKET[2]               # R sequences
    h0_product = 2 * (2 * rows * lstm.hidden * 4 * lstm.hidden)  # both directions
    assert want.flops - got.flops == h0_product * lstm.num_layers == 1048576
    counters, rng_key = 3 * 4, 2 * 4
    assert got.bytes_accessed - want.bytes_accessed == \
        _bias_ih_bytes(small_pair.model) - 2 * counters - 2 * rng_key == 984


# ---------------------------------------------------------------------------
# live accounting: gauges + null-not-fake MFU
# ---------------------------------------------------------------------------

def _fake_cost(flops=1e9, byts=1e6, program="serve_eval[t]"):
    return ProgramCost(program=program, flops=flops, bytes_accessed=byts,
                       peak_hbm_bytes=byts, batch_slots=8)


def test_accountant_mfu_present_only_with_known_peaks():
    for peaks, expect_mfu in ((ChipPeaks("test", 1.0, 100.0), True),
                              (None, False)):
        reg = MetricsRegistry(namespace="t")
        jrn = EventJournal(registry=reg)
        acc = DeviceTimeAccountant(registry=reg, journal=jrn, peaks=peaks)
        acc.register_cost("serve_eval[t]", _fake_cost())
        # 1e9 flops in 0.01 s = 100 GFLOP/s = 10% of the 1-TFLOP peak
        acc.observe_batch("serve_eval[t]", "t", 0.01, occupancy=4, slots=8,
                          real_density=0.5)
        mfu = reg.value("device_mfu", labels={"program": "serve_eval[t]"})
        if expect_mfu:
            assert mfu == pytest.approx(0.1, rel=0.01)
            assert reg.value("device_roofline_ridge") == pytest.approx(10.0)
        else:
            assert mfu == 0.0  # never set: absent, not fabricated
        # platform-free gauges export either way
        assert reg.value("device_util_fraction") > 0
        assert reg.value("device_useful_flops_fraction",
                         labels={"bucket": "t"}) == pytest.approx(0.25)
        assert reg.value("device_roofline_intensity",
                         labels={"program": "serve_eval[t]"}) == \
            pytest.approx(1e9 / 1e6)


def test_accountant_snapshot_surfaces_per_program_truth():
    reg = MetricsRegistry(namespace="t")
    acc = DeviceTimeAccountant(registry=reg, journal=EventJournal(),
                               peaks=ChipPeaks("test", 1.0, 100.0))
    acc.register_cost("p", _fake_cost(program="p"))
    for _ in range(3):
        acc.observe_batch("p", "t", 0.02, occupancy=8, slots=8)
    snap = acc.snapshot()
    assert snap["platform_peaks"]["tflops_bf16"] == 1.0
    p = snap["programs"]["p"]
    assert p["calls"] == 3
    assert p["device_seconds"] == pytest.approx(0.06, rel=0.01)
    assert p["mfu"] == pytest.approx(3e9 / 0.06 / 1e12, rel=0.01)
    assert snap["useful_flops_fraction"]["t"] == 1.0
    assert 0 < snap["util_fraction"] <= 1.0


def test_accountant_util_and_useful_age_out_stale_programs(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    reg = MetricsRegistry(namespace="t")
    acc = DeviceTimeAccountant(registry=reg, journal=EventJournal(),
                               peaks=None, window_sec=60.0)
    # program A burns 50 busy-seconds, then traffic moves elsewhere
    for _ in range(5):
        acc.observe_batch("A", "a", 10.0, occupancy=8, slots=8)
    clock[0] += 600.0  # ten quiet minutes
    acc.observe_batch("B", "b", 0.001, occupancy=1, slots=8)
    assert reg.value("device_util_fraction") < 0.01  # not 0.83
    snap = acc.snapshot()
    assert snap["programs"]["A"]["calls"] == 0
    assert "a" not in snap["useful_flops_fraction"]  # aged out with A
    assert "b" in snap["useful_flops_fraction"]


def test_accountant_saturation_journal_record():
    reg = MetricsRegistry(namespace="t")
    jrn = EventJournal(registry=reg)
    acc = DeviceTimeAccountant(registry=reg, journal=jrn, peaks=None,
                               headroom_update_sec=0.0,
                               saturation_margin_streams=1.0)
    # one stream whose demand is ~2x the device: headroom < 0
    for _ in range(20):
        acc.observe_admit("s0", "t")
        acc.observe_batch("p", "t", 0.2, occupancy=1, slots=8)
    kinds = [r.kind for r in jrn.tail()]
    assert "capacity_saturation" in kinds
    sat = [r for r in jrn.tail() if r.kind == "capacity_saturation"][-1]
    assert sat.data["headroom_streams"] < 1.0
    assert reg.value("capacity_headroom_streams") == \
        pytest.approx(sat.data["headroom_streams"], abs=0.5)


# ---------------------------------------------------------------------------
# headroom math: synthetic mixes vs the analytic saturation point, and the
# reference's estimates on the same mixes
# ---------------------------------------------------------------------------

def test_headroom_is_the_references_source():
    rel = "devtime/headroom.py"
    port = (ROOT / "nerrf_tpu_torch" / rel).read_text()
    note = f"\nA host copy of ``nerrf_tpu/{rel}``, kept identical.\n"
    assert port.count(note) == 1
    assert port.replace(note, "") == (ROOT / "nerrf_tpu" / rel).read_text()


MIXES = {
    "uniform": ({f"s{i}": 2.0 for i in range(4)},
                {f"s{i}": {"b": 1.0} for i in range(4)}, {"b": 0.025}),
    "skewed": ({"a": 1.0, "b": 2.0, "c": 4.0, "d": 8.0},
               {s: {"b": 1.0} for s in "abcd"}, {"b": 0.02}),
    "hot_bucket": ({"a": 1.0, "b": 1.0},
                   {s: {"hot": 0.5, "cold": 0.5} for s in "ab"},
                   {"hot": 0.1, "cold": 0.01}),
    "saturated": ({"a": 30.0}, {"a": {"b": 1.0}}, {"b": 0.05}),
}


def test_headroom_uniform_mix_hits_analytic_saturation():
    # 4 streams, 2 windows/s each into one bucket costing 25 ms/window:
    # util = 0.2, per-stream demand 0.05 → saturation at exactly 20
    est = predict_headroom(*MIXES["uniform"])
    assert est.util == pytest.approx(0.2)
    assert est.saturation_streams == pytest.approx(20.0)
    assert est.headroom_streams == pytest.approx(16.0)


def test_headroom_skewed_rates():
    # rates 1/2/4/8 w/s, same 20 ms bucket: util = 0.3, mean demand
    # 0.075 → headroom (1-0.3)/0.075 = 9.333…
    est = predict_headroom(*MIXES["skewed"])
    assert est.util == pytest.approx(0.3)
    assert est.headroom_streams == pytest.approx((1 - 0.3) / 0.075)


def test_headroom_one_bucket_hot_mix():
    # util = 2·(0.5·0.1 + 0.5·0.01) = 0.11, mean demand 0.055
    est = predict_headroom(*MIXES["hot_bucket"])
    assert est.util == pytest.approx(0.11)
    assert est.per_bucket_util["hot"] == pytest.approx(0.1)
    assert est.saturation_streams == pytest.approx(2 + (1 - 0.11) / 0.055)


def test_headroom_degenerate_cases_return_null():
    assert predict_headroom({}, {}, {"b": 0.1}) is None
    assert predict_headroom({"s": 0.0}, {"s": {"b": 1.0}}, {"b": 0.1}) is None
    # unknown bucket: never a fake number
    assert predict_headroom({"s": 1.0}, {"s": {"mystery": 1.0}},
                            {"b": 0.1}) is None
    assert predict_headroom({"s": 1.0}, {}, {"b": 0.1}) is None


def _tracker_run(cls):
    trk = cls(window_sec=100.0)
    for i in range(10):
        t = float(i)
        trk.observe_admit("a", "b", t=t)
        trk.observe_admit("b", "b", t=t)
        trk.observe_batch("b", 0.1, 2, t=t + 0.5)
    for i in range(4):  # a second bucket, from one stream
        trk.observe_admit("a", "c", t=10.0 + i)
        trk.observe_batch("c", 0.3, 1, t=10.2 + i)
    return [trk.estimate(now=n) for n in (10.0, 14.0, 200.0)]


def test_headroom_tracker_windows_arrivals_and_costs():
    trk = HeadroomTracker(window_sec=100.0)
    for i in range(10):
        t = float(i)
        trk.observe_admit("a", "b", t=t)
        trk.observe_admit("b", "b", t=t)
        trk.observe_batch("b", 0.1, 2, t=t + 0.5)
    est = trk.estimate(now=10.0)
    assert est is not None and est.streams == 2
    assert est.saturation_streams == pytest.approx(20.0, rel=0.05)
    assert HeadroomTracker().estimate(now=1.0) is None


def test_headroom_estimates_equal_the_references():
    for name, args in MIXES.items():
        got, want = predict_headroom(*args), jdevtime.predict_headroom(*args)
        assert got.to_dict() == want.to_dict(), name
    got = [e.to_dict() if e else None for e in _tracker_run(HeadroomTracker)]
    want = [e.to_dict() if e else None
            for e in _tracker_run(jdevtime.HeadroomTracker)]
    assert got == want and got[0] is not None and got[-1] is None


# ---------------------------------------------------------------------------
# profiler capture plane
# ---------------------------------------------------------------------------

def test_capture_produces_readable_trace_dir(tmp_path):
    jrn = EventJournal()
    out = str(tmp_path / "trace")
    with profiled(out, journal=jrn) as active:
        assert active == out
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    summary = trace_summary(out)
    assert summary == {"files": 1, "bytes": summary["bytes"]}
    assert summary["bytes"] > 0
    (name,) = os.listdir(out)
    events = json.loads((tmp_path / "trace" / name).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    kinds = [r.kind for r in jrn.tail()]
    assert "profile_capture" in kinds and "profile_failed" not in kinds
    # the timed form: a dir back, one more capture record
    timed = str(tmp_path / "timed")
    assert capture_trace(timed, seconds=0.05, journal=jrn) == timed


def test_capture_disabled_is_a_noop(tmp_path):
    jrn = EventJournal()
    out = str(tmp_path / "trace")
    with profiled(out, enabled=False, journal=jrn) as active:
        assert active is None
    assert capture_trace(out, seconds=0.0, enabled=False, journal=jrn) is None
    assert not os.path.exists(out)
    assert jrn.tail() == []


def test_capture_start_failure_is_fail_open_with_journal(tmp_path, monkeypatch):
    def boom(self):
        raise RuntimeError("profiler already active")

    monkeypatch.setattr(torch.profiler.profile, "start", boom)
    jrn = EventJournal()
    out = str(tmp_path / "trace")
    with profiled(out, journal=jrn) as active:
        assert active is None  # fail-open: caller proceeds traceless
    recs = [r for r in jrn.tail() if r.kind == "profile_failed"]
    assert len(recs) == 1
    assert recs[0].data["phase"] == "start"
    assert "profiler already active" in recs[0].data["error"]
    assert capture_trace(out, seconds=0.0, journal=jrn) is None


def test_trace_summary_null_for_absent_or_empty(tmp_path):
    assert trace_summary(tmp_path / "nope") is None
    empty = tmp_path / "empty"
    empty.mkdir()
    assert trace_summary(empty) is None


# ---------------------------------------------------------------------------
# serve integration: the scorer-side observation path
# ---------------------------------------------------------------------------

def test_service_observe_devtime_derives_tag_occupancy_density():
    from test_torch_shed import make_port_service_shell

    cfg = ServeConfig(buckets=(BUCKET,))
    svc, reg = make_port_service_shell(cfg)
    acc = DeviceTimeAccountant(registry=reg, journal=svc._journal, peaks=None)
    acc.register_cost(f"serve_eval[{TAG}]", _fake_cost(program=f"serve_eval[{TAG}]"))
    svc._devtime = acc
    mask = np.zeros((8, 64), bool)
    mask[0, :32] = True   # one real window, half-dense
    mask[1, :16] = True   # one real window, quarter-dense
    batch = {"node_feat": np.zeros((8, 64, 5), np.float32),
             "edge_src": np.zeros((8, 128), np.int32),
             "seq_feat": np.zeros((8, 32, 100, 8), np.float32),
             "node_mask": mask}
    svc._observe_devtime(batch, 0.05)
    # occupancy 2/8 x mean density of the OCCUPIED slots (0.375)
    assert reg.value("device_useful_flops_fraction",
                     labels={"bucket": TAG}) == pytest.approx((2 / 8) * 0.375)
    snap = acc.snapshot()
    assert snap["programs"][f"serve_eval[{TAG}]"]["calls"] == 1
    assert bucket_tag(BUCKET) == TAG


# ---------------------------------------------------------------------------
# the shape trace, and the full-width count
# ---------------------------------------------------------------------------

def test_meta_operands_take_the_plain_version_and_other_devices_raise():
    ops.reset_launches()
    data = torch.empty(2, 16, 8, device="meta")
    ids = torch.empty(2, 16, dtype=torch.int32, device="meta")
    out = ops.segment_sum(data, ids, 5)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 5, 8)
    assert tuple(ops.gather_rows(out, ids).shape) == (2, 16, 8)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    from nerrf_tpu_torch.ops import segment

    fake = SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(RuntimeError, match="no kernel or plain version"):
        segment._use_kernel("segment_sum", fake)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_full_width_serve_flops_equal_the_smokes_closed_form(small_pair):
    smoke = _chip_smoke()
    rung = (4096, 4096, 4096)
    full = serve_program_costs(NerrfNet(JointConfig()),
                               ServeConfig(buckets=(rung,), batch_size=8))
    assert full[bucket_tag(rung)].flops == \
        smoke.serve_flops_closed_form(JointConfig(), 8, rung) == 15630482800640
    assert smoke.serve_flops_closed_form(JointConfig().small, 8, BUCKET) == \
        986497024
