"""The port's batched incident planner (nerrf_tpu_torch.respond
``BatchedDeviceMCTS``) on the CPU (the search kernel's plain version), against
the port's ``DeviceMCTS`` and the JAX package's ``BatchedDeviceMCTS``.

* A wave packs its lanes exactly as ``DeviceMCTS`` pads one incident.
* B = 1 is bit-equal to ``DeviceMCTS`` (every tree array), a lane of a
  padded slot to the same incident alone, waves run above the top slot,
  mixed buckets raise, and the recompile counter keeps the reference's
  meaning.
* B = 1 plans equal the reference's ``BatchedDeviceMCTS`` plans (one
  bucket and one M, so that XLA compiles the reference's search once).
"""

import numpy as np
import pytest
import torch

from nerrf_tpu.observability import MetricsRegistry as JMetricsRegistry
from nerrf_tpu.planner import MCTSConfig as JMCTSConfig
from nerrf_tpu.planner import UndoDomain as JUndoDomain
from nerrf_tpu.respond import BatchedDeviceMCTS as JBatchedDeviceMCTS
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.ops import mcts as ops_mcts
from nerrf_tpu_torch.planner import DeviceMCTS, MCTSConfig, UndoDomain
from nerrf_tpu_torch.planner.device_mcts import run_chunks
from nerrf_tpu_torch.respond import BatchedDeviceMCTS
from nerrf_tpu_torch.respond.planner import _bucket_dims, _pack_batch

CFG = MCTSConfig(num_simulations=48)


def _domain(mod, seed=0, F=10, P=2, max_steps=64):
    rng = np.random.default_rng(seed)
    scores = np.where(np.arange(F) % 2 == 0, 0.95, 0.03).astype(np.float32)
    return mod(
        file_paths=[f"/srv/data/f_{i}.lockbit3" for i in range(F)],
        file_scores=scores,
        file_loss_mb=rng.uniform(1.0, 4.0, F).astype(np.float32),
        proc_names=[f"{4000 + p}:python3" for p in range(P)],
        proc_scores=np.array([0.97] + [0.05] * (P - 1), np.float32),
        max_steps=max_steps,
    )


def _key(plan):
    return ([(a.kind.name, a.target) for a in plan.actions], plan.expected_reward,
            plan.rollouts)


def _batched(cfg=CFG, **kw):
    return BatchedDeviceMCTS(cfg, device="cpu", registry=MetricsRegistry(), **kw)


def test_pack_batch_lane_layout_equals_device_mcts():
    ds = [_domain(UndoDomain, s, F=3 + s, P=1 + s % 2) for s in range(3)]
    F, P, _ = _bucket_dims(ds[0])
    roots, ctx = _pack_batch(ds, F, P, 4, 1.5, "cpu")
    for i, d in enumerate(ds):
        dm = DeviceMCTS(d, CFG, device="cpu")
        assert torch.equal(roots[i], torch.from_numpy(dm._pad_state(d.initial_state())))
        for name in ("file_scores", "file_loss", "proc_scores", "prior", "real"):
            assert torch.equal(getattr(ctx, name)[i], getattr(dm._ctx, name)[0]), name
        assert torch.equal(ctx.consts, dm._ctx.consts)
    assert roots[3, -1] == 1.0  # the pad lane's root is stopped


def test_single_incident_tree_bit_equal_to_device_mcts():
    d = _domain(UndoDomain, seed=3)
    dm = DeviceMCTS(d, CFG, device="cpu")
    solo = dm.init_tree()
    run_chunks(solo, dm._ctx, None, CFG, 0.0)
    F, P, _ = _bucket_dims(d)
    roots, ctx = _pack_batch([d], F, P, 1, CFG.c_puct, "cpu")
    wave = ops_mcts.init_tree(roots, CFG.num_simulations + 1, F, P, ctx.consts)
    run_chunks(wave, ctx, None, CFG, 0.0)
    for a, b in zip(solo, wave):
        assert torch.equal(a, b)
    got = _batched(batch_slots=(1, 2)).plan_batch([d])[0]
    assert _key(got)[0::2] == _key(dm.plan())[0::2]
    assert got.expected_reward == dm.plan().expected_reward


def test_padded_slot_lanes_equal_solo_plans():
    ds = [_domain(UndoDomain, seed=s) for s in (1, 2, 3)]
    solo = [DeviceMCTS(d, CFG, device="cpu").plan() for d in ds]
    packed = _batched(batch_slots=(4,)).plan_batch(ds)
    for s, p in zip(solo, packed):
        assert _key(p)[0::2] == _key(s)[0::2] and p.expected_reward == s.expected_reward


def test_zero_recompiles_after_warmup_and_waves():
    reg = MetricsRegistry()
    b = BatchedDeviceMCTS(CFG, batch_slots=(1, 2), registry=reg, device="cpu")
    b.warmup_for(10, 2)
    for n in (1, 2):
        b.plan_batch([_domain(UndoDomain, seed=10 + i) for i in range(n)])
    plans = b.plan_batch([_domain(UndoDomain, seed=s) for s in range(5)])
    assert len(plans) == 5 and all(p.rollouts == CFG.num_simulations for p in plans)
    assert b.recompiles == 0 and reg.value("respond_recompiles_total") == 0.0
    cold = BatchedDeviceMCTS(CFG, batch_slots=(2,), registry=reg, device="cpu")
    cold.plan_batch([_domain(UndoDomain, seed=1)])  # no warmup: counted
    assert cold.recompiles == 1 and reg.value("respond_recompiles_total") == 1.0


def test_mixed_buckets_raise_and_value_must_be_a_net():
    b = _batched()
    with pytest.raises(ValueError, match="mixed shape buckets"):
        b.plan_batch([_domain(UndoDomain, max_steps=64), _domain(UndoDomain, max_steps=32)])
    with pytest.raises(ValueError, match="mixed shape buckets"):
        b.plan_batch([_domain(UndoDomain), _domain(UndoDomain, F=300)])
    with pytest.raises(TypeError, match="ValueNet or None"):
        BatchedDeviceMCTS(CFG, value=lambda f: f[:, 0], device="cpu")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedDeviceMCTS(CFG, registry=MetricsRegistry())


@pytest.mark.parametrize("seed", [3, 4])
def test_single_incident_plans_equal_reference(seed):
    jcfg = JMCTSConfig(num_simulations=CFG.num_simulations)
    want = JBatchedDeviceMCTS(jcfg, batch_slots=(1,), registry=JMetricsRegistry()).plan_batch(
        [_domain(JUndoDomain, seed=seed)])[0]
    got = _batched(batch_slots=(1,)).plan_batch([_domain(UndoDomain, seed=seed)])[0]
    assert _key(got)[0] == _key(want)[0] and got.rollouts == want.rollouts
    assert abs(got.expected_reward - want.expected_reward) <= 1e-4 * (
        1 + abs(want.expected_reward))
