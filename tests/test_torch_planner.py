"""The port's undo planner (nerrf_tpu_torch.planner, ops.mcts) against the JAX
package's, on the CPU (the search kernel's plain version).

* ``UndoDomain`` is a host copy: ``legal_actions``, ``terminal``,
  ``step_batch``, ``priors``, ``value_features`` and ``expected_gains`` are
  bit-equal.
* ``DeviceMCTS``'s domain ops in padded coordinates: states, legality and
  terminality exact against the reference's ``DeviceMCTS``; rewards and
  features within 1e-6·(1+|x|) (the reference's XLA program contracts
  a*b + c into one rounding and divides by a constant as a product with its
  reciprocal; the port rounds every product and sum on its own).
* Heuristic searches: the port's tree equals the reference's
  ``DeviceMCTS._search`` tree (every node, child, visit count and flag;
  value sums and edge rewards within the tolerance above, relative to
  their size), and plans on ``bench.py``'s planner domain are equal.  One
  bucket (256f/16p) and one M (201) throughout, so that XLA compiles the
  reference's search once.
* The value net: a converted flax net's forward within 1e-5, and
  ``fit_to_domain`` from the same init against the reference's fit (loss
  and root value within 1e-3 relative, every fitted state within
  1e-2·(1+|v|): ``optax.adam`` and ``torch.optim.Adam`` round
  differently); the search kernel's layout of the weights.
* ``make_planner`` and the device rule: the CPU runs the plain version,
  the default device raises without CUDA, nothing falls back.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nerrf_tpu.planner import MCTSConfig as JMCTSConfig
from nerrf_tpu.planner import MCTSPlanner as JMCTSPlanner
from nerrf_tpu.planner import UndoDomain as JUndoDomain
from nerrf_tpu.planner.device_mcts import DeviceMCTS as JDeviceMCTS
from nerrf_tpu.planner.value_net import HeuristicValue as JHeuristicValue
from nerrf_tpu.planner.value_net import ValueNet as JValueNet
from nerrf_tpu_torch import convert
from nerrf_tpu_torch.ops import mcts as ops_mcts
from nerrf_tpu_torch.planner import (
    DeviceMCTS,
    MCTSConfig,
    MCTSPlanner,
    UndoDomain,
    make_planner,
)
from nerrf_tpu_torch.planner.device_mcts import search_constants
from nerrf_tpu_torch.planner.value_net import HeuristicValue, ValueNet, heuristic_value

SIMS = 200  # one M for every search below: the reference compiles once
TREE_EXACT = ("visits", "children", "parent", "parent_action", "expanded", "terminal")
# |Δ| ≤ 1e-6·(1 + |x|) for one reward or feature (FMA and reciprocals);
# value sums add up to SIMS such terms
ATOL = 1e-6


def _domain(mod, seed, F=12, P=3, max_steps=64, beta=True):
    rng = np.random.default_rng(seed)
    if beta:
        scores = rng.beta(0.4, 0.4, F).astype(np.float32)
    else:
        scores = np.where(np.arange(F) % 2 == 0, 0.95, 0.03).astype(np.float32)
    loss = rng.uniform(1.0, 4.0, F).astype(np.float32)
    pscores = rng.uniform(0.0, 1.0, P).astype(np.float32)
    return mod(
        file_paths=[f"/app/uploads/f_{i}.lockbit3" for i in range(F)],
        file_scores=scores, file_loss_mb=loss,
        proc_names=[f"{4567 + p}:python3" for p in range(P)],
        proc_scores=pscores, max_steps=max_steps)


def bench_domain(mod):
    """``bench.py``'s planner domain: M1 scale, 45 files, 4 processes."""
    prng = np.random.default_rng(7)
    F, P = 45, 4
    return mod(
        file_paths=[f"/app/uploads/doc_{i}.lockbit3" for i in range(F)],
        file_scores=prng.beta(0.4, 0.4, F).astype(np.float32),
        file_loss_mb=prng.uniform(2.0, 5.0, F).astype(np.float32),
        proc_names=[f"{4000 + p}:python3" for p in range(P)],
        proc_scores=np.array([0.95] + [0.1] * (P - 1), np.float32),
        max_steps=64)


def _close(got, want, what, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > atol * (1.0 + np.abs(want))
    assert not bad.any(), f"{what}: max |Δ| {np.abs(got - want).max()}"


def _plan_key(plan):
    return [(a.kind.name, a.target) for a in plan.actions]


# --- the domain copy ---------------------------------------------------------


@pytest.mark.parametrize("seed,F,P", [(0, 12, 3), (1, 45, 4), (2, 1, 1)])
def test_domain_copy_bit_equal(seed, F, P):
    jd, d = _domain(JUndoDomain, seed, F, P), _domain(UndoDomain, seed, F, P)
    rng = np.random.default_rng(seed + 100)
    s = rng.integers(0, 2, (32, d.state_dim)).astype(np.float32)
    s[:, F + P] = rng.uniform(0, 10, 32)
    s[:, F + P + 1] = rng.integers(0, 70, 32)
    for name in ("legal_actions", "terminal", "value_features"):
        np.testing.assert_array_equal(getattr(d, name)(s), getattr(jd, name)(s), err_msg=name)
    a = rng.integers(0, d.A, 32)
    for got, want in zip(d.step_batch(s, a), jd.step_batch(s, a)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(d.priors(), jd.priors())
    np.testing.assert_array_equal(d.expected_gains(), jd.expected_gains())
    for i in (0, d.F, d.A - 1):
        got, want = dataclasses.asdict(d.action_info(i)), dataclasses.asdict(jd.action_info(i))
        assert got.pop("kind").name == want.pop("kind").name and got == want


# --- the search's domain ops, padded, against the reference's ----------------


@pytest.mark.parametrize("F,P", [(255, 15), (256, 16), (257, 17), (3, 1)])
def test_step_legal_terminal_features_match_reference(F, P):
    """A random walk at the bucket boundaries of
    test_pad_unpad_roundtrip_at_bucket_boundaries: exact states, legality and
    terminality; rewards and features within 1e-6·(1+|x|)."""
    jd, d = _domain(JUndoDomain, F, F, P), _domain(UndoDomain, F, F, P)
    cfg = MCTSConfig(num_simulations=4)
    ref = JDeviceMCTS(jd, JMCTSConfig(num_simulations=4))
    dm = DeviceMCTS(d, cfg, device="cpu")
    assert dm._dims == ref._dims
    rng = np.random.default_rng(F * 1000 + P)
    s = d.initial_state()
    for _ in range(8):
        legal = d.legal_actions(s[None])[0]
        if not legal.any():
            break
        a = int(rng.choice(np.flatnonzero(legal)))
        s2, r = dm._step(s, a)
        js2, jr = ref._step(s, a)
        np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))
        np.testing.assert_array_equal(s2.numpy(), d.step_batch(s[None], np.array([a]))[0][0])
        _close(float(r), float(jr), "reward")
        np.testing.assert_array_equal(dm._legal(s2).numpy(), np.asarray(ref._legal(js2)))
        assert bool(dm._terminal(s2)) == bool(ref._terminal(js2))
        _close(dm._features(s2).numpy(), np.asarray(ref._features(js2)), "features")
        s = s2.numpy()
    padded = dm._pad_state(d.initial_state())
    np.testing.assert_array_equal(padded, ref._pad_state(jd.initial_state()))
    np.testing.assert_array_equal(dm._unpad_state(padded), d.initial_state())
    np.testing.assert_array_equal(dm._action_map(), ref._action_map())


# --- heuristic searches -------------------------------------------------------


def _assert_trees_equal(tree, jtree, what):
    """The port's tree [1, ...] against the reference's: every structural
    array equal; value sums and edge rewards within the tolerance, scaled by
    the node's visits (a value sum adds one leaf value and its path's edge
    rewards per visit)."""
    jt = jax.device_get(jtree)
    assert int(tree.n_nodes[0]) == int(jt.n_nodes), what
    for name in TREE_EXACT:
        got = getattr(tree, name)[0].numpy()
        want = np.asarray(getattr(jt, name)).astype(got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(tree.state[0].numpy(), np.asarray(jt.state), err_msg=what)
    _close(tree.child_reward[0].numpy(), np.asarray(jt.child_reward), f"{what}: child_reward")
    visits = np.maximum(tree.visits[0].numpy(), 1)
    scale = np.abs(np.asarray(jt.value_sum)) + visits
    diff = np.abs(tree.value_sum[0].numpy() - np.asarray(jt.value_sum))
    assert (diff <= 64 * ATOL * scale).all(), f"{what}: value_sum max |Δ| {diff.max()}"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_heuristic_search_tree_matches_reference(seed):
    jd, d = _domain(JUndoDomain, seed), _domain(UndoDomain, seed)
    jtree = JDeviceMCTS(jd, JMCTSConfig(num_simulations=SIMS))._search(jd.initial_state())
    tree = DeviceMCTS(d, MCTSConfig(num_simulations=SIMS), device="cpu")._search(
        d.initial_state())
    _assert_trees_equal(tree, jtree, f"seed {seed}")


def test_bench_domain_plan_matches_reference():
    jd, d = bench_domain(JUndoDomain), bench_domain(UndoDomain)
    want = JDeviceMCTS(jd, JMCTSConfig(num_simulations=SIMS)).plan()
    got = DeviceMCTS(d, MCTSConfig(num_simulations=SIMS), device="cpu").plan()
    assert _plan_key(got) == _plan_key(want)
    assert got.rollouts == want.rollouts == SIMS
    _close(got.expected_reward, want.expected_reward, "expected_reward", atol=64 * ATOL)


def test_terminal_root_and_determinism():
    d = _domain(UndoDomain, 0)
    dm = DeviceMCTS(d, MCTSConfig(num_simulations=20), device="cpu")
    s = d.initial_state()
    s[d.F + d.P + 2] = 1.0  # stopped
    tree = dm._search(s)
    assert int(tree.n_nodes[0]) == 1 and int(tree.visits[0, 0]) == 20
    p1, p2 = dm.plan(), dm.plan()
    assert _plan_key(p1) == _plan_key(p2) and p1.expected_reward == p2.expected_reward
    over = DeviceMCTS(d, MCTSConfig(num_simulations=5000, timeout_seconds=0.0),
                      device="cpu").plan()
    assert over.rollouts == 128  # one chunk, then the wall-clock check trips


def test_all_clean_domain_plans_nothing():
    F = 6
    d = UndoDomain(file_paths=[f"/app/f{i}.dat" for i in range(F)],
                   file_scores=np.full(F, 0.02, np.float32),
                   file_loss_mb=np.full(F, 2.0, np.float32),
                   proc_names=["200:nginx"], proc_scores=np.array([0.01], np.float32),
                   max_steps=16)
    assert DeviceMCTS(d, MCTSConfig(num_simulations=100), device="cpu").plan().actions == []


def test_host_planner_matches_reference():
    jd, d = _domain(JUndoDomain, 5, beta=False), _domain(UndoDomain, 5, beta=False)
    cfg = dict(num_simulations=SIMS, batch_size=16)
    want = JMCTSPlanner(jd, JHeuristicValue(), JMCTSConfig(**cfg)).plan()
    got = MCTSPlanner(d, HeuristicValue("cpu"), MCTSConfig(**cfg)).plan()
    assert _plan_key(got) == _plan_key(want)
    assert got.rollouts == want.rollouts


# --- the value net ------------------------------------------------------------


def _converted(hidden=16, seed=3):
    jnet = JValueNet.create(jax.random.PRNGKey(seed), hidden=hidden)
    net = ValueNet.create(seed=0, hidden=hidden, device="cpu")
    net.model.load_state_dict(convert.value_net_to_state_dict(jax.device_get(jnet.params)))
    return jnet, net


def test_value_net_forward_matches_flax():
    jnet, net = _converted()
    x = np.random.default_rng(0).normal(0, 3, (256, 8)).astype(np.float32)
    np.testing.assert_allclose(net(x), jnet(x), rtol=0, atol=1e-5)
    # the search's plain leaf value on the kernel layout of the weights
    consts = search_constants(64.0, 1.5, "cpu")
    got = ops_mcts.leaf_value_plain(torch.from_numpy(x), consts, net.search_weights())
    np.testing.assert_allclose(got.numpy(), jnet(x), rtol=0, atol=1e-5)


def _rollout_features(d, num_rollouts, horizon, seed=0):
    """The states ``fit_to_domain`` regresses on: its prior-guided rollouts,
    the same numpy draws."""
    rng = np.random.default_rng(seed)
    priors = d.priors()
    s = np.stack([d.initial_state()] * num_rollouts)
    feats = []
    for _ in range(horizon):
        feats.append(d.value_features(s))
        p = priors[None, :] * d.legal_actions(s)
        rowsum = p.sum(-1, keepdims=True)
        p = np.where(rowsum > 0, p / np.maximum(rowsum, 1e-9), 0.0)
        a = np.array([rng.choice(d.A, p=p[b]) if rowsum[b, 0] > 0 else d.A - 1
                      for b in range(num_rollouts)])
        s, _ = d.step_batch(s, a)
    return np.concatenate(feats)


def test_fit_to_domain_matches_reference():
    """The same converted init and the reference's rollouts (numpy, one
    seed): the final losses and the root state's value agree within 1e-3
    relative; over all the states the fit regresses on, the two nets agree
    within 1e-2·(1+|v|) (6.1e-3 measured): ``optax.adam`` and
    ``torch.optim.Adam`` take different rounding from gradients that differ
    in the last bits (product order, GELU), and 60 Adam steps at lr 1e-2
    amplify that."""
    jnet, net = _converted(hidden=32)
    jd, d = _domain(JUndoDomain, 4, beta=False), _domain(UndoDomain, 4, beta=False)
    kw = dict(num_rollouts=64, horizon=16, steps=60)
    jloss, loss = jnet.fit_to_domain(jd, **kw), net.fit_to_domain(d, **kw)
    np.testing.assert_allclose(loss, jloss, rtol=1e-3)
    root = d.value_features(d.initial_state()[None])
    np.testing.assert_allclose(net(root), jnet(root), rtol=1e-3)
    x = _rollout_features(d, kw["num_rollouts"], kw["horizon"])
    got, want = net(x), jnet(x)
    assert np.max(np.abs(got - want) / (1.0 + np.abs(want))) <= 1e-2


def test_heuristic_value_is_the_plain_leaf_value():
    x = np.random.default_rng(1).normal(0, 5, (64, 8)).astype(np.float32)
    x[::3, 7] = 1.0
    consts = search_constants(64.0, 1.5, "cpu")
    want = heuristic_value(torch.from_numpy(x))
    assert torch.equal(ops_mcts.leaf_value_plain(torch.from_numpy(x), consts), want)
    np.testing.assert_allclose(HeuristicValue("cpu")(x), JHeuristicValue()(x), rtol=1e-6,
                               atol=1e-5)


# --- construction and the device rule ------------------------------------------


def test_make_planner_kinds_on_the_cpu():
    d = bench_domain(UndoDomain)
    ops_mcts.reset_launches()
    dm = make_planner(d, None, MCTSConfig(num_simulations=50), kind="auto", device="cpu")
    assert isinstance(dm, DeviceMCTS) and dm.plan().rollouts == 50
    assert ops_mcts.LAUNCHES == {"mcts_search": 0, "mcts_value": 0}
    host = make_planner(d, None, MCTSConfig(num_simulations=50, batch_size=16),
                        kind="host", device="cpu")
    assert isinstance(host, MCTSPlanner) and host.plan().rollouts == 50
    with pytest.raises(ValueError, match="unknown planner kind"):
        make_planner(d, None, MCTSConfig(), kind="gpu", device="cpu")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = bench_domain(UndoDomain)
    for kind in ("auto", "device", "host"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_planner(d, None, MCTSConfig(), kind=kind)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ValueNet.create()


def test_device_mcts_refuses_a_callable_value():
    d = bench_domain(UndoDomain)
    with pytest.raises(TypeError, match="ValueNet or None"):
        DeviceMCTS(d, MCTSConfig(), value=lambda f: f[:, 0], device="cpu")


def test_search_weights_layout_and_limits():
    net = ValueNet.create(seed=1, hidden=8, device="cpu")
    w = net.search_weights()
    assert w.hidden == 8 and w.flat.numel() == ops_mcts.weight_count(8) == 8 * 8 + 88 + 1
    m = net.model
    np.testing.assert_array_equal(w.flat[:64].view(8, 8).numpy(), m.Dense_0.weight.T.detach())
    assert float(w.flat[-1]) == float(m.Dense_2.bias.detach())
    # the search kernel's shared memory: the bench bucket with h = 64 fits
    assert ops_mcts.shared_bytes(256, 16, 64) <= ops_mcts.MAX_SHARED_BYTES
    assert ops_mcts.shared_bytes(256, 16, 256) > ops_mcts.MAX_SHARED_BYTES
