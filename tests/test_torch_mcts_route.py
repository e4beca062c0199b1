"""The search kernel's two entries and what the resident one relies on, on
the CPU.

* :func:`ops.mcts.search_route` and the resident entry's shared-memory
  budget for each bucket of ``chip_smoke.mcts_domains()`` at 96, 800 and
  5000 simulations, with the heuristic and a value net of width 64.
* The invariants the resident entry relies on, held on the plain version
  over seeded trees (one root with marks off 0 and 1): parents made before
  their children, each child in its parent's row, a zero edge reward in
  every empty slot, each unvisited legal action scoring c·prior·root bit
  for bit, the legal bitmask equal to ``legal()``.
* Its arithmetic, modelled in numpy: the warp's halving sums (lane l holds
  elements l + 32k) add as ``_halve`` does, bit for bit; the warp argmax
  by ordered keys picks what ``argmax`` picks.
* A search in chunks of at most 128 simulations, each resuming the last
  one's tree, equals one whole search, bit for bit: through ``plan()`` at 96
  (one chunk) and 300 (two resumed chunks) simulations on a seeded
  12-file domain, and through ``search_chunk`` (128 + 128 + 44) against
  ``DeviceMCTS._search`` on ``bench.py``'s 45-file domain.

The plain search is thousands of small tensor ops; each test runs it on one
intra-op thread, so that the CPU's other test processes do not make each op
wait on a thread pool.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from nerrf_tpu_torch.ops import mcts as ops_mcts
from nerrf_tpu_torch.planner import DeviceMCTS, MCTSConfig, UndoDomain

ROOT = Path(__file__).resolve().parents[1]
ROUTE_AT = {96: "resident", 800: "resident", 5000: "global"}


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sims", sorted(ROUTE_AT))
def test_route_and_shared_budget_per_bucket(sims):
    domains = _chip_smoke().mcts_domains()
    buckets = set()
    for d, _ in domains.values():
        dm = DeviceMCTS(d, MCTSConfig(num_simulations=sims), device="cpu")
        buckets.add((dm._dims["F"], dm._dims["P"]))
    assert buckets == {(256, 16), (512, 32)}
    for Fp, Pp in buckets:
        for hidden in (0, 64):
            M = sims + 1
            route = ops_mcts.search_route(M, Fp, Pp, hidden)
            need = ops_mcts.resident_shared_bytes(M, Fp, Pp, hidden)
            assert route == ROUTE_AT[sims], (Fp, Pp, hidden)
            if route == "resident":
                assert need <= ops_mcts.MAX_SHARED_BYTES
            else:
                assert need > ops_mcts.MAX_SHARED_BYTES
                assert ops_mcts.shared_bytes(Fp, Pp, hidden) <= ops_mcts.MAX_SHARED_BYTES


def test_resident_layout_and_the_global_case():
    # the layout's bytes at the bench bucket (the card checks the C entry's
    # count against this function), and check_mcts's global case
    assert ops_mcts.resident_shared_bytes(801, 256, 16, 64) == 76256
    assert ops_mcts.resident_shared_bytes(801, 256, 16, 0) == 54480
    name, sims = _chip_smoke().MCTS_GLOBAL_CASE
    assert name == "512f/32p bucket 300f/20p"
    assert ops_mcts.search_route(sims + 1, 512, 32, 0) == "global"
    # halving sums of more than 16 values a lane (Fp or Pp above 512) go global
    assert ops_mcts.search_route(65, 1024, 16, 0) == "global"
    assert ops_mcts.search_route(65, 512, 16, 0) == "resident"


@pytest.mark.parametrize("case", ["96", "300", "bench-300"])
def test_plan_chunks_resume_to_the_whole_search(case):
    # DeviceMCTS.plan searches in chunks of 128 simulations, each resuming
    # the last one's tree; on the plain version the plan's tree equals one
    # whole search (the card holds the kernel's chunks to the same tree),
    # and the planner names the entry its shape takes.  "bench-300" resumes
    # by hand through search_chunk (the dispatching wrapper) on bench.py's
    # domain, against one _search call of all 300
    if case == "bench-300":
        sims, d = 300, _chip_smoke().bench_domain()
        dm = DeviceMCTS(d, MCTSConfig(num_simulations=sims), device="cpu")
        whole = dm._search(d.initial_state())
        chunked = dm.init_tree()
        for n in (128, 128, 44):
            ops_mcts.search_chunk(chunked, n, dm._ctx)
    else:
        sims = int(case)
        dm = DeviceMCTS(_domain(sims), MCTSConfig(num_simulations=sims), device="cpu")
        assert dm.route == ops_mcts.search_route(sims + 1, 256, 16, 0) == "resident"
        dm.plan()
        chunked = dm.last_tree
        whole = dm.init_tree()
        ops_mcts.search_chunk_plain(whole, sims, dm._ctx, dm._weights)
    for f in whole._fields:
        assert torch.equal(getattr(chunked, f), getattr(whole, f)), f
    assert int(chunked.visits[0, 0]) == sims


def _domain(seed, F=12, P=3):
    rng = np.random.default_rng(seed)
    return UndoDomain(
        file_paths=[f"/app/uploads/f_{i}.lockbit3" for i in range(F)],
        file_scores=rng.beta(0.4, 0.4, F).astype(np.float32),
        file_loss_mb=rng.uniform(1.0, 4.0, F).astype(np.float32),
        proc_names=[f"{4567 + p}:python3" for p in range(P)],
        proc_scores=rng.uniform(0.0, 1.0, P).astype(np.float32), max_steps=16)


def _legal_words(s, Fp, Pp, consts):
    """The resident entry's legal-action bitmask of states ``s`` [n, D] as
    its warp ballots form it: word w bit i for action 32w + i, set for a
    mark below 0.5 or the stop action while the episode is open."""
    A = Fp + Pp + 1
    W = (A + 31) // 32
    max_steps = consts[ops_mcts.CONST_SLOTS.index("max_steps")]
    open_ = (s[:, Fp + Pp + 2] < 0.5) & (s[:, Fp + Pp + 1] < max_steps)
    bits = torch.zeros(s.shape[0], 32 * W, dtype=torch.bool)
    bits[:, :Fp + Pp] = s[:, :Fp + Pp] < 0.5
    bits[:, Fp + Pp] = True
    bits &= open_[:, None]
    return (bits.view(-1, W, 32).long() << torch.arange(32)).sum(-1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_trees_hold_the_resident_invariants(seed):
    d = _domain(seed)
    dm = DeviceMCTS(d, MCTSConfig(num_simulations=60), device="cpu")
    root = d.initial_state()
    if seed == 2:  # marks off 0 and 1: the legal bits follow s < 0.5, not 0/1
        root[:5] = [0.3, 0.7, -1.0, 2.0, 0.5]
    t = dm._search(root)
    Fp, Pp, A = dm._dims["F"], dm._dims["P"], dm._dims["A"]
    n = int(t.n_nodes[0])
    assert n > 20
    parent, pa = t.parent[0, :n].long(), t.parent_action[0, :n].long()
    kids = t.children[0, :n]
    # every node made after its parent, in its parent's row, expanded
    assert bool((parent[1:] >= 0).all()) and bool((parent[1:] < torch.arange(1, n)).all())
    assert torch.equal(kids[parent[1:], pa[1:]], torch.arange(1, n, dtype=kids.dtype))
    assert int((kids >= 0).sum()) == n - 1
    assert bool((t.expanded[0, :n] == 1).all())
    # an empty slot's edge reward is 0
    assert bool((t.child_reward[0, :n][kids < 0] == 0).all())
    # an unvisited legal action scores c·prior·root, bit for bit
    scores = ops_mcts.ucb_scores(t, 0, n, dm._ctx, Fp, Pp)
    ok = ops_mcts.legal(t.state[0, :n], Fp, Pp, dm._ctx.consts)
    c = dm._ctx.consts[ops_mcts.CONST_SLOTS.index("c_puct")]
    root_n = torch.sqrt(t.visits[0, :n].clamp(min=1).to(torch.float32))
    closed = (c * dm._ctx.prior[0])[None, :] * root_n[:, None]
    fresh = ok & (kids < 0)
    assert int(fresh.sum()) > 0
    assert torch.equal(scores[fresh], closed[fresh])
    # the legal bitmask: s < 0.5 or stop, while open; no bit past A
    words = _legal_words(t.state[0, :n], Fp, Pp, dm._ctx.consts)
    bits = (words[..., None] >> torch.arange(32)) & 1
    bits = bits.reshape(n, -1).bool()
    assert torch.equal(bits[:, :A], ok) and not bool(bits[:, A:].any())


def _lane_tree(v):
    """The halving tree over one lane's values: evens' tree + odds' tree."""
    return v[0] if len(v) == 1 else _lane_tree(v[0::2]) + _lane_tree(v[1::2])


def _warp_halving(x):
    """The resident entry's ``warp_sums`` on one array, in float32."""
    n = len(x)
    if n >= 32:
        lanes = [_lane_tree([x[lane + 32 * k] for k in range(n // 32)]) for lane in range(32)]
        off = 16
    else:
        lanes = [x[lane] if lane < n else np.float32(0) for lane in range(32)]
        off = n // 2
    while off:
        lanes = [lanes[i] + (lanes[i + off] if i + off < 32 else lanes[i]) for i in range(32)]
        off //= 2
    return lanes[0]


@pytest.mark.parametrize("n", [1, 2, 16, 32, 64, 256, 512])
def test_warp_halving_sums_add_as_the_plain_version(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-4, 5, n)).astype(np.float32)
    want = ops_mcts._halve(torch.from_numpy(x)).numpy()
    got = np.float32(_warp_halving([np.float32(v) for v in x]))
    assert got.tobytes() == want.tobytes()


def _order_key(f):
    """The kernel's ``order_key``: larger floats larger keys, ±0 one key."""
    if np.isnan(f):
        return 0
    u = int(np.array([f + np.float32(0.0)], np.float32).view(np.uint32)[0])
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def test_warp_argmax_by_keys_picks_the_plain_argmax():
    rng = np.random.default_rng(5)
    rows = [rng.choice(np.float32([-np.inf, -0.0, 0.0, 0.25, 0.5, -3.0]), 40)
            for _ in range(200)]
    rows += [np.full(40, -np.inf, np.float32), np.float32(rng.standard_normal(40))]
    for row in rows:
        keys = [_order_key(np.float32(v)) for v in row]
        kmax = max(keys)
        got = min(a for a, k in enumerate(keys) if k == kmax)
        assert got == int(torch.from_numpy(np.asarray(row, np.float32)).argmax())
