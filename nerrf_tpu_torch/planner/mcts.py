"""MCTS rollback planner: host-side PUCT tree, device-batched leaf values.

(Copied from ``nerrf_tpu/planner/mcts.py``; keep the two identical.  The
port's changes: the default `HeuristicValue` runs on ``device``, and a leaf
batch that comes back as a tensor on the card is resolved with ``.cpu()``.)

Implements the reference's specified planner (`architecture.mdx:62-72`:
500–1000 simulations, ≤5 min budget, ranked undo plan) with the host/device
split that fits TPU (SURVEY.md §7 "MCTS host↔device ping-pong"): tree
selection/expansion/backup is irregular pointer-chasing — that stays on host
in preallocated numpy arrays — while leaf evaluation is a dense [B, 8] →
[B] value-net call dispatched to the device once per frontier batch, with
virtual loss keeping the B selected paths distinct.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

import torch

from nerrf_tpu_torch.planner.domain import UndoDomain, UndoPlan
from nerrf_tpu_torch.planner.value_net import HeuristicValue, ValueFn
from nerrf_tpu_torch.tracing import span as trace_span


@dataclasses.dataclass(frozen=True)
class MCTSConfig:
    num_simulations: int = 800          # spec band: 500–1000
    # Frontier leaves per device dispatch.  Each dispatch pays a fixed
    # host→device round trip (large over a remote tunnel); bigger batches
    # amortize it, and since r2 the dispatch is double-buffered — the host
    # selects/expands frontier i+1 while batch i's values are in flight —
    # so the round trip overlaps host work instead of serializing with it.
    # 64 stays the default to stay conservative on small action spaces;
    # bench.py uses 128 (the benchmark of record tracks rollouts/s there).
    batch_size: int = 64
    c_puct: float = 1.5
    virtual_loss: float = 3.0
    max_nodes: int = 4096
    timeout_seconds: float = 300.0      # spec: ≤5 min planning
    plan_actions: int = 64              # max actions emitted in the plan


class MCTSPlanner:
    def __init__(self, domain: UndoDomain, value_fn: Optional[ValueFn] = None,
                 cfg: Optional[MCTSConfig] = None, device=None) -> None:
        self.d = domain
        self.value_fn = value_fn if value_fn is not None else HeuristicValue(device)
        self.cfg = cfg or MCTSConfig()

        self.prior = domain.priors()
        self._reset()

    def _reset(self) -> None:
        N, A, D = self.cfg.max_nodes, self.d.A, self.d.state_dim
        self.state = np.zeros((N, D), np.float32)
        self.visits = np.zeros(N, np.int64)
        self.value_sum = np.zeros(N, np.float64)
        # count of outstanding (selected, not yet backed-up) paths per node
        self.vloss = np.zeros(N, np.int64)
        self.parent = np.full(N, -1, np.int64)
        self.parent_action = np.full(N, -1, np.int64)
        self.children = np.full((N, A), -1, np.int64)
        self.child_reward = np.zeros((N, A), np.float32)
        self.legal = np.zeros((N, A), np.bool_)
        self.expanded = np.zeros(N, np.bool_)
        self.is_terminal = np.zeros(N, np.bool_)
        self.n_nodes = 0

    # --- tree primitives -----------------------------------------------------
    def _new_node(self, s: np.ndarray, parent: int, action: int) -> int:
        i = self.n_nodes
        if i >= self.cfg.max_nodes:
            raise RuntimeError("MCTS node pool exhausted")
        self.n_nodes += 1
        self.state[i] = s
        self.parent[i] = parent
        self.parent_action[i] = action
        self.legal[i] = self.d.legal_actions(s[None])[0]
        self.is_terminal[i] = bool(self.d.terminal(s[None])[0])
        return i

    def _ucb(self, i: int) -> np.ndarray:
        kids = self.children[i]
        nv = np.where(kids >= 0, self.visits[np.maximum(kids, 0)], 0)
        vs = np.where(kids >= 0, self.value_sum[np.maximum(kids, 0)], 0.0)
        # virtual loss: each outstanding selection counts as a visit that
        # returned cfg.virtual_loss below average, so concurrent selections in
        # one frontier batch spread over distinct leaves (including unvisited
        # children, whose effective visit count becomes nonzero)
        vl = np.where(kids >= 0, self.vloss[np.maximum(kids, 0)], 0)
        nv_eff = nv + vl
        q = np.where(nv_eff > 0,
                     (vs - vl * self.cfg.virtual_loss) / np.maximum(nv_eff, 1), 0.0)
        # normalize Q to a bounded scale for PUCT mixing
        q = q / 50.0
        total = max(self.visits[i] + self.vloss[i], 1)
        u = self.cfg.c_puct * self.prior * np.sqrt(total) / (1.0 + nv_eff)
        score = q + u + self.child_reward[i] / 50.0
        score = np.where(self.legal[i], score, -np.inf)
        return score

    def _select_leaf(self) -> tuple[int, list[int]]:
        """Descend by UCB until hitting an unexpanded/terminal node."""
        i, path = 0, [0]
        while self.expanded[i] and not self.is_terminal[i]:
            a = int(np.argmax(self._ucb(i)))
            child = self.children[i, a]
            if child < 0:
                s, r = self.d.step_batch(self.state[i][None], np.array([a]))
                child = self._new_node(s[0], i, a)
                self.children[i, a] = child
                self.child_reward[i, a] = r[0]
            i = int(child)
            path.append(i)
        return i, path

    def _backup(self, path: list[int], leaf_value: float) -> None:
        # value at each node = sum of rewards below it + leaf value
        v = float(leaf_value)
        for i in reversed(path):
            self.visits[i] += 1
            self.value_sum[i] += v
            a = self.parent_action[i]
            if a >= 0:
                v += float(self.child_reward[self.parent[i], a])

    # --- main loop -----------------------------------------------------------
    def plan(self) -> UndoPlan:
        with trace_span("mcts_plan",
                        simulations=self.cfg.num_simulations) as sp:
            plan = self._plan()
            sp.args["rollouts"] = plan.rollouts
        return plan

    def _plan(self) -> UndoPlan:
        t0 = time.perf_counter()
        cfg = self.cfg
        self._reset()  # planner is reusable: every plan() searches a fresh tree
        root = self._new_node(self.d.initial_state(), -1, -1)
        self.expanded[root] = True
        sims = 0
        # async double-buffered dispatch: while frontier batch i's values are
        # in flight on the device, the host selects/expands batch i+1 (its
        # virtual losses from batch i are still applied, so the two batches
        # explore disjoint leaves).  ValueFns exposing `submit` return the
        # un-synced device tensor; plain callables degrade to synchronous.
        submit = getattr(self.value_fn, "submit", self.value_fn)
        issued = 0
        pending: Optional[tuple[list, object]] = None

        def collect() -> Optional[tuple[list, object]]:
            nonlocal issued
            want = min(cfg.batch_size, cfg.num_simulations - issued)
            if want <= 0:
                return None
            frontier: list[tuple[int, list[int]]] = []
            for _ in range(want):
                leaf, path = self._select_leaf()
                for n in path:
                    self.vloss[n] += 1
                frontier.append((leaf, path))
            issued += len(frontier)
            feats = self.d.value_features(
                np.stack([self.state[leaf] for leaf, _ in frontier])
            )
            return frontier, submit(feats)

        def resolve(batch: tuple[list, object]) -> None:
            nonlocal sims
            frontier, fut = batch
            # the sync point (device round trip): when these spans dominate
            # mcts_plan, the search is device-bound, not tree-bound
            with trace_span("mcts_leaf_eval", device=True,
                            batch=len(frontier)):
                if isinstance(fut, torch.Tensor):
                    fut = fut.cpu()
                values = np.asarray(fut)
            terminal = np.array(
                [self.is_terminal[leaf] for leaf, _ in frontier])
            values = np.where(terminal, 0.0, values)
            for (leaf, path), v in zip(frontier, values):
                for n in path:
                    self.vloss[n] -= 1
                self.expanded[leaf] = True
                self._backup(path, float(v))
                sims += 1

        pending = collect()
        while pending is not None:
            if time.perf_counter() - t0 > cfg.timeout_seconds:
                resolve(pending)
                break
            nxt = collect()   # overlaps with pending's device eval
            resolve(pending)
            pending = nxt
        elapsed = time.perf_counter() - t0

        # --- extract ranked plan ---------------------------------------------
        # 1) greedy descent by visit count while the tree has visit mass;
        # 2) then append the remaining positive-expected-gain candidates the
        #    search didn't fully explore (ranked by expected gain), so the
        #    plan covers every flagged target even at modest budgets — the
        #    spec's "ranked undo candidates" (architecture.mdx:63-69).
        return extract_plan(
            self.d, cfg, children=self.children, visits=self.visits,
            value_sum=self.value_sum, is_terminal=self.is_terminal,
            expanded=self.expanded, sims=sims, elapsed=elapsed, root=root,
        )


def extract_plan(domain, cfg, *, children, visits, value_sum, is_terminal,
                 expanded, sims, elapsed, root=0) -> UndoPlan:
    """Ranked plan from a searched tree (shared by the host planner and the
    on-device planner — both produce the same array family)."""
    actions = []
    taken: set[int] = set()
    i = root
    # below this visit mass the argmax is exploration noise, not a
    # decision — hand over to the expected-gain ranking instead
    min_visits = max(4, sims // 100)
    for _ in range(cfg.plan_actions):
        kids = children[i]
        counts = np.where(kids >= 0, visits[np.maximum(kids, 0)], 0)
        if counts.max() < min_visits:
            break
        a = int(np.argmax(counts))
        info = domain.action_info(a)
        if info.kind.name == "STOP":
            break
        if a not in taken:
            actions.append(info)
            taken.add(a)
        i = int(kids[a])
        if is_terminal[i] or not expanded[i]:
            break
    gains = domain.expected_gains()
    for a in np.argsort(-gains):
        if len(actions) >= cfg.plan_actions:
            break
        if int(a) in taken or gains[a] <= 0 or int(a) == domain.A - 1:
            continue
        actions.append(domain.action_info(int(a)))
        taken.add(int(a))
    root_value = value_sum[root] / max(visits[root], 1)
    return UndoPlan(
        actions=actions,
        expected_reward=float(root_value),
        rollouts=sims,
        rollouts_per_sec=sims / elapsed if elapsed > 0 else 0.0,
        planning_seconds=elapsed,
    )
