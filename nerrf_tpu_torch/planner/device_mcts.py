"""On-device MCTS: the whole PUCT search as one CUDA kernel launch a chunk.

The port of ``nerrf_tpu/planner/device_mcts.py``.  The host planner
(`mcts.py`) keeps the tree on the host and sends leaf batches to the card;
this planner keeps the tree arrays in device memory, and select → expand →
evaluate → backup run inside the ``mcts_search`` kernel
(``ops/csrc/mcts_search.cu``, wrapped by :func:`ops.mcts.search_chunk`),
the counterpart of the reference's single XLA search program.  One
`plan()` is ⌈num_simulations / 128⌉ launches with a wall-clock check
between them, then one copy of the tree to the host.

Problem shapes are padded to buckets (`FILE_BUCKET_FLOOR`,
`PROC_BUCKET_FLOOR`, then the next power of two), as in the reference,
and every per-incident quantity (detector scores, loss estimates, PUCT
priors, the value net's weights) is a tensor argument of the launch.  The
reference pads to share one compiled executable per bucket; the port keeps
the same layouts so that the two searches and their batched forms agree.

The value net is a `ValueNet` (its weights, copied at construction, ride
in the kernel's shared memory) or ``None`` for the closed-form heuristic.
A params-closed Python callable (the reference's ``value_fn``) cannot run
inside a kernel: it is refused with ``TypeError``.

Same decision domain (`UndoDomain`, in padded coordinates in
:mod:`nerrf_tpu_torch.ops.mcts`), same PUCT scoring and reward bookkeeping
as the host planner, and the same plan extraction (`mcts.extract_plan`)
over the returned arrays.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from nerrf_tpu_torch.device import resolve_device, synchronize
from nerrf_tpu_torch.ops import mcts as ops_mcts
from nerrf_tpu_torch.ops.mcts import MCTSTree, SearchCtx, ValueWeights
from nerrf_tpu_torch.planner.domain import (
    DOWNTIME_WEIGHT,
    FP_REVERT_FLOOR_MB,
    FP_REVERT_SCALE,
    KILL_DOWNTIME_SEC,
    ONGOING_LOSS_MB_PER_SEC,
    REVERT_SECONDS_PER_MB,
    UndoDomain,
    UndoPlan,
)
from nerrf_tpu_torch.planner.mcts import MCTSConfig, extract_plan
from nerrf_tpu_torch.planner.value_net import ValueNet
from nerrf_tpu_torch.tracing import span as trace_span

# Simulations per launch of a plan: the reference's chunk, between which the
# wall-clock budget is checked.
CHUNK_SIMULATIONS = 128


def search_constants(max_steps: float, c_puct: float, device) -> torch.Tensor:
    """The kernel's constants (``ops.mcts.CONST_SLOTS``) as f32 on
    ``device``: the domain's reward constants, the literals the reference
    writes inline (a kill's false-positive factor 2.0, the 30 s loss cap, the
    heuristic's 5.0 s horizon), and the reciprocals of the constants the
    reference divides by (its XLA program multiplies by them)."""
    f32 = np.float32
    one = f32(1.0)
    values = {
        "revert_seconds_per_mb": REVERT_SECONDS_PER_MB,
        "fp_revert_scale": FP_REVERT_SCALE,
        "fp_revert_floor_mb": FP_REVERT_FLOOR_MB,
        "downtime_weight": DOWNTIME_WEIGHT,
        "ongoing_loss_mb_per_sec": ONGOING_LOSS_MB_PER_SEC,
        "kill_downtime_sec": KILL_DOWNTIME_SEC,
        "kill_cost": DOWNTIME_WEIGHT * KILL_DOWNTIME_SEC,
        "fp_kill_factor": 2.0,
        "loss_cap_sec": 30.0,
        "heuristic_horizon_sec": 5.0,
        "recip_q_scale": one / f32(50.0),
        "recip_downtime_scale": one / f32(60.0),
        "recip_max_steps": one / f32(max_steps),
        "max_steps": max_steps,
        "c_puct": c_puct,
    }
    vec = np.array([values[k] for k in ops_mcts.CONST_SLOTS], np.float32)
    return torch.from_numpy(vec).to(device)


def tree_to_host(tree: MCTSTree) -> dict:
    """What `extract_plan` reads of the trees, as numpy on the host."""
    return {k: getattr(tree, k).cpu().numpy()
            for k in ("children", "visits", "value_sum", "terminal", "expanded")}


def run_chunks(tree: MCTSTree, ctx: SearchCtx, value: Optional[ValueWeights],
               cfg: MCTSConfig, t0: float) -> int:
    """The plan's chunk schedule: ≤ CHUNK_SIMULATIONS simulations a launch,
    the wall-clock budget checked after each (a sync); returns the
    simulations run."""
    done = 0
    chunk = min(CHUNK_SIMULATIONS, cfg.num_simulations)
    while done < cfg.num_simulations:
        n = min(chunk, cfg.num_simulations - done)
        ops_mcts.search_chunk(tree, n, ctx, value)
        done += n
        synchronize(tree.visits.device)
        if time.perf_counter() - t0 > cfg.timeout_seconds:
            break
    return done


@dataclasses.dataclass
class DeviceMCTS:
    """Single-kernel MCTS over an :class:`UndoDomain` on ``device`` (the
    card unless the caller names another; on the CPU the search runs its
    plain version)."""

    domain: UndoDomain
    cfg: MCTSConfig = dataclasses.field(default_factory=MCTSConfig)
    value: Optional[ValueNet] = None
    device: Optional[object] = None

    # Shape buckets.  F and P are padded up to these floors (then the next
    # power of two), as the reference pads them.
    FILE_BUCKET_FLOOR = 256
    PROC_BUCKET_FLOOR = 16

    @staticmethod
    def _bucket(n: int, floor: int) -> int:
        n = max(int(n), 1)
        return max(floor, 1 << int(np.ceil(np.log2(n))))

    def __post_init__(self) -> None:
        if self.value is not None and not isinstance(self.value, ValueNet):
            raise TypeError(
                f"DeviceMCTS takes a ValueNet or None, not {type(self.value).__name__}: "
                "the search runs inside one kernel, which can evaluate the value "
                "net's weights but no Python callable")
        self.device = resolve_device(self.device)
        d = self.domain
        F, P = d.F, d.P
        Fp = self._bucket(F, self.FILE_BUCKET_FLOOR)
        Pp = self._bucket(P, self.PROC_BUCKET_FLOOR)
        self._real = (F, P)
        self._dims = dict(F=Fp, P=Pp, A=Fp + Pp + 1, D=Fp + Pp + 3)

        def pad(a: np.ndarray, n: int) -> np.ndarray:
            out = np.zeros(n, np.float32)
            out[: len(a)] = a
            return out

        pr = d.priors()
        prior = np.zeros(Fp + Pp + 1, np.float32)
        prior[:F] = pr[:F]
        prior[Fp:Fp + P] = pr[F:F + P]
        prior[-1] = pr[-1]
        dev = self.device
        put = lambda a: torch.from_numpy(np.asarray(a, np.float32)[None]).to(dev)  # noqa: E731
        self._ctx = SearchCtx(
            file_scores=put(pad(d.file_scores, Fp)),
            file_loss=put(pad(d.file_loss_mb, Fp)),
            proc_scores=put(pad(d.proc_scores, Pp)),
            prior=put(prior),
            real=put(np.array([F, P], np.float32)),
            consts=search_constants(float(d.max_steps), float(self.cfg.c_puct), dev),
        )
        self._weights = None if self.value is None else self.value.search_weights(dev)
        # the trees of the last plan(), left on the device for inspection
        self.last_tree: Optional[MCTSTree] = None

    @property
    def route(self) -> str:
        """The ``mcts_search`` entry this planner's trees take on the card
        (:func:`ops.mcts.search_route` of its shape)."""
        return ops_mcts.search_route(self.cfg.num_simulations + 1, self._dims["F"],
                                     self._dims["P"],
                                     0 if self._weights is None else self._weights.hidden)

    def _pad_state(self, s: np.ndarray) -> np.ndarray:
        """Domain-shaped state [F+P+3] → padded [Fp+Pp+3]; pad files are
        born done and pad procs born killed, so they are never legal."""
        (F, P), (Fp, Pp) = self._real, (self._dims["F"], self._dims["P"])
        out = np.ones(self._dims["D"], np.float32)
        out[:F] = s[:F]
        out[Fp:Fp + P] = s[F:F + P]
        out[Fp + Pp:] = s[F + P:]
        return out

    def _action_map(self) -> np.ndarray:
        """Domain action index → padded action index (files | procs | stop)."""
        (F, P), (Fp, Pp) = self._real, (self._dims["F"], self._dims["P"])
        return np.concatenate(
            [np.arange(F), Fp + np.arange(P), [Fp + Pp]]).astype(np.int64)

    def _unpad_state(self, p: np.ndarray) -> np.ndarray:
        (F, P), (Fp, Pp) = self._real, (self._dims["F"], self._dims["P"])
        return np.concatenate([p[:F], p[Fp:Fp + P], p[Fp + Pp:]])

    # --- domain-coordinate views of the search's domain ops, through the
    # plain version (tests cross-check these against the numpy UndoDomain
    # transition and the reference) ----------------------------------------

    def _padded(self, s) -> torch.Tensor:
        return torch.from_numpy(self._pad_state(np.asarray(s, np.float32))).to(self.device)

    def _step(self, s, a):
        c = self._ctx
        s2, r = ops_mcts.step(self._padded(s), int(self._action_map()[int(a)]),
                              c.file_scores[0], c.file_loss[0], c.proc_scores[0], c.consts)
        return torch.from_numpy(self._unpad_state(s2.cpu().numpy())), r.cpu()

    def _legal(self, s):
        full = ops_mcts.legal(self._padded(s), self._dims["F"], self._dims["P"],
                              self._ctx.consts)
        return full.cpu()[torch.from_numpy(self._action_map())]

    def _terminal(self, s):
        return ops_mcts.terminal(self._padded(s), self._dims["F"], self._dims["P"],
                                 self._ctx.consts).cpu()

    def _features(self, s):
        c = self._ctx
        return ops_mcts.features(self._padded(s), c.file_scores[0], c.file_loss[0],
                                 c.proc_scores[0], c.real[0], c.consts).cpu()

    def init_tree(self, root_state: Optional[np.ndarray] = None) -> MCTSTree:
        """A fresh tree over ``root_state`` (domain-shaped; the domain's
        initial state by default) on the planner's device."""
        s = self.domain.initial_state() if root_state is None else root_state
        return ops_mcts.init_tree(self._padded(s)[None], self.cfg.num_simulations + 1,
                                  self._dims["F"], self._dims["P"], self._ctx.consts)

    def warmup(self) -> float:
        """One 1-simulation launch on a fresh tree, synced: builds and loads
        the kernel's library on first use; returns the seconds spent."""
        t0 = time.perf_counter()
        ops_mcts.search_chunk(self.init_tree(), 1, self._ctx, self._weights)
        synchronize(self.device)
        return time.perf_counter() - t0

    @classmethod
    def warmup_for(cls, num_files: int, num_procs: int,
                   cfg: Optional[MCTSConfig] = None, value: Optional[ValueNet] = None,
                   max_steps: int = 64, device=None) -> "DeviceMCTS":
        """A planner for the shape bucket covering (num_files, num_procs),
        warmed: what a resident daemon does at boot, before any incident
        exists, so that the kernel's build stays out of MTTR."""
        n_f, n_p = max(int(num_files), 1), max(int(num_procs), 1)
        dummy = UndoDomain(
            file_paths=[f"/warm/{i}" for i in range(n_f)],
            file_scores=np.full(n_f, 0.5, np.float32),
            file_loss_mb=np.ones(n_f, np.float32),
            proc_names=[f"warm-{i}" for i in range(n_p)],
            proc_scores=np.full(n_p, 0.5, np.float32),
            max_steps=max_steps,
        )
        planner = cls(dummy, cfg or MCTSConfig(), value=value, device=device)
        planner.warmup()
        return planner

    # kept for tests and debugging: one full search from a root state
    # (domain-shaped; padded internally), in one launch
    def _search(self, root_state) -> MCTSTree:
        tree = self.init_tree(np.asarray(root_state, np.float32))
        return ops_mcts.search_chunk(tree, self.cfg.num_simulations, self._ctx,
                                     self._weights)

    def plan(self) -> UndoPlan:
        """Search within the spec budget (``timeout_seconds``) and extract.

        The search runs in launches of ≤128 simulations with a wall-clock
        check between them (a sync each): a kernel cannot be interrupted, so
        chunking is what keeps the ≤5 min planning budget a real contract,
        as in the reference.  Recorded as the host planner's ``mcts_plan``
        span (the reference's device search opens none), so a traced undo
        shows the search whichever planner ran it."""
        with trace_span("mcts_plan", simulations=self.cfg.num_simulations,
                        device=True) as sp:
            t0 = time.perf_counter()
            tree = self.init_tree()
            run_chunks(tree, self._ctx, self._weights, self.cfg, t0)
            self.last_tree = tree
            host = tree_to_host(tree)
            elapsed = time.perf_counter() - t0
            visits = host["visits"][0]
            # project the padded action axis back onto the domain's action
            # space (pad slots are never legal, so dropping them loses nothing)
            plan = extract_plan(
                self.domain, self.cfg,
                children=host["children"][0][:, self._action_map()],
                visits=visits, value_sum=host["value_sum"][0],
                is_terminal=host["terminal"][0], expanded=host["expanded"][0],
                sims=int(visits[0]), elapsed=elapsed, root=0,
            )
            sp.args["rollouts"] = plan.rollouts
        return plan
