"""Batched incident planning: one search kernel launch over many incidents.

The port of ``nerrf_tpu/respond/planner.py``'s `BatchedDeviceMCTS`.  The
reference vmaps the single-incident search program over a batch of
incident roots (``jit(vmap(...))``); here the ``mcts_search`` kernel takes
B trees in one launch (``gridDim = B``, one thread block a tree), so a
batch slot is the single planner's computation with a leading tree axis,
which is what makes the B = 1 parity gate meaningful.

Incidents are padded into (file, proc) shape buckets as `DeviceMCTS` pads
them, batches are padded up a fixed batch-slot ladder, and `warmup_for`
runs one 1-simulation launch per slot.  `recompiles` (and the registry's
``respond_recompiles_total``) keep the reference's meaning: waves that ran
outside the warmed (bucket, slot) set.  The reference's ``CompileCache``
argument and ``respond_program_key`` wait for the port's compile-cache
slice.  Pad lanes re-run the first incident's context on a pre-stopped
root: terminal at the root, the search visits it once a simulation
without growing the tree.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nerrf_tpu_torch.device import resolve_device, synchronize
from nerrf_tpu_torch.ops import mcts as ops_mcts
from nerrf_tpu_torch.ops.mcts import SearchCtx
from nerrf_tpu_torch.planner.device_mcts import (
    DeviceMCTS,
    run_chunks,
    search_constants,
    tree_to_host,
)
from nerrf_tpu_torch.planner.domain import UndoDomain, UndoPlan
from nerrf_tpu_torch.planner.mcts import MCTSConfig, extract_plan
from nerrf_tpu_torch.planner.value_net import ValueNet


def _bucket_dims(d: UndoDomain) -> Tuple[int, int, float]:
    """(Fp, Pp, max_steps): the bucket signature of one domain, without
    paying a DeviceMCTS construction to learn it."""
    return (DeviceMCTS._bucket(d.F, DeviceMCTS.FILE_BUCKET_FLOOR),
            DeviceMCTS._bucket(d.P, DeviceMCTS.PROC_BUCKET_FLOOR),
            float(d.max_steps))


def _pack_batch(domains: Sequence[UndoDomain], F: int, P: int, pad_to: int,
                c_puct: float, device) -> Tuple[torch.Tensor, SearchCtx]:
    """Host-side wave assembly: (padded roots [B, D], batched `SearchCtx`)
    built from the domains in numpy, one transfer per field.  Per-lane
    layout is bit-identical to DeviceMCTS.__post_init__/_pad_state (pad
    files born done, pad procs born killed, zero scores — the parity tests
    pin this).  Lanes past ``len(domains)`` repeat lane 0 with the root
    pre-stopped."""
    n, B, D = len(domains), pad_to, F + P + 3
    fs = np.zeros((B, F), np.float32)
    fl = np.zeros((B, F), np.float32)
    ps = np.zeros((B, P), np.float32)
    pr = np.zeros((B, F + P + 1), np.float32)
    real = np.zeros((B, 2), np.float32)
    roots = np.ones((B, D), np.float32)
    for i in range(B):
        d = domains[i] if i < n else domains[0]
        f, p = d.F, d.P
        fs[i, :f] = d.file_scores
        fl[i, :f] = d.file_loss_mb
        ps[i, :p] = d.proc_scores
        dp = d.priors()
        pr[i, :f] = dp[:f]
        pr[i, F:F + p] = dp[f:f + p]
        pr[i, -1] = dp[-1]
        real[i] = (f, p)
        s = d.initial_state()
        roots[i, :f] = s[:f]
        roots[i, F:F + p] = s[f:f + p]
        roots[i, F + P:] = s[f + p:]
    roots[n:, -1] = 1.0  # pad lanes: root already stopped
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    ctx = SearchCtx(file_scores=put(fs), file_loss=put(fl), proc_scores=put(ps),
                    prior=put(pr), real=put(real),
                    consts=search_constants(float(domains[0].max_steps), c_puct, device))
    return put(roots), ctx


def _action_map(F: int, P: int, f: int, p: int) -> np.ndarray:
    """Domain action index → padded action index (files | procs | stop) —
    DeviceMCTS._action_map without the instance."""
    return np.concatenate(
        [np.arange(f), F + np.arange(p), [F + P]]).astype(np.int64)


class BatchedDeviceMCTS:
    """The respond tier's planner: one kernel launch a chunk for a whole
    wave of incidents, each batch slot warmed at start.

    ``value`` (a `ValueNet`, or None for the closed-form heuristic, the
    online default) is SHARED by every incident of a batch."""

    def __init__(self, cfg: Optional[MCTSConfig] = None,
                 batch_slots: Sequence[int] = (1, 2, 4, 8),
                 value: Optional[ValueNet] = None, registry=None,
                 device=None) -> None:
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        if value is not None and not isinstance(value, ValueNet):
            raise TypeError(f"BatchedDeviceMCTS takes a ValueNet or None, not "
                            f"{type(value).__name__}")
        self.cfg = cfg or MCTSConfig()
        self.batch_slots = tuple(sorted(set(int(b) for b in batch_slots)))
        if not self.batch_slots or self.batch_slots[0] < 1:
            raise ValueError(f"bad batch_slots: {batch_slots}")
        self.device = resolve_device(device)
        self.value = value
        self._weights = None if value is None else value.search_weights(self.device)
        self._reg = registry
        # (F, P, max_steps, B) warmed by warmup_for
        self._warmed: set = set()
        self._recompiles = 0

    # -- warmup ------------------------------------------------------------

    def _slot_for(self, n: int) -> int:
        for b in self.batch_slots:
            if n <= b:
                return b
        return self.batch_slots[-1]

    def warmup_for(self, num_files: int, num_procs: int,
                   max_steps: int = 64) -> float:
        """One 1-simulation launch per batch slot for the bucket covering
        (num_files, num_procs), synced; returns seconds.  The resident
        daemon's boot step: afterwards every wave the admission clamps allow
        runs inside the warmed set."""
        t0 = time.perf_counter()
        dm = DeviceMCTS.warmup_for(num_files, num_procs, self.cfg, value=self.value,
                                   max_steps=max_steps, device=self.device)
        dims = dm._dims
        for B in self.batch_slots:
            roots, ctx = _pack_batch([dm.domain] * B, dims["F"], dims["P"], B,
                                     float(self.cfg.c_puct), self.device)
            tree = ops_mcts.init_tree(roots, self.cfg.num_simulations + 1, dims["F"],
                                      dims["P"], ctx.consts)
            ops_mcts.search_chunk(tree, 1, ctx, self._weights)
            synchronize(self.device)
            self._warmed.add((dims["F"], dims["P"], float(max_steps), B))
        return time.perf_counter() - t0

    @property
    def recompiles(self) -> int:
        """Waves that ran outside the warmed (bucket, slot) set."""
        return self._recompiles

    # -- planning ----------------------------------------------------------

    def plan_batch(self, domains: Sequence[UndoDomain]) -> List[UndoPlan]:
        """Plan every domain in one (or a few) batched searches.

        All domains must land in ONE (file, proc) shape bucket — the
        admission clamps guarantee it for router traffic; mixed-bucket
        callers get a loud error.  Counts above the largest batch slot are
        processed in slot-sized waves."""
        if not domains:
            return []
        dims0 = _bucket_dims(domains[0])
        for d in domains[1:]:
            got = _bucket_dims(d)
            if got != dims0:
                raise ValueError(
                    f"mixed shape buckets in one batch: {got} vs {dims0} "
                    "(clamp domains at admission — RespondConfig.max_files/"
                    "max_procs)")
        out: List[UndoPlan] = []
        top = self.batch_slots[-1]
        for i in range(0, len(domains), top):
            out.extend(self._plan_wave(list(domains[i:i + top]), dims0))
        return out

    def _plan_wave(self, domains: List[UndoDomain],
                   dims: Tuple[int, int, float]) -> List[UndoPlan]:
        cfg = self.cfg
        F, P, max_steps = dims
        n = len(domains)
        B = self._slot_for(n)
        if (F, P, max_steps, B) not in self._warmed:
            # honesty counter: the zero-recompile contract says warmup
            # should have covered this wave
            self._recompiles += 1
            self._reg.counter_inc(
                "respond_recompiles_total",
                help="batched searches that ran outside the warmed "
                     "(bucket, batch-slot) ladder — should stay 0 after "
                     "warmup")

        t0 = time.perf_counter()
        roots, ctx = _pack_batch(domains, F, P, B, float(cfg.c_puct), self.device)
        tree = ops_mcts.init_tree(roots, cfg.num_simulations + 1, F, P, ctx.consts)
        # DeviceMCTS.plan's chunk schedule — REQUIRED for the B = 1 parity
        # contract with the single planner
        run_chunks(tree, ctx, self._weights, cfg, t0)
        host = tree_to_host(tree)
        elapsed = time.perf_counter() - t0

        plans: List[UndoPlan] = []
        for i, d in enumerate(domains):
            amap = _action_map(F, P, d.F, d.P)
            plans.append(extract_plan(
                d, cfg,
                children=host["children"][i][:, amap],
                visits=host["visits"][i], value_sum=host["value_sum"][i],
                is_terminal=host["terminal"][i], expanded=host["expanded"][i],
                sims=int(host["visits"][i][0]), elapsed=elapsed, root=0))
        return plans
