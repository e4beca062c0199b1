"""The device MCTS search: one CUDA kernel (``csrc/mcts_search.cu``) and its
plain PyTorch version.

The counterpart of the reference's search program
(``nerrf_tpu/planner/device_mcts.py`` ``search_chunk``, an XLA program and
not a Pallas kernel) and of its vmap over incidents
(``nerrf_tpu/respond/planner.py``): :func:`search_chunk` runs ``num_sims``
more simulations of select → expand → evaluate → backup on B search trees
at once, in place, resumable across calls.

* On CUDA tensors it launches ``mcts_search`` (one thread block a tree,
  counted in :data:`LAUNCHES`, and by entry in :data:`ROUTE_LAUNCHES`) or
  raises.  :func:`search_route` picks the entry from the shape alone:
  ``resident`` (the working set of select and backup in shared memory for
  the launch) where it fits in a block, else ``global`` (the tree in device
  memory);
* on CPU tensors it runs :func:`search_chunk_plain`, the same four phases
  as Python loops over tensors, which runs on any device and is what the
  kernel is held against on the card (inside ``ops.plain_ops()``, as for
  the other ops).

Both compute one explicit arithmetic, so that they agree bit for bit with
the heuristic value: every product and sum rounded on its own (the kernel
is built with ``-fmad=false``); a division by a constant is a product with
the constant's f32 reciprocal (``consts``), as the reference's XLA program
computes it; a division by a runtime value is a true division; the sums
over the padded files and processes (powers of two) run as a halving tree,
``x[:n/2] + x[n/2:]`` repeated; the argmax breaks ties to the lowest index.
The value net needs no bit-equality: the kernel sums its products in its
own order.

The constants arrive as one f32 vector in the order of :data:`CONST_SLOTS`;
``planner/device_mcts.py`` fills it from ``planner/domain.py``, and nothing
in the kernel spells them again.  The value net arrives as
:class:`ValueWeights`, one flat f32 buffer in the kernel's layout; ``None``
is the closed-form heuristic.

The tree is updated in place (the reference returns a new one): a chunk
of a plan continues the same buffers.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from nerrf_tpu_torch.ops import kernels
from nerrf_tpu_torch.ops.segment import _use_kernel

# Kernel launches since the last reset_launches(); a wrapper adds one where
# it launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {"mcts_search": 0, "mcts_value": 0}
# ``mcts_search`` launches by entry (their sum is LAUNCHES["mcts_search"])
ROUTE_LAUNCHES: Dict[str, int] = {"resident": 0, "global": 0}
# each route's C entry (csrc/mcts_search.cu)
ROUTE_ENTRY = {"resident": "mcts_search_resident", "global": "mcts_search"}

# the constants vector, slot by slot (csrc/mcts_search.cu `enum Const`)
CONST_SLOTS = (
    "revert_seconds_per_mb", "fp_revert_scale", "fp_revert_floor_mb",
    "downtime_weight", "ongoing_loss_mb_per_sec", "kill_downtime_sec",
    "kill_cost",            # DOWNTIME_WEIGHT * KILL_DOWNTIME_SEC, as Python folds it
    "fp_kill_factor",       # the 2.0 of a kill's false-positive cost
    "loss_cap_sec",         # the 30 s encryptor-activity cap
    "heuristic_horizon_sec",  # the 5.0 of heuristic_value
    "recip_q_scale",        # 1/50: Q and edge rewards onto the PUCT scale
    "recip_downtime_scale",  # 1/60: the downtime feature
    "recip_max_steps", "max_steps", "c_puct",
)
_C = {name: i for i, name in enumerate(CONST_SLOTS)}
# the kernel's block and its shared-memory limit
THREADS = 256
MAX_SHARED_BYTES = 232448
# the resident entry's halving sums hold at most this many values a lane of
# one warp (csrc `kLaneValues`): Fp and Pp up to 32 times as many
LANE_VALUES = 16
# the value net's h x h rows lie h + W2_PAD floats apart in shared memory
W2_PAD = 8


def reset_launches() -> None:
    kernels.reset_counts(LAUNCHES, ROUTE_LAUNCHES)


class MCTSTree(NamedTuple):
    """B search trees of M node slots over A actions and D state features
    (the reference's ``_Tree`` with a leading tree axis)."""

    visits: torch.Tensor         # [B, M] int32
    value_sum: torch.Tensor      # [B, M] f32
    parent: torch.Tensor         # [B, M] int32
    parent_action: torch.Tensor  # [B, M] int32
    children: torch.Tensor       # [B, M, A] int32 (-1 = unvisited)
    child_reward: torch.Tensor   # [B, M, A] f32
    expanded: torch.Tensor       # [B, M] uint8
    terminal: torch.Tensor       # [B, M] uint8
    state: torch.Tensor          # [B, M, D] f32
    n_nodes: torch.Tensor        # [B] int32


class SearchCtx(NamedTuple):
    """Per-tree inputs, padded to the shape bucket (Fp files, Pp processes,
    both powers of two), and the shared constants."""

    file_scores: torch.Tensor  # [B, Fp] f32
    file_loss: torch.Tensor    # [B, Fp] f32
    proc_scores: torch.Tensor  # [B, Pp] f32
    prior: torch.Tensor        # [B, A] f32
    real: torch.Tensor         # [B, 2] f32: the real (F, P)
    consts: torch.Tensor       # [len(CONST_SLOTS)] f32


class ValueWeights(NamedTuple):
    """The value net in the kernel's layout: ``flat`` = [W1 (8 x h), b1 (h),
    W2 (h x h), b2 (h), W3 (h), b3 (1)], weights in-major (a Linear's
    ``weight.T``)."""

    flat: torch.Tensor  # [h*h + 11h + 1] f32
    hidden: int


def weight_count(hidden: int) -> int:
    return hidden * hidden + 11 * hidden + 1


def net_floats(hidden: int) -> int:
    """Floats of the value net in shared memory: the weights with W2's rows
    padded, and two hidden rows of scratch (csrc `net_floats`)."""
    return hidden * (hidden + W2_PAD) + 13 * hidden + 1 if hidden else 0


def shared_bytes(Fp: int, Pp: int, hidden: int) -> int:
    """The global entry's dynamic shared memory (csrc `shared_floats`)."""
    return 4 * (16 + net_floats(hidden) + 3 * Fp + 2 * Pp + 8)


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def resident_shared_bytes(M: int, Fp: int, Pp: int, hidden: int) -> int:
    """The resident entry's dynamic shared memory for trees of M slots
    (csrc `resident_bytes`): the constants and the domain's scores, the
    value net, the warp winners, then per node its visits, value sum,
    sqrt(visits), Q and edge reward on the PUCT scale, edge reward, path
    slot, a bitmask of its legal actions (⌈A/32⌉ words) and a flags
    byte."""
    A = Fp + Pp + 1
    W = (A + 31) // 32
    return (_a16(4 * 16) + 2 * _a16(4 * Fp) + _a16(4 * Pp)
            + _a16(4 * net_floats(hidden)) + 2 * 8 * 8
            + 7 * _a16(4 * M) + _a16(4 * M * W) + _a16(M))


def search_route(M: int, Fp: int, Pp: int, hidden: int) -> str:
    """The entry :func:`search_chunk` launches for trees of M slots in the
    Fp/Pp bucket with a value net of width ``hidden`` (0: the heuristic),
    from the shape alone: ``"resident"`` where its working set fits in a
    block's shared memory and its halving sums in a warp, else
    ``"global"``."""
    fits = (max(Fp, Pp) <= 32 * LANE_VALUES
            and resident_shared_bytes(M, Fp, Pp, hidden) <= MAX_SHARED_BYTES)
    return "resident" if fits else "global"


# --- the domain in padded coordinates (plain; shared by both versions' init) --
# state layout: [done_f (Fp), killed_p (Pp), downtime, steps, stopped]


def _const(consts: torch.Tensor, name: str) -> torch.Tensor:
    return consts[_C[name]]


def _halve(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two) as a halving tree."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def legal(s: torch.Tensor, Fp: int, Pp: int, consts: torch.Tensor) -> torch.Tensor:
    """bool [..., A]: pending files and live processes, and stop, while the
    episode is open."""
    ok = s[..., :Fp + Pp] < 0.5
    open_ = (s[..., Fp + Pp + 2] < 0.5) & (s[..., Fp + Pp + 1] < _const(consts, "max_steps"))
    return torch.cat([ok, torch.ones_like(ok[..., :1])], -1) & open_[..., None]


def terminal(s: torch.Tensor, Fp: int, Pp: int, consts: torch.Tensor) -> torch.Tensor:
    return (s[..., Fp + Pp + 2] > 0.5) | (s[..., Fp + Pp + 1] >= _const(consts, "max_steps"))


def step(s: torch.Tensor, a: int, fs: torch.Tensor, fl: torch.Tensor, ps: torch.Tensor,
         consts: torch.Tensor):
    """(state [D], action index) → (state', incremental reward): the
    reference's branchless ``step`` (``device_mcts.py:110``) in the explicit
    arithmetic."""
    c = lambda name: _const(consts, name)  # noqa: E731
    Fp, Pp = fs.shape[0], ps.shape[0]
    a = int(a)
    is_file, is_kill, is_stop = a < Fp, Fp <= a < Fp + Pp, a == Fp + Pp
    fi, pi = min(max(a, 0), Fp - 1), min(max(a - Fp, 0), Pp - 1)
    killed = s[Fp:Fp + Pp]
    live = _halve(ps * (killed < 0.5).to(s.dtype))
    steps = s[Fp + Pp + 1]
    remaining = torch.clamp(c("max_steps") - steps, min=0.0)
    cap = torch.minimum(remaining, c("loss_cap_sec"))
    if is_file:
        sc, loss = fs[fi], fl[fi]
        t_op = c("revert_seconds_per_mb") * loss
        fp_cost = c("fp_revert_scale") * loss + c("fp_revert_floor_mb")
        r = sc * loss - (1 - sc) * fp_cost - c("downtime_weight") * t_op
    elif is_kill:
        sc = ps[pi]
        r = (sc * c("ongoing_loss_mb_per_sec") * cap - c("kill_cost") * sc
             - (1 - sc) * c("downtime_weight") * c("kill_downtime_sec") * c("fp_kill_factor"))
    elif is_stop:
        r = -live * c("ongoing_loss_mb_per_sec") * cap
    else:
        r = torch.zeros((), dtype=s.dtype, device=s.device)
    add = torch.zeros(Fp + Pp, dtype=s.dtype, device=s.device)
    if is_file:
        add[fi] = 1.0
    elif is_kill:
        add[Fp + pi] = 1.0
    marks = torch.clamp(s[:Fp + Pp] + add, 0.0, 1.0)
    downtime = s[Fp + Pp] + t_op if is_file else s[Fp + Pp] + 0.0
    stopped = torch.clamp(s[Fp + Pp + 2], min=1.0 if is_stop else 0.0)
    return torch.cat([marks, downtime[None], (steps + 1.0)[None], stopped[None]]), r


def features(s: torch.Tensor, fs: torch.Tensor, fl: torch.Tensor, ps: torch.Tensor,
             real: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
    """[..., 8] value features of padded states ``s`` [..., D] (the
    reference's ``features``, ``device_mcts.py:153``): the done and killed
    fractions renormalized to the real counts ``real`` = (F, P)."""
    Fp, Pp = fs.shape[-1], ps.shape[-1]
    done, killed = s[..., :Fp], s[..., Fp:Fp + Pp]
    open_ = 1 - done
    f_sums = _halve(torch.stack([open_ * fs * fl, open_ * (1 - fs), done]))
    p_sums = _halve(torch.stack([ps * (killed < 0.5).to(s.dtype), killed]))
    rF, rP = real[..., 0], real[..., 1]
    return torch.stack([
        f_sums[0], f_sums[1], p_sums[0],
        (f_sums[2] - (Fp - rF)) / torch.clamp(rF, min=1.0),
        (p_sums[1] - (Pp - rP)) / torch.clamp(rP, min=1.0),
        s[..., Fp + Pp] * _const(consts, "recip_downtime_scale"),
        s[..., Fp + Pp + 1] * _const(consts, "recip_max_steps"),
        s[..., Fp + Pp + 2],
    ], -1)


def leaf_value_plain(feats: torch.Tensor, consts: torch.Tensor,
                     value: Optional[ValueWeights] = None) -> torch.Tensor:
    """[...] leaf values of ``feats`` [..., 8]: the heuristic (``value`` is
    None) or the value net from its flat weights."""
    if value is None:
        future = (feats[..., 0] - feats[..., 2] * _const(consts, "ongoing_loss_mb_per_sec")
                  * _const(consts, "heuristic_horizon_sec"))
        return torch.where(feats[..., 7] > 0.5, 0.0, future)
    h, w = value.hidden, value.flat
    parts, o = [], 0
    for n in (8 * h, h, h * h, h, h, 1):
        parts.append(w[o:o + n])
        o += n
    W1, b1, W2, b2, W3, b3 = parts
    x = F.gelu(feats @ W1.view(8, h) + b1, approximate="tanh")
    x = F.gelu(x @ W2.view(h, h) + b2, approximate="tanh")
    return x @ W3 + b3[0]


# --- the tree ----------------------------------------------------------------


def init_tree(roots: torch.Tensor, num_nodes: int, Fp: int, Pp: int,
              consts: torch.Tensor) -> MCTSTree:
    """Fresh trees of ``num_nodes`` slots over root states ``roots`` [B, D],
    on their device: the root expanded, its terminal flag set."""
    B, D = roots.shape
    A, M, dev = Fp + Pp + 1, num_nodes, roots.device
    if D != Fp + Pp + 3:
        raise ValueError(f"roots of width {D}; the bucket {Fp}f/{Pp}p takes {Fp + Pp + 3}")
    state = torch.zeros(B, M, D, dtype=torch.float32, device=dev)
    state[:, 0] = roots
    expanded = torch.zeros(B, M, dtype=torch.uint8, device=dev)
    expanded[:, 0] = 1
    term = torch.zeros(B, M, dtype=torch.uint8, device=dev)
    term[:, 0] = terminal(roots, Fp, Pp, consts).to(torch.uint8)
    return MCTSTree(
        visits=torch.zeros(B, M, dtype=torch.int32, device=dev),
        value_sum=torch.zeros(B, M, dtype=torch.float32, device=dev),
        parent=torch.full((B, M), -1, dtype=torch.int32, device=dev),
        parent_action=torch.full((B, M), -1, dtype=torch.int32, device=dev),
        children=torch.full((B, M, A), -1, dtype=torch.int32, device=dev),
        child_reward=torch.zeros(B, M, A, dtype=torch.float32, device=dev),
        expanded=expanded, terminal=term, state=state,
        n_nodes=torch.ones(B, dtype=torch.int32, device=dev))


def ucb_scores(t: MCTSTree, b: int, n: int, ctx: SearchCtx, Fp: int, Pp: int) -> torch.Tensor:
    """[n, A] f32: the PUCT score of every action of the first ``n`` nodes
    of tree ``b`` (the reference's ``ucb``, ``device_mcts.py:178``), -inf
    where illegal."""
    c = ctx.consts
    kids = t.children[b, :n]
    has = kids >= 0
    safe = kids.clamp(min=0).long()
    nv = torch.where(has, t.visits[b][safe], 0)
    vs = torch.where(has, t.value_sum[b][safe], 0.0)
    q = torch.where(nv > 0, vs / nv.clamp(min=1).to(torch.float32), 0.0)
    q = q * _const(c, "recip_q_scale")
    root = torch.sqrt(t.visits[b, :n].clamp(min=1).to(torch.float32))[:, None]
    u = _const(c, "c_puct") * ctx.prior[b] * root / (1.0 + nv.to(torch.float32))
    score = q + u + t.child_reward[b, :n] * _const(c, "recip_q_scale")
    ok = legal(t.state[b, :n], Fp, Pp, c)
    return torch.where(ok, score, torch.full_like(score, float("-inf")))


def _choices(t: MCTSTree, b: int, n: int, ctx: SearchCtx, Fp: int, Pp: int) -> List[list]:
    """Each of the first ``n`` nodes' UCB argmax (on every node at once: the
    tree does not change during a descent), that action's child and the
    node's expanded and terminal flags, as host lists: one sync a
    simulation, not one a level."""
    kids = t.children[b, :n]
    best = ucb_scores(t, b, n, ctx, Fp, Pp).argmax(dim=1)
    child = kids.gather(1, best[:, None])[:, 0].long()
    return torch.stack([best, child, t.expanded[b, :n].long(),
                        t.terminal[b, :n].long()]).tolist()


def _search_one(t: MCTSTree, b: int, num_sims: int, ctx: SearchCtx,
                value: Optional[ValueWeights]) -> None:
    Fp, Pp = ctx.file_scores.shape[1], ctx.proc_scores.shape[1]
    M = t.visits.shape[1]
    fs, fl, ps, real = (ctx.file_scores[b], ctx.file_loss[b], ctx.proc_scores[b],
                        ctx.real[b])
    c = ctx.consts
    dev = t.visits.device
    n = int(t.n_nodes[b])
    for _ in range(num_sims):
        # SELECT: descend by UCB until an unvisited child slot or a frontier
        # (unexpanded or terminal) node; the path is kept, so the backup
        # below needs no parent reads
        best, child_of, expanded, term = _choices(t, b, n, ctx, Fp, Pp)
        cur, act, need_new, cur_term = 0, -1, False, bool(term[0])
        path, acts = [0], []
        going = bool(expanded[0]) and not cur_term
        while going:
            act, child = best[cur], child_of[cur]
            need_new = child < 0
            if not need_new:
                cur, cur_term = child, bool(term[child])
                path.append(cur)
                acts.append(act)
            going = not need_new and bool(expanded[cur]) and not cur_term
        # EXPAND
        grow = need_new and not cur_term and n < M
        if grow:
            s2, r = step(t.state[b, cur], act, fs, fl, ps, c)
            t.state[b, n] = s2
            t.parent[b, n] = cur
            t.parent_action[b, n] = act
            t.expanded[b, n] = 1
            leaf_term = terminal(s2, Fp, Pp, c)
            t.terminal[b, n] = leaf_term.to(torch.uint8)
            t.children[b, cur, act] = n
            t.child_reward[b, cur, act] = r
            path.append(n)
            acts.append(act)
            n += 1
        else:
            leaf_term = torch.tensor(cur_term, device=dev)
        # EVALUATE: 0 at a terminal leaf
        feats = features(t.state[b, path[-1]], fs, fl, ps, real, c)
        v = torch.where(leaf_term, 0.0, leaf_value_plain(feats[None], c, value)[0])
        # BACKUP: leaf to root, each node's value the leaf value plus the
        # edge rewards below it, added one edge at a time
        idx = torch.tensor(path, device=dev)
        vals: List[torch.Tensor] = [v]
        if len(path) > 1:
            edges = t.child_reward[b, idx[:-1], torch.tensor(acts, device=dev)]
            for k in range(len(path) - 2, -1, -1):
                vals.append(vals[-1] + edges[k])
        t.visits[b, idx] += 1
        t.value_sum[b, idx] = t.value_sum[b, idx] + torch.stack(vals[::-1])
    t.n_nodes[b] = n


def search_chunk_plain(tree: MCTSTree, num_sims: int, ctx: SearchCtx,
                       value: Optional[ValueWeights] = None) -> MCTSTree:
    """``num_sims`` more simulations on every tree, in place, as Python
    loops over tensors on the trees' device (the reference's
    ``search_chunk``, ``device_mcts.py:205``, in the explicit arithmetic)."""
    for b in range(tree.visits.shape[0]):
        _search_one(tree, b, int(num_sims), ctx, value)
    return tree


# --- the wrappers ------------------------------------------------------------


def _check_f32(what: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"mcts_search: {what} must be a contiguous f32 {shape}")


def _check_value(value: Optional[ValueWeights], device) -> int:
    if value is None:
        return 0
    h = int(value.hidden)
    if not 0 < h <= THREADS:
        raise ValueError(f"mcts_search: value net width {h}; the kernel takes 1..{THREADS}")
    if value.flat.dtype != torch.float32 or value.flat.numel() != weight_count(h) \
            or not value.flat.is_contiguous() or value.flat.device != device:
        raise ValueError("mcts_search: the value weights must be one contiguous f32 "
                         f"buffer of {weight_count(h)} values on {device}")
    return h


def _check_shared(Fp: int, Pp: int, hidden: int) -> None:
    need = shared_bytes(Fp, Pp, hidden)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"mcts_search: {Fp}f/{Pp}p with a value net of width {hidden} "
                         f"needs {need} bytes of shared memory; a block has "
                         f"{MAX_SHARED_BYTES}")


def search_chunk(tree: MCTSTree, num_sims: int, ctx: SearchCtx,
                 value: Optional[ValueWeights] = None) -> MCTSTree:
    """``num_sims`` more simulations on every tree of ``tree``, in place.
    CUDA operands launch ``mcts_search`` once (every tree in its grid, by
    the entry :func:`search_route` names);
    CPU operands (and CUDA ones inside ``plain_ops()``) run
    :func:`search_chunk_plain`."""
    ops = (*tree, *ctx) + (() if value is None else (value.flat,))
    if not _use_kernel("mcts_search", *ops):
        return search_chunk_plain(tree, num_sims, ctx, value)
    B, M = tree.visits.shape
    Fp, Pp = ctx.file_scores.shape[1], ctx.proc_scores.shape[1]
    A, D = Fp + Pp + 1, Fp + Pp + 3
    i32, f32, u8 = torch.int32, torch.float32, torch.uint8
    want = {"visits": ((B, M), i32), "value_sum": ((B, M), f32),
            "parent": ((B, M), i32), "parent_action": ((B, M), i32),
            "children": ((B, M, A), i32), "child_reward": ((B, M, A), f32),
            "expanded": ((B, M), u8), "terminal": ((B, M), u8),
            "state": ((B, M, D), f32), "n_nodes": ((B,), i32)}
    for name, (shape, dtype) in want.items():
        t = getattr(tree, name)
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"mcts_search: tree.{name} {tuple(t.shape)} {t.dtype}, "
                             f"want a contiguous {shape} {dtype}")
    for name, shape in (("file_scores", (B, Fp)), ("file_loss", (B, Fp)),
                        ("proc_scores", (B, Pp)), ("prior", (B, A)), ("real", (B, 2))):
        _check_f32(f"ctx.{name}", getattr(ctx, name), shape)
    _check_f32("ctx.consts", ctx.consts, (len(CONST_SLOTS),))
    if Fp & (Fp - 1) or Pp & (Pp - 1):
        raise ValueError(f"mcts_search: {Fp} files and {Pp} processes; the halving "
                         "sums take powers of two")
    hidden = _check_value(value, tree.visits.device)
    route = search_route(M, Fp, Pp, hidden)
    if route == "global":
        _check_shared(Fp, Pp, hidden)
    if int(num_sims) <= 0 or B == 0:
        return tree
    kernels._launch(
        ROUTE_ENTRY[route], tree.visits.device,
        *(t.data_ptr() for t in tree), *(t.data_ptr() for t in ctx),
        None if value is None else value.flat.data_ptr(), hidden,
        B, M, Fp, Pp, int(num_sims))
    kernels.count_launch(LAUNCHES, "mcts_search")
    kernels.count_launch(ROUTE_LAUNCHES, route)
    return tree


def leaf_value(feats: torch.Tensor, consts: torch.Tensor,
               value: Optional[ValueWeights] = None) -> torch.Tensor:
    """[N] leaf values of ``feats`` [N, 8] through the search kernel's own
    device function (the C entry ``nerrf_mcts_value``, one block a row) on
    CUDA, :func:`leaf_value_plain` on the CPU."""
    ops = (feats, consts) + (() if value is None else (value.flat,))
    if not _use_kernel("mcts_value", *ops):
        return leaf_value_plain(feats, consts, value)
    feats = feats.to(torch.float32).contiguous()
    if feats.dim() != 2 or feats.shape[1] != 8:
        raise ValueError(f"mcts_value: features {tuple(feats.shape)}, want [N, 8]")
    _check_f32("consts", consts, (len(CONST_SLOTS),))
    hidden = _check_value(value, feats.device)
    out = torch.empty(feats.shape[0], dtype=torch.float32, device=feats.device)
    if out.numel():
        kernels._launch("mcts_value", feats.device, feats.data_ptr(), consts.data_ptr(),
                        None if value is None else value.flat.data_ptr(), hidden,
                        feats.shape[0], out.data_ptr())
        kernels.count_launch(LAUNCHES, "mcts_value")
    return out
