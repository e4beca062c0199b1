"""The undo planner: the decision domain, the value net, the host MCTS and
the single-kernel device MCTS.  The port of ``nerrf_tpu/planner/``."""

from nerrf_tpu_torch.planner.device_mcts import DeviceMCTS
from nerrf_tpu_torch.planner.domain import UndoAction, UndoDomain, UndoPlan, ActionKind
from nerrf_tpu_torch.planner.mcts import MCTSConfig, MCTSPlanner


def make_planner(domain, value, cfg: MCTSConfig, kind: str = "auto", device=None):
    """One constructor for both planner families, on ``device`` (the card
    unless the caller names another).

    ``kind='auto'`` or ``'device'`` → :class:`DeviceMCTS`, the search as one
    kernel launch a chunk, with ``value`` (a `ValueNet`, or None for the
    heuristic) in the kernel; ``kind='host'`` → the batched-leaf
    :class:`MCTSPlanner` with ``value`` as its batch evaluator (None: the
    heuristic).  Nothing falls back: a search that cannot build or launch
    its kernel raises (the reference's ``auto`` retreats to the host
    search instead)."""
    if kind in ("auto", "device"):
        return DeviceMCTS(domain, cfg, value=value, device=device)
    if kind != "host":
        raise ValueError(f"unknown planner kind {kind!r}")
    return MCTSPlanner(domain, value, cfg, device=device)


__all__ = [
    "make_planner",
    "UndoAction",
    "UndoDomain",
    "UndoPlan",
    "ActionKind",
    "MCTSConfig",
    "MCTSPlanner",
    "DeviceMCTS",
]
