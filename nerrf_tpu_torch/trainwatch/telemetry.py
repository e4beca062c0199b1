"""In-step training telemetry: health scalars computed on the card inside
the train step.

The port of ``nerrf_tpu/trainwatch/telemetry.py``.  ``make_train_step``
(``nerrf_tpu_torch/train/loop.py``) calls :func:`step_telemetry` when
``TrainConfig.telemetry`` is on and returns its dict under ``aux``'s
``"telemetry"`` key: tensors on the device, read by the host only where it
already synchronizes (the logged steps' ``float(loss)``):

* ``grad_norm``: global L2 norm of the raw gradients (before the clip at
  1.0, whose clipped norm saturates exactly when it matters);
* ``param_norm``: global L2 norm of the parameters before the update;
* ``update_norm`` and ``update_ratio``: ‖Δθ‖ and ‖Δθ‖/‖θ‖, the effective
  learning rate;
* ``nonfinite``: per loss component (and ``total``) a NaN/Inf flag, and
  under ``grads`` the count of non-finite gradient elements.

Every argument is a tensor, a list or tuple of them, or a dict of them
(nested freely), as the reference takes any pytree.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [leaf for item in tree for leaf in _leaves(item)]


def _scalar_zero(leaves) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32,
                       device=leaves[0].device if leaves else None)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """Global L2 norm over the tensors of ``tree`` (f32 accumulation): one
    ``_foreach_norm`` over the leaves and the norm of their norms, a few
    launches however many leaves."""
    leaves = [x.float() for x in _leaves(tree)]
    if not leaves:
        return _scalar_zero(leaves)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


@torch.no_grad()
def nonfinite_count(tree) -> torch.Tensor:
    """Number of non-finite elements across ``tree`` (an f32 scalar)."""
    leaves = _leaves(tree)
    if not leaves:
        return _scalar_zero(leaves)
    flat = torch.cat([x.reshape(-1).float() for x in leaves])
    return torch.sum(~torch.isfinite(flat)).float()


@torch.no_grad()
def step_telemetry(old_params, new_params, grads, loss,
                   losses: Dict[str, torch.Tensor]) -> Dict:
    """The in-step health dict (all scalars; see the module docstring).
    ``losses`` is the step's aux dict of loss components."""
    grad_norm = global_norm(grads)
    param_norm = global_norm(old_params)
    update_norm = global_norm(torch._foreach_sub(
        [x.float() for x in _leaves(new_params)],
        [x.float() for x in _leaves(old_params)]))
    nonfinite = {k: (~torch.isfinite(v)).float() for k, v in losses.items()}
    nonfinite["total"] = (~torch.isfinite(loss)).float()
    nonfinite["grads"] = nonfinite_count(grads)
    return {
        "grad_norm": grad_norm,
        "param_norm": param_norm,
        "update_norm": update_norm,
        "update_ratio": update_norm / torch.clamp_min(param_norm, 1e-12),
        "nonfinite": nonfinite,
    }
