"""StreamNet's training step: the single-card half of the reference's
``nerrf_tpu/parallel/train.py`` ``make_stream_train_step``.

The reference's step runs over a dp × sp mesh (batch over ``dp``, time over
``sp``, gradients all-reduced by GSPMD).  Here it runs on one device: a mesh
with any axis above 1 raises (ROADMAP A.7, DDP and the ``sp`` ring).  The
optimizer is ``optax.adamw(learning_rate)`` at its defaults, written out in
PyTorch: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every parameter,
no clipping, no schedule.  Dropout masks come from an explicit
``torch.Generator`` on the model's device (the reference splits a PRNG key
each step; the generator advances on its own).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch

WEIGHT_DECAY = 1e-4  # optax.adamw's default


def _check_single_device(mesh) -> None:
    """``mesh``: None or a ``config.MeshConfig``; any axis above 1 raises."""
    if mesh is None:
        return
    wide = {axis: n for axis in ("dp", "tp", "sp")
            if (n := getattr(mesh, axis)) not in (1, -1)}
    if wide:
        raise NotImplementedError(
            f"stream training over a mesh of {wide} is not ported (ROADMAP A.7: "
            "DDP and the sp ring); the port trains StreamNet on one card")


def make_stream_train_step(model, mesh=None, learning_rate: float = 1e-3):
    """``(init_fn, step_fn, place)`` for ``model`` (a ``StreamNet``) on the
    device its params lie on.

    * ``place(batch)``: a dict of numpy arrays (``feat``, ``mask``,
      ``label``) → tensors on the device, copied from pinned host memory
      (asynchronous on the card);
    * ``init_fn(seed)``: draws the model's params from ``seed`` (flax's
      initializer kinds, on the host: the params of
      ``build_streamnet(cfg, seed)``) and returns a ``train.loop.TrainState``
      with a fresh optimizer;
    * ``step_fn(state, batch, dropout_gen=None) -> (state, loss, dropout_gen)``:
      one forward, backward and AdamW update; ``loss`` a detached tensor on
      the device (reading it syncs); no dropout without a generator.
    """
    from nerrf_tpu_torch.models.layers import init_params_
    from nerrf_tpu_torch.models.stream import stream_loss
    from nerrf_tpu_torch.train.loop import TrainState

    _check_single_device(mesh)
    device = next(model.parameters()).device

    def place(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t.to(device)
        return out

    def init_fn(seed: int) -> TrainState:
        # drawn on the host, as build_streamnet draws them, then copied in
        host = copy.deepcopy(model).cpu()
        init_params_(host, torch.Generator().manual_seed(seed))
        model.load_state_dict(host.state_dict())
        tx = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                               betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=WEIGHT_DECAY)
        return TrainState(model=model, optimizer=tx)

    params = [p for p in model.parameters() if p.requires_grad]

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                dropout_gen: Optional[torch.Generator] = None):
        state.optimizer.zero_grad(set_to_none=True)
        out = model(batch["feat"], batch["mask"], dropout_gen)
        loss = stream_loss(out, batch["label"], batch["mask"])
        loss.backward()
        for p in params:
            if p.grad is None:  # optax updates (and decays) every param
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
        state.step += 1
        return state, loss.detach(), dropout_gen

    return init_fn, step_fn, place
