"""Value function for MCTS leaf evaluation — batched on the card.

The port of ``nerrf_tpu/planner/value_net.py``.  Two interchangeable
evaluators over ``UndoDomain.value_features`` ([B, 8] → [B]):

* `HeuristicValue` — the closed-form expected remaining reward
  (`heuristic_value`), on tensors;
* `ValueNet` — the small MLP (Linear 8→h, GELU, Linear h→h, GELU, Linear
  h→1; the GELU is the tanh form, as flax's ``nn.gelu`` defaults to), fit
  by full-batch regression on Monte-Carlo returns of prior-guided rollouts
  (`fit_to_domain`), then served on its device.

The reference keys its compiled programs on a stable ``apply`` object
(``_mlp_apply``, ``jit_fn``); PyTorch compiles nothing, so the port has
neither.  The weights are `model`'s state dict (the layer names are
flax's, ``Dense_0``-``Dense_2``: ``convert.value_net_to_state_dict`` gives
it from a flax tree), and `DeviceMCTS` reads them through `search_weights`,
one flat buffer in the search kernel's layout.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerrf_tpu_torch.device import resolve_device
from nerrf_tpu_torch.ops.mcts import ValueWeights
from nerrf_tpu_torch.planner.domain import ONGOING_LOSS_MB_PER_SEC, UndoDomain

ValueFn = Callable[[np.ndarray], np.ndarray]  # [B, 8] features → [B] values


def heuristic_value(features: torch.Tensor) -> torch.Tensor:
    """Expected remaining reward from the feature summary.

    rem_gain is recoverable data still on the table; live threats forfeit
    ~30 s of ongoing loss unless killed; downtime already spent is sunk.
    """
    rem_gain = features[..., 0]
    live = features[..., 2]
    stopped = features[..., 7]
    future = rem_gain - live * ONGOING_LOSS_MB_PER_SEC * 5.0
    return torch.where(stopped > 0.5, 0.0, future)


class HeuristicValue:
    """`heuristic_value` on ``device`` (the card unless the caller names
    another) for numpy feature blocks."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)

    def submit(self, features: np.ndarray) -> torch.Tensor:
        return heuristic_value(torch.from_numpy(np.asarray(features, np.float32))
                               .to(self.device))

    def __call__(self, features: np.ndarray) -> np.ndarray:
        return self.submit(features).cpu().numpy()


class _MLP(nn.Module):
    def __init__(self, hidden: int = 64) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(8, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.Dense_0(x), approximate="tanh")
        x = F.gelu(self.Dense_1(x), approximate="tanh")
        return self.Dense_2(x)[..., 0]


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default Dense kernel init: a normal of variance 1/fan_in,
    truncated at two standard deviations (and rescaled for the cut)."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)


class ValueNet:
    """The value net on one device; see the module docstring."""

    def __init__(self, model: _MLP, hidden: int = 64) -> None:
        self.model = model.eval()
        self.hidden = hidden

    @property
    def device(self) -> torch.device:
        return self.model.Dense_0.weight.device

    @classmethod
    def create(cls, seed: int = 0, hidden: int = 64, device=None) -> "ValueNet":
        """A fresh net, its weights drawn from ``torch.Generator(seed)``
        (flax's init distribution, not its draws), on ``device``."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        model = _MLP(hidden)
        with torch.no_grad():
            for layer in (model.Dense_0, model.Dense_1, model.Dense_2):
                _lecun_normal_(layer.weight, gen)
                layer.bias.zero_()
        return cls(model.to(dev), hidden=hidden)

    def search_weights(self, device=None) -> ValueWeights:
        """A copy of the weights as the search kernel takes them, on
        ``device`` (the net's own by default)."""
        m = self.model
        with torch.no_grad():
            flat = torch.cat([m.Dense_0.weight.T.reshape(-1), m.Dense_0.bias,
                              m.Dense_1.weight.T.reshape(-1), m.Dense_1.bias,
                              m.Dense_2.weight.reshape(-1), m.Dense_2.bias])
        dev = self.device if device is None else torch.device(device)
        return ValueWeights(flat.to(device=dev, dtype=torch.float32).contiguous(), self.hidden)

    def submit(self, features: np.ndarray) -> torch.Tensor:
        """Dispatch without waiting: the values as an un-synced tensor on the
        net's device, so the caller can overlap host work (MCTS select and
        expand of the NEXT frontier) with the card; resolve with
        ``.cpu()``."""
        x = torch.from_numpy(np.asarray(features, np.float32)).to(self.device)
        with torch.no_grad():
            return self.model(x)

    def __call__(self, features: np.ndarray) -> np.ndarray:
        return self.submit(features).cpu().numpy()

    def fit_to_domain(
        self,
        domain: UndoDomain,
        num_rollouts: int = 512,
        horizon: int = 32,
        steps: int = 300,
        lr: float = 1e-2,
        seed: int = 0,
    ) -> float:
        """Regress value(features) onto MC returns of prior-guided rollouts.

        Rollouts run vectorized on the host domain model (numpy transition,
        the reference's draws from ``default_rng(seed)``); the regression is
        full-batch Adam on the net's device.  Returns the final MSE loss.
        """
        rng = np.random.default_rng(seed)
        priors = domain.priors()
        B = num_rollouts
        s = np.stack([domain.initial_state()] * B)
        feats, rewards, alive_hist = [], [], []
        for _ in range(horizon):
            feats.append(domain.value_features(s))
            legal = domain.legal_actions(s)
            p = priors[None, :] * legal
            rowsum = p.sum(-1, keepdims=True)
            p = np.where(rowsum > 0, p / np.maximum(rowsum, 1e-9), 0.0)
            alive = rowsum[:, 0] > 0
            a = np.array([
                rng.choice(domain.A, p=p[b]) if alive[b] else domain.A - 1
                for b in range(B)
            ])
            s, r = domain.step_batch(s, a)
            rewards.append(np.where(alive, r, 0.0))
            alive_hist.append(alive)
        returns = np.zeros(B, np.float32)
        targets = np.zeros((horizon, B), np.float32)
        for t in reversed(range(horizon)):
            returns = rewards[t] + returns
            targets[t] = returns
        X = torch.from_numpy(np.concatenate(feats).astype(np.float32)).to(self.device)
        Y = torch.from_numpy(targets.reshape(-1)).to(self.device)

        opt = torch.optim.Adam(self.model.parameters(), lr=lr)
        loss = torch.tensor(float("inf"))
        self.model.train()
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((self.model(X) - Y) ** 2)
            loss.backward()
            opt.step()
        self.model.eval()
        return float(loss.detach())
