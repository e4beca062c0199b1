"""Flax-equivalent layers: ``Dense``, ``LayerNorm``, ``Embed`` and ``gelu``.

Each computes what its ``flax.linen`` namesake computes with ``dtype`` set
over float32 params, so converted weights give the reference's outputs:

* ``Dense``: input, kernel and bias cast to the compute type, then the
  product (the kernel is stored PyTorch-style, ``[out, in]``);
* ``LayerNorm``: statistics in float32 (E[x²] − E[x]², clamped at 0), eps
  1e-6 (PyTorch's default is 1e-5), scale and shift in float32, the result
  cast to the compute type;
* ``Embed``: the table cast to the compute type, then a row lookup;
* ``gelu``: the tanh approximation (flax's default; PyTorch's is exact);
* ``dropout``: flax's ``nn.Dropout`` in training: keep with probability
  1 − rate, scale kept values by 1/(1 − rate), the mask drawn from an
  explicit ``torch.Generator`` (no global RNG state, no ``nn.Dropout``).

``init_`` draws each layer's params as flax's default initializers do
(``lecun_normal`` kernels, zero biases, unit LayerNorm scales, normal
embeddings with std 1/sqrt(features)), from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """``x`` with each element kept with probability ``1 - rate`` and scaled
    by ``1 / (1 - rate)``, the rest zero; an identity when ``gen`` is None
    (inference) or ``rate`` is 0.  The mask comes from ``gen``, which lies
    on ``x``'s device."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal on [-2σ, 2σ], rescaled so the
    variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def init_(self, gen: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def init_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.weight
        return ((x - mean) * mul + self.bias).to(self.dtype)


class Embed(nn.Module):
    def __init__(self, num: int, features: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, features))

    def init_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]),
                                generator=gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight.to(self.dtype)[ids.long()]


def init_params_(module: nn.Module, gen: torch.Generator) -> None:
    """Draw every layer's params below ``module`` in registration order."""
    for m in module.modules():
        if m is not module and hasattr(m, "init_"):
            m.init_(gen)
