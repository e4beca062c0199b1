"""Flax ``NerrfNet`` (and value-net) params → the port's ``state_dict``.

Takes the reference's param tree as nested dicts of numpy arrays (``{"lstm":
{"in_proj": {"kernel": ..., "bias": ...}, ...}, "gnn": {...}}``, e.g.
``jax.device_get(variables["params"])``) and imports nothing of flax.  Rules:

* Dense ``kernel`` [in, out] → Linear ``weight`` [out, in], ``bias`` as is;
* Embed ``embedding`` → ``weight``; LayerNorm ``scale``/``bias`` →
  ``weight``/``bias`` (the port's LayerNorm has eps 1e-6, as flax's);
* ``block_i`` → ``gnn.blocks.i`` (``dir_bias`` as is), ``merge_i`` →
  ``lstm.merges.i``;
* ``OptimizedLSTMCell_{2i+d}``'s ``ii..io`` kernels → ``weight_ih`` and
  ``hi..ho`` kernels → ``weight_hh`` (gates stacked i, f, g, o), the ``h*``
  biases → ``bias_hh``, ``bias_ih`` = 0.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_GATES = ("i", "f", "g", "o")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd, name, p):
    sd[f"{name}.weight"] = _t(p["kernel"]).T.contiguous()
    sd[f"{name}.bias"] = _t(p["bias"])


def _norm(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def lstm_state_dict(lstm: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``ImpactLSTM`` subtree → the port's ``ImpactLSTM`` state."""
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "in_proj", lstm["in_proj"])
    k = 0
    while f"OptimizedLSTMCell_{k}" in lstm:
        cell = lstm[f"OptimizedLSTMCell_{k}"]
        w_hh = [_t(cell[f"h{g}"]["kernel"]).T for g in _GATES]
        sd[f"cells.{k}.weight_ih"] = torch.cat(
            [_t(cell[f"i{g}"]["kernel"]).T for g in _GATES]).contiguous()
        sd[f"cells.{k}.weight_hh"] = torch.cat(w_hh).contiguous()
        sd[f"cells.{k}.bias_hh"] = torch.cat(
            [_t(cell[f"h{g}"]["bias"]) for g in _GATES])
        sd[f"cells.{k}.bias_ih"] = torch.zeros(4 * w_hh[0].shape[1])
        k += 1
    i = 0
    while f"merge_{i}" in lstm:
        _dense(sd, f"merges.{i}", lstm[f"merge_{i}"])
        i += 1
    _norm(sd, "pool_ln", lstm["pool_ln"])
    _dense(sd, "head", lstm["head"])
    return sd


def gnn_state_dict(gnn: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``GraphSAGET`` subtree → the port's ``GraphSAGET`` state."""
    sd: Dict[str, torch.Tensor] = {}
    sd["type_emb.weight"] = _t(gnn["type_emb"]["embedding"])
    sd["aux_emb.weight"] = _t(gnn["aux_emb"]["embedding"])
    _dense(sd, "node_enc", gnn["node_enc"])
    _dense(sd, "edge_enc", gnn["edge_enc"])
    i = 0
    while f"block_{i}" in gnn:
        b = gnn[f"block_{i}"]
        _norm(sd, f"blocks.{i}.ln", b["ln"])
        _dense(sd, f"blocks.{i}.w_msg", b["w_msg"])
        sd[f"blocks.{i}.dir_bias"] = _t(b["dir_bias"])
        _dense(sd, f"blocks.{i}.w_self", b["w_self"])
        i += 1
    _norm(sd, "final_ln", gnn["final_ln"])
    _dense(sd, "node_head", gnn["node_head"])
    _dense(sd, "edge_head_1", gnn["edge_head_1"])
    _dense(sd, "edge_head_2", gnn["edge_head_2"])
    return sd


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``NerrfNet`` param tree → the port's ``NerrfNet`` state."""
    sd = {f"lstm.{k}": v for k, v in lstm_state_dict(params["lstm"]).items()}
    if "seq_to_node" in params:
        _dense(sd, "seq_to_node", params["seq_to_node"])
    sd.update({f"gnn.{k}": v for k, v in gnn_state_dict(params["gnn"]).items()})
    return sd


def value_net_to_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax value-net tree (``planner/value_net._MLP``: ``Dense_0``-
    ``Dense_2``, with or without the outer ``"params"``) → the state of the
    port's ``_MLP`` (`ValueNet.load_params`)."""
    p = flax_params.get("params", flax_params)
    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"Dense_{i}" in p:
        _dense(sd, f"Dense_{i}", p[f"Dense_{i}"])
        i += 1
    return sd


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load converted reference params into ``model`` (strict: every key of
    both sides must match) on the device its params already lie on."""
    dev = next(model.parameters()).device
    sd = {k: v.to(dev) for k, v in flax_to_state_dict(params).items()}
    model.load_state_dict(sd, strict=True)
    return model
