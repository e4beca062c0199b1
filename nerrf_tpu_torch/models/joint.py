"""NerrfNet: joint GraphSAGE-T + BiLSTM detector, the port of
``nerrf_tpu/models/joint.py``.

Each per-file LSTM embedding is projected to node-feature width and summed
into its file node's features *before* message passing.  Sequence→node
routing (``seq_node_idx``) comes from the host; -1 routes a sequence to the
dummy slot ``n``, which the slice ``[:n]`` drops.

A training forward passes ``dropout_gen``, a ``torch.Generator`` on the
model's device (the counterpart of flax's ``rngs={"dropout": ...}``): the
LSTM's pooled embedding and the GNN's final hidden state then take dropout
masks from it, in that order.  Without it the forward is deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from nerrf_tpu_torch.device import resolve_device
from nerrf_tpu_torch.graph.builder import NODE_FEATURE_DIM
from nerrf_tpu_torch.models.graphsage import GraphSAGEConfig, GraphSAGET
from nerrf_tpu_torch.models.layers import Dense, init_params_
from nerrf_tpu_torch.models.lstm import ImpactLSTM, LSTMConfig
from nerrf_tpu_torch.ops import segment_sum


@dataclasses.dataclass(frozen=True)
class JointConfig:
    gnn: GraphSAGEConfig = GraphSAGEConfig()
    lstm: LSTMConfig = LSTMConfig()
    fuse: bool = True

    @property
    def small(self) -> "JointConfig":
        return JointConfig(gnn=self.gnn.small, lstm=self.lstm.small, fuse=self.fuse)


class NerrfNet(nn.Module):
    """A batch of window graphs + their per-file sequences → edge / node /
    seq logits, every input with a leading batch dimension."""

    def __init__(self, cfg: JointConfig = JointConfig()) -> None:
        super().__init__()
        self.cfg = cfg
        self.lstm = ImpactLSTM(cfg.lstm)
        self.seq_to_node = (Dense(cfg.lstm.hidden, NODE_FEATURE_DIM,
                                  torch.float32) if cfg.fuse else None)
        self.gnn = GraphSAGET(cfg.gnn)

    def forward(self, node_feat, node_type, node_aux, node_mask, edge_src,
                edge_dst, edge_feat, edge_mask, seq_feat, seq_mask,
                seq_node_idx, dropout_gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        lstm_out = self.lstm(seq_feat, seq_mask, dropout_gen)
        if self.seq_to_node is not None:
            n = node_feat.shape[1]
            h_seq = self.seq_to_node(lstm_out["seq_emb"])
            ok = seq_node_idx >= 0
            # route invalid sequences to slot n (dropped by the slice below)
            tgt = torch.where(ok, seq_node_idx, n)
            fused = segment_sum(h_seq * ok[..., None].to(h_seq.dtype), tgt,
                                n + 1)[:, :n]
            node_feat = node_feat + fused
        gnn_out = self.gnn(node_feat, node_type, node_aux, node_mask,
                           edge_src, edge_dst, edge_feat, edge_mask,
                           dropout_gen)
        return {**gnn_out, **lstm_out}


def build_nerrfnet(cfg: JointConfig = JointConfig(), seed: int = 0,
                   device=None) -> NerrfNet:
    """A NerrfNet with params drawn as flax's initializers draw them (kinds,
    not bits) from a ``torch.Generator`` seeded with ``seed``, in eval mode
    on ``device`` (the card unless ``device='cpu'``)."""
    dev = resolve_device(device)
    model = NerrfNet(cfg)
    init_params_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
