from nerrf_tpu_torch.models.graphsage import GraphSAGEConfig, GraphSAGET
from nerrf_tpu_torch.models.joint import JointConfig, NerrfNet, build_nerrfnet
from nerrf_tpu_torch.models.lstm import ImpactLSTM, LSTMConfig

__all__ = [
    "GraphSAGET",
    "GraphSAGEConfig",
    "ImpactLSTM",
    "LSTMConfig",
    "NerrfNet",
    "JointConfig",
    "build_nerrfnet",
]
