from nerrf_tpu_torch.parallel.ring import ring_self_attention
from nerrf_tpu_torch.parallel.train import make_stream_train_step

__all__ = [
    "make_stream_train_step",
    "ring_self_attention",
]
