"""Online detection serving: continuous cross-stream micro-batching onto one
scorer on the card.  The port of ``nerrf_tpu/serve/``: `OnlineDetectionService`
is bit-equal to `pipeline.model_detect` on the same trace at the bucket's
`DatasetConfig`."""

from nerrf_tpu_torch.serve.alerts import AlertSink, WindowAlert
from nerrf_tpu_torch.serve.batcher import (MicroBatcher, ScoredWindow,
                                           WindowRequest)
from nerrf_tpu_torch.serve.config import (
    Bucket,
    ServeConfig,
    bucket_tag,
    select_bucket,
)
from nerrf_tpu_torch.serve.service import (
    OnlineDetectionService,
    StreamHandle,
    StreamRun,
    init_untrained_model,
)
from nerrf_tpu_torch.serve.windower import StreamWindower

__all__ = [
    "AlertSink",
    "Bucket",
    "MicroBatcher",
    "OnlineDetectionService",
    "ScoredWindow",
    "ServeConfig",
    "StreamHandle",
    "StreamRun",
    "StreamWindower",
    "WindowAlert",
    "WindowRequest",
    "bucket_tag",
    "init_untrained_model",
    "select_bucket",
]
