"""trainwatch: the training run's health plane.

In-step telemetry computed on the card inside the train step
(`telemetry.step_telemetry`) and a `TrainHealthMonitor` exporting
``nerrf_train_*`` gauges and cadenced ``train_health`` journal records, and
latching a divergence that halts the loop.  The reference's
``training_health`` wiring (metrics server, flight recorder, archive) waits
for those planes (ROADMAP A.6).
"""

from nerrf_tpu_torch.trainwatch.monitor import TrainHealthConfig, TrainHealthMonitor
from nerrf_tpu_torch.trainwatch.telemetry import (
    global_norm,
    nonfinite_count,
    step_telemetry,
)

__all__ = [
    "TrainHealthConfig",
    "TrainHealthMonitor",
    "global_norm",
    "nonfinite_count",
    "step_telemetry",
]
