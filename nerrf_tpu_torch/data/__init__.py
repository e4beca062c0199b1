from nerrf_tpu_torch.data.labels import derive_event_labels
from nerrf_tpu_torch.data.loaders import GroundTruth, Trace, load_trace_jsonl
from nerrf_tpu_torch.data.synth import SimConfig, simulate_trace

__all__ = [
    "GroundTruth",
    "Trace",
    "load_trace_jsonl",
    "SimConfig",
    "simulate_trace",
    "derive_event_labels",
]
