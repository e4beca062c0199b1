from nerrf_tpu_torch.data.labels import derive_event_labels
from nerrf_tpu_torch.data.loaders import GroundTruth, Trace, load_trace_jsonl
from nerrf_tpu_torch.data.stream import (
    STREAM_FEATURE_DIM,
    StreamBatch,
    build_stream,
    build_streams,
)
from nerrf_tpu_torch.data.synth import SimConfig, make_corpus, simulate_trace

__all__ = [
    "GroundTruth",
    "Trace",
    "load_trace_jsonl",
    "SimConfig",
    "simulate_trace",
    "make_corpus",
    "derive_event_labels",
    "StreamBatch",
    "build_stream",
    "build_streams",
    "STREAM_FEATURE_DIM",
]
