"""Host-side ingest: wire schema, native decode bridge, gRPC stream service.
The port of ``nerrf_tpu/ingest/``.

Everything between the capture programs (``native/bpf/``) and the graph
constructor: the nerrf.trace wire schema (``proto/trace.proto``, stubs in
``trace_pb2.py``, a byte-for-byte copy of the reference's), the C++ decode
bridge (``native/src/ingest.cc`` via ``bridge.py``), and the Tracker
streaming service and client (``service.py``).
"""

from nerrf_tpu_torch.ingest.bridge import (
    RECORD_DTYPE,
    RECORD_SIZE,
    IngestBridge,
    encode_ring_records,
    events_to_batch_frames,
    native_available,
)

__all__ = [
    "IngestBridge",
    "RECORD_DTYPE",
    "RECORD_SIZE",
    "encode_ring_records",
    "events_to_batch_frames",
    "native_available",
    "TraceReplayServer",
    "TrackerClient",
]


def __getattr__(name):  # grpc import deferred: the data path works without it
    if name in ("TraceReplayServer", "TrackerClient"):
        from nerrf_tpu_torch.ingest import service

        return getattr(service, name)
    raise AttributeError(name)
