"""gRPC Tracker service + client for the nerrf.trace wire protocol.

The port of ``nerrf_tpu/ingest/service.py``: the same service and frames
(the port's ``trace_pb2`` is a byte-for-byte copy of the reference's, so
the two packages' servers and clients interoperate), its spans through the
port's ``tracing``, the chaos fault points in ``iter_blocks`` through the
port's ``chaos``; ``spawn_trackerd`` builds the native daemon into the
port's ``ops/_build/native/``.

Speaks the same service upstream NERRF's Go tracker daemon (the
"reference daemon" below) serves —
``/nerrf.trace.Tracker/StreamEvents``, server-streaming ``EventBatch``
(upstream NERRF `proto/trace.proto:55-57`) — so either side interoperates:
a reference tracker can feed our `TrackerClient`, and our `TraceReplayServer`
can feed reference consumers (grpcurl, the planned AI pods).

Implementation notes vs the reference daemon
(`tracker/cmd/tracker/main.go:184-267`):
  * real batching (64 events/frame default) instead of one event per frame;
  * a replay source: gRPC's flow control paces each subscriber, so no frame
    is dropped; live-capture sources fan out through `subscriber_queue`'s
    bounded drop-on-full queues (100 frames by default, the reference
    daemon's), counting what they drop in ``frames_dropped``;
  * decode on the client side lands in the native C++ bridge when built.

No generated service stubs: grpcio's generic-handler API binds the method
path directly, which keeps the checked-in surface to protoc's message
stubs (trace_pb2.py).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import grpc

from nerrf_tpu_torch.ingest import trace_pb2
from nerrf_tpu_torch.ingest.bridge import (NATIVE_BUILD_DIR, IngestBridge,
                                           events_to_batch_frames)
from nerrf_tpu_torch.schema import EventArrays, StringTable
from nerrf_tpu_torch.tracing import span as trace_span

SERVICE_NAME = "nerrf.trace.Tracker"
STREAM_METHOD = "StreamEvents"
_METHOD_PATH = f"/{SERVICE_NAME}/{STREAM_METHOD}"

# Standard reflection service names (v1alpha is what grpcurl ≤1.8 speaks;
# newer grpcurl tries v1 first and falls back — serve both, same handler).
_REFLECTION_SERVICES = (
    "grpc.reflection.v1alpha.ServerReflection",
    "grpc.reflection.v1.ServerReflection",
)
_REFLECTION_METHOD = "ServerReflectionInfo"


# -- hand-rolled reflection wire helpers --------------------------------------
# No grpcio-reflection package exists in this environment (and the checked-in
# proto surface is message-stubs only), so the reflection service encodes
# ServerReflectionResponse with the public protobuf wire format directly —
# the serialized descriptor bytes already live in trace_pb2.DESCRIPTOR.

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field (wire type 2)."""
    return bytes([(field << 3) | 2]) + _varint(len(payload)) + payload


def _vi(field: int, value: int) -> bytes:
    """Varint field (wire type 0)."""
    return bytes([field << 3]) + _varint(value)


def _wire_fields(buf: bytes):
    """Yield (field, wire_type, payload_or_int) over one message's fields."""
    i = 0
    while i < len(buf):
        key = buf[i]
        i += 1
        field, wire = key >> 3, key & 7
        if wire == 2:
            ln = shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, buf[i:i + ln]
            i += ln
        elif wire == 0:
            v = shift = 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, v
        else:
            raise ValueError(f"unsupported wire type {wire} in reflection "
                             "request")


def _descriptor_files() -> dict:
    """filename → serialized FileDescriptorProto, for trace.proto and its
    transitive deps (grpcurl needs timestamp.proto to resolve Event.ts)."""
    files = {}

    def add(fd) -> None:
        if fd.name in files:
            return
        files[fd.name] = fd.serialized_pb
        for dep in fd.dependencies:
            add(dep)

    add(trace_pb2.DESCRIPTOR)
    return files


def _file_descriptor_response(names) -> bytes:
    """ServerReflectionResponse arm 4: FileDescriptorResponse with one
    file_descriptor_proto (field 1) per serialized file."""
    files = _descriptor_files()
    payload = b"".join(_ld(1, files[n]) for n in names)
    return _ld(4, payload)


def _error_response(code: int, message: str) -> bytes:
    """ServerReflectionResponse arm 7: ErrorResponse{error_code, message}."""
    return _ld(7, _vi(1, code) + _ld(2, message.encode()))


def reflection_response(request: bytes) -> bytes:
    """One ServerReflectionRequest frame → one ServerReflectionResponse.

    Supported arms (the grpcurl `list` / `describe` flows): 7
    list_services, 4 file_containing_symbol, 3 file_by_filename.  Anything
    else gets a proper UNIMPLEMENTED/NOT_FOUND error_response instead of a
    dropped stream."""
    arm = None
    payload: bytes = b""
    for field, wire, value in _wire_fields(request):
        if field in (3, 4, 5, 6, 7) and wire == 2:
            arm, payload = field, value
    files = _descriptor_files()
    # original_request echo (field 2): grpcurl matches responses to
    # requests by it when pipelining
    echo = _ld(2, request)
    if arm == 7:  # list_services
        services = (SERVICE_NAME,) + _REFLECTION_SERVICES
        body = b"".join(_ld(1, _ld(1, s.encode())) for s in services)
        return echo + _ld(6, body)
    if arm == 3:  # file_by_filename
        name = payload.decode()
        if name not in files:
            return echo + _error_response(5, f"file not found: {name}")
        return echo + _file_descriptor_response(files)  # file + its deps
    if arm == 4:  # file_containing_symbol
        symbol = payload.decode()
        package = trace_pb2.DESCRIPTOR.package
        if symbol == package or symbol.startswith(package + "."):
            return echo + _file_descriptor_response(files)
        if symbol.startswith("google.protobuf.Timestamp"):
            return echo + _file_descriptor_response(
                [n for n in files if n != trace_pb2.DESCRIPTOR.name])
        return echo + _error_response(5, f"symbol not found: {symbol}")
    return echo + _error_response(12, "reflection request not implemented")


class TraceReplayServer:
    """Serves an event stream over the Tracker wire protocol.

    The role the reference fills with its Go daemon: this is the replay/test
    flavor (trace in, stream out), the production flavor being the native
    capture agent feeding the same frames.  Fan-out policy matches the
    reference: per-subscriber bounded queue (default 100 frames), drop on
    overflow so one slow consumer cannot stall the rest.
    """

    def __init__(
        self,
        events: EventArrays,
        strings: StringTable,
        address: str = "127.0.0.1:0",
        batch_size: int = 64,
        queue_slots: int = 100,
    ) -> None:
        self._frames = events_to_batch_frames(events, strings, batch_size)
        self._address = address
        self._queue_slots = queue_slots
        self.frames_dropped = 0
        self._lock = threading.Lock()
        self._server: Optional[grpc.Server] = None
        self.port: Optional[int] = None

    # -- grpc plumbing --------------------------------------------------------

    def _stream_events(self, request: bytes, context) -> Iterator[bytes]:
        # Replay source: frames are pre-serialized once and yielded directly —
        # gRPC's own flow control paces each subscriber, so nothing is dropped.
        # (The bounded drop-on-full queue policy applies to *live* capture
        # sources, where a producer thread feeds subscriber queues and a slow
        # consumer must not stall the ring-buffer drain; see subscriber_queue.)
        from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

        DEFAULT_REGISTRY.counter_inc(
            "tracker_subscribers_total", help="StreamEvents subscriptions served")
        # one span per subscription: its duration is the full stream drain
        # (gRPC flow control paces it), so a slow consumer is visible as a
        # long tracker_stream span in the serve-side trace
        with trace_span("tracker_stream") as sp:
            sent = 0
            for frame in self._frames:
                DEFAULT_REGISTRY.counter_inc(
                    "tracker_frames_sent_total",
                    help="EventBatch frames streamed")
                yield frame
                sent += 1
            sp.args["frames"] = sent

    def _reflection_info(self, request_iterator, context) -> Iterator[bytes]:
        """`grpc.reflection.v1alpha/v1.ServerReflection/ServerReflectionInfo`
        — the reference daemon registers stock reflection so grpcurl works
        schema-free (`tracker/cmd/tracker/main.go:135`); this is the same
        surface for the Python replay flavor, from the descriptor bytes
        already checked in as trace_pb2."""
        for request in request_iterator:
            try:
                yield reflection_response(request)
            except (ValueError, IndexError) as e:
                # IndexError = truncated varint/length in a malformed frame
                yield _error_response(3, str(e))  # INVALID_ARGUMENT

    def subscriber_queue(self) -> "queue.Queue[Optional[bytes]]":
        """Bounded frame queue with the live-source overflow policy: callers
        pushing with put_nowait should count queue.Full as a dropped frame
        (mirrors the reference daemon's 100-slot drop-on-full channels,
        tracker/cmd/tracker/main.go:255-265)."""
        return queue.Queue(maxsize=self._queue_slots)

    def start(self) -> int:
        from concurrent import futures

        handler = grpc.method_handlers_generic_handler(
            SERVICE_NAME,
            {
                STREAM_METHOD: grpc.unary_stream_rpc_method_handler(
                    self._stream_events,
                    request_deserializer=lambda b: b,   # Empty: ignore payload
                    response_serializer=lambda b: b,    # frames pre-serialized
                )
            },
        )
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((handler,))
        for svc in _REFLECTION_SERVICES:
            self._server.add_generic_rpc_handlers((
                grpc.method_handlers_generic_handler(
                    svc,
                    {
                        _REFLECTION_METHOD: grpc.stream_stream_rpc_method_handler(
                            self._reflection_info,
                            request_deserializer=lambda b: b,
                            response_serializer=lambda b: b,
                        )
                    },
                ),))
        self.port = self._server.add_insecure_port(self._address)
        self._server.start()
        return self.port

    def stop(self, grace: float = 0.5) -> None:
        if self._server is not None:
            self._server.stop(grace).wait()
            self._server = None


class TrackerClient:
    """Drains ``StreamEvents`` into EventArrays via the ingest bridge."""

    def __init__(self, target: str, bridge: Optional[IngestBridge] = None) -> None:
        self._target = target
        self._bridge = bridge or IngestBridge()

    @property
    def bridge(self) -> IngestBridge:
        """The decoder this client feeds (``bridge.is_native`` says which)."""
        return self._bridge

    def iter_blocks(
        self, max_events: Optional[int] = None, timeout: float = 30.0,
        stream: Optional[str] = None,
    ) -> Iterator[tuple[EventArrays, StringTable]]:
        """Yield (block, string-table) per decoded frame as it arrives, so
        callers can persist incrementally — a dropped stream loses only the
        frame in flight, not the whole session.  The string table is the
        bridge's cumulative view (ids stable for the client's lifetime).
        ``stream`` is the caller's stream label, carried only into the
        chaos fault-point context so an injected wire fault is joinable to
        the stream it hit."""
        from nerrf_tpu_torch import chaos

        total = 0
        with grpc.insecure_channel(self._target) as channel:
            call = channel.unary_stream(
                _METHOD_PATH,
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=lambda b: b,  # raw frame → native decode
            )(trace_pb2.Empty(), timeout=timeout)
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            for frame in call:
                # chaos fault points (no-ops while disarmed): a mid-stream
                # wire reset / producer stall, exactly where a flaky
                # tracker or a congested link would deliver one
                chaos.inject("ingest.wire_stall", stream=stream,
                             target=self._target)
                chaos.inject("ingest.wire_error", stream=stream,
                             target=self._target)
                # one instrumentation point: the span dual-writes the
                # stage_latency_seconds{stage="ingest_decode"} histogram,
                # so the Prometheus series and the trace stay consistent
                with trace_span("ingest_decode") as sp:
                    block = self._bridge.decode_batch(frame)
                    sp.args["events"] = int(block.num_valid)
                DEFAULT_REGISTRY.counter_inc(
                    "ingest_events_total", block.num_valid,
                    help="events decoded from the tracker stream")
                yield block, self._bridge.string_table()
                total += block.num_valid
                if max_events is not None and total >= max_events:
                    call.cancel()
                    break

    def stream(
        self, max_events: Optional[int] = None, timeout: float = 30.0
    ) -> tuple[EventArrays, StringTable]:
        """Collect until the stream ends (or max_events reached)."""
        blocks = [b for b, _ in self.iter_blocks(max_events, timeout)]
        events = EventArrays.concatenate(blocks) if blocks else EventArrays.empty(0)
        return events, self._bridge.string_table()


def spawn_trackerd(extra_args, daemon_path=None, timeout=10.0,
                   build=True):
    """Start the native daemon on an ephemeral port → ``(Popen, port)``.

    The ONE implementation of the spawn + serving-line parse that the
    interop tests and the e2e benchmarks previously each hand-rolled
    (three drifting copies of the same stderr regex).  Always passes
    ``--listen 127.0.0.1:0`` — a fixed port collides with concurrent
    runs — and parses the resolved port from the daemon's serving line.
    Raises RuntimeError if the daemon never reports one; the caller owns
    termination."""
    import re as _re
    import subprocess as _sp
    import time as _time
    from pathlib import Path as _Path

    import fcntl as _fcntl

    repo = _Path(__file__).resolve().parents[2]
    daemon = _Path(daemon_path) if daemon_path else (
        NATIVE_BUILD_DIR / "nerrf-trackerd")
    if not daemon.exists() and build:
        NATIVE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(NATIVE_BUILD_DIR / ".lock", "w") as lock:
            _fcntl.flock(lock, _fcntl.LOCK_EX)
            r = _sp.run(["make", "-C", str(repo / "native"),
                         f"BUILD={NATIVE_BUILD_DIR}", str(daemon)],
                        capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"daemon build failed: {r.stderr[-400:]}")
    proc = _sp.Popen([str(daemon), "--listen", "127.0.0.1:0"]
                     + list(extra_args),
                     stderr=_sp.PIPE, text=True)
    deadline = _time.time() + timeout
    lines = []
    while _time.time() < deadline:
        line = proc.stderr.readline()
        if not line and proc.poll() is not None:
            break
        lines.append(line)
        m = _re.search(r"serving StreamEvents on .* \(port (\d+)\)", line)
        if m:
            return proc, int(m.group(1))
    proc.terminate()
    raise RuntimeError(f"daemon never reported its serving port: {lines}")
