"""Per-stream event-time windowing for the online detection service.

A host copy of ``nerrf_tpu/serve/windower.py``, kept identical.

Turns an *accumulating* event stream into exactly the sliding windows the
offline path would produce for the finished trace: window boundaries come
from `graph.builder.snapshot_windows(t0, t1)` semantics, emitted
incrementally — a window [lo, lo+W) closes the moment the stream's
watermark (max event timestamp seen) passes its right edge, and the
remaining partial windows close at `flush()` (stream leave).  Replaying a
whole stream through ``feed`` + ``flush`` therefore yields the same
(lo, hi) sequence as `snapshot_windows(min_ts, max_ts)` on the final trace,
which is one of the two legs of the serve path's bit-parity with
`pipeline.model_detect` (the other is the shared per-window lowering,
`train.data.window_sample`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from nerrf_tpu_torch.data.loaders import Trace
from nerrf_tpu_torch.schema import EventArrays, StringTable

_NS = 1_000_000_000

# (window_idx, lo_ns, hi_ns)
ClosedWindow = Tuple[int, int, int]


class StreamWindower:
    """Event-time sliding windows over one stream's accumulating events.

    Assumes per-stream in-order delivery (the Tracker wire protocol streams
    frames in capture order); events that arrive with timestamps before the
    watermark of an already-closed window still land in the accumulated
    trace (they count for byte/mutation accounting at finalize) but are
    counted in ``late_events`` — a non-zero count flags a source whose
    reordering breaks the closed-window == offline-window equivalence.
    """

    def __init__(self, window_sec: float = 45.0, stride_sec: float = 15.0):
        self._window_ns = int(window_sec * _NS)
        self._stride_ns = int(stride_sec * _NS)
        # blocks accumulate O(1) per feed; the flat array is rebuilt
        # lazily (at window close / finalize), so a frame-granular feeder
        # does not pay an O(stream) copy per frame.  Memory is inherently
        # O(stream): finalize's byte/mutation accounting needs every event
        # — `leave()` is what releases a stream.
        self._blocks: list = []
        self._events: Optional[EventArrays] = None
        self._strings: Optional[StringTable] = None
        self._t0: Optional[int] = None
        self._next_lo: Optional[int] = None
        self._watermark: Optional[int] = None
        self._idx = 0
        self.late_events = 0
        # window_view's O(log n) slicing is only sound while the flat
        # array's ts column is globally sorted with no padding rows; any
        # violation flips this and admission falls back to full scans
        self._sliceable = True

    # -- accumulation ---------------------------------------------------------

    @property
    def events(self) -> EventArrays:
        if self._blocks:
            parts = ([self._events] if self._events is not None else []) \
                + self._blocks
            self._events = parts[0] if len(parts) == 1 \
                else EventArrays.concatenate(parts)
            self._blocks = []
        return self._events if self._events is not None else EventArrays.empty(0)

    @property
    def strings(self) -> Optional[StringTable]:
        return self._strings

    def trace(self, name: str = "") -> Trace:
        """The unlabeled accumulated trace (detection must not peek at
        labels; a live stream has none anyway)."""
        if self._strings is None:
            raise ValueError("windower has seen no events yet")
        return Trace(events=self.events, strings=self._strings,
                     ground_truth=None, labels=None, name=name)

    def window_view(self, lo_ns: int, hi_ns: int) -> EventArrays:
        """The events a [lo, hi) window can select, as a narrow slice.

        Admission lowers every closed window; scanning the WHOLE
        accumulated stream per window is O(stream) and goes quadratic on a
        resident stream, while an in-order stream's window is a contiguous
        index range found in O(log n).  Lowering from the slice is
        bit-identical to lowering from the full array — both end up
        selecting exactly the events with lo ≤ ts < hi.  Streams that
        violate the slicing preconditions (padding rows, out-of-order
        delivery) fall back to the full array: correct, just slower."""
        ev = self.events
        if not self._sliceable:
            return ev
        i0 = int(np.searchsorted(ev.ts_ns, lo_ns, side="left"))
        i1 = int(np.searchsorted(ev.ts_ns, hi_ns, side="left"))
        return ev.slice(i0, i1)

    def feed(self, events: EventArrays, strings: StringTable) -> List[ClosedWindow]:
        """Append one decoded block; return the windows it closed."""
        self._strings = strings
        if events.num_valid == 0:
            return []
        ts = events.ts_ns[events.valid]
        self._blocks.append(events)
        if not events.valid.all() or np.any(np.diff(events.ts_ns) < 0):
            self._sliceable = False  # padding rows / intra-block disorder
        if self._t0 is None:
            self._t0 = int(ts.min())
            self._next_lo = self._t0
            self._watermark = self._t0
        if self._watermark is not None and int(ts.min()) < self._watermark:
            self.late_events += int(np.sum(ts < self._watermark))
            self._sliceable = False
        self._watermark = max(self._watermark, int(ts.max()))
        closed: List[ClosedWindow] = []
        # a window is complete once the watermark passes its right edge
        while self._next_lo + self._window_ns <= self._watermark:
            closed.append((self._idx, self._next_lo,
                           self._next_lo + self._window_ns))
            self._idx += 1
            self._next_lo += self._stride_ns
        return closed

    def flush(self) -> List[ClosedWindow]:
        """Close every remaining window (stream leave): `snapshot_windows`
        yields windows while lo < t1, so the tail windows — whose right
        edges extend past the last event — emit here."""
        if self._t0 is None:
            return []
        closed: List[ClosedWindow] = []
        while self._next_lo < self._watermark:
            closed.append((self._idx, self._next_lo,
                           self._next_lo + self._window_ns))
            self._idx += 1
            self._next_lo += self._stride_ns
        return closed

    @property
    def windows_emitted(self) -> int:
        return self._idx
