"""Host-side spans: the ``span`` context manager the pipeline stages open.

The port's counterpart of ``nerrf_tpu/tracing.py``'s one-import
instrumentation point, cut to what detection uses: each span records its
stage name, its duration and the attributes the body adds into a bounded
ring.  ``device=True`` also opens a ``torch.profiler.record_function`` region
of the same name, so the stage shows up in a profiler trace beside the
kernels it launched.  Chrome-trace export and the metrics dual-write come
with the port's tracing slice.

:func:`enabled` (``NERRF_TRACE=1`` in the environment) opts the training
loops into per-step spans that synchronize the card each step
(``data_wait``, ``device_step``), as the reference's
``DEFAULT_TRACER.enabled`` does; off, they open none.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Dict, List


class Span:
    """One recorded host-side region; ``args`` is the mutable attribute dict
    the ``with`` body may extend."""

    __slots__ = ("name", "t0", "dur", "args")

    def __init__(self, name: str, args: Dict) -> None:
        self.name = name
        self.t0 = 0.0
        self.dur = 0.0
        self.args = args


_LOCK = threading.Lock()
_SPANS: deque = deque(maxlen=65536)
_ENABLED = os.environ.get("NERRF_TRACE") == "1"


def enabled() -> bool:
    """Whether hot loops open their per-step synced spans."""
    return _ENABLED



@contextlib.contextmanager
def span(stage: str, device: bool = False, **args):
    """Record a host-side span named ``stage`` (see the module docstring)."""
    sp = Span(stage, args)
    ann = contextlib.nullcontext()
    if device:
        import torch

        ann = torch.profiler.record_function(stage)
    sp.t0 = time.perf_counter()
    try:
        with ann:
            yield sp
    finally:
        sp.dur = time.perf_counter() - sp.t0
        with _LOCK:
            _SPANS.append(sp)


def records() -> List[Span]:
    """The recorded spans, oldest first."""
    with _LOCK:
        return list(_SPANS)
