"""The flight plane: the serve path's incident flight recorder and SLO plane.

The port of ``nerrf_tpu/flight/``, exporting what the reference's package
does.  Three pieces, all host code:

  * `journal`: a bounded, thread-safe ring of typed `JournalRecord`s, the
    record of what the system decided (a host copy);
  * `slo`: end-to-end SLO accounting per stream, the e2e histograms, the
    per-stage budget burn and the exemplar trace IDs (a host copy);
  * `recorder`: declarative anomaly triggers (trailing-p99 breach, drop
    burst, shadow disagreement, guardrail veto, quality drift, uncaught
    exception, the training triggers) that atomically dump a
    self-contained diagnostic bundle, read offline by ``nerrf doctor
    <bundle>`` (`doctor`).
"""

from nerrf_tpu_torch.flight.journal import (
    DEFAULT_JOURNAL,
    EventJournal,
    JournalRecord,
    fingerprint,
    make_trace_id,
)
from nerrf_tpu_torch.flight.recorder import (
    FlightConfig,
    FlightRecorder,
    install_crash_handlers,
)
from nerrf_tpu_torch.flight.slo import SLO_BUCKETS, SLOTracker

__all__ = [
    "DEFAULT_JOURNAL",
    "EventJournal",
    "JournalRecord",
    "FlightConfig",
    "FlightRecorder",
    "SLOTracker",
    "SLO_BUCKETS",
    "fingerprint",
    "install_crash_handlers",
    "make_trace_id",
]
