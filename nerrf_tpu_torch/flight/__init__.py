"""The flight plane's journal: the serve path's decision log.

The port of ``nerrf_tpu/flight/``'s journal; the SLO tracker, the flight
recorder and the doctor come with their planes.
"""

from nerrf_tpu_torch.flight.journal import (
    DEFAULT_JOURNAL,
    EventJournal,
    JournalRecord,
    fingerprint,
    make_trace_id,
)

__all__ = [
    "DEFAULT_JOURNAL",
    "EventJournal",
    "JournalRecord",
    "fingerprint",
    "make_trace_id",
]
