"""Telemetry archive plane: continuous crash-safe spooling + offline reports.

Every live observability plane (spans, SLO/flight, devtime, quality,
trainwatch) is ring-buffered: evidence survives only as long as the ring,
or when a trigger fires.  The archive plane makes the telemetry durable —
a segmented on-disk spool of journal records, cadenced metrics snapshots
and mergeable workload sketches — and everything downstream is offline:
`nerrf report` (SLO/capacity/drift/efficiency/train-health from segments
alone), `nerrf report --compare` (cross-run regression diffs),
`nerrf archive export --tune` (the learned-ladder cost-model corpus), and
`nerrf archive ls|prune|verify|merge`.  See docs/archive.md.

Host copies of ``nerrf_tpu/archive/``, kept identical: archiving and
reading need no device, and an archive written by either package reads
in the other.
"""

from nerrf_tpu_torch.archive.spool import (  # noqa: F401
    ArchiveSpool,
    SpoolConfig,
    is_archive_dir,
    iter_records,
    list_segments,
    merge_archives,
    prune_archive,
    read_segment,
    verify_archive,
)
from nerrf_tpu_torch.archive.writer import (  # noqa: F401
    ArchiveConfig,
    ArchiveWriter,
)
from nerrf_tpu_torch.archive.report import (  # noqa: F401
    CompareConfig,
    build_report,
    compare_reports,
    export_tune,
    format_compare,
    format_report,
    report_main,
)
