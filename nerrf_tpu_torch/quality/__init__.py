"""Detection-quality plane: reference profiles, live drift sketches.

Every other observability layer (spans, flight/SLO, devtime) watches
*performance*; this package watches whether the model is still *right*.
Three pieces:

  * `sketch` — the one mergeable fixed-bin histogram primitive both the
    calibration-time reference and the serve-side trailing windows are
    built from (mergeable by construction, so pod-scale aggregation is
    count addition);
  * `profile` — the **reference profile** stamped into every published
    checkpoint at calibration time (``quality_profile.json``): the score
    distribution, window-feature distributions, alert rate and
    calibrated-threshold margin mass the version *expects* to serve;
  * `monitor` — the serve-side `QualityMonitor` comparing live trailing
    sketches against the live version's reference, exported as
    ``nerrf_quality_*`` gauges and cadenced ``quality_stats`` journal
    records (the flight recorder's ``quality_drift`` trigger edge).

See docs/quality.md for the schema, metric catalog and the
threshold-tuning runbook.
"""

from nerrf_tpu_torch.quality.monitor import QualityConfig, QualityMonitor
from nerrf_tpu_torch.quality.profile import (
    PROFILE_FILENAME,
    PROFILE_SCHEMA,
    ProfileBuilder,
    QualityProfile,
    build_reference_profile,
    load_profile,
    merge_profiles,
)
from nerrf_tpu_torch.quality.sketch import (
    COUNT_EDGES,
    FRACTION_EDGES,
    SCORE_EDGES,
    Sketch,
    psi,
)

__all__ = [
    "COUNT_EDGES",
    "FRACTION_EDGES",
    "PROFILE_FILENAME",
    "PROFILE_SCHEMA",
    "ProfileBuilder",
    "QualityConfig",
    "QualityMonitor",
    "QualityProfile",
    "SCORE_EDGES",
    "Sketch",
    "build_reference_profile",
    "load_profile",
    "merge_profiles",
    "psi",
]
