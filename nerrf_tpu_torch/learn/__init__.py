"""Continuous-learning plane: replay buffer + drift-triggered retraining.

The port of ``nerrf_tpu/learn/``: colocate an elastic learner with serving
so experience never leaves the pod, and let the existing shadow/canary
gates decide promotion.  Two halves:

- ``replay`` (a host copy): scored serve windows teed at the demux seam
  into a crash-safe, size-bounded on-disk buffer (archive spool segments)
  with per-stream reservoir sampling, operator tp/fp disposition join, and
  a deterministic seedable reader (`nerrf archive export --replay`);
- ``supervisor``: a journal-subscribed daemon that arms on sustained
  ``quality_drift``, retrains elastically under trainwatch on the card (a
  divergence halt publishes nothing), and publishes the candidate with its
  retrain provenance stamped in the checkpoint sidecar.
"""

from nerrf_tpu_torch.learn.replay import (  # noqa: F401
    DISPOSITIONS_FILENAME,
    REPLAY_KIND,
    ReplayConfig,
    ReplayWriter,
    append_disposition,
    build_replay_dataset,
    iter_replay,
    load_dispositions,
    replay_batches,
    replay_fingerprint,
    replay_stats,
)
from nerrf_tpu_torch.learn.supervisor import (  # noqa: F401
    RetrainConfig,
    RetrainSupervisor,
)
