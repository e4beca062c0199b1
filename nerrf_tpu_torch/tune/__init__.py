"""`nerrf tune`: learned bucket ladder + per-bucket kernel routing.

The port of ``nerrf_tpu/tune``.  Fits a latency+padding cost model over the
archived tune corpus (`archive export --tune`), searches rung placement and
per-rung kernel choice, and emits the versioned tuned-ladder artifact that
``serve-detect --tuned`` consumes (the reference's AOT re-export waits for
the compile cache, ROADMAP A.7).  docs/tuning.md is the runbook.  Two
differences from the reference: the search's rung gate is the CUDA kernels'
own limits (`ops.kernels.rung_limits`), not the Pallas VMEM audit, and the
fit's dense↔fused prior is the reference's authored crossover, named as
such, since the port's ``auto`` has none.
"""

from nerrf_tpu_torch.tune.artifact import (
    ARTIFACT_KIND,
    ARTIFACT_SCHEMA,
    TuneError,
    apply_to_model_config,
    apply_to_serve_config,
    build_artifact,
    load_artifact,
    save_artifact,
    validate_artifact,
)
from nerrf_tpu_torch.tune.costmodel import (
    DENSE_FUSED_PRIOR_NODES,
    LadderCostModel,
    fit_cost_model,
    load_kernel_bench_crossover,
    parse_tag,
)
from nerrf_tpu_torch.tune.search import (
    budget_clean,
    demand_points,
    expected_cost,
    search_ladder,
    tune,
)

__all__ = [
    "ARTIFACT_KIND", "ARTIFACT_SCHEMA", "TuneError",
    "apply_to_model_config", "apply_to_serve_config", "build_artifact",
    "load_artifact", "save_artifact", "validate_artifact",
    "DENSE_FUSED_PRIOR_NODES", "LadderCostModel", "fit_cost_model",
    "load_kernel_bench_crossover", "parse_tag", "budget_clean",
    "demand_points", "expected_cost", "search_ladder", "tune",
]
