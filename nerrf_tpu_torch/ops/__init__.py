from nerrf_tpu_torch.ops.segment import (
    LAUNCHES,
    active_impls,
    gather_rows,
    gather_rows_sorted,
    plain_ops,
    reset_launches,
    sage_aggregate,
    sage_row_ptrs,
    segment_mean,
    segment_sum,
    segment_sum_sorted,
)

__all__ = [
    "LAUNCHES",
    "active_impls",
    "gather_rows",
    "gather_rows_sorted",
    "plain_ops",
    "reset_launches",
    "sage_aggregate",
    "sage_row_ptrs",
    "segment_mean",
    "segment_sum",
    "segment_sum_sorted",
]
