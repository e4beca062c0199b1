from nerrf_tpu_torch.ops.segment import (
    LAUNCHES,
    active_impls,
    gather_rows,
    plain_ops,
    reset_launches,
    sage_aggregate,
    sage_row_ptrs,
    segment_sum,
)

__all__ = [
    "LAUNCHES",
    "active_impls",
    "gather_rows",
    "plain_ops",
    "reset_launches",
    "sage_aggregate",
    "sage_row_ptrs",
    "segment_sum",
]
