from nerrf_tpu_torch.graph.builder import (
    EDGE_FEATURE_DIM,
    NODE_FEATURE_DIM,
    GraphBatch,
    GraphConfig,
    WindowStats,
    build_window_graph,
    measure_window,
    snapshot_windows,
)

__all__ = [
    "GraphConfig",
    "GraphBatch",
    "WindowStats",
    "build_window_graph",
    "measure_window",
    "snapshot_windows",
    "NODE_FEATURE_DIM",
    "EDGE_FEATURE_DIM",
]
