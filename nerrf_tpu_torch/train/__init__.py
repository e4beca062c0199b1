from nerrf_tpu_torch.train.data import (
    DatasetConfig,
    WindowDataset,
    build_dataset,
    fit_dataset_config,
    padding_waste_fractions,
    window_sample,
    windows_of_trace,
)
from nerrf_tpu_torch.train.metrics import best_f1, f1_score, roc_auc

# ``train.loop`` (``train_nerrfnet``) is imported by its module path: it
# needs ``pipeline``, which imports ``train.data`` through this package.
__all__ = [
    "DatasetConfig",
    "WindowDataset",
    "best_f1",
    "build_dataset",
    "f1_score",
    "fit_dataset_config",
    "padding_waste_fractions",
    "roc_auc",
    "window_sample",
    "windows_of_trace",
]
