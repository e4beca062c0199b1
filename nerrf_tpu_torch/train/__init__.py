from nerrf_tpu_torch.train.data import DatasetConfig, window_sample, windows_of_trace

__all__ = ["DatasetConfig", "window_sample", "windows_of_trace"]
