"""Whole-trace event-stream extraction for StreamNet (the long-context path).

(Copied from ``nerrf_tpu/data/stream.py`` so the port needs nothing of the JAX
package; keep the two identical: the parity tests compare their arrays.)

Where `sequences.py` slices the last 100 events of one file (the reference's
LSTM input spec), this module lowers the *entire* trace to one time-ordered
feature sequence with per-event labels — the input the sequence-parallel
stream detector attends over.  Long traces are split into consecutive
``max_len`` segments (label structure is preserved: segment boundaries fall
between events, never inside one).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from nerrf_tpu_torch.data.loaders import Trace
from nerrf_tpu_torch.data.sequences import SEQ_FEATURE_DIM, event_features
from nerrf_tpu_torch.schema.events import Syscall

STREAM_FEATURE_DIM = SEQ_FEATURE_DIM  # same per-event feature layout


@dataclasses.dataclass
class StreamBatch:
    feat: np.ndarray    # float32 [B, T, STREAM_FEATURE_DIM]
    mask: np.ndarray    # bool    [B, T]
    label: np.ndarray   # float32 [B, T] per-event attack labels

    def __len__(self) -> int:
        return len(self.feat)

    @staticmethod
    def concatenate(batches: list["StreamBatch"]) -> "StreamBatch":
        return StreamBatch(
            feat=np.concatenate([b.feat for b in batches]),
            mask=np.concatenate([b.mask for b in batches]),
            label=np.concatenate([b.label for b in batches]),
        )

    def arrays(self) -> dict[str, np.ndarray]:
        return {"feat": self.feat, "mask": self.mask, "label": self.label}

    def tile_to_multiple(self, n: int) -> dict[str, np.ndarray]:
        """Arrays with batch tiled (wrapping) up to the next multiple of n.

        Always covers every segment at least once (rounds len up, never
        down), so data-parallel sharding over ``n`` devices drops nothing.
        """
        if len(self) == 0:
            raise ValueError("cannot tile an empty StreamBatch")
        size = max(n, ((len(self) + n - 1) // n) * n)
        idx = np.arange(size) % len(self)
        return {k: v[idx] for k, v in self.arrays().items()}


def build_stream(trace: Trace, max_len: int = 1024) -> StreamBatch:
    """Trace → [num_segments, max_len, F] padded stream segments."""
    ev = trace.events
    lab = (
        trace.labels
        if trace.labels is not None
        else np.zeros(len(ev), np.float32)
    )
    sel = ev.valid & (ev.syscall != int(Syscall.MARKER))
    idx = np.nonzero(sel)[0]
    if len(idx) == 0:
        return StreamBatch(
            feat=np.zeros((0, max_len, STREAM_FEATURE_DIM), np.float32),
            mask=np.zeros((0, max_len), np.bool_),
            label=np.zeros((0, max_len), np.float32),
        )

    ts = ev.ts_ns[idx]
    t0, t1 = int(ts.min()), max(int(ts.max()), int(ts.min()) + 1)
    f = event_features(ev, idx, trace.strings.features(), t0, t1)
    # feature 7 here is the *global* inter-event gap (stream time structure —
    # recon bursts vs the steady encryption cadence), vs per-file in
    # build_file_sequences
    f[:, 7] = np.log1p(np.diff(ts, prepend=ts[0]) / 1e9)

    labels = np.asarray(lab, np.float32)[idx]

    n = len(idx)
    num_seg = (n + max_len - 1) // max_len
    out_feat = np.zeros((num_seg, max_len, STREAM_FEATURE_DIM), np.float32)
    out_mask = np.zeros((num_seg, max_len), np.bool_)
    out_label = np.zeros((num_seg, max_len), np.float32)
    for s in range(num_seg):
        lo, hi = s * max_len, min((s + 1) * max_len, n)
        k = hi - lo
        out_feat[s, :k] = f[lo:hi]
        out_mask[s, :k] = True
        out_label[s, :k] = labels[lo:hi]
    return StreamBatch(feat=out_feat, mask=out_mask, label=out_label)


def build_streams(traces: list[Trace], max_len: int = 1024) -> StreamBatch:
    return StreamBatch.concatenate([build_stream(t, max_len) for t in traces])
