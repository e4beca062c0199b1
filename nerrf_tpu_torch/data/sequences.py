"""Per-file event-sequence extraction for the impact LSTM.

(Copied from ``nerrf_tpu/data/sequences.py`` so the port needs nothing of the JAX
package; keep the two identical: the parity tests compare their arrays.)

The reference specifies "last 100 events per file" as the LSTM input
(`architecture.mdx:56`; worked example `threat-model.mdx:191-203`: the
openat→write→rename motif is the signal).  This module lowers a trace to
padded [num_files, seq_len, F] arrays with step masks and per-file labels.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from nerrf_tpu_torch.data.loaders import Trace
from nerrf_tpu_torch.schema.events import Syscall

# Per-event sequence features:
#   0..5  syscall one-hot [openat, write, rename, read, unlink, other]
#   6     log1p(bytes/1KiB)
#   7     log1p(dt since previous event on this file, seconds)
#   8     suspicious-extension involvement (path or new_path)
#   9     write-access flag (openat O_WRONLY/O_RDWR)
#   10    position in window [0, 1]
#   11    readme/ransom-note name flag
SEQ_FEATURE_DIM = 12

_SYS_SLOT = {
    int(Syscall.OPENAT): 0,
    int(Syscall.WRITE): 1,
    int(Syscall.RENAME): 2,
    int(Syscall.READ): 3,
    int(Syscall.UNLINK): 4,
}


@dataclasses.dataclass
class SequenceBatch:
    feat: np.ndarray    # float32 [S, T, SEQ_FEATURE_DIM]
    mask: np.ndarray    # bool    [S, T]
    label: np.ndarray   # float32 [S]
    inode: np.ndarray   # int64   [S] (file identity, host side)

    def __len__(self) -> int:
        return len(self.label)

    def pad_to(self, n: int) -> "SequenceBatch":
        s = len(self)
        if s > n:
            raise ValueError(f"cannot pad {s} sequences down to {n}")
        pad = n - s
        return SequenceBatch(
            feat=np.concatenate([self.feat, np.zeros((pad,) + self.feat.shape[1:], np.float32)]),
            mask=np.concatenate([self.mask, np.zeros((pad, self.mask.shape[1]), np.bool_)]),
            label=np.concatenate([self.label, np.zeros(pad, np.float32)]),
            inode=np.concatenate([self.inode, np.zeros(pad, np.int64)]),
        )

    @staticmethod
    def concatenate(batches: list["SequenceBatch"]) -> "SequenceBatch":
        return SequenceBatch(
            feat=np.concatenate([b.feat for b in batches]),
            mask=np.concatenate([b.mask for b in batches]),
            label=np.concatenate([b.label for b in batches]),
            inode=np.concatenate([b.inode for b in batches]),
        )


def event_features(ev, idx, feats_table, t0: int, t1: int) -> np.ndarray:
    """Vectorized per-event features [len(idx), SEQ_FEATURE_DIM] — the one
    source of the feature layout documented above.  Feature 7 (inter-event
    gap) is context-dependent (per-file vs whole-stream) and left zero for
    the caller to fill."""
    ts = ev.ts_ns[idx]
    f = np.zeros((len(idx), SEQ_FEATURE_DIM), np.float32)
    sys = ev.syscall[idx]
    slot = np.full(len(idx), 5, np.int64)
    for sc, sl in _SYS_SLOT.items():
        slot[sys == sc] = sl
    f[np.arange(len(idx)), slot] = 1.0
    f[:, 6] = np.log1p(ev.bytes[idx] / 1024.0)
    pf = feats_table[ev.path_id[idx]]
    nf = feats_table[ev.new_path_id[idx]]
    f[:, 8] = np.maximum(pf[:, 4], nf[:, 4])
    f[:, 9] = ((sys == int(Syscall.OPENAT)) & (ev.flags[idx] > 0)).astype(np.float32)
    f[:, 10] = (ts - t0) / (t1 - t0)
    f[:, 11] = pf[:, 5]
    return f


def build_file_sequences(
    trace: Trace,
    labels: np.ndarray | None = None,
    seq_len: int = 100,
    lo_ns: int | None = None,
    hi_ns: int | None = None,
) -> SequenceBatch:
    """Last ≤seq_len events per file (inode), left-padded.

    A file's label is 1.0 if any attack event touched it — per the reference's
    framing, the LSTM predicts whether the file is being encrypted.
    """
    ev = trace.events
    lab = labels if labels is not None else (
        trace.labels if trace.labels is not None else np.zeros(len(ev), np.float32)
    )
    sel = ev.valid & (ev.inode > 0) & (ev.syscall != int(Syscall.MARKER))
    if lo_ns is not None:
        sel &= ev.ts_ns >= lo_ns
    if hi_ns is not None:
        sel &= ev.ts_ns < hi_ns
    idx = np.nonzero(sel)[0]
    if len(idx) == 0:
        return SequenceBatch(
            feat=np.zeros((0, seq_len, SEQ_FEATURE_DIM), np.float32),
            mask=np.zeros((0, seq_len), np.bool_),
            label=np.zeros(0, np.float32),
            inode=np.zeros(0, np.int64),
        )

    ts = ev.ts_ns[idx]
    t0, t1 = int(ts.min()), max(int(ts.max()), int(ts.min()) + 1)
    f = event_features(ev, idx, trace.strings.features(), t0, t1)

    inode = ev.inode[idx]
    uniq, inv = np.unique(inode, return_inverse=True)
    S = len(uniq)
    out_feat = np.zeros((S, seq_len, SEQ_FEATURE_DIM), np.float32)
    out_mask = np.zeros((S, seq_len), np.bool_)
    out_label = np.zeros(S, np.float32)
    np.maximum.at(out_label, inv, lab[idx])

    # per-file gather via one stable sort (events are time-sorted already, so
    # within each group order is chronological) — O(E log E), not O(S·E)
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(S + 1))
    for s in range(S):
        rows = order[bounds[s] : bounds[s + 1]][-seq_len:]
        k = len(rows)
        block = f[rows]
        # dt since previous event on this file (feature 7)
        dts = np.diff(ts[rows], prepend=ts[rows[0]]) / 1e9
        block[:, 7] = np.log1p(dts)
        out_feat[s, seq_len - k:] = block
        out_mask[s, seq_len - k:] = True
    return SequenceBatch(feat=out_feat, mask=out_mask, label=out_label,
                         inode=uniq.astype(np.int64))
