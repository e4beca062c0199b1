"""Dataset assembly: traces → padded window samples.

(Copied from ``nerrf_tpu/train/data.py``, the parts detection and training
run, so the port needs nothing of the JAX package; keep the two identical:
the parity tests compare their arrays.)

One sample = one sliding-window graph (`GraphBatch`) plus the per-file event
sequences inside that window (`SequenceBatch`), with a host-computed
``seq_node_idx`` routing each sequence to its file node (inode match).  All
samples of one config share one static shape, so a dataset stacks into flat
[B, ...] arrays (`WindowDataset`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from nerrf_tpu_torch.data.labels import derive_event_labels
from nerrf_tpu_torch.data.loaders import Trace
from nerrf_tpu_torch.data.sequences import SequenceBatch, build_file_sequences
from nerrf_tpu_torch.graph.builder import (
    GraphBatch,
    GraphConfig,
    NODE_TYPE_FILE,
    build_window_graph,
    measure_window,
    snapshot_windows,
)


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    graph: GraphConfig = GraphConfig()
    seq_len: int = 100
    max_seqs: int = 128
    # windows with fewer events than this are skipped (no signal, all padding)
    min_events: int = 4


@dataclasses.dataclass
class WindowDataset:
    """Flat [B, ...] arrays ready for device transfer."""

    arrays: dict[str, np.ndarray]

    def __len__(self) -> int:
        return len(self.arrays["node_feat"])

    def take(self, idx: np.ndarray) -> "WindowDataset":
        return WindowDataset({k: v[idx] for k, v in self.arrays.items()})

    def split(self, frac: float, seed: int = 0) -> tuple["WindowDataset", "WindowDataset"]:
        n = len(self)
        order = np.random.default_rng(seed).permutation(n)
        k = int(n * (1 - frac))
        return self.take(order[:k]), self.take(order[k:])

    @staticmethod
    def concatenate(parts: List["WindowDataset"]) -> "WindowDataset":
        keys = parts[0].arrays.keys()
        return WindowDataset(
            {k: np.concatenate([p.arrays[k] for p in parts]) for k in keys}
        )


def _seq_node_index(g: GraphBatch, seqs: SequenceBatch) -> np.ndarray:
    """Match each sequence's inode to its file-node slot in g (-1 if absent)."""
    out = np.full(len(seqs), -1, np.int32)
    file_slots = np.nonzero(g.node_mask & (g.node_type == NODE_TYPE_FILE))[0]
    if len(file_slots) == 0 or len(seqs) == 0:
        return out
    key_to_slot = {int(g.node_key[s]): int(s) for s in file_slots}
    for i, ino in enumerate(seqs.inode):
        out[i] = key_to_slot.get(int(ino), -1)
    return out


def window_sample(trace: Trace, lo: int, hi: int, cfg: DatasetConfig,
                  labels: Optional[np.ndarray] = None):
    """Lower ONE window [lo, hi) to a padded sample → ``(sample, stats)``.

    ``sample`` is None when the window carries fewer than ``cfg.min_events``
    events (all padding, no signal)."""
    g, stats = build_window_graph(trace.events, trace.strings, lo, hi,
                                  cfg.graph, labels=labels)
    if stats.num_events < cfg.min_events:
        return None, stats
    seqs = build_file_sequences(trace, labels=labels, seq_len=cfg.seq_len,
                                lo_ns=lo, hi_ns=hi)
    if len(seqs) > cfg.max_seqs:
        # keep the most event-dense sequences (they carry the signal)
        density = seqs.mask.sum(axis=1)
        keep = np.argsort(-density, kind="stable")[: cfg.max_seqs]
        keep.sort()
        seqs = SequenceBatch(feat=seqs.feat[keep], mask=seqs.mask[keep],
                             label=seqs.label[keep], inode=seqs.inode[keep])
    seqs = seqs.pad_to(cfg.max_seqs)
    seq_valid = seqs.mask.any(axis=1)
    sample = dict(g.arrays())
    sample.update(
        seq_feat=seqs.feat.astype(np.float32),
        seq_mask=seqs.mask,
        seq_label=seqs.label.astype(np.float32),
        seq_valid=seq_valid,
        seq_node_idx=_seq_node_index(g, seqs),
    )
    return sample, stats


def windows_of_trace(trace: Trace, cfg: DatasetConfig,
                     stats_out: Optional[list] = None) -> List[dict[str, np.ndarray]]:
    """All window samples for one trace.

    ``stats_out``, when given, receives one ``WindowStats`` per *emitted*
    sample."""
    labels = derive_event_labels(trace)
    ev = trace.events
    if ev.num_valid == 0:
        return []
    valid_ts = ev.ts_ns[ev.valid]
    out = []
    for lo, hi in snapshot_windows(int(valid_ts.min()), int(valid_ts.max()), cfg.graph):
        sample, stats = window_sample(trace, lo, hi, cfg, labels=labels)
        if sample is None:
            continue
        if stats_out is not None:
            stats_out.append(stats)
        out.append(sample)
    return out


def padding_waste_fractions(arrays) -> dict[str, float]:
    """Fraction of padded capacity carrying no real data, per dimension.

    Static shapes mean a padded slot costs exactly as much device compute
    as a real one, so this IS the step-time attribution for bucket sizing."""
    masks = (("node", "node_mask"), ("edge", "edge_mask"),
             ("seq", "seq_valid"))
    return {kind: round(float(1.0 - np.asarray(arrays[key]).mean()), 4)
            for kind, key in masks if key in arrays}


def fit_dataset_config(traces: List[Trace],
                       cfg: Optional[DatasetConfig] = None) -> DatasetConfig:
    """A DatasetConfig whose graph capacities fit every window of ``traces``
    with zero drops (GraphConfig.fit_counts bucket policy, corpus-wide max).
    Evaluation datasets must use this: scoring a model on windows that
    silently truncate the attack burst measures the truncation, not the
    model."""
    cfg = cfg or DatasetConfig()
    max_n = max_e = 0
    for tr in traces:
        ev = tr.events
        if ev.num_valid == 0:
            continue
        ts = ev.ts_ns[ev.valid]
        for lo, hi in snapshot_windows(int(ts.min()), int(ts.max()), cfg.graph):
            n, e = measure_window(ev, lo, hi)
            max_n, max_e = max(max_n, n), max(max_e, e)
    return dataclasses.replace(cfg, graph=cfg.graph.fit_counts(max_n, max_e))


def build_dataset(traces: List[Trace], cfg: Optional[DatasetConfig] = None) -> WindowDataset:
    cfg = cfg or DatasetConfig()
    samples: List[dict[str, np.ndarray]] = []
    for tr in traces:
        samples.extend(windows_of_trace(tr, cfg))
    if not samples:
        raise ValueError("no window samples produced — traces empty?")
    keys = samples[0].keys()
    return WindowDataset({k: np.stack([s[k] for s in samples]) for k in keys})
