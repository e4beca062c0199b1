"""Temporal dependency-graph construction: event windows → padded device graphs.

(Copied from ``nerrf_tpu/graph/builder.py`` so the port needs nothing of the JAX
package; keep the two identical: the parity tests compare their arrays.)

Implements the reference's specified graph constructor
(upstream NERRF `docs/content/docs/architecture.mdx:32-43`: sliding window
30–60 s, node merging by inode, causality-confidence edge weights; node schema
at `architecture.mdx:144-160`) — re-architected for XLA's static-shape world:

* A window of events lowers to a **fixed-capacity padded graph**
  (`GraphBatch`): `max_nodes`/`max_edges` slots, boolean masks for validity,
  edges sorted by destination so message passing is a segment reduction.
  Snapshots of any window therefore all share one shape → one XLA compilation.
* Nodes are **files keyed by inode** (dedup per spec) and **processes keyed by
  pid**.  Because inode identity survives renames (our loaders carry it), a
  rename is a node *property* (rename_count, suspicious-extension flag), not a
  file→file edge — same information, no dynamic node growth mid-window.
* Edges are **aggregated (process, file) interaction pairs** with per-syscall
  count features and a causality weight (event count within window); the GNN
  classifies these edges as normal/attack, exactly the reference's task
  ("classify edges as normal/attack", `architecture.mdx:49-53`).
* Per-node features realize the threat model's indicator set
  (`threat-model.mdx:176-189`: in/out-degree, temporal delta, byte ratio,
  extension pattern) plus the interned path-feature rows.

All host-side work is vectorized numpy — no per-event Python in the hot path —
so a ~25k-event window (the density projected at `threat-model.mdx:121-137`)
lowers in milliseconds.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from nerrf_tpu_torch.data.loaders import Trace
from nerrf_tpu_torch.tracing import span as trace_span
from nerrf_tpu_torch.schema.events import (
    EXT_VOCAB,
    EventArrays,
    StringTable,
    Syscall,
    _stable_hash,
)

_NS = 1_000_000_000

NODE_TYPE_FILE = 0
NODE_TYPE_PROCESS = 1

# node_aux vocabulary: 0 = pad, 1..EXT_VOCAB = file extension ids,
# then AUX_COMM_BUCKETS process-comm hash buckets.
AUX_COMM_BUCKETS = 32
AUX_COMM_BASE = 1 + EXT_VOCAB
AUX_VOCAB = AUX_COMM_BASE + AUX_COMM_BUCKETS

# Node feature layout (float32):
#   0..7   path_features row (files; zeros for processes)
#   8      read_count    (log1p)
#   9      write_count   (log1p)
#   10     rename_count  (log1p)
#   11     unlink_count  (log1p)
#   12     open_count    (log1p)
#   13     stat/other count (log1p)
#   14     bytes_read    (log1p, MB-ish scale)
#   15     bytes_written (log1p)
#   16     in_degree     (log1p; distinct peers writing to this node)
#   17     out_degree    (log1p; distinct peers this node acts on)
#   18     active_span   (last_seen - first_seen, fraction of window)
#   19     mean inter-event gap (fraction of window)
#   20     write/read byte ratio (the spec's "byte count ratio")
#   21     is_process flag
#   22     renamed-by-writer fraction: of this file's renames, the share
#          done by a process that ALSO wrote the file in-window — the
#          threat model's write→rename motif as a feature.  Separates
#          logrotate's rename-only touch (0.0) from ransomware's
#          encrypt-then-rename (1.0); without it the probe
#          model scored rotated logs p≈0.983, inseparable from stealth
#          victims, and the zero-FP cut zeroed benign-comm detection.
#   23     in-place-overwrite flag: some process both read and wrote this
#          file in-window (the no-rename encryption signature; also fires
#          on e.g. postgres data files, which is exactly the benign
#          context the model must weigh).
NODE_FEATURE_DIM = 24

# Edge feature layout (float32):
#   0..5   per-syscall event counts on this (src,dst) pair
#          [openat, write, rename, read, unlink, other]  (log1p)
#   6      bytes moved on the pair (log1p)
#   7      event rate on the pair (events/sec over window, log1p)
#   8      mean inter-event gap on the pair (fraction of window)
#   9      first-seen offset in window [0,1]
#   10     last-seen offset in window [0,1]
#   11     suspicious-extension involvement flag
#   12     causality weight: pair events / total window events
EDGE_FEATURE_DIM = 13


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Window + capacity knobs.  Defaults: 45 s window / 15 s stride (inside
    the spec's 30–60 s band), capacities sized ~4× the M1 scale (45-50 files +
    a handful of processes) so padding dominates only mildly.

    Capacity guidance (measured, benchmarks/run_graph_capacity.py): the
    defaults fit the synthetic training corpus (40 Hz benign load) with zero
    drops, but a ~25 k-event window at projected real-eBPF density
    (threat-model.mdx:121-137, ≈550 evt/s) needs ~3.2 k nodes / 4.4 k edges —
    at the defaults ~34 % of events drop.  Online paths at real density
    should use :meth:`fit` (exact count → power-of-two bucket), which bounds
    XLA recompiles to the handful of bucket shapes."""

    window_sec: float = 45.0
    stride_sec: float = 15.0
    max_nodes: int = 256
    max_edges: int = 512

    @staticmethod
    def bucket(need: int, floor: int, headroom: float = 1.25) -> int:
        """THE sizing policy: need × headroom, next power of two, floored.
        Every auto-capacity consumer (fit, model_detect) goes through here
        so the policy cannot silently diverge between paths."""
        need = max(int(np.ceil(need * headroom)), floor)
        return 1 << int(np.ceil(np.log2(need)))

    def fit_counts(self, n_nodes: int, n_edges: int,
                   headroom: float = 1.25) -> "GraphConfig":
        """Capacities sized to given exact needs (bucket policy above)."""
        return dataclasses.replace(
            self,
            max_nodes=self.bucket(n_nodes, self.max_nodes, headroom),
            max_edges=self.bucket(n_edges, self.max_edges, headroom),
        )

    def fit(self, events: "EventArrays", lo_ns: int, hi_ns: int,
            headroom: float = 1.25) -> "GraphConfig":
        """Capacities sized to THIS window's exact node/edge need."""
        n_nodes, n_edges = measure_window(events, lo_ns, hi_ns)
        return self.fit_counts(n_nodes, n_edges, headroom)


def measure_window(events: "EventArrays", lo_ns: int, hi_ns: int) -> Tuple[int, int]:
    """Exact (num_nodes, num_edges) a window needs for zero-drop lowering:
    nodes = unique processes + unique file inodes, edges = unique
    (process, file) pairs — the same universe build_window_graph constructs,
    counted vectorized without building anything."""
    sel = (
        events.valid
        & (events.ts_ns >= lo_ns)
        & (events.ts_ns < hi_ns)
        & (events.syscall != int(Syscall.MARKER))
    )
    pid = events.pid[sel].astype(np.int64)
    inode = events.inode[sel]
    has_file = inode > 0
    n_nodes = len(np.unique(pid)) + len(np.unique(inode[has_file]))
    pairs = np.stack(
        [pid[has_file], inode[has_file].astype(np.int64)], axis=1)
    n_edges = len(np.unique(pairs, axis=0)) if len(pairs) else 0
    return n_nodes, n_edges


@dataclasses.dataclass
class WindowStats:
    """Host-side observability for one lowering (overflow accounting)."""

    num_events: int = 0
    num_nodes: int = 0
    num_edges: int = 0
    dropped_nodes: int = 0
    dropped_edges: int = 0
    dropped_events: int = 0


@dataclasses.dataclass
class GraphBatch:
    """One padded window graph (all arrays fixed-shape, device-ready).

    Edges are sorted by ``edge_dst`` so neighbor aggregation is a single
    segment-sum over a monotone segment-id vector — the layout the Pallas
    aggregation kernel and `jax.ops.segment_sum` both want.
    """

    node_feat: np.ndarray  # float32 [max_nodes, NODE_FEATURE_DIM]
    node_type: np.ndarray  # int32  [max_nodes]
    node_aux: np.ndarray   # int32  [max_nodes] identity bucket (ext / comm)
    node_mask: np.ndarray  # bool   [max_nodes]
    node_key: np.ndarray   # int64  [max_nodes] (inode | pid tag; host-side id)
    node_label: np.ndarray  # float32 [max_nodes]
    edge_src: np.ndarray   # int32  [max_edges]
    edge_dst: np.ndarray   # int32  [max_edges] (sorted ascending on valid prefix)
    edge_feat: np.ndarray  # float32 [max_edges, EDGE_FEATURE_DIM]
    edge_mask: np.ndarray  # bool   [max_edges]
    edge_label: np.ndarray  # float32 [max_edges]
    window_start_ns: int = 0
    window_end_ns: int = 0

    @property
    def num_nodes(self) -> int:
        return int(self.node_mask.sum())

    @property
    def num_edges(self) -> int:
        return int(self.edge_mask.sum())

    def arrays(self) -> dict[str, np.ndarray]:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), np.ndarray)
        }

    @staticmethod
    def stack(batches: List["GraphBatch"]) -> dict[str, np.ndarray]:
        """Stack same-shape windows into [B, ...] arrays for device transfer."""
        if not batches:
            raise ValueError("cannot stack zero graphs")
        names = batches[0].arrays().keys()
        return {n: np.stack([getattr(b, n) for b in batches]) for n in names}


_PROC_TAG = np.int64(1) << np.int64(62)

_SYSCALL_TO_EDGE_SLOT = {
    int(Syscall.OPENAT): 0,
    int(Syscall.WRITE): 1,
    int(Syscall.RENAME): 2,
    int(Syscall.READ): 3,
    int(Syscall.UNLINK): 4,
}


def _first_appearance_unique(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Like np.unique but ids are assigned in order of first appearance, so
    node numbering is stable under capacity truncation."""
    uniq_sorted, inv_sorted = np.unique(keys, return_inverse=True)
    first_pos = np.full(len(uniq_sorted), np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first_pos, inv_sorted, np.arange(len(keys)))
    order = np.argsort(first_pos, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return uniq_sorted[order], rank[inv_sorted]


def build_window_graph(
    events: EventArrays,
    strings: StringTable,
    lo_ns: int,
    hi_ns: int,
    cfg: GraphConfig,
    labels: Optional[np.ndarray] = None,
) -> Tuple[GraphBatch, WindowStats]:
    """Lower the events in [lo_ns, hi_ns) to one padded window graph."""
    with trace_span("graph_lower") as sp:
        g, stats = _build_window_graph(events, strings, lo_ns, hi_ns, cfg,
                                       labels=labels)
        sp.args.update(events=stats.num_events, nodes=stats.num_nodes,
                       edges=stats.num_edges)
    return g, stats


def _build_window_graph(
    events: EventArrays,
    strings: StringTable,
    lo_ns: int,
    hi_ns: int,
    cfg: GraphConfig,
    labels: Optional[np.ndarray] = None,
) -> Tuple[GraphBatch, WindowStats]:
    stats = WindowStats()
    window_ns = max(hi_ns - lo_ns, 1)

    sel = (
        events.valid
        & (events.ts_ns >= lo_ns)
        & (events.ts_ns < hi_ns)
        & (events.syscall != int(Syscall.MARKER))
    )
    idx = np.nonzero(sel)[0]
    stats.num_events = len(idx)

    g = GraphBatch(
        node_feat=np.zeros((cfg.max_nodes, NODE_FEATURE_DIM), np.float32),
        node_type=np.zeros(cfg.max_nodes, np.int32),
        node_aux=np.zeros(cfg.max_nodes, np.int32),
        node_mask=np.zeros(cfg.max_nodes, np.bool_),
        node_key=np.zeros(cfg.max_nodes, np.int64),
        node_label=np.zeros(cfg.max_nodes, np.float32),
        edge_src=np.zeros(cfg.max_edges, np.int32),
        edge_dst=np.zeros(cfg.max_edges, np.int32),
        edge_feat=np.zeros((cfg.max_edges, EDGE_FEATURE_DIM), np.float32),
        edge_mask=np.zeros(cfg.max_edges, np.bool_),
        edge_label=np.zeros(cfg.max_edges, np.float32),
        window_start_ns=int(lo_ns),
        window_end_ns=int(hi_ns),
    )
    if len(idx) == 0:
        return g, stats

    ts = events.ts_ns[idx]
    pid = events.pid[idx].astype(np.int64)
    inode = events.inode[idx]
    syscall = events.syscall[idx]
    nbytes = events.bytes[idx].astype(np.float64)
    path_id = events.path_id[idx]
    new_path_id = events.new_path_id[idx]
    comm_id = events.comm_id[idx]
    ev_label = (
        labels[idx].astype(np.float32) if labels is not None else np.zeros(len(idx), np.float32)
    )

    # --- node universe: processes (tagged pid) + files (inode>0) -------------
    has_file = inode > 0
    proc_key = pid | _PROC_TAG
    file_key = inode.astype(np.int64)
    all_keys = np.concatenate([proc_key, file_key[has_file]])
    uniq_keys, ids_all = _first_appearance_unique(all_keys)
    n_nodes_total = len(uniq_keys)
    kept_nodes = min(n_nodes_total, cfg.max_nodes)
    stats.dropped_nodes = n_nodes_total - kept_nodes

    proc_node = ids_all[: len(idx)]
    file_node = np.full(len(idx), -1, np.int64)
    file_node[has_file] = ids_all[len(idx) :]

    # events touching a dropped (overflow) node are dropped whole
    ev_ok = (proc_node < kept_nodes) & (~has_file | (file_node < kept_nodes))
    stats.dropped_events = int((~ev_ok).sum())
    if stats.dropped_events:
        keep = np.nonzero(ev_ok)[0]
        (ts, pid, inode, syscall, nbytes, path_id, new_path_id, comm_id,
         ev_label, proc_node, file_node, has_file) = (
            a[keep] for a in (ts, pid, inode, syscall, nbytes, path_id,
                              new_path_id, comm_id, ev_label, proc_node,
                              file_node, has_file)
        )
    if len(ts) == 0:
        return g, stats

    node_is_proc = uniq_keys[:kept_nodes] >= _PROC_TAG
    g.node_mask[:kept_nodes] = True
    g.node_key[:kept_nodes] = np.where(
        node_is_proc, uniq_keys[:kept_nodes] & ~_PROC_TAG, uniq_keys[:kept_nodes]
    )
    g.node_type[:kept_nodes] = np.where(node_is_proc, NODE_TYPE_PROCESS, NODE_TYPE_FILE)
    stats.num_nodes = kept_nodes

    # --- per-node aggregates -------------------------------------------------
    nf = g.node_feat
    t_rel = ((ts - lo_ns) / window_ns).astype(np.float32)

    # event → "actor node" (process) and "object node" (file, may be -1)
    is_read = syscall == int(Syscall.READ)
    is_write = syscall == int(Syscall.WRITE)
    is_rename = syscall == int(Syscall.RENAME)
    is_unlink = syscall == int(Syscall.UNLINK)
    is_open = syscall == int(Syscall.OPENAT)
    other = ~(is_read | is_write | is_rename | is_unlink | is_open)

    def node_count(mask: np.ndarray, node: np.ndarray) -> np.ndarray:
        m = mask & (node >= 0)
        return np.bincount(node[m].astype(np.int64), minlength=kept_nodes).astype(np.float32)

    # file-node counters
    for slot, m in ((8, is_read), (9, is_write), (10, is_rename), (11, is_unlink),
                    (12, is_open), (13, other)):
        nf[:kept_nodes, slot] = np.log1p(node_count(m, file_node) + node_count(m, proc_node))

    def node_sum(values: np.ndarray, mask: np.ndarray, node: np.ndarray) -> np.ndarray:
        m = mask & (node >= 0)
        return np.bincount(
            node[m].astype(np.int64), weights=values[m], minlength=kept_nodes
        ).astype(np.float32)

    bytes_read = node_sum(nbytes, is_read, file_node) + node_sum(nbytes, is_read, proc_node)
    bytes_written = node_sum(nbytes, is_write, file_node) + node_sum(nbytes, is_write, proc_node)
    nf[:kept_nodes, 14] = np.log1p(bytes_read / 1024.0)
    nf[:kept_nodes, 15] = np.log1p(bytes_written / 1024.0)
    nf[:kept_nodes, 20] = bytes_written / (bytes_written + bytes_read + 1.0)

    # temporal span / gaps per node (over both roles)
    both_node = np.concatenate([proc_node, file_node])
    both_t = np.concatenate([t_rel, t_rel])
    ok = both_node >= 0
    first = np.full(kept_nodes, 2.0, np.float32)
    last = np.full(kept_nodes, -1.0, np.float32)
    np.minimum.at(first, both_node[ok].astype(np.int64), both_t[ok])
    np.maximum.at(last, both_node[ok].astype(np.int64), both_t[ok])
    cnt = np.bincount(both_node[ok].astype(np.int64), minlength=kept_nodes)
    span = np.where(cnt > 0, np.maximum(last - first, 0.0), 0.0).astype(np.float32)
    nf[:kept_nodes, 18] = span
    nf[:kept_nodes, 19] = span / np.maximum(cnt, 1)

    # path features: last path seen per file node
    feats_table = strings.features()
    file_ok = file_node >= 0
    nf_rows = file_node[file_ok].astype(np.int64)
    nf[:kept_nodes, 0:8][nf_rows] = feats_table[path_id[file_ok]]
    # renames: mark destination suspicious-extension on the file node too
    ren_ok = is_rename & file_ok
    if ren_ok.any():
        dst_feat = feats_table[new_path_id[ren_ok]]
        rows = file_node[ren_ok].astype(np.int64)
        np.maximum.at(nf[:kept_nodes, 0:8], rows, dst_feat)

    nf[:kept_nodes, 21] = node_is_proc.astype(np.float32)

    # identity buckets (node_aux): files → extension id of the latest path
    # seen (rename destination wins); processes → comm hash bucket.  Gives the
    # GNN the process-identity signal the Event schema carries in `comm`
    # (proto/trace.proto:14) without string features on device.
    aux = np.zeros(kept_nodes, np.int32)
    ext_ids = strings.extension_ids()
    last_pos = np.full(kept_nodes, -1, np.int64)
    fm_idx = np.nonzero(file_ok)[0]
    np.maximum.at(last_pos, file_node[fm_idx].astype(np.int64), fm_idx)
    file_rows = np.nonzero((last_pos >= 0) & ~node_is_proc)[0]
    if len(file_rows):
        lp = last_pos[file_rows]
        choice = np.where(
            is_rename[lp] & (new_path_id[lp] > 0), new_path_id[lp], path_id[lp]
        )
        aux[file_rows] = 1 + ext_ids[choice]
    first_pos = np.full(kept_nodes, len(ts), np.int64)
    np.minimum.at(first_pos, proc_node.astype(np.int64), np.arange(len(ts)))
    proc_rows = np.nonzero(node_is_proc & (first_pos < len(ts)))[0]
    if len(proc_rows):
        comms = [strings.lookup(int(comm_id[first_pos[r]])) for r in proc_rows]
        aux[proc_rows] = AUX_COMM_BASE + np.array(
            [_stable_hash(c) % AUX_COMM_BUCKETS for c in comms], np.int32
        )
    g.node_aux[:kept_nodes] = aux

    # node labels: any attack event touching the node
    node_lab = np.zeros(kept_nodes, np.float32)
    np.maximum.at(node_lab, proc_node.astype(np.int64), ev_label)
    fm = file_node >= 0
    np.maximum.at(node_lab, file_node[fm].astype(np.int64), ev_label[fm])
    g.node_label[:kept_nodes] = node_lab

    # --- edges: aggregated (process, file) pairs -----------------------------
    pair_ok = file_node >= 0
    pe = np.nonzero(pair_ok)[0]
    n_edges = 0
    if len(pe):
        pair_key = proc_node[pe] * np.int64(cfg.max_nodes + 1) + file_node[pe]
        uniq_pairs, pair_id = _first_appearance_unique(pair_key)
        n_pairs_total = len(uniq_pairs)
        kept_edges = min(n_pairs_total, cfg.max_edges)
        stats.dropped_edges = n_pairs_total - kept_edges
        e_ok = pair_id < kept_edges
        pe, pair_id = pe[e_ok], pair_id[e_ok]

        src = (uniq_pairs[:kept_edges] // (cfg.max_nodes + 1)).astype(np.int32)
        dst = (uniq_pairs[:kept_edges] % (cfg.max_nodes + 1)).astype(np.int32)

        ef = np.zeros((kept_edges, EDGE_FEATURE_DIM), np.float32)
        e_sys = syscall[pe]
        slot_of = np.full(int(Syscall.OTHER) + 1, 5, np.int64)
        for sc, slot in _SYSCALL_TO_EDGE_SLOT.items():
            slot_of[sc] = slot
        np.add.at(ef, (pair_id, slot_of[e_sys]), 1.0)
        ef[:, :6] = np.log1p(ef[:, :6])

        pair_bytes = np.bincount(pair_id, weights=nbytes[pe], minlength=kept_edges)
        ef[:, 6] = np.log1p(pair_bytes / 1024.0)
        pair_cnt = np.bincount(pair_id, minlength=kept_edges).astype(np.float32)
        ef[:, 7] = np.log1p(pair_cnt / (window_ns / _NS))
        e_first = np.full(kept_edges, 2.0, np.float32)
        e_last = np.full(kept_edges, -1.0, np.float32)
        np.minimum.at(e_first, pair_id, t_rel[pe])
        np.maximum.at(e_last, pair_id, t_rel[pe])
        e_span = np.maximum(e_last - e_first, 0.0)
        ef[:, 8] = e_span / np.maximum(pair_cnt, 1.0)
        ef[:, 9] = np.where(pair_cnt > 0, e_first, 0.0)
        ef[:, 10] = np.where(pair_cnt > 0, e_last, 0.0)
        susp = np.maximum(
            feats_table[path_id[pe], 4], feats_table[new_path_id[pe], 4]
        )
        np.maximum.at(ef[:, 11], pair_id, susp)
        ef[:, 12] = pair_cnt / max(len(ts), 1)

        e_lab = np.zeros(kept_edges, np.float32)
        np.maximum.at(e_lab, pair_id, ev_label[pe])

        # motif features on the FILE nodes, from per-pair syscall counts
        # (see layout slots 22/23): who renames vs who writes is pair-level
        # information the per-node counters above cannot express
        w_cnt = np.bincount(pair_id[is_write[pe]], minlength=kept_edges)
        r_cnt = np.bincount(pair_id[is_read[pe]], minlength=kept_edges)
        ren_cnt = np.bincount(pair_id[is_rename[pe]], minlength=kept_edges)
        ren_total = np.bincount(dst, weights=ren_cnt.astype(np.float64),
                                minlength=kept_nodes)
        ren_by_writer = np.bincount(
            dst, weights=(ren_cnt * (w_cnt > 0)).astype(np.float64),
            minlength=kept_nodes)
        nf[:kept_nodes, 22] = (
            ren_by_writer / np.maximum(ren_total, 1.0)).astype(np.float32)
        inplace = np.bincount(
            dst, weights=((w_cnt > 0) & (r_cnt > 0)).astype(np.float64),
            minlength=kept_nodes)
        nf[:kept_nodes, 23] = (inplace > 0).astype(np.float32)

        # sort by destination node for segment-reduction message passing
        order = np.argsort(dst, kind="stable")
        g.edge_src[:kept_edges] = src[order]
        g.edge_dst[:kept_edges] = dst[order]
        g.edge_feat[:kept_edges] = ef[order]
        g.edge_label[:kept_edges] = e_lab[order]
        g.edge_mask[:kept_edges] = True
        n_edges = kept_edges

    # degrees from the aggregated edge list
    if n_edges:
        in_deg = np.bincount(g.edge_dst[:n_edges], minlength=kept_nodes)
        out_deg = np.bincount(g.edge_src[:n_edges], minlength=kept_nodes)
        nf[:kept_nodes, 16] = np.log1p(in_deg.astype(np.float32))
        nf[:kept_nodes, 17] = np.log1p(out_deg.astype(np.float32))
    stats.num_edges = n_edges
    # padded edge slots must not corrupt segment reductions: point them at the
    # last node slot with zero features (masked in the model anyway)
    if n_edges < cfg.max_edges:
        g.edge_dst[n_edges:] = cfg.max_nodes - 1
        g.edge_src[n_edges:] = cfg.max_nodes - 1
    return g, stats


def snapshot_windows(
    t0_ns: int, t1_ns: int, cfg: GraphConfig
) -> Iterator[Tuple[int, int]]:
    """Sliding [lo, hi) windows covering [t0, t1]."""
    stride = int(cfg.stride_sec * _NS)
    window = int(cfg.window_sec * _NS)
    lo = t0_ns
    while lo < t1_ns:
        yield lo, lo + window
        lo += stride
