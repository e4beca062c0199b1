"""Detection: trace → windows → NerrfNet scores → DetectionResult.

The port of ``nerrf_tpu/pipeline.py``'s model path.  ``DetectionResult``,
``aggregate_window_scores``, ``pad_batch``, ``accumulate_node_scores``,
``finalize_detection``, ``_inode_to_path`` and ``_pid_to_comm`` are numpy
and copied from it unchanged (keep them identical: the decision tail must
not drift).  ``make_eval_fn`` runs the batch of windows as an explicit batch
dimension of the PyTorch ``NerrfNet``; ``model_detect`` is the reference's,
auto-capacity bucketing included, with the model in place of the params.
``DETECTOR_WARMUP_BUCKETS`` is the reference's boot ladder, and
``warmup_detector`` runs one eager forward per bucket where the reference
compiles one program per bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nerrf_tpu_torch.data.loaders import Trace
from nerrf_tpu_torch.device import resolve_device
from nerrf_tpu_torch.graph.builder import (
    NODE_TYPE_FILE,
    NODE_TYPE_PROCESS,
    GraphConfig,
    measure_window,
    snapshot_windows,
)
from nerrf_tpu_torch.models.joint import NerrfNet
from nerrf_tpu_torch.schema.events import MUTATING_SYSCALLS
from nerrf_tpu_torch.tracing import span as trace_span
from nerrf_tpu_torch.train.data import DatasetConfig, windows_of_trace

MODEL_INPUTS = (
    "node_feat", "node_type", "node_aux", "node_mask", "edge_src", "edge_dst",
    "edge_feat", "edge_mask", "seq_feat", "seq_mask", "seq_node_idx",
)


@dataclasses.dataclass
class DetectionResult:
    file_scores: Dict[str, float]   # path → P(compromised)
    proc_scores: Dict[str, float]   # "pid:comm" → P(malicious)
    file_bytes: Dict[str, float]    # path → bytes seen moving
    detector: str = "heuristic"
    # every per-window node probability per file, so consumers can compare
    # aggregation rules from ONE model pass
    file_window_scores: Optional[Dict[str, list]] = None
    # the operating threshold this detection was configured with
    threshold: float = 0.5

    def flagged_files(
            self, threshold: Optional[float] = None) -> Dict[str, float]:
        t = self.threshold if threshold is None else threshold
        return {k: v for k, v in self.file_scores.items() if v >= t}

    def rescored(self, agg: str) -> "DetectionResult":
        """Same detection, file scores re-aggregated from the per-window
        scores (`agg` as in model_detect).  Only files already present in
        ``file_scores`` are re-scored."""
        if not self.file_window_scores:
            return self
        return dataclasses.replace(
            self,
            file_scores={p: aggregate_window_scores(
                self.file_window_scores.get(p, []), agg)
                for p in self.file_scores},
            detector=f"{self.detector}[{agg}]")


def aggregate_window_scores(scores: list, agg: str) -> float:
    """Per-window node probabilities → one per-file score.

    ``max``     any hot window flags the file.
    ``robust``  the 2nd-highest window when the file was scored in ≥2
                windows, else the single score.
    """
    if not scores:
        return 0.0
    s = sorted(scores, reverse=True)
    if agg == "max":
        return s[0]
    if agg == "robust":
        return s[1] if len(s) >= 2 else s[0]
    raise ValueError(f"unknown aggregation {agg!r}")


def _inode_to_path(trace: Trace) -> Dict[int, str]:
    """inode → most-informative path (rename destination wins, else last)."""
    ev, st = trace.events, trace.strings
    out: Dict[int, str] = {}
    for i in range(len(ev)):
        if not ev.valid[i] or ev.inode[i] == 0:
            continue
        ino = int(ev.inode[i])
        new_path = st.lookup(int(ev.new_path_id[i]))
        out[ino] = new_path if new_path else st.lookup(int(ev.path_id[i]))
    return out


def _pid_to_comm(trace: Trace) -> Dict[int, str]:
    ev, st = trace.events, trace.strings
    out: Dict[int, str] = {}
    for i in range(len(ev)):
        if ev.valid[i]:
            out.setdefault(int(ev.pid[i]), st.lookup(int(ev.comm_id[i])))
    return out


def pad_batch(samples: list, batch_size: int) -> Dict[str, np.ndarray]:
    """Stack window samples into one fixed-shape batch, zero-padding the
    ragged tail."""
    pad = batch_size - len(samples)
    return {
        k: np.concatenate(
            [np.stack([s[k] for s in samples])]
            + ([np.zeros((pad,) + samples[0][k].shape,
                         samples[0][k].dtype)] if pad else []))
        for k in samples[0]
    }


def accumulate_node_scores(
    probs: np.ndarray,
    node_type: np.ndarray,
    node_key: np.ndarray,
    node_mask: np.ndarray,
    ino_path: Dict[int, str],
    pid_comm: Dict[int, str],
    window_scores: Dict[str, list],
    proc_scores: Dict[str, float],
) -> None:
    """Fold ONE scored window's per-node probabilities into the running
    per-path window-score lists and per-process maxima."""
    for slot in np.nonzero(node_mask)[0]:
        p = float(probs[slot])
        key = int(node_key[slot])
        if node_type[slot] == NODE_TYPE_FILE:
            path = ino_path.get(key)
            if path is not None:
                window_scores.setdefault(path, []).append(p)
        elif node_type[slot] == NODE_TYPE_PROCESS:
            name = f"{key}:{pid_comm.get(key, '?')}"
            proc_scores[name] = max(proc_scores.get(name, 0.0), p)


def finalize_detection(
    trace: Trace,
    window_scores: Dict[str, list],
    proc_scores: Dict[str, float],
    agg: str = "max",
    threshold: Optional[float] = None,
    detector: str = "model",
    ino_path: Optional[Dict[int, str]] = None,
) -> DetectionResult:
    """Accumulated window node scores → the final DetectionResult: byte
    accounting, the mutation gate, and window→file aggregation."""
    if ino_path is None:
        ino_path = _inode_to_path(trace)
    file_bytes: Dict[str, float] = {}
    ev = trace.events
    mutated: set = set()
    for i in range(len(ev)):
        if not ev.valid[i]:
            continue
        if ev.inode[i] != 0:
            path = ino_path[int(ev.inode[i])]
            file_bytes[path] = file_bytes.get(path, 0.0) + float(ev.bytes[i])
        if int(ev.syscall[i]) in MUTATING_SYSCALLS:
            # gate on the inode-canonical path first; raw event strings as
            # well, since a rename's OLD name is a distinct undo target
            if ev.inode[i] != 0:
                mutated.add(ino_path[int(ev.inode[i])])
            for pid_field in (ev.path_id[i], ev.new_path_id[i]):
                p = trace.strings.lookup(int(pid_field))
                if p:
                    mutated.add(p)
    # undo candidacy requires mutation: a file nothing ever wrote, renamed or
    # unlinked has no pre-attack state to restore
    file_scores = {p: aggregate_window_scores(ws, agg)
                   for p, ws in window_scores.items() if p in mutated}
    return DetectionResult(file_scores, proc_scores, file_bytes,
                           detector=detector,
                           file_window_scores=window_scores,
                           threshold=0.5 if threshold is None else threshold)


def make_eval_fn(model: NerrfNet) -> Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]:
    """The scorer: a padded numpy batch ([B, ...] per key) → the model's
    outputs as float32 numpy arrays, run under ``torch.inference_mode`` on
    the device the model's params lie on."""
    device = next(model.parameters()).device
    model.eval()

    def eval_fn(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        args = [torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
                for k in MODEL_INPUTS]
        with torch.inference_mode():
            out = model(*args)
            return {k: v.float().cpu().numpy() for k, v in out.items()}

    return eval_fn


# Boot-sweep bucket ladder (the reference's, kept identical).
# model_detect's auto-capacity fit buckets the graph and the sequence
# capacity independently, so the sweep covers the cross product.  Graph
# rungs: the corpus-fitted training bucket up to the deployed-density
# bucket a ~25k-event live window needs.
_GRAPH_WARMUP_RUNGS = ((1024, 2048), (2048, 4096), (4096, 8192))
_SEQ_WARMUP_RUNGS = (128, 256, 512)
DETECTOR_WARMUP_BUCKETS = tuple(
    (n, e, s) for n, e in _GRAPH_WARMUP_RUNGS for s in _SEQ_WARMUP_RUNGS)


def warmup_trace(name: str) -> Trace:
    """The shape-donor trace of every warmup and of the serve plane's init
    check (the reference's ``serve/service.py`` ``_tiny_trace``, and the
    trace its ``warmup_detector`` builds inline; one copy here): any tiny
    unlabeled trace yields a window sample, only the shapes matter."""
    from nerrf_tpu_torch.data.synth import SimConfig, simulate_trace

    tiny = simulate_trace(SimConfig(duration_sec=20.0, attack=False,
                                    num_target_files=2, benign_rate_hz=4.0,
                                    seed=1))
    return Trace(events=tiny.events, strings=tiny.strings,
                 ground_truth=None, labels=None, name=name)


def warmup_detector(model: NerrfNet, buckets=DETECTOR_WARMUP_BUCKETS,
                    batch_size: int = 8, log=None) -> Dict[str, float]:
    """Boot sweep of the detector forward over the capacity buckets: one
    eager forward of a shape-donor batch per bucket, on the device the
    model lies on, synchronised by fetching its result.  It builds the
    kernel libraries on the calling thread and sets up each shape's
    library state (cuBLAS handles, allocator blocks) before the first live
    window.  Returns {bucket_tag: seconds}."""
    import time as _time

    tiny = warmup_trace("warmup")
    eval_fn = make_eval_fn(model)
    times: Dict[str, float] = {}
    for max_nodes, max_edges, max_seqs in buckets:
        cfg = DatasetConfig(
            graph=GraphConfig(max_nodes=max_nodes, max_edges=max_edges),
            max_seqs=max_seqs)
        samples = windows_of_trace(tiny, cfg)
        if not samples:
            continue
        batch = {k: np.broadcast_to(v, (batch_size,) + v.shape).copy()
                 for k, v in samples[0].items()}
        tag = f"{max_nodes}n/{max_edges}e/{max_seqs}s"
        t0 = _time.perf_counter()
        eval_fn(batch)  # returns host arrays: the forward has finished
        times[tag] = round(_time.perf_counter() - t0, 1)
        if log:
            log(f"detector bucket {tag} warm ({times[tag]}s)")
    return times


def fit_capacity(trace: Trace, ds_cfg: DatasetConfig) -> DatasetConfig:
    """Size the graph and sequence capacities to the trace's densest window
    (power-of-two buckets, ``GraphConfig.fit_counts``/``bucket`` policy);
    ``ds_cfg`` unchanged when it already fits."""
    ev = trace.events
    valid_ts = ev.ts_ns[ev.valid]
    g = ds_cfg.graph
    need_n = need_e = need_f = 0
    for lo, hi in snapshot_windows(int(valid_ts.min()), int(valid_ts.max()), g):
        n, e = measure_window(ev, lo, hi)
        need_n, need_e = max(need_n, n), max(need_e, e)
        sel = ev.valid & (ev.ts_ns >= lo) & (ev.ts_ns < hi)
        files = len(np.unique(ev.inode[sel & (ev.inode > 0)]))
        need_f = max(need_f, files)
    if (need_n > g.max_nodes or need_e > g.max_edges
            or need_f > ds_cfg.max_seqs):
        # the sequence capacity scales with the file population too
        ds_cfg = dataclasses.replace(
            ds_cfg,
            graph=g.fit_counts(need_n, need_e),
            max_seqs=g.bucket(need_f, ds_cfg.max_seqs),
        )
    return ds_cfg


def model_detect(
    trace: Trace,
    model: NerrfNet,
    ds_cfg: Optional[DatasetConfig] = None,
    batch_size: int = 8,
    auto_capacity: bool = True,
    agg: str = "max",
    threshold: Optional[float] = None,
    device=None,
) -> DetectionResult:
    """Aggregate model node scores across windows onto host ids.

    ``model`` must lie on ``device`` (the card unless ``device='cpu'``).
    ``threshold`` sets the result's operating point (None keeps 0.5);
    ``agg`` picks the window→file aggregation; ``auto_capacity`` sizes the
    capacities to the trace's densest window (:func:`fit_capacity`)."""
    dev = resolve_device(device)
    param_dev = next(model.parameters()).device
    if param_dev.type != dev.type:
        raise ValueError(f"model_detect on {dev}: the model lies on "
                         f"{param_dev}; move it first")
    ds_cfg = ds_cfg or DatasetConfig()
    if auto_capacity and trace.events.num_valid:
        ds_cfg = fit_capacity(trace, ds_cfg)
    # detection must not peek at labels: strip them
    unlabelled = Trace(events=trace.events, strings=trace.strings,
                       ground_truth=None, labels=None, name=trace.name)
    with trace_span("bucket_pad") as sp:
        samples = windows_of_trace(unlabelled, ds_cfg)
        sp.args.update(windows=len(samples),
                       max_nodes=ds_cfg.graph.max_nodes,
                       max_edges=ds_cfg.graph.max_edges,
                       max_seqs=ds_cfg.max_seqs)
    ino_path = _inode_to_path(trace)
    pid_comm = _pid_to_comm(trace)
    eval_fn = make_eval_fn(model)

    window_scores: Dict[str, list] = {}
    proc_scores: Dict[str, float] = {}
    for i in range(0, len(samples), batch_size):
        chunk = samples[i: i + batch_size]
        with trace_span("detect_score", device=True, windows=len(chunk)):
            out = eval_fn(pad_batch(chunk, batch_size))
        probs = 1.0 / (1.0 + np.exp(-out["node_logit"]))
        for j, s in enumerate(chunk):
            accumulate_node_scores(probs[j], s["node_type"], s["node_key"],
                                   s["node_mask"], ino_path, pid_comm,
                                   window_scores, proc_scores)
    return finalize_detection(trace, window_scores, proc_scores, agg=agg,
                              threshold=threshold, detector=f"model[{agg}]",
                              ino_path=ino_path)
