"""Serve-traffic replay buffer: the experience half of the learn plane.

A host copy of ``nerrf_tpu/learn/replay.py``, kept identical.

Scored windows are teed off the serve demux seam — with enough of the
window's raw event payload to reconstruct the training example through
the exact `window_sample` path the trainer uses — into a crash-safe,
size-bounded on-disk buffer built on the archive spool's segment
machinery (same sealed-segment + ``.open``-tail contract, same torn-line
crash shape, same oldest-first retention pruning).

Design points (docs/learning.md):

- **Reservoir at admission.**  Acceptance is decided per BASE stream with
  Algorithm-R probability ``min(1, quota / n_seen)`` BEFORE the event
  payload is serialized, so one hot stream's acceptance rate decays
  logarithmically instead of drowning the quiet streams — and rejected
  windows cost one RNG draw, not a serialization.
- **Join at demux.**  The admit-time payload parks in a bounded pending
  map keyed by trace_id; the scored window joins it (scores, version,
  bucket) and the completed record crosses to a jax-free writer thread.
  A window the device failed is discarded — the buffer holds only
  windows the serve path actually scored.
- **Labels ride sideways.**  Serve traffic carries no ground truth, so
  replayed windows default to all-benign labels; operator dispositions
  (``nerrf alerts label <trace_id> tp|fp``) land in a sidecar jsonl the
  reader joins by trace_id, last-wins.
- **Deterministic reads.**  ``build_replay_dataset`` orders records by a
  content key (stream, window_idx, trace_id), applies one seeded
  permutation, and lowers each through ``window_sample`` — same seed,
  same buffer → bit-identical batch stream.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from nerrf_tpu_torch.archive.spool import ArchiveSpool, SpoolConfig, iter_records

REPLAY_KIND = "replay_window"
DISPOSITIONS_FILENAME = "dispositions.jsonl"


@dataclass(frozen=True)
class ReplayConfig:
    """Knobs for the serve-side replay writer (docs/learning.md)."""

    out_dir: str = "replay-buffer"
    # spool geometry: small segments so retention (and the crash window)
    # stays fine-grained relative to the default 64 MiB bound
    segment_max_bytes: int = 4 * 1024 * 1024
    segment_max_age_sec: float = 300.0
    max_total_bytes: int = 64 * 1024 * 1024
    fsync_on_seal: bool = False
    # Algorithm-R quota per BASE stream: expected acceptance is
    # quota * (1 + ln(n/quota)) for n >> quota — logarithmic, so a 100:1
    # hot stream lands ~5:1 in the buffer, not 100:1
    per_stream_quota: int = 64
    # bounded admit→scored pending map (windows in flight through the
    # device); overflow evicts oldest — a stuck window must not pin RAM
    pending_slots: int = 512
    # per-window event payload clamp (a pathological window cannot mint
    # a pathological record)
    max_events: int = 4096
    # bounded hand-off to the writer thread; overflow drops (counted)
    queue_slots: int = 1024
    # reservoir RNG seed (per-stream streams are derived from it)
    seed: int = 0

    def spool_config(self) -> SpoolConfig:
        return SpoolConfig(
            out_dir=self.out_dir,
            segment_max_bytes=self.segment_max_bytes,
            segment_max_age_sec=self.segment_max_age_sec,
            max_total_bytes=self.max_total_bytes,
            fsync_on_seal=self.fsync_on_seal)


def _stream_rng(seed: int, stream: str) -> np.random.Generator:
    """Deterministic per-stream reservoir RNG: same (seed, stream) →
    same acceptance sequence, independent across streams."""
    h = hashlib.blake2s(stream.encode("utf-8", "replace"),
                        digest_size=8).digest()
    return np.random.default_rng((seed, int.from_bytes(h, "big")))


class ReplayWriter:
    """Tees scored serve windows into the on-disk replay buffer.

    Attach with ``service.attach_learn(writer)``.  Both observer hooks
    are called from serve's hot paths and are fail-open there: this
    class keeps its own work O(accepted window) and pushes all IO to a
    dedicated thread.

    The writer thread is daemon + jax-free by design (exactly the
    archive writer's rationale): if the process dies mid-write, the
    abandoned ``.open`` tail with a possibly-torn last line IS the
    documented crash shape — the next writer (or any reader) adopts or
    tolerates it.
    """

    def __init__(self, cfg: Optional[ReplayConfig] = None, registry=None,
                 log=None) -> None:
        self.cfg = cfg or ReplayConfig()
        self._log = log or (lambda *a: None)
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        self._registry = registry
        self._spool = ArchiveSpool(self.cfg.spool_config(),
                                   registry=registry, log=log)
        self._lock = threading.Lock()
        # per-BASE-stream reservoir state + bounded pending join map,
        # all under one lock (pure dict ops — no IO under it)
        self._seen: Dict[str, int] = {}
        self._accepted: Dict[str, int] = {}
        self._rngs: Dict[str, np.random.Generator] = {}
        self._pending: "OrderedDict[str, dict]" = OrderedDict()
        self._pending_evicted = 0
        self._q: "queue.Queue[Optional[dict]]" = queue.Queue(
            maxsize=self.cfg.queue_slots)
        self._dropped_queue_full = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._drain_loop, name="nerrf-learn-replay", daemon=True)
        self._thread.start()

    # -- serve-side observers (fail-open at the call site) -------------------

    def observe_admit(self, trace_id: str, stream: str, window_idx: int,
                      lo_ns: int, hi_ns: int, events, strings) -> None:
        """Admission tee: reservoir-decide, then (only on accept)
        serialize the window's event slice synchronously — the windower
        buffer behind ``events`` is reused, so the payload must be
        captured before this call returns."""
        with self._lock:
            n = self._seen.get(stream, 0) + 1
            self._seen[stream] = n
            rng = self._rngs.get(stream)
            if rng is None:
                rng = _stream_rng(self.cfg.seed, stream)
                self._rngs[stream] = rng
            quota = max(1, self.cfg.per_stream_quota)
            accept = n <= quota or rng.random() < quota / n
            if not accept:
                return
            self._accepted[stream] = self._accepted.get(stream, 0) + 1
        sel = np.nonzero(events.valid & (events.ts_ns >= lo_ns)
                         & (events.ts_ns < hi_ns))[0]
        if len(sel) > self.cfg.max_events:
            sel = sel[:self.cfg.max_events]
        payload = [events.record(int(i), strings) for i in sel]
        with self._lock:
            self._pending[trace_id] = {
                "stream": stream, "window_idx": int(window_idx),
                "lo_ns": int(lo_ns), "hi_ns": int(hi_ns),
                "events": payload}
            while len(self._pending) > self.cfg.pending_slots:
                self._pending.popitem(last=False)
                self._pending_evicted += 1

    def observe_scored(self, scored) -> None:
        """Demux tee: join the scored window to its admit-time payload
        and hand the completed record to the writer thread."""
        with self._lock:
            base = self._pending.pop(scored.trace_id, None)
        if base is None:
            return  # reservoir-rejected at admit (or pending-evicted)
        mask = scored.node_mask.astype(bool)
        max_prob = float(scored.probs[mask].max()) if mask.any() else None
        rec = {
            "v": "1.0", "kind": REPLAY_KIND, "t_wall": time.time(),
            "stream": base["stream"], "session": scored.stream,
            "window_idx": base["window_idx"],
            "trace_id": scored.trace_id,
            "lo_ns": base["lo_ns"], "hi_ns": base["hi_ns"],
            "bucket": list(scored.bucket),
            "model_version": scored.model_version,
            "max_prob": max_prob,
            "nodes": int(scored.nodes), "edges": int(scored.edges),
            "files": int(scored.files),
            "events": base["events"],
        }
        try:
            self._q.put_nowait(rec)
        except queue.Full:
            with self._lock:
                self._dropped_queue_full += 1

    def discard(self, trace_id: str) -> None:
        """A window the device failed never becomes training data."""
        with self._lock:
            self._pending.pop(trace_id, None)

    # -- writer thread --------------------------------------------------------

    def _drain_loop(self) -> None:
        while True:
            try:
                rec = self._q.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if rec is None:
                return
            try:
                if self._spool.append(rec):
                    self._registry.counter_inc(
                        "learn_replay_windows_total",
                        labels={"stream": rec["stream"]},
                        help="scored windows accepted into the replay "
                             "buffer, by base stream")
                    self._registry.gauge_set(
                        "learn_replay_bytes", float(self._disk_bytes()),
                        help="replay buffer size on disk (post-retention)")
            except Exception as e:  # noqa: BLE001 — telemetry plane
                self._log(f"replay append failed: {type(e).__name__}: {e}")

    def _disk_bytes(self) -> int:
        total = 0
        try:
            root = Path(self.cfg.out_dir)
            for p in root.iterdir():
                if p.suffix == ".jsonl" or p.name.endswith(".jsonl.open"):
                    total += p.stat().st_size
        except OSError:
            pass
        return total

    # -- lifecycle / introspection -------------------------------------------

    def rotate(self) -> None:
        self._spool.rotate()

    def flush(self, timeout: float = 10.0) -> None:
        """Drain the queue (tests): blocks until the writer thread has
        consumed everything enqueued before the call."""
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)

    def stats(self) -> dict:
        with self._lock:
            return {
                "seen": dict(self._seen),
                "accepted": dict(self._accepted),
                "pending": len(self._pending),
                "pending_evicted": self._pending_evicted,
                "dropped_queue_full": self._dropped_queue_full,
                "disk_bytes": self._disk_bytes(),
            }

    def close(self, timeout: float = 30.0) -> None:
        """Flush + seal.  On a crash (no close) the ``.open`` tail stays
        behind — that abandoned tail is the kill -9 shape the spool's
        adoption contract (and tests/test_learn.py) covers."""
        self._stop.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            self._log("replay writer did not drain in time; leaving the "
                      ".open tail for the next writer to adopt")
            return
        self._spool.close()

    def __enter__(self) -> "ReplayWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- operator dispositions (sidecar) -----------------------------------------


def append_disposition(replay_dir, trace_id: str, label: str,
                       note: Optional[str] = None) -> dict:
    """Append one tp/fp disposition to the replay buffer's sidecar.

    O_APPEND single-line writes into a file the spool never touches, so
    an operator labeling alerts is safe against a LIVE writer.  Returns
    the record written."""
    if label not in ("tp", "fp"):
        raise ValueError(f"disposition label must be tp|fp, got {label!r}")
    rec = {"v": "1.0", "kind": "alert_disposition", "t_wall": time.time(),
           "trace_id": trace_id, "label": label}
    if note:
        rec["note"] = note
    root = Path(replay_dir)
    root.mkdir(parents=True, exist_ok=True)
    line = json.dumps(rec, separators=(",", ":")) + "\n"
    fd = os.open(root / DISPOSITIONS_FILENAME,
                 os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode("utf-8"))
    finally:
        os.close(fd)
    return rec


def load_dispositions(replay_dir) -> Dict[str, dict]:
    """trace_id → latest disposition record (last-wins; torn/garbage
    lines skipped — the sidecar shares the archive's crash tolerance)."""
    path = Path(replay_dir) / DISPOSITIONS_FILENAME
    out: Dict[str, dict] = {}
    if not path.exists():
        return out
    for line in path.read_text(errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        tid = rec.get("trace_id")
        if tid and rec.get("label") in ("tp", "fp"):
            out[tid] = rec
    return out


# -- readers ------------------------------------------------------------------


def iter_replay(replay_dir) -> Iterator[dict]:
    """Yield raw replay_window records, segment order (oldest first)."""
    yield from iter_records(replay_dir, kinds={REPLAY_KIND})


def replay_fingerprint(replay_dir) -> str:
    """Stable content digest of the buffer: blake2s over the sorted
    trace_id inventory — the provenance stamp a retrained checkpoint
    carries, so 'what data produced v2' is answerable offline."""
    ids = sorted(r.get("trace_id", "") for r in iter_replay(replay_dir))
    h = hashlib.blake2s(digest_size=8)
    h.update(str(len(ids)).encode())
    for tid in ids:
        h.update(b"\x00")
        h.update(tid.encode("utf-8", "replace"))
    return h.hexdigest()


def replay_stats(replay_dir) -> dict:
    """Offline inventory: window/byte counts per stream + dispositions."""
    per_stream: Dict[str, int] = {}
    windows = 0
    for rec in iter_replay(replay_dir):
        windows += 1
        s = rec.get("stream", "?")
        per_stream[s] = per_stream.get(s, 0) + 1
    root = Path(replay_dir)
    disk = 0
    if root.is_dir():
        for p in root.iterdir():
            if p.is_file():
                disk += p.stat().st_size
    return {"windows": windows, "per_stream": per_stream,
            "disk_bytes": disk,
            "dispositions": len(load_dispositions(replay_dir)),
            "fingerprint": replay_fingerprint(replay_dir)}


def _labels_for(rec: dict, dispo: Dict[str, dict],
                n_events: int) -> Optional[np.ndarray]:
    """Training labels for one replayed window.  Serve traffic has no
    ground truth: default all-benign (zeros); an operator tp marks every
    event in the window attack-positive (window-granularity labels — the
    alert fired on the window, that is the evidence we have); fp is an
    explicit confirmation of the benign default."""
    d = dispo.get(rec.get("trace_id"))
    if d is not None and d.get("label") == "tp":
        return np.ones(n_events, dtype=np.float32)
    return np.zeros(n_events, dtype=np.float32)


def build_replay_dataset(replay_dir, ds_cfg, seed: int = 0,
                         limit: Optional[int] = None,
                         log=None) -> Tuple[Optional[object], dict]:
    """Lower the replay buffer into a ``WindowDataset`` ready for
    ``train_elastic`` — deterministic and seedable.

    Records are sorted by a content key (stream, window_idx, trace_id) —
    NOT file order, so a pruned/merged buffer with identical content
    yields the identical dataset — then shuffled by one seeded
    permutation and clipped to ``limit``.  Each record rebuilds its
    ``EventArrays`` from the serialized payload and lowers through the
    same ``window_sample`` path serve admission used, with disposition
    labels joined by trace_id.

    Returns ``(dataset | None, info)``; None when nothing lowered."""
    from nerrf_tpu_torch.data.loaders import Trace
    from nerrf_tpu_torch.schema.events import EventArrays, StringTable
    from nerrf_tpu_torch.train.data import WindowDataset, window_sample

    log = log or (lambda *a: None)
    recs = list(iter_replay(replay_dir))
    recs.sort(key=lambda r: (str(r.get("stream", "")),
                             int(r.get("window_idx", 0)),
                             str(r.get("trace_id", ""))))
    order = np.random.default_rng(seed).permutation(len(recs))
    if limit is not None:
        order = order[:limit]
    dispo = load_dispositions(replay_dir)
    samples: List[dict] = []
    skipped = 0
    labeled_tp = 0
    per_stream: Dict[str, int] = {}
    for i in order:
        rec = recs[int(i)]
        strings = StringTable()
        events = EventArrays.from_records(rec.get("events", []), strings)
        labels = _labels_for(rec, dispo, len(events.ts_ns))
        if labels is not None and labels.any():
            labeled_tp += 1
        trace = Trace(events=events, strings=strings, ground_truth=None,
                      labels=None, name=rec.get("stream", "replay"))
        sample, _stats = window_sample(
            trace, int(rec["lo_ns"]), int(rec["hi_ns"]), ds_cfg,
            labels=labels)
        if sample is None:
            skipped += 1
            continue
        samples.append(sample)
        s = rec.get("stream", "?")
        per_stream[s] = per_stream.get(s, 0) + 1
    info = {"windows": len(samples), "skipped": skipped,
            "records": len(recs), "labeled_tp": labeled_tp,
            "per_stream": per_stream, "seed": seed,
            "fingerprint": replay_fingerprint(replay_dir)}
    if not samples:
        return None, info
    ds = WindowDataset({k: np.stack([s[k] for s in samples])
                        for k in samples[0].keys()})
    log(f"replay dataset: {len(samples)} windows ({skipped} skipped, "
        f"{labeled_tp} tp-labeled) from {replay_dir}")
    return ds, info


def replay_batches(ds, batch_size: int, seed: int = 0) -> Iterator[dict]:
    """Deterministic seeded batch stream over a replay dataset (the
    `export --replay` reader contract): one seeded permutation, fixed
    batch slicing — same (buffer, seed) → bit-identical batches."""
    n = len(ds)
    order = np.random.default_rng(seed).permutation(n)
    for at in range(0, n, batch_size):
        idx = order[at:at + batch_size]
        yield {k: v[idx] for k, v in ds.arrays.items()}
