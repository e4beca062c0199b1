"""RetrainSupervisor: quality_drift → retrain → publish, hands-free.

The port of ``nerrf_tpu/learn/supervisor.py``.  The control half of the
learn plane: subscribes to the flight journal and arms on the drift plane's
sustained breach, the ``bundle`` record the flight recorder emits with
``trigger: "quality_drift"`` (the evidence-gated trigger, not a raw PSI
sample).  Launch discipline, a copy of the reference's:

- **debounce**: ``debounce_triggers`` distinct trigger records inside
  ``debounce_window_sec`` (the flight recorder already rate-limits, so the
  default arms on the first bundle);
- **cooldown**: at most one launch every ``cooldown_sec``;
- **single-flight**: a breach during an active retrain never double-launches
  (the latch clears only when the run finishes).

A launch journals ``retrain_triggered`` and runs the port's elastic trainer
(`train/elastic.py`) over a mix of the replay buffer and a fresh synth
corpus, on ``device`` (the card unless the caller passes ``device='cpu'``)
and, on the card, on a CUDA stream of its own, so that its launches do not
queue behind the serve scorer's.  A `TrainHealthMonitor` watches it: a
divergence halt aborts the run and journals ``retrain_aborted``, and
non-finite weights are never published.  On success the candidate is saved
(``params.pt``) with the retrain provenance (trigger record seq, replay
fingerprint, parent version) in the checkpoint sidecar and published into
the registry lineage; the existing shadow scoring, guardrails and canary
promotion then decide whether it goes live.  The supervisor ends at
publish; it holds no promotion authority.

Refused at construction: ``aot_export=True`` (the candidate's AOT sidecar
needs the compile cache, ROADMAP A.7) and a ``compile_cache`` (as
``train_elastic`` refuses one, ROADMAP B.D1).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

TRIGGER_KIND = "bundle"
TRIGGER_NAME = "quality_drift"


@dataclass(frozen=True)
class RetrainConfig:
    """Launch discipline + trainer shape for the retrain supervisor (the
    reference's fields and defaults)."""

    lineage: str = "default"
    replay_dir: str = "replay-buffer"
    out_dir: str = "retrain"
    # launch discipline
    debounce_triggers: int = 1
    debounce_window_sec: float = 900.0
    cooldown_sec: float = 3600.0
    # trainer shape (fresh-init elastic run; resumable within out_dir)
    num_steps: int = 200
    batch_size: int = 8
    learning_rate: float = 2e-3
    seed: int = 0
    save_every: int = 25
    # replay/synth mix: the replay buffer supplies the CURRENT traffic
    # distribution (benign unless an operator labeled tp), the synth
    # corpus supplies attack-labeled signal so the decision boundary
    # does not collapse to all-benign
    replay_limit: Optional[int] = 512
    replay_seed: int = 0
    synth_traces: int = 2
    synth_seed: int = 4200
    synth_duration_sec: float = 120.0
    synth_drift: float = 0.0
    synth_num_target_files: int = 8
    synth_benign_rate_hz: float = 8.0
    # the candidate's AOT sidecar export: refused (ROADMAP A.7)
    aot_export: bool = False
    join_timeout_sec: float = 600.0


class RetrainSupervisor:
    """Journal-subscribed daemon closing drift detection into retraining.

    ``retrain_fn`` is injectable (tests): it receives the trigger seq and
    must return an outcome string (``"published"``/``"aborted"``/...); the
    default is the real elastic retrain on ``device``.  The worker thread is
    non-daemon (it runs the device) and ``close()`` joins it bounded, the
    serve scorer's teardown discipline."""

    def __init__(self, store, model_cfg, cfg: Optional[RetrainConfig] = None,
                 ds_cfg=None, registry=None, journal=None, log=None,
                 compile_cache=None, monitor_cfg=None,
                 retrain_fn=None, device=None) -> None:
        from nerrf_tpu_torch.device import resolve_device

        self.cfg = cfg or RetrainConfig()
        if self.cfg.aot_export:
            raise NotImplementedError(
                "RetrainConfig(aot_export=True): the candidate's AOT sidecar "
                "needs the compile cache, which is not ported yet (ROADMAP A.7)")
        if compile_cache is not None:
            raise NotImplementedError(
                "RetrainSupervisor(compile_cache=...): the compile cache is not "
                "ported; it becomes a capture cache of CUDA graphs (ROADMAP B.D1)")
        self.device = resolve_device(device)
        self._store = store
        self._model_cfg = model_cfg
        self._ds_cfg = ds_cfg
        self._log = log or (lambda *a: None)
        if registry is None:
            from nerrf_tpu_torch.observability import DEFAULT_REGISTRY

            registry = DEFAULT_REGISTRY
        self._registry = registry
        if journal is None:
            from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

            journal = DEFAULT_JOURNAL
        self._journal = journal
        self._monitor_cfg = monitor_cfg
        self._retrain_fn = retrain_fn
        self._lock = threading.Lock()
        self._triggers: deque = deque()  # (monotonic, seq) inside window
        self._active = False
        self._last_launch: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.launches = 0
        self.last_outcome: Optional[str] = None
        self.last_version: Optional[int] = None
        self._registry.gauge_set(
            "retrain_active", 0.0,
            help="1 while a drift-triggered retrain is running")
        journal.subscribe(self._on_record)

    # -- trigger path ---------------------------------------------------------

    def _on_record(self, rec) -> None:
        """Journal listener (runs on the EMITTER's thread — decide fast,
        never block): arm only on the flight recorder's quality_drift
        bundle record."""
        if rec.kind != TRIGGER_KIND:
            return
        if (rec.data or {}).get("trigger") != TRIGGER_NAME:
            return
        now = time.monotonic()
        launch_seq = None
        with self._lock:
            if self._closed:
                return
            self._triggers.append((now, rec.seq))
            horizon = now - self.cfg.debounce_window_sec
            while self._triggers and self._triggers[0][0] < horizon:
                self._triggers.popleft()
            if len(self._triggers) < self.cfg.debounce_triggers:
                return  # debounce: not yet sustained
            if self._active:
                return  # single-flight: a retrain is already running
            if (self._last_launch is not None
                    and now - self._last_launch < self.cfg.cooldown_sec):
                return  # cooldown
            self._active = True
            self._last_launch = now
            launch_seq = rec.seq
            self._triggers.clear()
            self.launches += 1
        self._thread = threading.Thread(
            target=self._run, args=(launch_seq,),
            name="nerrf-learn-retrain", daemon=False)
        self._thread.start()

    # -- worker ---------------------------------------------------------------

    def _run(self, trigger_seq: int) -> None:
        outcome = "error"
        self._registry.gauge_set(
            "retrain_active", 1.0,
            help="1 while a drift-triggered retrain is running")
        try:
            fn = self._retrain_fn or self._retrain
            outcome = fn(trigger_seq)
        except Exception as e:  # noqa: BLE001 — supervisor must survive
            self._log(f"retrain failed: {type(e).__name__}: {e}")
            self._journal.record(
                "retrain_aborted", trigger_seq=trigger_seq,
                reason=f"{type(e).__name__}: {e}")
            outcome = "error"
        finally:
            self._registry.counter_inc(
                "retrain_runs_total", labels={"outcome": outcome},
                help="drift-triggered retrain runs, by outcome")
            self._registry.gauge_set(
                "retrain_active", 0.0,
                help="1 while a drift-triggered retrain is running")
            with self._lock:
                self._active = False
                self._last_launch = time.monotonic()
                self.last_outcome = outcome

    def _worker_stream(self):
        """The retrain's own CUDA stream (a no-op context on the CPU): the
        worker's launches then overlap the serve scorer's instead of
        queueing behind them on the default stream."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        import torch

        return torch.cuda.stream(torch.cuda.Stream(device=self.device))

    def _retrain(self, trigger_seq: int) -> str:
        """The real retrain: replay+synth mix → elastic trainer under
        trainwatch → provenance-stamped publish.  Returns the outcome."""
        with self._worker_stream():
            return self._retrain_on_stream(trigger_seq)

    def _retrain_on_stream(self, trigger_seq: int) -> str:
        from nerrf_tpu_torch.data.synth import SimConfig, simulate_trace
        from nerrf_tpu_torch.flight.journal import fingerprint
        from nerrf_tpu_torch.learn.replay import (
            build_replay_dataset,
            replay_fingerprint,
        )
        from nerrf_tpu_torch.train.checkpoint import save_checkpoint
        from nerrf_tpu_torch.train.data import (
            DatasetConfig,
            WindowDataset,
            build_dataset,
        )
        from nerrf_tpu_torch.train.elastic import train_elastic
        from nerrf_tpu_torch.train.loop import TrainConfig
        from nerrf_tpu_torch.trainwatch.monitor import TrainHealthMonitor

        cfg = self.cfg
        t0 = time.perf_counter()
        parent = self._store.live_version(cfg.lineage)
        replay_fp = None
        try:
            replay_fp = replay_fingerprint(cfg.replay_dir)
        except OSError:
            pass
        self._journal.record(
            "retrain_triggered", trigger_seq=trigger_seq,
            lineage=cfg.lineage, parent_version=parent,
            replay_fingerprint=replay_fp)
        self._log(f"retrain: launching (trigger seq {trigger_seq}, "
                  f"parent v{parent}, replay {replay_fp})")

        ds_cfg = self._ds_cfg or DatasetConfig()
        parts = []
        replay_info = {"windows": 0}
        try:
            replay_ds, replay_info = build_replay_dataset(
                cfg.replay_dir, ds_cfg, seed=cfg.replay_seed,
                limit=cfg.replay_limit, log=self._log)
            if replay_ds is not None:
                parts.append(replay_ds)
        except OSError as e:
            # the data's semantics, not a device fallback: an unreadable
            # buffer leaves the synth corpus as the whole training set
            self._log(f"retrain: replay buffer unreadable ({e}); "
                      "falling back to synth-only")
        synth_traces = [
            simulate_trace(SimConfig(
                duration_sec=cfg.synth_duration_sec,
                attack=(i % 2 == 0),
                attack_start_sec=cfg.synth_duration_sec / 3,
                num_target_files=cfg.synth_num_target_files,
                benign_rate_hz=cfg.synth_benign_rate_hz,
                seed=cfg.synth_seed + i, drift=cfg.synth_drift))
            for i in range(cfg.synth_traces)]
        if synth_traces:
            parts.append(build_dataset(synth_traces, ds_cfg))
        parts = [p for p in parts if len(p)]
        if not parts:
            self._journal.record(
                "retrain_aborted", trigger_seq=trigger_seq,
                reason="no training data (empty replay buffer, no synth)")
            return "aborted"
        train_ds = (parts[0] if len(parts) == 1
                    else WindowDataset.concatenate(parts))

        tc = TrainConfig(model=self._model_cfg, batch_size=cfg.batch_size,
                         num_steps=cfg.num_steps,
                         learning_rate=cfg.learning_rate, seed=cfg.seed)
        monitor = TrainHealthMonitor(self._monitor_cfg,
                                     registry=self._registry,
                                     journal=self._journal, log=self._log)
        monitor.set_run(trigger_seq=trigger_seq, steps=cfg.num_steps,
                        seed=cfg.seed, config_fingerprint=fingerprint(tc))
        ckpt_dir = Path(cfg.out_dir) / f"run-{trigger_seq}"
        result = train_elastic(
            train_ds, cfg=tc, ckpt_dir=ckpt_dir,
            save_every=cfg.save_every, log=self._log, monitor=monitor,
            device=self.device)
        if monitor.diverged is not None or not result.metrics:
            step, why = monitor.diverged or (None, "no eval metrics")
            self._journal.record(
                "retrain_aborted", trigger_seq=trigger_seq,
                reason=why, step=step, parent_version=parent)
            self._log(f"retrain: ABORTED — {why} (nothing published)")
            return "aborted"

        provenance = {
            "trigger": TRIGGER_NAME,
            "trigger_seq": int(trigger_seq),
            "parent_version": parent,
            "replay_fingerprint": replay_fp,
            "replay_windows": int(replay_info.get("windows", 0)),
            "synth_windows": int(sum(len(p) for p in parts[1:])
                                 if len(parts) > 1 else 0),
            "steps": int(cfg.num_steps),
            "seed": int(cfg.seed),
        }
        out = ckpt_dir / "model"
        save_checkpoint(out, result.state.model.state_dict(), self._model_cfg,
                        provenance=provenance)
        version = self._store.publish(
            cfg.lineage, out,
            source=f"learn.retrain trigger_seq={trigger_seq}")
        wall = time.perf_counter() - t0
        self._journal.record(
            "retrain_done", trigger_seq=trigger_seq,
            lineage=cfg.lineage, version=version, parent_version=parent,
            replay_fingerprint=replay_fp,
            edge_auc=result.metrics.get("edge_auc"),
            wall_sec=round(wall, 2),
            steps_per_sec=round(result.steps_per_sec, 3))
        with self._lock:
            self.last_version = version
        self._log(f"retrain: published v{version} (parent v{parent}, "
                  f"{wall:.1f}s) — shadow/canary decide promotion")
        return "published"

    # -- introspection / lifecycle -------------------------------------------

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active

    def wait(self, timeout: float = 600.0) -> bool:
        """Block until the in-flight retrain (if any) finishes."""
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            return not t.is_alive()
        return True

    def close(self, timeout: Optional[float] = None) -> None:
        """Unsubscribe and join the worker (bounded: the thread runs the
        device, so teardown waits it out rather than abandon it)."""
        self._journal.unsubscribe(self._on_record)
        with self._lock:
            self._closed = True
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=(timeout if timeout is not None
                            else self.cfg.join_timeout_sec))
            if t.is_alive():
                self._log("retrain worker still running at close "
                          "(joined out the timeout)")

    def __enter__(self) -> "RetrainSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
