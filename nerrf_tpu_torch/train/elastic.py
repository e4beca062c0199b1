"""Elastic training: periodic full-state checkpoints, resume, fault injection.

The port of ``nerrf_tpu/train/elastic.py``.  Training resumes after a
preemption with bit-identical results: an interrupted-and-resumed run ends
with the same parameters as an uninterrupted one.

Design for determinism under restart:
  * per-step randomness is *derived*, never threaded: batch order comes from
    ``np.random.default_rng((seed, step))`` and each step's dropout from a
    generator seeded by a fixed function of ``(seed, step)``
    (``loop._step_seed``, the counterpart of ``jax.random.fold_in``), so step
    N's randomness is the same however many restarts came before it;
  * a checkpoint holds the full state: ``torch.save`` of the model's and the
    optimizer's state dicts (AdamW's moments and its per-parameter step) and
    the step, which drives the learning-rate schedule, in ``step_%08d/``;
    its ``meta.json`` is written last, through a ``.tmp`` rename, and is the
    scanner's commit marker;
  * a heartbeat file updated every few seconds of training (HEARTBEAT_SEC)
    and at every save supports external failure detection
    (`stale_heartbeat`); supervisors should use a timeout well above
    HEARTBEAT_SEC, not the checkpoint interval.

Fault injection for tests and drills: pass ``fault=fault_at(step)`` and the
loop raises `Preemption` once, after that step's optimizer update and
before its checkpoint, the worst-case window.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerrf_tpu_torch.device import resolve_device
from nerrf_tpu_torch.tracing import span
from nerrf_tpu_torch.train.data import WindowDataset
from nerrf_tpu_torch.train.loop import (
    TrainConfig,
    TrainResult,
    _fits_resident,
    _history,
    _history_entry,
    _loss_components,
    _set_run,
    _step_seed,
    _sync,
    _telemetry_floats,
    batch_to_device,
    evaluate,
    init_state,
    make_train_step,
    make_train_step_resident,
)
from nerrf_tpu_torch.pipeline import make_eval_fn

STATE_FILENAME = "state.pt"


class Preemption(Exception):
    """Simulated preemption (fault injection for recovery drills)."""

    def __init__(self, step: int) -> None:
        super().__init__(f"simulated preemption at step {step}")
        self.step = step


@dataclasses.dataclass
class _FaultAt:
    fail_at: int
    fired: bool = False

    def __call__(self, step: int) -> None:
        if not self.fired and step == self.fail_at:
            self.fired = True
            raise Preemption(step)


def fault_at(step: int) -> _FaultAt:
    """A fault injector that preempts once at `step`."""
    return _FaultAt(step)


# --------------------------------------------------------------------------
# checkpoint dir layout: <dir>/step_<n>/{state.pt, meta.json}; meta last.
# --------------------------------------------------------------------------

def _save_full(ckpt_dir: Path, step: int, state) -> None:
    out = ckpt_dir / f"step_{step:08d}"
    with span("checkpoint", step=step):
        out.mkdir(parents=True, exist_ok=True)
        torch.save({"model": {k: v.detach().cpu()
                              for k, v in state.model.state_dict().items()},
                    "optimizer": state.optimizer.state_dict(),
                    "step": step}, out / STATE_FILENAME)
        # meta.json IS the commit marker (latest_step treats its presence as
        # "this checkpoint is complete"), so it must appear atomically
        tmp = out / "meta.json.tmp"
        tmp.write_text(json.dumps({"step": step}) + "\n")
        tmp.replace(out / "meta.json")
    _heartbeat(ckpt_dir, step)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """Highest committed checkpoint step, or None."""
    best = None
    for p in Path(ckpt_dir).glob("step_*"):
        if (p / "meta.json").exists():
            step = json.loads((p / "meta.json").read_text())["step"]
            best = step if best is None else max(best, step)
    return best


def _restore_full(ckpt_dir: Path, step: int, template_state):
    """``template_state`` with the model's params, the optimizer's state
    and the step of checkpoint ``step`` loaded into it.  Read onto the CPU:
    ``load_state_dict`` moves the params and the moments to the params'
    device and leaves AdamW's step counts on the host, as a fresh run has
    them."""
    got = torch.load(ckpt_dir / f"step_{step:08d}" / STATE_FILENAME,
                     map_location="cpu", weights_only=True)
    template_state.model.load_state_dict(got["model"], strict=True)
    template_state.optimizer.load_state_dict(got["optimizer"])
    template_state.step = int(got["step"])
    return template_state


HEARTBEAT_SEC = 5.0  # wall-clock heartbeat cadence during training


def _heartbeat(ckpt_dir: Path, step: int) -> None:
    tmp = ckpt_dir / ".heartbeat.tmp"
    tmp.write_text(json.dumps({"step": step, "ts": time.time()}) + "\n")
    tmp.rename(ckpt_dir / "heartbeat.json")


def stale_heartbeat(ckpt_dir: str | Path, timeout_sec: float) -> bool:
    """Failure detection: True if no heartbeat within `timeout_sec` (or none
    at all), the signal an external supervisor uses to reschedule."""
    p = Path(ckpt_dir) / "heartbeat.json"
    if not p.exists():
        return True
    hb = json.loads(p.read_text())
    return (time.time() - hb["ts"]) > timeout_sec


# --------------------------------------------------------------------------

def train_elastic(
    train_ds: WindowDataset,
    eval_ds: Optional[WindowDataset] = None,
    cfg: Optional[TrainConfig] = None,
    ckpt_dir: str | Path = "checkpoints",
    save_every: int = 50,
    fault=None,
    log=None,
    compile_cache=None,
    monitor=None,
    full_history: bool = False,
    device=None,
) -> TrainResult:
    """Run (or resume) training to ``cfg.num_steps`` with periodic full-state
    checkpoints on ``device`` (the card unless ``device='cpu'``).
    Restartable at any point; deterministic across restarts.

    The dataset lives on the card when it fits (:func:`_fits_resident`;
    ``make_train_step_resident``), else each step's batch is copied from the
    host.  ``monitor`` (a ``trainwatch.TrainHealthMonitor``) observes the
    loss and telemetry at every checkpoint boundary, and a latched divergence
    halts the run before the diverged state overwrites the last good
    checkpoint.  ``compile_cache`` is refused: it becomes a capture cache of
    CUDA graphs (ROADMAP B.D1)."""
    if compile_cache is not None:
        raise NotImplementedError(
            "train_elastic(compile_cache=...): the compile cache is not "
            "ported; it becomes a capture cache of CUDA graphs (ROADMAP B.D1)")
    cfg = cfg or TrainConfig()
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    with span("train_setup", device=True):
        state = init_state(cfg, dev)
        start = latest_step(ckpt_dir)
        if start is not None:
            state = _restore_full(ckpt_dir, start, state)
            if log:
                log(f"resumed from step {start}")
        else:
            start = 0
        resident = _fits_resident(train_ds.arrays)
        train_step = (make_train_step_resident(state.model, cfg, train_ds.arrays)
                      if resident else make_train_step(state.model, cfg))
    if monitor is not None:
        _set_run(monitor, cfg)
        if start > 0:
            monitor.note_checkpoint(ckpt_dir / f"step_{start:08d}", start)

    n = len(train_ds)
    history = _history(full_history)
    dropout_gen = torch.Generator(device=dev)
    t_start = None
    halted = None
    # heartbeat on a wall-clock cadence, apart from the checkpoint interval:
    # keyed to saves only, a supervisor with a timeout below save_every ×
    # step time would restart healthy runs
    last_hb = 0.0
    completed = start
    with span("train_loop", steps=cfg.num_steps, resident=resident, elastic=True):
        for step in range(start, cfg.num_steps):
            # derived randomness: the same for step N on every (re)run
            order = np.random.default_rng((cfg.seed, step))
            idx = order.choice(n, size=min(cfg.batch_size, n), replace=False)
            dropout_gen.manual_seed(_step_seed(cfg.seed, step))
            if resident:
                state, loss, aux = train_step(state, idx, dropout_gen)
            else:
                batch = batch_to_device(train_ds.arrays, idx, dev)
                state, loss, aux = train_step(state, batch, dropout_gen)
            if t_start is None:
                _sync(dev)  # the first step pays the set-up: not timed
                t_start = time.perf_counter()
            if fault is not None:
                fault(step)
            now = time.monotonic()
            if now - last_hb >= HEARTBEAT_SEC:
                _heartbeat(ckpt_dir, step)
                last_hb = now
            done = completed = step + 1
            if done % save_every == 0 or done == cfg.num_steps:
                entry = _history_entry(step, loss, aux)
                if monitor is not None:
                    # observe BEFORE saving: a divergence latched here halts
                    # the loop with the previous checkpoint the newest good one
                    monitor.observe_step(step, entry["loss"],
                                         telemetry=_telemetry_floats(aux),
                                         components=_loss_components(aux))
                    if monitor.should_halt:
                        halted = monitor.diverged
                        if log:
                            log(f"trainwatch: halting at step {step} — "
                                f"{halted[1]} (last good checkpoint kept)")
                        break
                _save_full(ckpt_dir, done, state)
                if monitor is not None:
                    monitor.note_checkpoint(ckpt_dir / f"step_{done:08d}", done)
                history.append(entry)
                if log:
                    log(f"step {step}: loss={entry['loss']:.4f} (checkpointed)")
        _sync(dev)
    if monitor is not None:
        monitor.finish()  # the evaluation must not read as a stall
    elapsed = time.perf_counter() - (t_start or time.perf_counter())
    # the steps this call ran (a halt ends early: the configured count would
    # overstate the rate)
    steps = completed - start
    steps_per_sec = max(steps - 1, 1) / elapsed if elapsed > 0 else 0.0
    metrics = ({} if halted is not None else evaluate(
        make_eval_fn(state.model),
        eval_ds if eval_ds is not None else train_ds, cfg.batch_size))
    return TrainResult(state=state, metrics=metrics,
                       steps_per_sec=steps_per_sec, history=list(history))
