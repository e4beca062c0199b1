"""The undo-planning decision domain.

(Copied from ``nerrf_tpu/planner/domain.py`` so the port needs nothing of
the JAX package; keep the two identical: the parity tests compare their
arrays, and the search kernel takes its constants from here.)

Realizes the reference's specified MCTS planner I/O
(`docs/content/docs/architecture.mdx:62-72`: input = graph +
anomaly scores + predictions; output = ranked undo plan of file reversions and
process kills; reward = restoration gain − side effects) with the README's
reward variant `−(data_loss + 0.1×downtime)` (`README.md:115`) and the
candidate-scoring shape of the worked example (`threat-model.mdx:205-223`:
revert-file cost 1, kill-process cost 10, restore-backup cost 100).

The domain is **vectorized**: a state is a fixed-width float vector and a
transition applies to a whole batch of states at once, so MCTS rollouts and
leaf evaluations run as single XLA programs on TPU — this is where the
"batched value-net rollouts" capability lives.

Action space (fixed width A = MAX_FILES + MAX_PROCS + 1):
  * revert file i  — recovers the file's data if it really was attacked
    (probability = detector score), costs per-file downtime; reverting a
    clean file is a false-positive undo with a side-effect cost.
  * kill process p — stops that process's future encryption (halts ongoing
    loss accrual) at a service-disruption cost.
  * stop           — end the episode.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np


class ActionKind(enum.IntEnum):
    REVERT_FILE = 0
    KILL_PROCESS = 1
    STOP = 2


@dataclasses.dataclass(frozen=True)
class UndoAction:
    kind: ActionKind
    target: str            # file path or process "pid:comm"
    score: float           # detector confidence the target is compromised
    loss_mb: float = 0.0   # data at stake (files)
    op_seconds: float = 1.0


@dataclasses.dataclass
class UndoPlan:
    """Ranked plan (the planner's output; the rollback executor's input)."""

    actions: List[UndoAction]
    expected_reward: float
    rollouts: int
    rollouts_per_sec: float
    planning_seconds: float

    def to_dict(self) -> Dict:
        return {
            "expected_reward": self.expected_reward,
            "rollouts": self.rollouts,
            "rollouts_per_sec": self.rollouts_per_sec,
            "planning_seconds": self.planning_seconds,
            "actions": [
                {
                    "kind": a.kind.name.lower(),
                    "target": a.target,
                    "score": a.score,
                    "loss_mb": a.loss_mb,
                }
                for a in self.actions
            ],
        }


# Cost model constants, following the worked example's relative costs
# (threat-model.mdx:205-223) on the README reward scale.
# Reverting a clean file loses whatever legitimate changes happened since the
# snapshot — proportional to the file itself, plus a fixed disruption floor.
FP_REVERT_SCALE = 2.0
FP_REVERT_FLOOR_MB = 0.05
KILL_DOWNTIME_SEC = 30.0      # service disruption of killing a process
REVERT_SECONDS_PER_MB = 0.05  # reverse-diff apply rate
ONGOING_LOSS_MB_PER_SEC = 2.0  # active encryptor destroys ~2 MB/s (M1 rate)
DOWNTIME_WEIGHT = 0.1          # README.md:115: −(data_loss + 0.1×downtime)


class UndoDomain:
    """Fixed-width vectorized undo MDP built from detector output."""

    def __init__(
        self,
        file_paths: List[str],
        file_scores: np.ndarray,   # [F] detector P(file compromised)
        file_loss_mb: np.ndarray,  # [F] data at stake per file
        proc_names: List[str],
        proc_scores: np.ndarray,   # [P] detector P(process malicious)
        max_steps: int = 64,
    ) -> None:
        self.file_paths = list(file_paths)
        self.file_scores = np.asarray(file_scores, np.float32)
        self.file_loss_mb = np.asarray(file_loss_mb, np.float32)
        self.proc_names = list(proc_names)
        self.proc_scores = np.asarray(proc_scores, np.float32)
        self.F = len(file_paths)
        self.P = len(proc_names)
        self.A = self.F + self.P + 1
        self.max_steps = max_steps

    # --- state encoding ------------------------------------------------------
    # state vector: [done_f (F), killed_p (P), downtime_sec, steps, stopped]
    @property
    def state_dim(self) -> int:
        return self.F + self.P + 3

    def initial_state(self) -> np.ndarray:
        return np.zeros(self.state_dim, np.float32)

    def split(self, s: np.ndarray):
        F, P = self.F, self.P
        return s[..., :F], s[..., F : F + P], s[..., F + P], s[..., F + P + 1], s[..., F + P + 2]

    def legal_actions(self, s: np.ndarray) -> np.ndarray:
        """bool [.., A]; once stopped nothing is legal."""
        done_f, killed_p, _, steps, stopped = self.split(s)
        legal = np.concatenate(
            [done_f < 0.5, killed_p < 0.5, np.ones(s.shape[:-1] + (1,), bool)], axis=-1
        )
        legal &= (stopped < 0.5)[..., None]
        legal &= (steps < self.max_steps)[..., None]
        return legal

    def step_batch(self, s: np.ndarray, a: np.ndarray):
        """Apply action a[B] to states s[B, D] → (s', incremental reward[B]).

        Expected incremental reward (in −MB units, the README reward scale):
          revert file i: +score_i·loss_i (restoration) − (1−score_i)·FP_COST
                         − 0.1·revert_time
          kill proc p:   +score_p·(expected future loss averted) − 0.1·30 s
          stop:          −(remaining expected loss while encryptors run)
        """
        s = s.copy()
        B = s.shape[0]
        F, P = self.F, self.P
        reward = np.zeros(B, np.float32)
        done_f = s[:, :F]
        killed_p = s[:, F : F + P]

        # any live malicious process keeps destroying data: expected MB/s now
        live_threat = (self.proc_scores[None, :] * (killed_p < 0.5)).sum(-1)

        is_file = a < F
        if is_file.any():
            i = a[is_file]
            sc = self.file_scores[i]
            loss = self.file_loss_mb[i]
            t_op = REVERT_SECONDS_PER_MB * loss
            fp_cost = FP_REVERT_SCALE * loss + FP_REVERT_FLOOR_MB
            reward[is_file] = (
                sc * loss - (1 - sc) * fp_cost - DOWNTIME_WEIGHT * t_op
            )
            s[is_file, i] = 1.0
            s[is_file, F + P] += t_op

        is_kill = (a >= F) & (a < F + P)
        if is_kill.any():
            p = a[is_kill] - F
            sc = self.proc_scores[p]
            # killing an active encryptor averts the loss it would cause over
            # the remaining episode horizon
            remaining = (self.max_steps - s[is_kill, F + P + 1]).clip(min=0.0)
            averted = sc * ONGOING_LOSS_MB_PER_SEC * np.minimum(remaining, 30.0)
            reward[is_kill] = averted - DOWNTIME_WEIGHT * KILL_DOWNTIME_SEC * sc - (
                1 - sc
            ) * DOWNTIME_WEIGHT * KILL_DOWNTIME_SEC * 2.0
            s[is_kill, F + p] = 1.0

        is_stop = a == F + P
        if is_stop.any():
            # stopping with live threats forfeits the loss they cause over the
            # remaining horizon (same 30 s encryptor-activity cap as kills)
            remaining = (self.max_steps - s[is_stop, F + P + 1]).clip(min=0.0)
            reward[is_stop] = (
                -live_threat[is_stop] * ONGOING_LOSS_MB_PER_SEC
                * np.minimum(remaining, 30.0)
            )
            s[is_stop, F + P + 2] = 1.0

        s[:, F + P + 1] += 1.0
        return s, reward

    def terminal(self, s: np.ndarray) -> np.ndarray:
        _, _, _, steps, stopped = self.split(s)
        return (stopped > 0.5) | (steps >= self.max_steps) | (
            self.legal_actions(s).sum(-1) == 0
        )

    # --- priors + value features --------------------------------------------
    def priors(self) -> np.ndarray:
        """Action priors from detector scores (softmax over expected gain)."""
        fp_cost = FP_REVERT_SCALE * self.file_loss_mb + FP_REVERT_FLOOR_MB
        gain_f = self.file_scores * self.file_loss_mb - (1 - self.file_scores) * fp_cost
        gain_p = self.proc_scores * ONGOING_LOSS_MB_PER_SEC * 30.0 - 3.0
        logits = np.concatenate([gain_f, gain_p, np.zeros(1)]) / 8.0
        e = np.exp(logits - logits.max())
        return (e / e.sum()).astype(np.float32)

    def value_features(self, s: np.ndarray) -> np.ndarray:
        """[B, 8] summary features for the value net (fixed width regardless
        of F/P so one net serves every incident size)."""
        done_f, killed_p, downtime, steps, stopped = self.split(s)
        rem_gain = ((1 - done_f) * self.file_scores * self.file_loss_mb).sum(-1)
        rem_fp = ((1 - done_f) * (1 - self.file_scores)).sum(-1)  # count-scale FP exposure
        live = (self.proc_scores * (killed_p < 0.5)).sum(-1)
        return np.stack(
            [
                rem_gain,
                rem_fp,
                live,
                done_f.sum(-1) / max(self.F, 1),
                killed_p.sum(-1) / max(self.P, 1),
                downtime / 60.0,
                steps / self.max_steps,
                stopped,
            ],
            axis=-1,
        ).astype(np.float32)

    def expected_gains(self) -> np.ndarray:
        """Per-action expected incremental reward from the initial state [A]."""
        gain_f = (
            self.file_scores * self.file_loss_mb
            - (1 - self.file_scores) * (FP_REVERT_SCALE * self.file_loss_mb + FP_REVERT_FLOOR_MB)
            - DOWNTIME_WEIGHT * REVERT_SECONDS_PER_MB * self.file_loss_mb
        )
        gain_p = (
            self.proc_scores * ONGOING_LOSS_MB_PER_SEC * 30.0
            - DOWNTIME_WEIGHT * KILL_DOWNTIME_SEC
        )
        return np.concatenate([gain_f, gain_p, np.zeros(1)]).astype(np.float32)

    def action_info(self, a: int) -> UndoAction:
        if a < self.F:
            return UndoAction(
                ActionKind.REVERT_FILE, self.file_paths[a],
                float(self.file_scores[a]), float(self.file_loss_mb[a]),
                REVERT_SECONDS_PER_MB * float(self.file_loss_mb[a]),
            )
        if a < self.F + self.P:
            p = a - self.F
            return UndoAction(
                ActionKind.KILL_PROCESS, self.proc_names[p], float(self.proc_scores[p])
            )
        return UndoAction(ActionKind.STOP, "stop", 1.0)
