"""Incremental staged PD approach controller.

The reference drives the arm near the affordance target with a *blocking*
staged PD loop (reference: hulc2/agents/base_agent.py:106-224 ``move_to`` /
``move_to_pos``): lift z, retract y, translate xy at height, descend — each
stage a PD position loop (kp=0.08, kd=0.05, <=200 steps, stop on convergence
or stall). Blocking is fine for one env, but the batched evaluator steps K
envs in lockstep, so the same controller is exposed here as a *state
machine*: ``action(tcp_pos, tcp_orn)`` returns ONE ``(pos, orn, gripper)``
action per call (or ``None`` when the approach is finished), letting some
envs approach while the rest run the policy in the same lockstep round.

The port's copy of ``hulc2_tpu/agents/approach.py`` (numpy only);
``agents/base_agent.BaseAgent.move_to`` drives it in a loop, so the blocking
and incremental paths share one implementation.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

KP, KD = 0.08, 0.05
MAX_STAGE_STEPS = 200
CONVERGED_DIST = 0.01
STALLED_DIST = 0.0005
Z_CEILING = 0.7

# neutral downward-pointing gripper orientation used when none is given
DEFAULT_TARGET_ORN = np.array([3.14, 0.0, 1.5])

_XY_AT_HEIGHT = "xy_at_height"  # stage sentinel: fill from live tcp z


class ApproachController:
    """Stage plan + per-stage PD state (reference: base_agent.py:106-147).

    Stages, computed from the TCP position at construction:
      1. small lift            (tcp + [0, 0, 0.03])
      2. retract + rise        ([tcp_x, tcp_y - 0.03, lift_z])
      3. xy translate at height (target xy, *current* z — resolved lazily)
      4. descend to target
    """

    def __init__(
        self,
        tcp_pos: Sequence[float],
        target_pos: Sequence[float],
        target_orn: Optional[Sequence[float]] = None,
        gripper_action: float = 1.0,
        max_stage_steps: int = MAX_STAGE_STEPS,
    ):
        tcp_pos = np.asarray(tcp_pos, np.float64)
        self.target_pos = np.asarray(target_pos, np.float64)
        self.target_orn = np.asarray(
            target_orn if target_orn is not None else DEFAULT_TARGET_ORN, np.float64
        )
        self.gripper_action = float(gripper_action)
        self.max_stage_steps = int(max_stage_steps)

        lift_z = min(max(tcp_pos[2] + 0.07, self.target_pos[2]), Z_CEILING)
        self._stages = [
            np.array([tcp_pos[0], tcp_pos[1], tcp_pos[2] + 0.03]),
            np.array([tcp_pos[0], tcp_pos[1] - 0.03, lift_z]),
            _XY_AT_HEIGHT,
            self.target_pos,
        ]
        self._stage_idx = -1
        self._stage_target: Optional[np.ndarray] = None
        self.n_steps = 0  # total PD steps emitted

    @classmethod
    def single_stage(cls, tcp_pos, target_pos, target_orn=None, gripper_action=1.0,
                     max_stage_steps: int = MAX_STAGE_STEPS) -> "ApproachController":
        """One direct PD drive to the target, no lift/retract staging
        (reference ``move_to_pos``, base_agent.py:180-224)."""
        c = cls(tcp_pos, target_pos, target_orn, gripper_action, max_stage_steps)
        c._stages = [c.target_pos]
        return c

    # ------------------------------------------------------------------ #
    @property
    def done(self) -> bool:
        return self._stage_idx >= len(self._stages)

    def _enter_next_stage(self, tcp_pos: np.ndarray) -> bool:
        """Advance to the next stage; False when the plan is exhausted."""
        self._stage_idx += 1
        if self.done:
            return False
        stage = self._stages[self._stage_idx]
        if isinstance(stage, str):  # xy translate at the current height
            stage = np.array([self.target_pos[0], self.target_pos[1], tcp_pos[2]])
        self._stage_target = np.asarray(stage, np.float64)
        # per-stage PD state (reference: base_agent.py:180-196): last_pos
        # starts AT the target so the first stall check reads |tcp - target|
        self._last_pos = self._stage_target.copy()
        self._derivative = np.zeros(3)
        self._stage_steps = 0
        return True

    def _stage_finished(self, tcp_pos: np.ndarray, tcp_orn: np.ndarray) -> bool:
        error = self._stage_target - tcp_pos
        angle_diff = np.arctan2(
            np.sin(tcp_orn - self.target_orn), np.cos(tcp_orn - self.target_orn)
        )
        moving = np.linalg.norm(tcp_pos - self._last_pos) > STALLED_DIST
        return bool(
            self._stage_steps >= self.max_stage_steps
            or np.linalg.norm(error) <= CONVERGED_DIST
            or not (moving or (angle_diff > 0.01).any())
        )

    def action(self, tcp_pos, tcp_orn) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
        """Next PD action ``(pos, orn, gripper)`` for the current robot state,
        or ``None`` once every stage has converged/stalled/capped."""
        # np.array (not asarray): callers often pass live views of the env's
        # robot_obs buffer, and _last_pos must be a frozen snapshot
        tcp_pos = np.array(tcp_pos, np.float64)
        tcp_orn = np.array(tcp_orn, np.float64)
        if self._stage_idx < 0 and not self._enter_next_stage(tcp_pos):
            return None
        while self._stage_finished(tcp_pos, tcp_orn):
            if not self._enter_next_stage(tcp_pos):
                return None
        error = self._stage_target - tcp_pos
        rel = error * KP + self._derivative * KD
        self._derivative = error
        self._last_pos = tcp_pos
        self._stage_steps += 1
        self.n_steps += 1
        return (tcp_pos + rel, self.target_orn.copy(), self.gripper_action)
