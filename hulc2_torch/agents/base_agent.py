"""Model-based motion primitive: the staged PD drive to a 3D target.

The port's copy of ``hulc2_tpu/agents/base_agent.py:40-83`` (numpy only)
(reference: hulc2/agents/base_agent.py:106-180, 226-258): approach a target
in stages (lift z, retract y, translate xy, descend), each stage a PD
position loop (kp 0.08, kd 0.05, at most 200 steps, stopping when converged
or stalled). It runs against the host simulator between policy segments.
The staged state machine is ``agents/approach.ApproachController``, which
the batched evaluator drives one lockstep round at a time.

One fault of the original is repaired: its ``_robot_state`` reads
``r.get("tcp_pos", info["robot_obs"][:3])``, whose default Python evaluates
first, so on calvin_env's info (``scene_info`` and ``robot_info`` only)
``move_to`` raises ``KeyError: 'robot_obs'`` at once. Here ``robot_info``'s
``tcp_pos``/``tcp_orn``/``gripper_action`` are read where present, and the
env's ``robot_obs`` (the info's, else a fresh observation's) only for what
is missing.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from hulc2_torch.agents.approach import DEFAULT_TARGET_ORN, ApproachController


class BaseAgent:
    def __init__(self, env, target_orn: Optional[Sequence[float]] = None, offset=(0.0, 0.0, 0.1)):
        self.env = env
        self.target_orn = np.asarray(target_orn if target_orn is not None else DEFAULT_TARGET_ORN)
        self.offset = np.asarray(offset)
        self.n_move_steps = 0  # env steps driven by move_to / move_to_pos

    def _robot_state(self) -> Tuple[np.ndarray, np.ndarray, float]:
        """(tcp_pos, tcp_orn, gripper action) of the env's robot."""
        info = self.env.get_info()
        r = info.get("robot_info", {})
        robot_obs = None

        def obs() -> np.ndarray:
            nonlocal robot_obs
            if robot_obs is None:
                robot_obs = np.asarray(info["robot_obs"] if "robot_obs" in info
                                       else self.env.get_obs()["robot_obs"])
            return robot_obs

        tcp_pos = np.asarray(r["tcp_pos"]) if "tcp_pos" in r else obs()[:3]
        tcp_orn = np.asarray(r["tcp_orn"]) if "tcp_orn" in r else obs()[3:6]
        gripper = float(r["gripper_action"]) if "gripper_action" in r else float(obs()[-1])
        return tcp_pos, tcp_orn, gripper

    def _drive(self, controller: ApproachController, tcp_pos, tcp_orn):
        """Step the env with the controller's actions until it is done;
        returns the last transition."""
        transition = (self.env.get_obs(), 0.0, False, self.env.get_info())
        while True:
            action = controller.action(tcp_pos, tcp_orn)
            if action is None:
                return transition
            transition = self.env.step(action)
            self.n_move_steps += 1
            tcp_pos, tcp_orn, _ = self._robot_state()

    def move_to(self, target_pos, target_orn=None, gripper_action=None):
        """Blocking staged approach (reference: base_agent.py:106-147)."""
        tcp_pos, tcp_orn, curr_grip = self._robot_state()
        controller = ApproachController(
            tcp_pos, target_pos,
            target_orn if target_orn is not None else self.target_orn.copy(),
            curr_grip if gripper_action is None else gripper_action)
        return self._drive(controller, tcp_pos, tcp_orn)

    def move_to_pos(self, target_pos, target_orn, gripper_action):
        """One PD position loop (reference: base_agent.py:180-224)."""
        tcp_pos, tcp_orn, _ = self._robot_state()
        controller = ApproachController.single_stage(tcp_pos, target_pos, target_orn, gripper_action)
        return self._drive(controller, tcp_pos, tcp_orn)
