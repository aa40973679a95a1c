"""The real robot's (Franka Panda, robot_io) env wrapper.

The port's copy of ``hulc2_tpu/envs/panda_wrapper.py:31-101`` (numpy only)
(reference: hulc2/wrappers/panda_lfp_wrapper.py,
hulc2/env_wrappers/aff_lfp_real_world_wrapper.py): it adapts a robot_io
``RobotEnv`` to the observation and action surface the agents and the
harness use. A relative policy action is scaled by the TACO preprocessing's
largest per-step displacements (``tools/preprocess_real_data.MAX_REL_*``);
an absolute (pos, orn, gripper) action of the approach is clipped to the
workspace. robot_io is an optional host dependency, imported only when no
``env`` is given; without it the wrapper raises ``ImportError`` naming it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from hulc2_torch.envs.camera import PinholeCamera
from hulc2_torch.tools.preprocess_real_data import (MAX_REL_ORN, MAX_REL_POS, build_robot_obs,
                                                    quat_to_euler_xyz)

DEFAULT_WORKSPACE = {
    "low": np.array([0.2, -0.45, 0.02]),
    "high": np.array([0.75, 0.45, 0.7]),
}


class PandaLfpWrapper:
    def __init__(
        self,
        robot=None,
        env=None,
        cameras: Optional[Sequence[PinholeCamera]] = None,
        workspace: Optional[Dict] = None,
        relative_actions: bool = True,
        freq_hz: int = 15,
    ):
        if env is None:
            try:
                from robot_io.envs.robot_env import RobotEnv  # type: ignore
            except ImportError as e:
                raise ImportError("robot_io is not installed on this host") from e
            env = RobotEnv(robot=robot, freq=freq_hz)
        self.env = env
        self.cameras = list(cameras or [])
        self.workspace = workspace or DEFAULT_WORKSPACE
        self.relative_actions = relative_actions

    def reset(self, **kwargs):
        return self._obs(self.env.reset(**kwargs))

    def step(self, action):
        if isinstance(action, np.ndarray) and self.relative_actions:
            a = np.asarray(action, np.float64)
            target = {
                "motion": (a[:3] * MAX_REL_POS, a[3:6] * MAX_REL_ORN, 1 if a[-1] > 0 else -1),
                "ref": "rel",
            }
        else:
            pos, orn, grip = action
            pos = np.clip(pos, self.workspace["low"], self.workspace["high"])
            target = {"motion": (pos, orn, grip), "ref": "abs"}
        obs, reward, done, info = self.env.step(target)
        return self._obs(obs), reward, done, info

    def get_obs(self):
        return self._obs(self.env._get_obs())

    def get_info(self) -> Dict:
        obs = self.env._get_obs()
        return {"robot_obs": self._robot_obs(obs), "scene_obs": np.zeros(24)}

    @staticmethod
    def _robot_obs(obs) -> np.ndarray:
        rs = obs["robot_state"]
        orn = np.asarray(rs["tcp_orn"])
        if orn.shape[-1] == 4:
            orn = quat_to_euler_xyz(orn)
        return build_robot_obs(np.asarray(rs["tcp_pos"]), orn, rs["gripper_opening_width"],
                               np.asarray(rs["joint_positions"]), rs.get("gripper_action", 1.0))

    def _obs(self, obs) -> Dict:
        return {
            "rgb_obs": {k: v for k, v in obs.items() if k.startswith("rgb_")},
            "depth_obs": {k: v for k, v in obs.items() if k.startswith("depth_")},
            "robot_obs": self._robot_obs(obs),
            "scene_obs": np.zeros(24),
        }
