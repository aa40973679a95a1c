"""Batched env farm: N lockstep envs whose observations one policy step serves.

The port's copy of ``EnvFarm`` from ``hulc2_tpu/envs/calvin_wrapper.py``
(numpy only). The calvin_env wrapper of that module belongs to the real
simulator, which the port does not drive yet.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class EnvFarm:
    """N lockstep envs -> stacked observations for one batched policy step."""

    def __init__(self, envs: Sequence):
        self.envs = list(envs)

    def __len__(self):
        return len(self.envs)

    def reset(self, robot_obs=None, scene_obs=None):
        obs = [
            e.reset(
                robot_obs=None if robot_obs is None else robot_obs[i],
                scene_obs=None if scene_obs is None else scene_obs[i],
            )
            for i, e in enumerate(self.envs)
        ]
        return self.stack_obs(obs)

    def step_all(self, actions: np.ndarray):
        """Step every env, serially; returns (obs_list, infos)."""
        results = [e.step(actions[i]) for i, e in enumerate(self.envs)]
        obs, _, _, infos = zip(*results)
        return list(obs), list(infos)

    @staticmethod
    def stack_obs(obs_list: Sequence[Dict]) -> Dict:
        # image groups are absent in state-only obs (render_obs=False envs —
        # the device-render eval path renders frames on the card instead)
        out: Dict = {"rgb_obs": {}, "depth_obs": {}}
        for cam in obs_list[0].get("rgb_obs", {}):
            out["rgb_obs"][cam] = np.stack([o["rgb_obs"][cam] for o in obs_list])
        for cam in obs_list[0].get("depth_obs", {}):
            out["depth_obs"][cam] = np.stack([o["depth_obs"][cam] for o in obs_list])
        out["robot_obs"] = np.stack([o["robot_obs"] for o in obs_list])
        out["scene_obs"] = np.stack([o["scene_obs"] for o in obs_list])
        return out
