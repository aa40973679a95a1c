"""The CALVIN simulator's wrapper (host CPU) and the batched env farm.

The port's copy of ``hulc2_tpu/envs/calvin_wrapper.py`` (numpy only)
(reference: hulc2/wrappers/hulc2_wrapper.py:16-101,
hulc2/env_wrappers/play_lmp_wrapper.py:13):

- ``CalvinEnvWrapper`` adapts a calvin_env ``PlayTableSimEnv``: raw dict obs
  (uint8 HWC images, 15-d robot_obs, 24-d scene_obs), relative actions passed
  through with the gripper binarised, the approach's absolute (pos, orn,
  gripper) actions as ``cartesian_abs``, and reset from a recorded
  ``state_info``. The simulator renders on the host.
- ``EnvFarm`` steps N independent envs in lockstep and stacks their
  observations, so that one policy step serves all of them.

One fault of the original is repaired: its ``get_info()`` passes calvin_env's
info through, which holds only ``scene_info`` and ``robot_info``, so the
scene-obs oracle (``--heuristic-oracle``) and every reader of
``info["robot_obs"]`` fail on it with a ``KeyError``. Here the info also
carries ``robot_obs`` and ``scene_obs``, kept from the last observation of
``reset``/``step``/``get_obs``, so no extra render is needed; calvin_env's
native oracle ignores the extra keys.

calvin_env is an optional host dependency, imported only when an env is built.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def make_calvin_env(dataset_path=None, show_gui: bool = False, **kwargs):
    """A calvin_env ``PlayTableSimEnv`` built from the dataset's recorded
    rendering config (reference: evaluation/utils.py:218-240)."""
    try:
        from calvin_env.envs.play_table_env import get_env  # type: ignore
    except ImportError as e:
        raise ImportError(
            "calvin_env is not installed on this host — use FakeCalvinEnv for "
            "tests or install the CALVIN simulator for benchmark rollouts"
        ) from e
    return get_env(dataset_path, show_gui=show_gui, **kwargs)


def make_wrapped_calvin_env(dataset_path=None, show_gui: bool = False, **kwargs):
    """Picklable factory: build and wrap a calvin env (``ProcessEnvFarm``'s
    workers build the simulator in their own process)."""
    return CalvinEnvWrapper(make_calvin_env(dataset_path, show_gui=show_gui, **kwargs))


class CalvinEnvWrapper:
    """The interface the agents, the evaluators and the oracles expect."""

    def __init__(self, env, relative_actions: bool = True):
        self.env = env
        self.relative_actions = relative_actions
        self._last: Optional[Dict] = None  # the last observation's state floats

    @property
    def cameras(self):
        return self.env.cameras

    def get_camera_params(self) -> Dict:
        """The static camera as ``PinholeCamera`` keyword arguments: picklable,
        unlike calvin_env's camera objects, which hold pybullet handles."""
        from hulc2_torch.envs.camera import PinholeCamera

        cam = self.env.cameras[0]
        if isinstance(cam, PinholeCamera):
            return cam.to_params()
        return PinholeCamera.from_gl_matrices(
            cam.width, cam.height, cam.projectionMatrix, cam.viewMatrix,
            getattr(cam, "name", "static"),
        ).to_params()

    def reset(self, robot_obs=None, scene_obs=None, state_info: Optional[Dict] = None):
        if state_info is not None:  # reset from a recorded dataset frame
            robot_obs = np.asarray(state_info["robot_obs"])
            scene_obs = np.asarray(state_info["scene_obs"])
        return self._obs(self.env.reset(robot_obs=robot_obs, scene_obs=scene_obs))

    def step(self, action):
        if isinstance(action, np.ndarray) and self.relative_actions:
            a = action.astype(np.float64).copy()
            a[-1] = 1.0 if a[-1] > 0 else -1.0
            env_action = {"action": a, "type": "cartesian_rel"}
        elif isinstance(action, (list, tuple)):
            # absolute [pos, orn, gripper] from the PD controller
            env_action = {
                "action": np.concatenate([np.asarray(p).reshape(-1) for p in action]),
                "type": "cartesian_abs",
            }
        else:
            env_action = action
        obs, reward, done, info = self.env.step(env_action)
        obs = self._obs(obs)
        return obs, reward, done, self._with_state(info)

    def get_obs(self):
        return self._obs(self.env.get_obs())

    def get_info(self) -> Dict:
        """calvin_env's info with the last observation's ``robot_obs`` and
        ``scene_obs``."""
        if self._last is None:
            self.get_obs()
        return self._with_state(self.env.get_info())

    def _with_state(self, info: Dict) -> Dict:
        return {**info, "robot_obs": self._last["robot_obs"].copy(),
                "scene_obs": self._last["scene_obs"].copy()}

    def _obs(self, obs: Dict) -> Dict:
        out = {
            "rgb_obs": dict(obs.get("rgb_obs", {})),
            "depth_obs": dict(obs.get("depth_obs", {})),
            "robot_obs": np.asarray(obs["robot_obs"]),
            "scene_obs": np.asarray(obs.get("scene_obs", np.zeros(24))),
        }
        self._last = {k: np.array(out[k]) for k in ("robot_obs", "scene_obs")}
        return out


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

    def step(self, actions: np.ndarray):
        """Step every env; returns the stacked obs, rewards, dones and infos."""
        results = [e.step(actions[i]) for i, e in enumerate(self.envs)]
        obs, rewards, dones, infos = zip(*results)
        return self.stack_obs(obs), np.asarray(rewards), np.asarray(dones), list(infos)

    def step_all(self, actions: np.ndarray):
        """Step every env, serially; returns (obs_list, infos). The
        ``ProcessEnvFarm`` steps its envs in parallel processes."""
        results = [e.step(actions[i]) for i, e in enumerate(self.envs)]
        obs, _, _, infos = zip(*results)
        return list(obs), list(infos)

    def get_obs(self):
        return self.stack_obs([e.get_obs() for e in self.envs])

    def get_infos(self) -> List[Dict]:
        return [e.get_info() for e in self.envs]

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
