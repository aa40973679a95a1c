"""The rollout agent: a batched policy carry and one fused policy call per env step.

Counterpart of ``hulc2_tpu/agents/hulc2_agent.py:39-212``. The hierarchical
mode's affordance approach runs in the batched evaluator
(``evaluation/batched_eval.py``); the agent's single-env approach at
``reset(caption)`` is not ported. The agent holds
no model state in Python: the policy's state of its ``n_envs`` envs is a
device-resident ``PolicyCarry``; ``reset_env_slot`` restarts one env's slice
of it. Each ``step_async`` copies the observations (K frames, or only K x 39
state floats with ``device_render``) and the goal tokens to the device through
pinned memory without waiting, makes one fused step call and returns the
device action without waiting for it, so that an evaluator can keep several
cohorts' steps in flight. The random draws come from one ``torch.Generator``
on the device, seeded by ``seed``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hulc2_torch.data.device_transforms import make_batch_transform
from hulc2_torch.models.hulc2 import Hulc2, PolicyCarry, PolicyDraws
from hulc2_torch.train.steps import make_fused_policy_step, make_fused_render_policy_step


class Hulc2Agent:
    def __init__(self, model: Hulc2, dm_cfg: dict, seed: int = 0, n_envs: int = 1,
                 fused_step=None, device_render: Optional[dict] = None):
        """``model`` lives on the device the agent runs on. ``fused_step``
        shares one agent's step function with the others of an evaluator.
        ``device_render`` = {"static_hw": H, "gripper_hw": h} renders the fake
        env's frames on the device from its state floats."""
        self.model = model
        self.n_envs = n_envs
        self.device = next(model.parameters()).device
        obs_space = dm_cfg["observation_space"]
        if obs_space.get("depth_obs"):
            raise NotImplementedError("depth cameras are not ported")
        bf16 = self.device.type == "cuda" and model.compute_dtype == torch.bfloat16
        self._transform = make_batch_transform(
            obs_space, dm_cfg["proprioception_dims"], dm_cfg.get("transforms", "rand_shift_96"),
            dtype=torch.bfloat16 if bf16 else torch.float32, train=False)
        self._rgb_keys = list(obs_space["rgb_obs"])
        self.device_render = device_render
        if fused_step is not None:
            self._fused_step = fused_step
        elif device_render:
            from hulc2_torch.envs.render_torch import make_render_obs_fn

            render_fn = make_render_obs_fn(int(device_render["static_hw"]),
                                           int(device_render["gripper_hw"]), with_depth=False,
                                           device=self.device)
            self._fused_step = make_fused_render_policy_step(model, self._transform, render_fn,
                                                             self._rgb_keys)
        else:
            self._fused_step = make_fused_policy_step(model, self._transform)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.carry: PolicyCarry = model.init_carry(n_envs, self.device)

    def reset_env_slot(self, i: int) -> None:
        """Restart env i's slice of the carry (zero plan, goal and hidden
        state; step counter 0, so its next step replans). In place, on the
        stream, after the step that made the carry."""
        with torch.inference_mode():
            for t in (self.carry.plan, self.carry.latent_goal, self.carry.step):
                t[i] = 0
            self.carry.hidden[:, i] = 0

    def _to_device(self, a) -> torch.Tensor:
        """A host array on the agent's device. On the card the copy goes
        through pinned memory and does not wait: a copy from pageable memory
        would synchronise the stream."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _batched(self, x, base_ndim: int) -> np.ndarray:
        """An env-stacked array (n_envs, ...) from one env's or a farm's obs."""
        a = np.asarray(x)
        if a.ndim == base_ndim:  # a single env's obs
            a = a[None]
        if a.shape[0] != self.n_envs:
            raise ValueError(f"expected observations of {self.n_envs} envs, got {a.shape}")
        return a

    def _obs_to_device(self, obs: Dict) -> Dict[str, torch.Tensor]:
        """Raw env obs (one env, or an EnvFarm stack) -> (B, 1, ...) device tensors."""
        raw = {cam: self._to_device(self._batched(v, 3)[:, None])
               for cam, v in obs["rgb_obs"].items() if cam in self._rgb_keys}
        robot = self._batched(obs["robot_obs"], 1).astype(np.float32)
        raw["robot_obs_raw"] = self._to_device(robot[:, None])
        raw["actions"] = torch.zeros((self.n_envs, 1, 7), dtype=torch.float32, device=self.device)
        return raw

    def make_visual_goal(self, goal_obs: Dict) -> Dict:
        """A raw env goal observation -> the visual goal ``policy_step`` takes,
        transformed once and kept on the device for the whole subtask."""
        with torch.inference_mode():
            tfd = self._transform(self._obs_to_device(goal_obs), None)
        return {"rgb_obs": tfd["rgb_obs"]}

    def step_async(self, obs: Dict, goal: Dict,
                   draws: Optional[PolicyDraws] = None) -> torch.Tensor:
        """Submit one fused policy step for the current observation(s) and
        return the (B, 7) device action without waiting for it. ``goal`` is
        {"lang": token ids (77,) or (B, 77)} or a visual goal."""
        if self.device_render:
            state = np.concatenate([self._batched(obs["robot_obs"], 1),
                                    self._batched(obs["scene_obs"], 1)], axis=1)
            state = self._to_device(state.astype(np.float32))
            raw = {"robot_obs": state[:, :15], "scene_obs": state[:, 15:]}
        else:
            raw = self._obs_to_device(obs)
        if "lang" in goal:
            lang = np.asarray(goal["lang"])
            if lang.ndim == 1:
                lang = np.repeat(lang[None], self.n_envs, axis=0)
            dev_goal = {"lang": self._to_device(lang)}
        else:
            dev_goal = goal
        action, self.carry = self._fused_step(raw, dev_goal, self.carry, self.generator, draws)
        return action

    def step(self, obs: Dict, goal: Dict) -> np.ndarray:
        """One action per env for the current observation(s), on the host."""
        act = self.step_async(obs, goal).cpu().numpy()
        return act[0] if self.n_envs == 1 else act
