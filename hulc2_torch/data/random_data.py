"""Synthetic training windows, made on the device (``data/random_data.py``).

Unlike the JAX ``RandomWindowDataset`` (200x200 static, 84x84 gripper frames
that ``rand_shift_96`` then resizes), these frames have the native 96/64 size
of the expert dataset (any size may be asked for), and the lang windows
carry a ``lang_task_id`` in [0, n_tasks) so the task-CE head is on the path.
Their ``lang`` is CLIP-BPE-shaped token ids, or, with ``lang_dim``, normal
sentence embeddings of that width for a policy without a text tower. With
``depth_keys`` each window carries float16 depth maps of those cameras
(uniform in [0.5, 2.5] m, the size of its RGB camera), with ``scene_obs`` a
(S, 24) scene_obs, with ``tactile`` a 6-channel uint8 ``rgb_tactile`` at
the tactile sensor's raw 160x120 (which every preset's tactile pipeline
resizes). Each call of
``next_batch`` draws a fresh batch from the generator in bulk on the device.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

SOT_TOKEN, EOT_TOKEN = 49406, 49407
CONTEXT_LENGTH = 77
TACTILE_HW = (160, 120)  # the tactile sensor's frames (CALVIN, TACO)


class RandomWindowBatches:
    def __init__(self, batch_vis: int, batch_lang: int, window: int, static_hw: int = 96,
                 gripper_hw: int = 64, action_dim: int = 7, n_tasks: int = 34,
                 seed: int = 0, device="cuda", lang_dim: Optional[int] = None,
                 depth_keys: Sequence[str] = (), scene_obs: bool = False, tactile: bool = False):
        self.batch_vis, self.batch_lang, self.window = batch_vis, batch_lang, window
        self.static_hw, self.gripper_hw = static_hw, gripper_hw
        self.action_dim, self.n_tasks, self.lang_dim = action_dim, n_tasks, lang_dim
        self.depth_keys, self.scene_obs, self.tactile = tuple(depth_keys), scene_obs, tactile
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _window(self, b: int) -> Dict[str, torch.Tensor]:
        g, s, dev = self.generator, self.window, self.device
        out = {
            "rgb_static": torch.randint(0, 256, (b, s, self.static_hw, self.static_hw, 3),
                                        generator=g, device=dev, dtype=torch.uint8),
            "rgb_gripper": torch.randint(0, 256, (b, s, self.gripper_hw, self.gripper_hw, 3),
                                         generator=g, device=dev, dtype=torch.uint8),
            "robot_obs_raw": torch.randn((b, s, 15), generator=g, device=dev),
        }
        for key in self.depth_keys:
            hw = self.static_hw if key == "depth_static" else self.gripper_hw
            out[key] = (torch.rand((b, s, hw, hw), generator=g, device=dev) * 2.0
                        + 0.5).to(torch.float16)
        if self.tactile:
            out["rgb_tactile"] = torch.randint(0, 256, (b, s, *TACTILE_HW, 6), generator=g,
                                               device=dev, dtype=torch.uint8)
        if self.scene_obs:
            out["scene_obs"] = torch.randn((b, s, 24), generator=g, device=dev)
        actions = (torch.randn((b, s, self.action_dim), generator=g, device=dev) * 0.3).clamp(-1, 1)
        actions[..., -1] = torch.sign(actions[..., -1] + 1e-6)
        out["actions"] = actions
        return out

    def _tokens(self, b: int) -> torch.Tensor:
        """CLIP-BPE-shaped ids: SOT, 2..10 random ids, EOT, zero padding."""
        g, dev = self.generator, self.device
        n = torch.randint(4, 12, (b, 1), generator=g, device=dev)
        pos = torch.arange(CONTEXT_LENGTH, device=dev)[None, :]
        ids = torch.randint(1, 49000, (b, CONTEXT_LENGTH), generator=g, device=dev)
        toks = torch.where(pos < n - 1, ids, torch.zeros_like(ids))
        toks[:, 0] = SOT_TOKEN
        return toks.scatter(1, n - 1, torch.full_like(n, EOT_TOKEN))

    def next_batch(self) -> Dict[str, Dict[str, torch.Tensor]]:
        g, dev, b = self.generator, self.device, self.batch_lang
        lang = self._window(b)
        lang["lang"] = (self._tokens(b) if self.lang_dim is None
                        else torch.randn((b, self.lang_dim), generator=g, device=dev))
        lang["use_for_aux_lang_loss"] = torch.rand((b,), generator=g, device=dev) > 0.5
        lang["lang_task_id"] = torch.randint(0, self.n_tasks, (b,), generator=g, device=dev)
        return {"vis": self._window(self.batch_vis), "lang": lang}
