"""Multi-camera perceptual encoder (counterpart of ``hulc2_tpu/models/perceptual.py``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from hulc2_torch.models.vision import VisionNetwork, VisionNetworkGripper


class ConcatEncoders(nn.Module):
    """Static + gripper RGB encoders over (B, S, H, W, C) windows, flattened
    to one batch of frames, concatenated to (B, S, 128) (``perceptual.py:22``)."""

    def __init__(self, rgb_static: VisionNetwork, rgb_gripper: VisionNetworkGripper):
        super().__init__()
        self.rgb_static_encoder = rgb_static
        self.rgb_gripper_encoder = rgb_gripper

    @staticmethod
    def _encode(enc: nn.Module, imgs: torch.Tensor, deterministic: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        b, s = imgs.shape[:2]
        frames = imgs.reshape(b * s, *imgs.shape[2:]).permute(0, 3, 1, 2)
        return enc(frames, deterministic, generator).reshape(b, s, -1)

    def forward(self, rgb_obs: Dict[str, torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.cat([
            self._encode(self.rgb_static_encoder, rgb_obs["rgb_static"], deterministic, generator),
            self._encode(self.rgb_gripper_encoder, rgb_obs["rgb_gripper"], deterministic, generator),
        ], dim=-1)
