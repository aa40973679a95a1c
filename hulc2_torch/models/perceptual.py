"""Multi-camera perceptual encoder (counterpart of ``hulc2_tpu/models/perceptual.py``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from hulc2_torch.core import trace

# each camera's span, named once so that a span off costs a lookup
SPANS = {key: f"model.encode.{key}" for key in
         ("rgb_static", "depth_static", "rgb_gripper", "depth_gripper", "rgb_tactile")}


class ConcatEncoders(nn.Module):
    """Per-camera encoders over (B, S, H, W, C) windows (depth maps (B, S, H,
    W) as one channel), each flattened to one batch of frames, concatenated
    in JAX's fixed order rgb_static ++ depth_static ++ rgb_gripper ++
    depth_gripper ++ tactile ++ proprio (``perceptual.py:43-57``): the
    gripper camera is optional, its depth encoder is used only with it, the
    tactile encoder reads ``rgb_obs["rgb_tactile"]``, and the proprio
    part is the identity slice ``robot_obs[..., :proprio_dim]`` of the
    processed robot_obs (narrower when robot_obs is). The encoders' names
    are the reference's state_dict names. Each camera's encoder runs in the
    tracer's span ``model.encode.<camera>`` (``core/trace``; the model puts
    the whole encoder in ``model.encode``)."""

    def __init__(self, rgb_static: nn.Module, rgb_gripper: Optional[nn.Module] = None,
                 depth_static: Optional[nn.Module] = None,
                 depth_gripper: Optional[nn.Module] = None, tactile: Optional[nn.Module] = None,
                 proprio_dim: int = 0):
        super().__init__()
        self.rgb_static_encoder = rgb_static
        self.depth_static_encoder = depth_static
        self.rgb_gripper_encoder = rgb_gripper
        self.depth_gripper_encoder = depth_gripper if rgb_gripper is not None else None
        self.tactile_encoder = tactile
        self.proprio_dim = proprio_dim

    @staticmethod
    def _encode(enc: nn.Module, imgs: torch.Tensor, deterministic: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        b, s = imgs.shape[:2]
        frames = imgs.reshape(b * s, *imgs.shape[2:])
        if frames.dim() == 3:  # depth maps (N, H, W) -> (N, H, W, 1)
            frames = frames[..., None]
        # NCHW in channels_last memory, one channel included: cuDNN's NHWC
        # kernels without layout conversions
        return enc(frames.permute(0, 3, 1, 2), deterministic, generator).reshape(b, s, -1)

    def forward(self, rgb_obs: Dict[str, torch.Tensor],
                depth_obs: Optional[Dict[str, torch.Tensor]] = None,
                robot_obs: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        parts = [(self.rgb_static_encoder, rgb_obs, "rgb_static"),
                 (self.depth_static_encoder, depth_obs, "depth_static"),
                 (self.rgb_gripper_encoder, rgb_obs, "rgb_gripper"),
                 (self.depth_gripper_encoder, depth_obs, "depth_gripper"),
                 (self.tactile_encoder, rgb_obs, "rgb_tactile")]
        feats = []
        for enc, obs, key in parts:
            if enc is not None:
                with trace.span(SPANS[key]):
                    feats.append(self._encode(enc, obs[key], deterministic, generator))
        if self.proprio_dim > 0:
            feats.append(robot_obs[..., :self.proprio_dim])
        return torch.cat(feats, dim=-1)
