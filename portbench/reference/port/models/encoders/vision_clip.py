"""The static camera's CLIP image tower and its head: mees/hulc2
``hulc2/models/perceptual_encoders/vision_clip.py`` (the port's
``models/pretrained_vision.VisionClip``). The tower is the plain
``clip_resnet.ClipModifiedResNet`` (``model_name`` "RN50", the reference's
default; ``tower_kwargs`` override its sizes) built for the camera's side
after the train transform; its 1024-d embedding (fc1 512 wide, else 256)
goes through ``relu(fc1)`` and ``fc2``.

With ``freeze_backbone`` the tower runs under ``torch.no_grad()``, as the
reference stops the gradient at the embedding, in blocks of ``BLOCK``
frames so that its activations fit beside the reference's step on the card
(each frame is its own; the blocks change no number). ``compute_dtype``
sets the program's precision and is not read: the reference computes in
fp32."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.port.models.clip_resnet import ClipModifiedResNet
from portbench.reference.port.models.layers import Dense

BLOCK = 256


class VisionClip(nn.Module):
    def __init__(self, input_hw: int, visual_features: int = 64, model_name: str = "RN50",
                 freeze_backbone: bool = True, tower_kwargs: Optional[dict] = None,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if model_name != "RN50":
            raise ValueError(f"the CLIP tower {model_name!r} is not copied into the reference")
        self.freeze_backbone = freeze_backbone
        self.clip = ClipModifiedResNet(input_hw, **(tower_kwargs or {}))
        emb = self.clip.output_dim
        hidden = 512 if emb == 1024 else 256
        self.fc1 = Dense(emb, hidden)
        self.fc2 = Dense(hidden, visual_features)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        if not self.freeze_backbone:
            return self.clip(x)
        with torch.no_grad():
            return torch.cat([self.clip(x[i:i + BLOCK]) for i in range(0, x.shape[0], BLOCK)])

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(self.embed(x))))


def build(cfg: dict, hw: int) -> VisionClip:
    return VisionClip(hw, **{k: v for k, v in cfg.items() if k != "_name_"})
