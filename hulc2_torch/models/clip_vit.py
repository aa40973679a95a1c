"""CLIP's ViT image tower (``hulc2_tpu/models/clip_vit.py:24-67``).

A patchifying convolution without bias, the class token and a learned
positional table, ``ln_pre``, pre-LN residual blocks with QuickGELU MLPs
(the text tower's blocks, ``models/clip_text.py``, here without a mask),
``ln_post`` on the class token and the projection ``proj``. NCHW in;
patches are taken in row-major (h, w) order. The positional table has
``(input_resolution // patch_size) ** 2 + 1`` rows: the JAX encoder builds
the tower for its input's size, and so does the port's (``VisionClip``
passes the camera's post-transform size). Parameter names are OpenAI
CLIP's visual ones without the ``visual.`` prefix.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from hulc2_torch.models.clip_text import Transformer


class ClipVisionTransformer(nn.Module):
    """NCHW images (B, 3, R, R) -> embeddings (B, output_dim)."""

    def __init__(self, patch_size: int = 32, width: int = 768, layers: int = 12, heads: int = 12,
                 output_dim: int = 512, input_resolution: int = 224):
        super().__init__()
        self.patch_size, self.width = patch_size, width
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty((input_resolution // patch_size) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = Transformer(width, layers, heads)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX tower's init: flax's lecun-normal patch kernel,
        normal(width^-0.5) class token, positions and projection (the blocks
        initialise themselves)."""
        from hulc2_torch.models.resnet import lecun_normal_

        lecun_normal_(self.conv1.weight, generator)
        scale = self.width ** -0.5
        for p in (self.class_embedding, self.positional_embedding, self.proj):
            p.normal_(0.0, scale, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x).flatten(2).transpose(1, 2)  # (B, h*w, width)
        if y.shape[1] + 1 != self.positional_embedding.shape[0]:
            raise ValueError(f"{y.shape[1]} patch tokens against "
                             f"{self.positional_embedding.shape[0] - 1} positions: the input "
                             "resolution must be the tower's")
        cls = self.class_embedding.to(y.dtype).expand(y.shape[0], 1, -1)
        y = torch.cat([cls, y], dim=1) + self.positional_embedding.to(y.dtype)
        y = self.ln_pre(y)
        for block in self.transformer.resblocks:
            y = block(y, None)
        return self.ln_post(y[:, 0]) @ self.proj.to(y.dtype)
