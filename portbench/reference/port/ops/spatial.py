"""Spatial softmax keypoint pooling (counterpart of ``hulc2_tpu/ops/spatial.py``).

Same coordinate convention as the JAX package and the reference: at feature
position (row r, col c), x = linspace(-1, 1, H)[r] varies over rows and
y = linspace(-1, 1, W)[c] over columns; the output interleaves
(x_0, y_0, x_1, y_1, ...) per channel.
"""
from __future__ import annotations

import torch


def spatial_softmax(features: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """(N, C, H, W) feature maps -> (N, 2 C) expected keypoints, computed in fp32."""
    n, c, h, w = features.shape
    with torch.autocast(device_type=features.device.type, enabled=False):
        x = features.float().reshape(n, c, h * w) / temperature
        p = torch.softmax(x, dim=-1).reshape(n, c, h, w)
        xs = torch.linspace(-1.0, 1.0, h, device=features.device)
        ys = torch.linspace(-1.0, 1.0, w, device=features.device)
        ex = (p.sum(dim=3) * xs).sum(dim=-1)  # (N, C): marginal over rows
        ey = (p.sum(dim=2) * ys).sum(dim=-1)  # (N, C): marginal over columns
        return torch.stack([ex, ey], dim=-1).reshape(n, 2 * c)
