"""Vision-language fusion (``hulc2_tpu/affordance/fusion.py:20-39``).

The port carries the ``mult`` fuser of the flagship detector: the visual
map times the projected language vector, broadcast over the spatial dims.
The per-scale language projection lives in the decoder block, as in the JAX
package. The other fusers of the JAX registry are not ported.
"""
from __future__ import annotations

import torch
import torch.nn as nn


class FusionMult(nn.Module):
    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """x1 (B, C, H, W) NCHW, x2 (B, C) the projected language."""
        return x1 * x2[:, :, None, None]


FUSERS = {"mult": FusionMult}
