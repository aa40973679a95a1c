"""The Gaussian depth head (``hulc2_tpu/affordance/depth_heads.py:21-64``).

fc(feat ++ lang) -> fc(++ lang) -> fc -> (mu, sigma) on the spatially pooled
bottleneck; the NLL loss of torch's GaussianNLLLoss with the variance
clamped at 1e-6; ``sample`` takes its standard normal draws as an input. The
logistic-mixture head is not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc2_torch.models.layers import Dense


class DepthNorm(NamedTuple):
    """Normalization of depth targets (statistics of the labelled dataset)."""

    mean: float = 0.0
    std: float = 1.0

    def normalize(self, d):
        return (d - self.mean) / self.std

    def denormalize(self, d):
        return d * self.std + self.mean


class GaussianDepthHead(nn.Module):
    def __init__(self, feat_dim: int, lang_dim: int, hidden_dim: int = 256):
        super().__init__()
        self.fc1 = Dense(feat_dim + lang_dim, hidden_dim * 3)
        self.fc2 = Dense(hidden_dim * 3 + lang_dim, hidden_dim * 2)
        self.fc3 = Dense(hidden_dim * 2, hidden_dim)
        self.depth_mu = Dense(hidden_dim, 1)
        self.depth_sigma = Dense(hidden_dim, 1)

    def forward(self, pooled: torch.Tensor, lang: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.fc1(torch.cat([pooled, lang], -1)))
        x = F.relu(self.fc2(torch.cat([x, lang], -1)))
        x = F.relu(self.fc3(x))
        return self.depth_mu(x), torch.exp(self.depth_sigma(x).clamp(-20.0, 2.0))

    @staticmethod
    def loss(pred: Tuple[torch.Tensor, torch.Tensor], target: torch.Tensor) -> torch.Tensor:
        mu, sigma = pred
        var = torch.clamp(sigma ** 2, min=1e-6)
        return torch.mean(0.5 * (torch.log(var) + (target - mu) ** 2 / var))

    @staticmethod
    def sample(normal: torch.Tensor, pred, norm: Optional[DepthNorm] = None) -> torch.Tensor:
        """mu + sigma * normal, denormalized by ``norm`` when given."""
        mu, sigma = pred
        s = mu + sigma * normal
        return norm.denormalize(s) if norm else s
