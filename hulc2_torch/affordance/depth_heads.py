"""The depth heads (``hulc2_tpu/affordance/depth_heads.py:21-123``).

Both read the spatially pooled bottleneck ++ the language: fc(feat ++ lang)
-> fc(++ lang) -> fc, then their outputs.

- ``GaussianDepthHead``: (mu, sigma); the NLL of torch's GaussianNLLLoss
  with the variance clamped at 1e-6; ``sample`` takes its standard normal
  draws (B, 1) as an input.
- ``LogisticDepthHead``: a mixture of 10 discretized logistics over 128
  bins, bounds (-2, 2) for normalized depth or (1.3, 4.5) m, log scales
  clamped at -7, through ``ops/logistic.py``; ``sample`` takes its uniforms
  (u_sel (B, 1, K), u (B, 1)) in [1e-5, 1 - 1e-5) as an input.

Each head's ``draws(n, generator, device)`` makes its sampler's draws.
``depth_dist: none`` builds no head (``DEPTH_HEADS``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc2_torch.models.layers import Dense
from hulc2_torch.ops import logistic


class DepthNorm(NamedTuple):
    """Normalization of depth targets (statistics of the labelled dataset)."""

    mean: float = 0.0
    std: float = 1.0

    def normalize(self, d):
        return (d - self.mean) / self.std

    def denormalize(self, d):
        return d * self.std + self.mean


class _Trunk(nn.Module):
    def __init__(self, feat_dim: int, lang_dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = Dense(feat_dim + lang_dim, hidden_dim * 3)
        self.fc2 = Dense(hidden_dim * 3 + lang_dim, hidden_dim * 2)
        self.fc3 = Dense(hidden_dim * 2, hidden_dim)

    def trunk(self, pooled: torch.Tensor, lang: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc1(torch.cat([pooled, lang], -1)))
        x = F.relu(self.fc2(torch.cat([x, lang], -1)))
        return F.relu(self.fc3(x))


class GaussianDepthHead(_Trunk):
    def __init__(self, feat_dim: int, lang_dim: int, hidden_dim: int = 256):
        super().__init__(feat_dim, lang_dim, hidden_dim)
        self.depth_mu = Dense(hidden_dim, 1)
        self.depth_sigma = Dense(hidden_dim, 1)

    def forward(self, pooled: torch.Tensor, lang: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.trunk(pooled, lang)
        return self.depth_mu(x), torch.exp(self.depth_sigma(x).clamp(-20.0, 2.0))

    def loss(self, pred: Tuple[torch.Tensor, torch.Tensor], target: torch.Tensor) -> torch.Tensor:
        mu, sigma = pred
        var = torch.clamp(sigma ** 2, min=1e-6)
        return torch.mean(0.5 * (torch.log(var) + (target - mu) ** 2 / var))

    @staticmethod
    def draws(n: int, generator: torch.Generator, device) -> torch.Tensor:
        return torch.randn((n, 1), generator=generator, device=device)

    @staticmethod
    def sample(normal: torch.Tensor, pred, norm: Optional[DepthNorm] = None) -> torch.Tensor:
        """mu + sigma * normal, denormalized by ``norm`` when given."""
        mu, sigma = pred
        s = mu + sigma * normal
        return norm.denormalize(s) if norm else s


def logistic_bounds(normalized: bool) -> Tuple[float, float]:
    return (-2.0, 2.0) if normalized else (1.3, 4.5)


class LogisticDepthHead(_Trunk):
    def __init__(self, feat_dim: int, lang_dim: int, hidden_dim: int = 256, n_mixtures: int = 10,
                 num_classes: int = 128, normalized: bool = True, log_scale_min: float = -7.0):
        super().__init__(feat_dim, lang_dim, hidden_dim)
        self.n_mixtures, self.num_classes = n_mixtures, num_classes
        self.normalized, self.log_scale_min = normalized, log_scale_min
        self.prob_fc = Dense(hidden_dim, n_mixtures)
        self.mean_fc = Dense(hidden_dim, n_mixtures)
        self.scale_fc = Dense(hidden_dim, n_mixtures)

    def forward(self, pooled: torch.Tensor, lang: torch.Tensor):
        """-> (logit_probs, log_scales, means), each (B, 1, K)."""
        x = self.trunk(pooled, lang)
        log_scales = torch.clamp(self.scale_fc(x)[:, None, :], min=self.log_scale_min)
        return self.prob_fc(x)[:, None, :], log_scales, self.mean_fc(x)[:, None, :]

    def loss(self, pred, target: torch.Tensor) -> torch.Tensor:
        """The mixture's NLL of ``target`` (B, 1), summed over the one dim and
        averaged over the batch."""
        logit_probs, log_scales, means = pred
        lo, hi = logistic_bounds(self.normalized)
        lp = logistic.logistic_mixture_log_prob(
            logit_probs, log_scales, means, target.reshape(-1, 1),
            torch.tensor(lo, device=means.device), torch.tensor(hi, device=means.device),
            self.num_classes, self.log_scale_min)
        return -lp.sum(dim=-1).mean()

    def draws(self, n: int, generator: torch.Generator, device) -> tuple:
        u_sel = logistic._mixture_uniform((n, 1, self.n_mixtures), generator, device)
        return u_sel, logistic._mixture_uniform((n, 1), generator, device)

    @staticmethod
    def sample(draws: tuple, pred, norm: Optional[DepthNorm] = None) -> torch.Tensor:
        """(B, 1) from the uniforms ``draws`` = (u_sel, u), denormalized by ``norm``."""
        u_sel, u = draws
        s = logistic.logistic_mixture_sample(*pred, u_sel=u_sel, u=u)
        return norm.denormalize(s) if norm else s


DEPTH_HEADS = {"gaussian": GaussianDepthHead, "logistic": LogisticDepthHead}
