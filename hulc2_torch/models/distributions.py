"""Latent-plan distributions (``hulc2_tpu/models/distributions.py``).

A plan state is the raw fp32 output of a plan network's ``fc_state``:

- discrete (the default): the logits, (..., category_size * class_size), of a
  straight-through one-hot categorical;
- continuous: (..., 2 * plan_features), the mean and the pre-softplus
  scale of a diagonal Normal, ``std = softplus(var) + 1e-4`` (``:53-101``).

Detaching the raw state detaches the distribution. The noise of ``sample``
and ``rsample`` (Gumbel for discrete plans, standard normal for continuous
ones) can be handed in, so a test feeds both frameworks the same draws;
otherwise it comes from the given generator.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from hulc2_torch.parallel.batch_shard import draw_rows


def _need_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("sampling needs either the noise or a generator")
    return generator


class DiscretePlanDistribution:
    def __init__(self, category_size: int, class_size: int):
        self.category_size = category_size
        self.class_size = class_size

    @property
    def plan_features(self) -> int:
        """Width of a flattened plan and of the logits that parametrise it."""
        return self.category_size * self.class_size

    @property
    def state_dim(self) -> int:
        return self.plan_features

    def noise_shape(self, batch: int) -> Tuple[int, ...]:
        return (batch, self.category_size, self.class_size)

    def _logits(self, logits: torch.Tensor) -> torch.Tensor:
        return logits.reshape(*logits.shape[:-1], self.category_size, self.class_size)

    def gumbel(self, shape, generator: torch.Generator, device) -> torch.Tensor:
        """Standard Gumbel noise of ``shape`` (..., categories, classes)."""
        u = draw_rows(lambda s: torch.rand(s, generator=generator, device=device), shape, device)
        u = u.clamp(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def _one_hot(self, lg: torch.Tensor, gumbel: Optional[torch.Tensor],
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        """One-hot category per row of ``lg`` (..., categories, classes), drawn
        as argmax(logits + Gumbel noise) (``jax.random.categorical``)."""
        if gumbel is None:
            gumbel = self.gumbel(lg.shape, _need_generator(generator), lg.device)
        idx = torch.argmax(lg + gumbel.reshape(lg.shape), dim=-1)
        return F.one_hot(idx, self.class_size).to(lg.dtype)

    def sample(self, logits: torch.Tensor, gumbel: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Non-reparameterized one-hot sample, flattened."""
        one_hot = self._one_hot(self._logits(logits), gumbel, generator)
        return one_hot.reshape(*one_hot.shape[:-2], -1)

    def rsample(self, logits: torch.Tensor, gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Straight-through sample ``one_hot + probs - probs.detach()``, flattened."""
        lg = self._logits(logits)
        one_hot = self._one_hot(lg, gumbel, generator)
        probs = torch.softmax(lg, dim=-1)
        st = one_hot + probs - probs.detach()
        return st.reshape(*st.shape[:-2], -1)

    def kl_divergence(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """KL(p || q) summed over categories -> batch shape."""
        lp = torch.log_softmax(self._logits(p), dim=-1)
        lq = torch.log_softmax(self._logits(q), dim=-1)
        return (torch.exp(lp) * (lp - lq)).sum(dim=-1).sum(dim=-1)


class ContinuousPlanDistribution:
    """Diagonal Normal plans of ``plan_features`` dims."""

    def __init__(self, plan_features: int):
        self.plan_features = plan_features

    @property
    def state_dim(self) -> int:
        return 2 * self.plan_features

    def noise_shape(self, batch: int) -> Tuple[int, ...]:
        return (batch, self.plan_features)

    @staticmethod
    def mean_std(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, var = state.chunk(2, dim=-1)
        return mean, F.softplus(var) + 1e-4

    def sample(self, state: torch.Tensor, normal: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``mean + std * eps``, eps standard normal; differentiable, so
        ``sample`` and ``rsample`` are one function as in the JAX package."""
        mean, std = self.mean_std(state)
        if normal is None:
            g = _need_generator(generator)
            normal = draw_rows(lambda s: torch.randn(s, generator=g, device=mean.device,
                                                     dtype=mean.dtype), mean.shape, mean.device)
        return mean + std * normal.reshape(mean.shape).to(mean.dtype)

    rsample = sample

    def kl_divergence(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Closed-form KL(p || q) of two diagonal Normals, summed over dims."""
        mp, sp = self.mean_std(p)
        mq, sq = self.mean_std(q)
        kl = 0.5 * ((sp ** 2 + (mp - mq) ** 2) / sq ** 2 - 1.0) + torch.log(sq / sp)
        return kl.sum(dim=-1)


def make_distribution(d_cfg: dict):
    """``model.distribution`` -> the port's distribution (``build.py:128``)."""
    if d_cfg["dist"] == "discrete":
        return DiscretePlanDistribution(d_cfg["category_size"], d_cfg["class_size"])
    if d_cfg["dist"] == "continuous":
        return ContinuousPlanDistribution(d_cfg["plan_features"])
    raise ValueError(f"unknown plan distribution {d_cfg['dist']!r}")
