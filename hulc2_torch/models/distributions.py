"""Discrete latent plans: straight-through one-hot categorical (``models/distributions.py``).

A plan state is the raw fp32 logits, (..., category_size * class_size). The
Gumbel noise of ``sample`` and ``rsample`` can be handed in, so a test feeds
both frameworks the same draws; otherwise it comes from the given generator.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


class DiscretePlanDistribution:
    def __init__(self, category_size: int, class_size: int):
        self.category_size = category_size
        self.class_size = class_size

    @property
    def plan_features(self) -> int:
        """Width of a flattened plan and of the logits that parametrise it."""
        return self.category_size * self.class_size

    def _logits(self, logits: torch.Tensor) -> torch.Tensor:
        return logits.reshape(*logits.shape[:-1], self.category_size, self.class_size)

    def gumbel(self, shape, generator: torch.Generator, device) -> torch.Tensor:
        """Standard Gumbel noise of ``shape`` (..., categories, classes)."""
        u = torch.rand(shape, generator=generator, device=device)
        u = u.clamp(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def _one_hot(self, lg: torch.Tensor, gumbel: Optional[torch.Tensor],
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        """One-hot category per row of ``lg`` (..., categories, classes), drawn
        as argmax(logits + Gumbel noise) (``jax.random.categorical``)."""
        if gumbel is None:
            if generator is None:
                raise ValueError("sampling needs either gumbel noise or a generator")
            gumbel = self.gumbel(lg.shape, generator, lg.device)
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
