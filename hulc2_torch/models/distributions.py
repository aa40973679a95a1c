"""Discrete latent plans: straight-through one-hot categorical (``models/distributions.py``).

A plan state is the raw fp32 logits, (..., category_size * class_size). The
Gumbel noise of ``rsample`` can be handed in, so a test feeds both frameworks
the same draws; otherwise it comes from the given generator.
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

    def rsample(self, logits: torch.Tensor, gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Straight-through sample ``one_hot + probs - probs.detach()``, with
        the category drawn as argmax(logits + Gumbel noise), flattened."""
        lg = self._logits(logits)
        if gumbel is None:
            if generator is None:
                raise ValueError("rsample needs either gumbel noise or a generator")
            gumbel = self.gumbel(lg.shape, generator, lg.device)
        idx = torch.argmax(lg + gumbel.reshape(lg.shape), dim=-1)
        one_hot = F.one_hot(idx, self.class_size).to(lg.dtype)
        probs = torch.softmax(lg, dim=-1)
        st = one_hot + probs - probs.detach()
        return st.reshape(*st.shape[:-2], -1)

    def kl_divergence(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """KL(p || q) summed over categories -> batch shape."""
        lp = torch.log_softmax(self._logits(p), dim=-1)
        lq = torch.log_softmax(self._logits(q), dim=-1)
        return (torch.exp(lp) * (lp - lq)).sum(dim=-1).sum(dim=-1)
