"""Discretized logistic mixture: log-likelihood and sampler (``ops/logistic.py:17, :82``).

Params are (..., A, K) for A action dims and K components; targets (..., A).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def logistic_mixture_log_prob(logit_probs: torch.Tensor, log_scales: torch.Tensor,
                              means: torch.Tensor, targets: torch.Tensor,
                              act_min: torch.Tensor, act_max: torch.Tensor,
                              num_classes: int, log_scale_min: float = -7.0) -> torch.Tensor:
    """Per-dim log p(target) under a mixture discretized into ``num_classes``
    bins over [act_min, act_max], edge bins integrating the open tails.
    ``act_min``/``act_max`` broadcast against (..., A, K). Returns (..., A)."""
    log_scales = log_scales.clamp(min=log_scale_min)
    x = targets[..., None]
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    half_bin = (act_max - act_min) / 2.0 / (num_classes - 1)

    plus_in = inv_stdv * (centered + half_bin)
    min_in = inv_stdv * (centered - half_bin)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)  # left tail bin
    log_one_minus_cdf_min = -F.softplus(min_in)  # right tail bin
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)

    inner = torch.where(
        cdf_delta > 1e-5,
        torch.log(cdf_delta.clamp(min=1e-12)),
        log_pdf_mid - math.log((num_classes - 1) / 2.0),
    )
    log_probs = torch.where(
        x < act_min + 1e-3, log_cdf_plus,
        torch.where(x > act_max - 1e-3, log_one_minus_cdf_min, inner),
    )
    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    return torch.logsumexp(log_probs, dim=-1)


_U_LO, _U_HI = 1e-5, 1.0 - 1e-5  # the sampler's uniforms (logistic_decoder_rnn.py:235-249)


def _mixture_uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniforms in [1e-5, 1 - 1e-5), the range the sampler draws from."""
    if generator is None:
        raise ValueError("the sampler needs injected uniforms or a generator")
    u = torch.rand(shape, generator=generator, device=device)
    return _U_LO + (_U_HI - _U_LO) * u


def logistic_mixture_sample(logit_probs: torch.Tensor, log_scales: torch.Tensor,
                            means: torch.Tensor, u_sel: Optional[torch.Tensor] = None,
                            u: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Actions (..., A) sampled from the mixture: Gumbel-max over the K
    components with uniforms ``u_sel`` (..., A, K), then inversion sampling of
    the chosen logistic with uniforms ``u`` (..., A). Either may be handed in;
    what is not comes from ``generator``."""
    if u_sel is None:
        u_sel = _mixture_uniform(logit_probs.shape, generator, logit_probs.device)
    gumbel = logit_probs - torch.log(-torch.log(u_sel))
    sel = F.one_hot(torch.argmax(gumbel, dim=-1), logit_probs.shape[-1]).to(means.dtype)
    log_scale = (sel * log_scales).sum(dim=-1)
    mean = (sel * means).sum(dim=-1)
    if u is None:
        u = _mixture_uniform(mean.shape, generator, mean.device)
    return mean + torch.exp(log_scale) * (torch.log(u) - torch.log(1.0 - u))
