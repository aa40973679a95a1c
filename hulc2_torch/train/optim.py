"""Optimizer factory (``hulc2_tpu/train/optim.py``): Adam with torch's defaults,
betas (0.9, 0.999) and eps 1e-8, the same update as ``optax.adam``. Only the
constant learning rate of the flagship is ported."""
from __future__ import annotations

from typing import Optional

import torch


def make_optimizer(params, opt_cfg: dict, sched_cfg: Optional[dict] = None) -> torch.optim.Optimizer:
    if opt_cfg.get("kind", "adam") != "adam" or opt_cfg.get("gradient_clip_norm"):
        raise NotImplementedError("only Adam without gradient clipping is ported")
    if (sched_cfg or {}).get("kind", "constant") != "constant":
        raise NotImplementedError("only the constant learning rate is ported")
    return torch.optim.Adam(params, lr=opt_cfg.get("lr", 2e-4), betas=(0.9, 0.999), eps=1e-8)
