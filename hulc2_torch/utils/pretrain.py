"""Partial initialisation from pretrained weights (``hulc2_tpu/utils/pretrain.py``).

``merge_pretrained_params`` loads a pretrained ``state_dict`` into a freshly
initialised one: an entry of the same shape is taken as it is; an entry whose
name contains ``position_embeddings`` and whose first axis is longer is cut
to the new length (a policy trained on longer windows); anything else keeps
its initial value, with a warning. ``get_portion_of_batch_ids`` is the
evenly spread subset of a batch's rows.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)


def merge_pretrained_params(init: Dict[str, torch.Tensor],
                            pretrained: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A new state_dict: ``init``'s entries, each replaced by ``pretrained``'s
    of the same name where it fits (module docstring), in ``init``'s dtype
    and device."""
    out: Dict[str, torch.Tensor] = {}
    n_loaded = n_kept = 0
    for key, leaf in init.items():
        cand = pretrained.get(key)
        if cand is not None:
            cand = torch.as_tensor(cand)
            if tuple(cand.shape) == tuple(leaf.shape):
                out[key] = cand.to(dtype=leaf.dtype, device=leaf.device).clone()
                n_loaded += 1
                continue
            if ("position_embeddings" in key and cand.ndim == leaf.ndim and cand.ndim > 0
                    and cand.shape[1:] == leaf.shape[1:] and cand.shape[0] >= leaf.shape[0]):
                out[key] = cand[:leaf.shape[0]].to(dtype=leaf.dtype, device=leaf.device).clone()
                logger.info("truncated %s %s -> %s", key, tuple(cand.shape), tuple(leaf.shape))
                n_loaded += 1
                continue
            logger.warning("shape mismatch for %s: %s vs %s, keeping init", key,
                           tuple(cand.shape), tuple(leaf.shape))
        n_kept += 1
        out[key] = leaf
    logger.info("pretrained init: %d entries loaded, %d kept from init", n_loaded, n_kept)
    return out


def get_portion_of_batch_ids(percentage: float, batch_size: int) -> np.ndarray:
    """An evenly spread subset of ``range(batch_size)``: 0.5 of 8 is [0, 2, 4, 6]."""
    if percentage <= 0:
        return np.array([], dtype=int)
    if percentage >= 1:
        return np.arange(batch_size)
    return np.unique(np.arange(0, batch_size, 1.0 / percentage).astype(int))
