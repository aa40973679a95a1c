"""Affordance segmentation losses and metrics (``hulc2_tpu/affordance/losses.py:15-67``).

The mask-label detector's objective: the target is a binary interaction
mask, not one pixel. Plain tensor functions, the same on the CPU and the
card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_cross_entropy(logits_flat: torch.Tensor, target_flat: torch.Tensor) -> torch.Tensor:
    """Softmax-over-pixels CE with a (possibly soft) target distribution;
    logits and target (B, H*W)."""
    logp = F.log_softmax(logits_flat, dim=-1)
    target = target_flat / torch.clamp(target_flat.sum(dim=-1, keepdim=True), min=1e-9)
    return -(target * logp).sum(dim=-1).mean()


def binary_mask_bce(logits: torch.Tensor, mask: torch.Tensor, pos_weight: float = 1.0) -> torch.Tensor:
    """Per-pixel sigmoid BCE, ``softplus(z) - z * mask``, positives weighted
    by ``pos_weight``; logits and mask (B, H, W) or flat."""
    loss = F.softplus(logits) - logits * mask
    if pos_weight != 1.0:
        loss = torch.where(mask > 0.5, pos_weight * loss, loss)
    return loss.mean()


def dice_loss(logits: torch.Tensor, mask: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """Soft dice over the sigmoid probabilities, per sample, averaged."""
    p = torch.sigmoid(logits).reshape(logits.shape[0], -1)
    m = mask.reshape(mask.shape[0], -1)
    inter = (p * m).sum(dim=-1)
    denom = p.sum(dim=-1) + m.sum(dim=-1)
    return (1.0 - (2.0 * inter + eps) / (denom + eps)).mean()


def miou(pred_mask: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean IoU of the masks thresholded at 0.5 (an empty union counts 0)."""
    p = pred_mask.reshape(pred_mask.shape[0], -1) > 0.5
    m = mask.reshape(mask.shape[0], -1) > 0.5
    inter = (p & m).sum(dim=-1)
    union = (p | m).sum(dim=-1)
    return (inter / torch.clamp(union, min=1)).mean()


def mask_criterion(logits_flat: torch.Tensor, mask: torch.Tensor, dice_weight: float = 0.5):
    """(1 - dice_weight) * BCE + dice_weight * dice of the (B, H*W) logits
    against the (B, H, W) mask -> (loss, {mask_bce, dice_loss, miou})."""
    logits = logits_flat.reshape(logits_flat.shape[0], *mask.shape[1:])
    bce = binary_mask_bce(logits, mask)
    dice = dice_loss(logits, mask)
    loss = (1 - dice_weight) * bce + dice_weight * dice
    return loss, {"mask_bce": bce, "dice_loss": dice, "miou": miou(torch.sigmoid(logits), mask)}
