"""Losses for the DL subsystems.

The port of the JAX package's ``models/losses.py`` (reference:
cbctmc/segmentation/losses.py, cbctmc/speedup/trainer.py:411-447). The
tensors are channels first ([B, C, *spatial]); the reductions run over the
spatial axes, as the channels-last JAX code's do.
"""

from __future__ import annotations

import torch


def dice_loss(probs: torch.Tensor, targets: torch.Tensor, smooth: float = 1e-5) -> torch.Tensor:
    """Soft Dice loss averaged over batch and channels; inputs [B, C,
    *spatial] with probabilities and binary targets."""
    axes = tuple(range(2, probs.ndim))
    intersection = torch.sum(probs * targets, dim=axes)
    denom = torch.sum(probs, dim=axes) + torch.sum(targets, dim=axes)
    dice = (2.0 * intersection + smooth) / (denom + smooth)
    return 1.0 - dice.mean()


def segmentation_loss(logits: torch.Tensor, targets: torch.Tensor,
                      n_softmax: int = 8) -> torch.Tensor:
    """Dice on the softmax tissue group + Dice on the sigmoid vessel
    channel (the reference trains with a MONAI-style DiceLoss on both
    groups, segmentation/losses.py:10)."""
    probs_soft = torch.softmax(logits[:, :n_softmax], dim=1)
    probs_sig = torch.sigmoid(logits[:, n_softmax:])
    return dice_loss(probs_soft, targets[:, :n_softmax]) + dice_loss(
        probs_sig, targets[:, n_softmax:]
    )


def l1_loss(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(prediction - target).mean()


def gaussian_nll_loss(mean: torch.Tensor, variance: torch.Tensor, target: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Negative log likelihood of target under Normal(mean, variance) —
    trains the speedup model's variance head."""
    variance = torch.clamp_min(variance, eps)
    return 0.5 * (torch.log(variance) + (target - mean) ** 2 / variance).mean()
