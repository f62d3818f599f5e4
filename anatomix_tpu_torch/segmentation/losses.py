"""Segmentation losses: Dice and DiceCE with MONAI-default semantics (the
port of `anatomix_tpu/segmentation/losses.py`).

As `monai.losses.DiceCELoss(softmax=True, to_onehot_y=True,
include_background=False)` and `DiceLoss(...)` are used by the reference:
softmax over channel logits, one-hot targets, background channel excluded,
smooth_nr = smooth_dr = 1e-5, the mean over batch and classes; DiceCE adds
an unweighted cross-entropy term (mean over voxels, all classes). Every
term is f32 torch ops, as they are XLA ops in JAX.

Layout: logits (B, D, H, W, C); labels (B, D, H, W) integer (or float
holding integers) or (B, D, H, W, 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _prep(logits: torch.Tensor, labels: torch.Tensor):
    if labels.dim() == logits.dim():
        labels = labels[..., 0]
    return logits.float(), labels.long()


def dice_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    include_background: bool = False,
    smooth_nr: float = 1e-5,
    smooth_dr: float = 1e-5,
) -> torch.Tensor:
    logits, labels = _prep(logits, labels)
    n_classes = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(labels, n_classes).float()
    start = 0 if include_background else 1
    probs = probs[..., start:]
    onehot = onehot[..., start:]
    reduce_dims = (1, 2, 3)
    intersection = (probs * onehot).sum(dim=reduce_dims)
    denom = probs.sum(dim=reduce_dims) + onehot.sum(dim=reduce_dims)
    dice = (2.0 * intersection + smooth_nr) / (denom + smooth_dr)
    return (1.0 - dice).mean()


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    logits, labels = _prep(logits, labels)
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels, logits.shape[-1]).float()
    return -(onehot * logp).sum(dim=-1).mean()


def dice_ce_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    include_background: bool = False,
    lambda_dice: float = 1.0,
    lambda_ce: float = 1.0,
) -> torch.Tensor:
    return lambda_dice * dice_loss(
        logits, labels, include_background=include_background
    ) + lambda_ce * cross_entropy_loss(logits, labels)
