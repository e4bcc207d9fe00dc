"""Smooth-L1 and L1 (counterpart of ``ioudet/models/losses/smooth_l1_loss.py``).

RetinaNet uses beta = 0.11, normalised by the number of positives through
``avg_factor`` (the sum runs over the 4 coordinates of every positive anchor).
"""

from __future__ import annotations

import torch
from torch import nn

from .utils import weighted_loss


@weighted_loss
def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0) -> torch.Tensor:
    diff = (pred.float() - target.float()).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


@weighted_loss
def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs()


class SmoothL1Loss(nn.Module):
    def __init__(self, beta: float = 1.0, reduction: str = "mean",
                 loss_weight: float = 1.0):
        super().__init__()
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * smooth_l1_loss(
            pred, target, weight, reduction=reduction, avg_factor=avg_factor,
            beta=self.beta)


class L1Loss(nn.Module):
    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__()
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * l1_loss(
            pred, target, weight, reduction=reduction, avg_factor=avg_factor)
