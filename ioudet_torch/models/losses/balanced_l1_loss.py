"""Balanced L1 (counterpart of ``ioudet/models/losses/balanced_l1_loss.py``;
Libra R-CNN's box loss).

Below ``beta`` the loss is ``alpha / b * (b |d| + beta) * log(b |d| / beta +
1) - alpha |d|``, above it ``gamma |d| + gamma / b - alpha * beta``, with
``b = e^(gamma / alpha) - 1`` so that the two pieces and their slopes meet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .utils import weighted_loss


@weighted_loss
def balanced_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0,
                     alpha: float = 0.5, gamma: float = 1.5) -> torch.Tensor:
    diff = (pred.float() - target.float()).abs()
    b = math.e ** (gamma / alpha) - 1.0
    return torch.where(
        diff < beta,
        alpha / b * (b * diff + beta) * torch.log(b * diff / beta + 1.0) - alpha * diff,
        gamma * diff + gamma / b - alpha * beta)


class BalancedL1Loss(nn.Module):
    def __init__(self, alpha: float = 0.5, gamma: float = 1.5, beta: float = 1.0,
                 reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__()
        self.alpha = alpha
        self.gamma = gamma
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None, reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * balanced_l1_loss(
            pred, target, weight, reduction=reduction, avg_factor=avg_factor,
            beta=self.beta, alpha=self.alpha, gamma=self.gamma)
