"""Sigmoid focal loss (counterpart of ``ioudet/models/losses/focal_loss.py``).

  loss = FW * BCE(pred, target),
  FW   = (alpha*t + (1 - alpha)*(1 - t)) * pt**gamma,
  pt   = (1 - p)*t + p*(1 - t).

``sigmoid_focal_loss_with_logits`` is the elementwise form in plain torch,
differentiated by autograd.  ``fused_level_focal_sum`` is the train path's
form: the weighted sum over one FPN level's conv output, consumed where the
convolution wrote it, through the hand-written kernels of
``ioudet_torch/ops/focal_cuda.py`` on a CUDA device and their plain versions
on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.focal_cuda import FusedLevelFocalSum
from .utils import weight_reduce_loss


def sigmoid_focal_loss_with_logits(pred: torch.Tensor, target: torch.Tensor,
                                   gamma: float = 2.0,
                                   alpha: float = 0.25) -> torch.Tensor:
    """Elementwise focal loss; ``target`` is {0, 1}, the same shape as ``pred``."""
    pred, target = pred.float(), target.float()
    p = torch.sigmoid(pred)
    pt = (1.0 - p) * target + p * (1.0 - target)
    focal_weight = (alpha * target + (1.0 - alpha) * (1.0 - target)) * pt ** gamma
    bce = F.softplus(pred) - pred * target  # = max(x, 0) - x*t + log1p(exp(-|x|))
    return bce * focal_weight


def fused_level_focal_sum(logits: torch.Tensor, labels: torch.Tensor,
                          lw: torch.Tensor, gamma: float, alpha: float,
                          num_anchors: int) -> torch.Tensor:
    """Weighted focal-loss sum over one FPN level's conv output.

    logits (B, H, W, A*C), any float type and strides (f32 math inside);
    labels (B, H*W*A) int32, 0 = background / 1..C foreground; lw (B, H*W*A)
    f32 weights.  The one-hot target is rebuilt from the labels in the
    forward and in the backward pass, so neither the target, the per-element
    loss nor the weight broadcast exists in device memory; what is kept for
    the backward pass is the inputs.  The gradient flows to the logits only.
    """
    return FusedLevelFocalSum.apply(logits, labels, lw, gamma, alpha, num_anchors)


def sigmoid_focal_loss(pred: torch.Tensor, labels: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       gamma: float = 2.0, alpha: float = 0.25,
                       reduction: str = "mean", avg_factor=None) -> torch.Tensor:
    """Integer-label form: pred (N, C) logits over C foreground classes;
    labels (N,) with 0 = background and 1..C = foreground; per-sample
    ``weight`` (N,) broadcast over the classes."""
    classes = torch.arange(1, pred.shape[-1] + 1, device=labels.device)
    onehot = (labels[..., None] == classes).to(pred.dtype)
    loss = sigmoid_focal_loss_with_logits(pred, onehot, gamma=gamma, alpha=alpha)
    if weight is not None and weight.dim() == loss.dim() - 1:
        weight = weight[..., None]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


class FocalLoss(nn.Module):
    def __init__(self, use_sigmoid: bool = True, gamma: float = 2.0,
                 alpha: float = 0.25, reduction: str = "mean",
                 loss_weight: float = 1.0):
        super().__init__()
        if not use_sigmoid:
            raise NotImplementedError("softmax focal loss is not supported")
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * sigmoid_focal_loss(
            pred, target, weight, gamma=self.gamma, alpha=self.alpha,
            reduction=reduction, avg_factor=avg_factor)
