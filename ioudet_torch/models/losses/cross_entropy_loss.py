"""Cross-entropy family (counterpart of
``ioudet/models/losses/cross_entropy_loss.py``).

``binary_cross_entropy_with_logits`` with a float target in [0, 1] is the
training loss of the IoU-prediction branch (positives only, divided by the
number of positives).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .utils import weight_reduce_loss


def cross_entropy(pred, label, weight=None, reduction="mean", avg_factor=None):
    """Softmax cross-entropy over logits (N, C) with int labels (N,)."""
    logp = F.log_softmax(pred.float(), dim=-1)
    loss = -torch.gather(logp, -1, label.long()[..., None])[..., 0]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def binary_cross_entropy_with_logits(pred: torch.Tensor,
                                     target: torch.Tensor) -> torch.Tensor:
    """Stable elementwise BCE over logits; the target may be soft.  The
    softplus form log(1 + exp(-|x|)) + max(x, 0), written so that autograd's
    gradient is sigmoid(x) - target at every x."""
    pred = pred.float()
    return F.softplus(pred) - pred * target.float()


def _expand_binary_labels(labels, weight, channels: int):
    """Int class labels (N,) -> per-channel binary targets (N, C), channel
    ``label - 1`` hot for labels >= 1; weights broadcast across channels."""
    idx = torch.arange(1, channels + 1, device=labels.device)
    one_hot = (labels[:, None] == idx).float()
    if weight is not None and weight.dim() < 2:
        weight = weight[:, None].expand_as(one_hot)
    return one_hot, weight


def binary_cross_entropy(pred, target, weight=None, reduction="mean",
                         avg_factor=None):
    if pred.dim() != target.dim():
        # int labels against (N, C) sigmoid logits
        target, weight = _expand_binary_labels(target, weight, pred.shape[-1])
    loss = binary_cross_entropy_with_logits(pred, target)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


class CrossEntropyLoss(nn.Module):
    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__()
        if use_mask:
            raise NotImplementedError("CrossEntropyLoss(use_mask=True) is not a loss of its "
                                      "own: the mask loss is FCNMaskHead.loss, as in ioudet")
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.loss_weight = loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None,
                reduction_override=None):
        reduction = reduction_override or self.reduction
        fn = binary_cross_entropy if self.use_sigmoid else cross_entropy
        return self.loss_weight * fn(pred, target, weight, reduction=reduction,
                                     avg_factor=avg_factor)
