"""IoU-based box regression losses (counterpart of
``ioudet/models/losses/iou_loss.py``; mmdet's ``iou_loss``,
``bounded_iou_loss``, ``IoULoss``, ``BoundedIoULoss``, and GIoU as
``ioudet`` adds it).

They take decoded xyxy boxes and keep the v1 "+1 pixel" convention of
``bbox_overlaps``.  A weight with the boxes' 4 coordinates is averaged over
them first, as in ``ioudet``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.bbox.geometry import bbox_overlaps
from .utils import weighted_loss


@weighted_loss
def iou_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """-log(IoU), the IoU floored at ``eps``."""
    return -torch.log(bbox_overlaps(pred, target, is_aligned=True).clamp(min=eps))


@weighted_loss
def bounded_iou_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 0.2,
                     eps: float = 1e-3) -> torch.Tensor:
    """Smooth-L1 (``beta``) of the four per-coordinate IoU bounds of the
    centre offsets and the size ratios."""
    pred, target = pred.float(), target.float()
    px = (pred[..., 0] + pred[..., 2]) * 0.5
    py = (pred[..., 1] + pred[..., 3]) * 0.5
    pw = pred[..., 2] - pred[..., 0] + 1.0
    ph = pred[..., 3] - pred[..., 1] + 1.0
    tx = (target[..., 0] + target[..., 2]) * 0.5
    ty = (target[..., 1] + target[..., 3]) * 0.5
    tw = target[..., 2] - target[..., 0] + 1.0
    th = target[..., 3] - target[..., 1] + 1.0
    dx, dy = tx - px, ty - py
    loss_dx = 1.0 - ((tw - 2.0 * dx.abs()) / (tw + 2.0 * dx.abs())).clamp(min=0.0)
    loss_dy = 1.0 - ((th - 2.0 * dy.abs()) / (th + 2.0 * dy.abs())).clamp(min=0.0)
    loss_dw = 1.0 - torch.minimum(tw / pw.clamp(min=eps), pw / tw.clamp(min=eps))
    loss_dh = 1.0 - torch.minimum(th / ph.clamp(min=eps), ph / th.clamp(min=eps))
    comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
    return torch.where(comb < beta, 0.5 * comb * comb / beta, comb - 0.5 * beta)


@weighted_loss
def giou_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """1 - GIoU; the intersection is recovered from the IoU as ``ioudet``
    recovers it, inter = IoU * (A + B) / (1 + IoU)."""
    pred, target = pred.float(), target.float()
    ious = bbox_overlaps(pred, target, is_aligned=True)
    lt = torch.minimum(pred[..., :2], target[..., :2])
    rb = torch.maximum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt + 1.0).clamp(min=0.0)
    enclose = wh[..., 0] * wh[..., 1]
    area_p = (pred[..., 2] - pred[..., 0] + 1.0) * (pred[..., 3] - pred[..., 1] + 1.0)
    area_t = (target[..., 2] - target[..., 0] + 1.0) * (target[..., 3] - target[..., 1] + 1.0)
    inter = ious * (area_p + area_t) / (1.0 + ious)
    union = area_p + area_t - inter
    return 1.0 - (ious - (enclose - union) / enclose.clamp(min=eps))


def _box_weight(weight, pred):
    """A (..., 4) weight averaged over the coordinates (``ioudet``'s rule)."""
    if weight is not None and weight.dim() == pred.dim():
        weight = weight.mean(dim=-1)
    return weight


class IoULoss(nn.Module):
    def __init__(self, eps: float = 1e-6, reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__()
        self.eps, self.reduction, self.loss_weight = eps, reduction, loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None, reduction_override=None):
        return self.loss_weight * iou_loss(
            pred, target, _box_weight(weight, pred), reduction=reduction_override or
            self.reduction, avg_factor=avg_factor, eps=self.eps)


class BoundedIoULoss(nn.Module):
    def __init__(self, beta: float = 0.2, eps: float = 1e-3, reduction: str = "mean",
                 loss_weight: float = 1.0):
        super().__init__()
        self.beta, self.eps = beta, eps
        self.reduction, self.loss_weight = reduction, loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None, reduction_override=None):
        return self.loss_weight * bounded_iou_loss(
            pred, target, _box_weight(weight, pred), reduction=reduction_override or
            self.reduction, avg_factor=avg_factor, beta=self.beta, eps=self.eps)


class GIoULoss(nn.Module):
    def __init__(self, eps: float = 1e-7, reduction: str = "mean", loss_weight: float = 1.0):
        super().__init__()
        self.eps, self.reduction, self.loss_weight = eps, reduction, loss_weight

    def forward(self, pred, target, weight=None, avg_factor=None, reduction_override=None):
        return self.loss_weight * giou_loss(
            pred, target, _box_weight(weight, pred), reduction=reduction_override or
            self.reduction, avg_factor=avg_factor, eps=self.eps)
