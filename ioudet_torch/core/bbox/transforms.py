"""Box <-> regression-delta transforms and result formatting (counterpart of
``ioudet/core/bbox/transforms.py``).

Same numerics as the reference, including the v1 "+1 pixel" width/height
convention (``w = x2 - x1 + 1``) and the ``wh_ratio_clip`` clamp.  Means and
stds stay Python floats, so no constant tensor is copied to the device.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
               stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode gt boxes as (dx, dy, dw, dh) deltas relative to proposals.

    proposals, gt: (..., 4) xyxy.  Returns (..., 4) normalized deltas.
    """
    proposals = proposals.float()
    gt = gt.float()
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0] + 1.0
    ph = proposals[..., 3] - proposals[..., 1] + 1.0

    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0

    deltas = ((gx - px) / pw, (gy - py) / ph,
              torch.log(gw / pw), torch.log(gh / ph))
    return torch.stack([(d - m) / s for d, m, s in zip(deltas, means, stds)],
                       dim=-1)


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
               stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
               max_shape: Optional[Tuple[int, int]] = None,
               wh_ratio_clip: float = 16.0 / 1000.0) -> torch.Tensor:
    """Decode deltas on top of anchor/proposal boxes.

    rois: (..., 4) xyxy anchors; deltas: (..., 4*k), k class-agnostic groups
    (RetinaNet uses k=1).  ``max_shape`` is the (H, W) to clamp into; the
    clamp is to ``[0, size - 1]``.
    """
    rois = rois.float()
    deltas = deltas.float()
    k = deltas.shape[-1] // 4
    d = deltas.reshape(deltas.shape[:-1] + (k, 4))
    dx = d[..., 0] * stds[0] + means[0]
    dy = d[..., 1] * stds[1] + means[1]
    dw = d[..., 2] * stds[2] + means[2]
    dh = d[..., 3] * stds[3] + means[3]
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)

    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0] + 1.0)[..., None]
    ph = (rois[..., 3] - rois[..., 1] + 1.0)[..., None]

    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy

    x1 = gx - gw * 0.5 + 0.5
    y1 = gy - gh * 0.5 + 0.5
    x2 = gx + gw * 0.5 - 0.5
    y2 = gy + gh * 0.5 - 0.5
    if max_shape is not None:
        x1 = x1.clamp(0, max_shape[1] - 1)
        y1 = y1.clamp(0, max_shape[0] - 1)
        x2 = x2.clamp(0, max_shape[1] - 1)
        y2 = y2.clamp(0, max_shape[0] - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(deltas.shape)


def bbox_flip(bboxes: torch.Tensor, img_shape) -> torch.Tensor:
    """Mirror (..., 4 + extra) boxes in a (H, W) image: x1' = w - x2 - 1,
    x2' = w - x1 - 1; trailing columns (scores) ride along."""
    w = img_shape[1]
    flipped = torch.stack([w - bboxes[..., 2] - 1, bboxes[..., 1],
                           w - bboxes[..., 0] - 1, bboxes[..., 3]], dim=-1)
    return torch.cat([flipped, bboxes[..., 4:]], dim=-1)


def bbox_mapping(bboxes: torch.Tensor, img_shape, scale_factor, flip: bool) -> torch.Tensor:
    """Original-image boxes -> a view's (scaled, maybe flipped) boxes."""
    new = bboxes * scale_factor
    return bbox_flip(new, img_shape) if flip else new


def bbox_mapping_back(bboxes: torch.Tensor, img_shape, scale_factor, flip: bool) -> torch.Tensor:
    """The inverse of ``bbox_mapping``, used to merge test-time views.  Pass
    ``scale_factor`` as a tensor: on the card, division by a Python float
    multiplies by its reciprocal, which is not ``ioudet``'s quotient."""
    new = bbox_flip(bboxes, img_shape) if flip else bboxes
    return new / scale_factor


def distance2bbox(points: torch.Tensor, distance: torch.Tensor,
                  max_shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Decode (left, top, right, bottom) distances around points (FCOS's
    form): points (..., 2) as (x, y), distance (..., 4) -> (..., 4) xyxy,
    clamped to ``[0, size - 1]`` of the (H, W) ``max_shape`` when given."""
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    if max_shape is not None:
        x1, x2 = x1.clamp(0, max_shape[1] - 1), x2.clamp(0, max_shape[1] - 1)
        y1, y2 = y1.clamp(0, max_shape[0] - 1), y2.clamp(0, max_shape[0] - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox2result(bboxes, labels, num_classes: int) -> List[np.ndarray]:
    """(N, 5) dets + 0-based labels -> the reference's per-class list of
    ``num_classes - 1`` float32 (k, 5) numpy arrays.

    Rows with label < 0 (fixed-shape padding) are dropped here: this is where
    the fixed-shape device result meets the variable-length host API, so it
    copies to the host.
    """
    if isinstance(bboxes, torch.Tensor):
        bboxes = bboxes.cpu().numpy()
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    keep = labels >= 0
    bboxes, labels = bboxes[keep], labels[keep]
    return [bboxes[labels == i].astype(np.float32)
            for i in range(num_classes - 1)]
