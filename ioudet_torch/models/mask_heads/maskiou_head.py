"""Mask-IoU head (counterpart of ``ioudet/models/mask_heads/maskiou_head.py``,
mmdet's ``MaskIoUHead`` of Mask Scoring R-CNN): it predicts, for every
class, the IoU of a roi's predicted mask with its gt, and the detector
rescales the detection scores by it at test time.

The input is the mask branch's RoI feature (R, C, 14, 14) with the roi's
class mask (probabilities, (R, 28, 28)) max-pooled 2x2 and concatenated
after the channels; then ``num_convs`` 3x3 convs + ReLU (the last at stride
2), ``num_fcs`` FCs + ReLU and ``fc_mask_iou`` to ``num_classes - 1`` IoUs.
NCHW; parameters under mmdet's names (``convs.{i}``, ``fcs.{i}``,
``fc_mask_iou``).  ``fcs.0`` takes the (C, 7, 7) flatten; the bridge
permutes ``ioudet``'s (7, 7, C) rows to it.

The target (``mask_iou_target_ref``) is mmdet's area-ratio rule in the roi's
raster, and the loss an L2 on each positive roi's own class channel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import global_count
from ..utils.layers import Conv2d, Linear, compute_dtype


def _area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * (boxes[:, 3] - boxes[:, 1]).clamp(min=0)


class MaskIoUHead(nn.Module):
    def __init__(self, num_convs: int = 4, num_fcs: int = 2, in_channels: int = 256,
                 conv_out_channels: int = 256, fc_out_channels: int = 1024,
                 num_classes: int = 81, roi_feat_size: int = 14, dtype=None):
        super().__init__()
        dt = compute_dtype(dtype)
        self.num_classes = num_classes
        chans = [in_channels + 1] + [conv_out_channels] * num_convs
        self.convs = nn.ModuleList([
            Conv2d(chans[i], chans[i + 1], 3, stride=2 if i == num_convs - 1 else 1,
                   padding=1, compute_dtype=dt) for i in range(num_convs)])
        side = (roi_feat_size + 1) // 2 if num_convs else roi_feat_size
        fc_in = [chans[-1] * side * side] + [fc_out_channels] * num_fcs
        self.fcs = nn.ModuleList([Linear(fc_in[i], fc_in[i + 1], compute_dtype=dt)
                                  for i in range(num_fcs)])
        self.fc_mask_iou = Linear(fc_in[-1], num_classes - 1, compute_dtype=dt)

    def init_weights(self, generator: torch.Generator) -> None:
        """``ioudet``'s initializers: N(0, 0.01) for the convs, LeCun normal
        (flax's ``Dense``) for the FCs; zero biases."""
        with torch.no_grad():
            for conv in self.convs:
                conv.weight.normal_(0.0, 0.01, generator=generator)
                conv.bias.zero_()
            for fc in list(self.fcs) + [self.fc_mask_iou]:
                fc.weight.normal_(0.0, fc.in_features ** -0.5, generator=generator)
                fc.bias.zero_()

    def forward(self, mask_feat: torch.Tensor, mask_pred: torch.Tensor) -> torch.Tensor:
        """mask_feat (R, C, 14, 14); mask_pred (R, 28, 28) probabilities of
        each roi's class -> (R, num_classes - 1) IoUs."""
        pooled = F.max_pool2d(mask_pred[:, None].to(mask_feat.dtype), 2, 2)
        x = torch.cat([mask_feat, pooled], dim=1)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.flatten(1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        return self.fc_mask_iou(x)

    @staticmethod
    def mask_iou_target_ref(mask_pred: torch.Tensor, mask_targets: torch.Tensor,
                            roi_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                            gt_crop_fracs: torch.Tensor, thr: float = 0.5) -> torch.Tensor:
        """mmdet's target (``get_target``, ``_get_area_ratio``): the IoU of the
        binarized prediction with the gt, whose area is the whole gt mask's
        (the in-roi target's sum over the area ratio), so that a roi over
        half of an object cannot score 1 against its own crop.

        mask_pred / mask_targets (R, S, S); roi_boxes / gt_boxes (R, 4) xyxy;
        gt_crop_fracs (R,), the mean of the matched gt's box-frame crop: the
        gt's mask area is that fraction of its box's (exact for box-frame
        crops).  A gt of no area has target 0."""
        p = (mask_pred > thr).float()
        t = mask_targets.float()
        s2 = mask_pred.shape[1] * mask_pred.shape[2]
        pred_areas = p.sum(dim=(1, 2))
        overlap = (p * t).sum(dim=(1, 2))
        t_sum = t.sum(dim=(1, 2))
        gt_in_roi_px = t_sum / s2 * _area(roi_boxes)
        gt_full_px = gt_crop_fracs * _area(gt_boxes)
        area_ratio = (gt_in_roi_px / gt_full_px.clamp(min=1e-7)).clamp(1e-7, 1.0)
        gt_full_grid = t_sum / area_ratio
        iou = overlap / (pred_areas + gt_full_grid - overlap).clamp(min=1e-7)
        return torch.where(gt_full_px > 0, iou.clamp(0.0, 1.0), 0.0)

    @staticmethod
    def loss(iou_pred: torch.Tensor, iou_target: torch.Tensor, labels: torch.Tensor,
             pos_mask: torch.Tensor) -> torch.Tensor:
        """Half the squared error of each positive roi's own class channel
        (labels 1-based) against its target, over the positive count (the
        global batch's in a process group, at least 1)."""
        safe = (labels.long() - 1).clamp(0, iou_pred.shape[-1] - 1)
        d = torch.gather(iou_pred.float(), 1, safe[:, None])[:, 0] - iou_target
        pos = pos_mask.float()
        return 0.5 * (d * d * pos).sum() / global_count(pos.sum()).clamp(min=1.0)
