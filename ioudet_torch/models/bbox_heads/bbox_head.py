"""Second-stage box heads (counterpart of
``ioudet/models/bbox_heads/bbox_head.py``).

``BBoxHead``: (avg-pool or) flatten, then linear ``fc_cls`` (softmax over
the classes, background in column 0) and ``fc_reg`` (class-specific 4 * C
deltas, stds (.1, .1, .2, .2)).  ``ConvFCBBoxHead`` / ``SharedFCBBoxHead``
(Faster R-CNN's): ``shared_convs`` then ``shared_fcs`` (two of 1024 + ReLU)
before the two linears.  The RoI features come NCHW and are flattened
channel-major, as mmdet flattens them, so a mmdet ``.pth`` loads as it is;
``ioudet`` flattens spatial-major, and the weight bridge permutes the first
fc's input (``apis/checkpoint.py``).  The linears compute in the head's
``dtype`` (flax's ``nn.Dense(dtype=...)``): f32 parameters cast per call.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox import bbox2delta
from ..losses import cross_entropy
from ..utils.layers import ConvModule, Linear, compute_dtype


class BBoxHead(nn.Module):
    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 roi_feat_size: int = 7, with_avg_pool: bool = False,
                 reg_class_agnostic: bool = False,
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 cls_loss_weight: float = 1.0, bbox_loss_weight: float = 1.0,
                 loss_bbox: Optional[dict] = None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.roi_feat_size = roi_feat_size
        self.with_avg_pool = with_avg_pool
        self.reg_class_agnostic = reg_class_agnostic
        self.target_means = tuple(float(m) for m in target_means)
        self.target_stds = tuple(float(s) for s in target_stds)
        self.cls_loss_weight = cls_loss_weight
        self.bbox_loss_weight = bbox_loss_weight
        self.dtype = compute_dtype(dtype)
        from ..builder import build_loss  # models/builder.py imports the heads
        self.loss_bbox_fn = build_loss(dict(loss_bbox or dict(type="SmoothL1Loss", beta=1.0)))
        self.build_fcs()

    def build_fcs(self) -> None:
        feat = self.in_channels * (1 if self.with_avg_pool else self.roi_feat_size ** 2)
        self.fc_cls = self.linear(feat, self.num_classes)
        self.fc_reg = self.linear(feat, 4 if self.reg_class_agnostic else 4 * self.num_classes)

    def linear(self, cin: int, cout: int) -> Linear:
        return Linear(cin, cout, compute_dtype=self.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.fc_cls.weight.normal_(0.0, 0.01, generator=generator)
            self.fc_reg.weight.normal_(0.0, 0.001, generator=generator)
            self.fc_cls.bias.zero_()
            self.fc_reg.bias.zero_()

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3)) if self.with_avg_pool else x.flatten(1)

    def forward(self, x: torch.Tensor):
        """RoI features (R, C, S, S) -> (cls_score (R, num_classes),
        bbox_pred (R, 4 * num_classes or 4))."""
        feat = self.trunk(x)
        return self.fc_cls(feat), self.fc_reg(feat)

    def loss(self, cls_score, bbox_pred, labels, label_weights, bbox_targets,
             bbox_weights, label_count: Optional[torch.Tensor] = None,
             pos_count: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Softmax CE over the labelled rois divided by the sum of
        ``label_weights``, and the regression of the delta of each roi's own
        class divided by the positive count.  ``label_count`` /
        ``pos_count`` replace the two sums (the detector passes the global
        batch's in data-parallel training); each is floored at 1."""
        if label_count is None:
            label_count = label_weights.sum()
        if pos_count is None:
            pos_count = (bbox_weights[:, 0] > 0).sum().float()
        loss_cls = cross_entropy(cls_score, labels, weight=label_weights,
                                 avg_factor=label_count.clamp(min=1.0))
        if not self.reg_class_agnostic:
            safe = labels.long().clamp(0, self.num_classes - 1)
            per_class = bbox_pred.reshape(bbox_pred.shape[0], self.num_classes, 4)
            bbox_pred = torch.gather(per_class, 1, safe[:, None, None].expand(-1, 1, 4))[:, 0]
        loss_bbox = self.loss_bbox_fn(bbox_pred, bbox_targets, weight=bbox_weights,
                                      avg_factor=pos_count.clamp(min=1.0))
        return dict(loss_cls=loss_cls * self.cls_loss_weight,
                    loss_bbox=loss_bbox * self.bbox_loss_weight)


class ConvFCBBoxHead(BBoxHead):
    """``num_shared_convs`` 3x3 ConvModules (GN and weight-standardized by
    ``norm_cfg`` / ``conv_cfg``, the gn / gn+ws configs' "4conv1fc" head),
    then ``num_shared_fcs`` fcs of ``fc_out_channels`` + ReLU, before
    ``fc_cls`` / ``fc_reg``."""

    def __init__(self, num_shared_convs: int = 0, num_shared_fcs: int = 2,
                 fc_out_channels: int = 1024, conv_out_channels: int = 256,
                 conv_cfg: Optional[dict] = None, norm_cfg: Optional[dict] = None,
                 **kwargs):
        self.num_shared_convs = num_shared_convs
        self.num_shared_fcs = num_shared_fcs
        self.fc_out_channels = fc_out_channels
        self.conv_out_channels = conv_out_channels
        self.conv_cfg, self.norm_cfg = conv_cfg, norm_cfg
        super().__init__(**kwargs)

    def build_fcs(self) -> None:
        chans = [self.in_channels] + [self.conv_out_channels] * self.num_shared_convs
        self.shared_convs = nn.ModuleList(
            [ConvModule(chans[i], chans[i + 1], 3, padding=1, conv_cfg=self.conv_cfg,
                        norm_cfg=self.norm_cfg, dtype=self.dtype)
             for i in range(self.num_shared_convs)])
        dims = [chans[-1] * self.roi_feat_size ** 2] + \
            [self.fc_out_channels] * self.num_shared_fcs
        self.shared_fcs = nn.ModuleList([self.linear(dims[i], dims[i + 1])
                                         for i in range(self.num_shared_fcs)])
        self.fc_cls = self.linear(dims[-1], self.num_classes)
        self.fc_reg = self.linear(dims[-1], 4 if self.reg_class_agnostic else 4 * self.num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        with torch.no_grad():
            for conv in self.shared_convs:
                conv.conv.weight.normal_(0.0, 0.01, generator=generator)
                if conv.conv.bias is not None:
                    conv.conv.bias.zero_()
            for fc in self.shared_fcs:
                nn.init.xavier_uniform_(fc.weight, generator=generator)
                fc.bias.zero_()

    def forward(self, x: torch.Tensor):
        for conv in self.shared_convs:
            x = conv(x)
        feat = x.flatten(1)
        for fc in self.shared_fcs:
            feat = F.relu(fc(feat))
        return self.fc_cls(feat), self.fc_reg(feat)


class SharedFCBBoxHead(ConvFCBBoxHead):
    """The standard two-fc head (registration name)."""


def bbox_target_single(rois, pos_mask, matched_gt, labels,
                       target_means=(0.0, 0.0, 0.0, 0.0),
                       target_stds=(0.1, 0.1, 0.2, 0.2)):
    """Second-stage targets of sampled rois (N, 4): the matched gts encoded
    against the rois on the positives; weights mark them.  Returns (labels
    (N,) int32, bbox_targets (N, 4), bbox_weights (N, 4))."""
    deltas = bbox2delta(rois, matched_gt, target_means, target_stds)
    posf = pos_mask.float()
    bbox_targets = deltas * posf[:, None]
    bbox_weights = posf[:, None].expand(deltas.shape)
    labels = torch.where(pos_mask, labels, 0).int()
    return labels, bbox_targets, bbox_weights
