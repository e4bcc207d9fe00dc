"""HTC's fused semantic head (counterpart of
``ioudet/models/mask_heads/fused_semantic_head.py``, mmdet's
``FusedSemanticHead``).

Every FPN level of the first ``num_ins`` goes through its 1x1 lateral conv
+ ReLU (``lateral_convs.{i}``) and is resized to the ``fusion_level``'s
grid (stride 8) by ``resize_nearest`` and summed; then ``num_convs`` 3x3
convs + ReLU (``convs.{i}``).  Out of that come ``conv_embedding`` (1x1 +
ReLU), the semantic feature that the box and mask branches RoIAlign, and
``conv_logits`` (1x1), the logits of the 183 COCO-stuff classes.  NCHW.

The loss is the softmax cross-entropy of the logits against the label map
on the same grid, pixels labelled 255 ignored, summed and divided by the
count of the others (at least 1; in a process group the global batch's),
times ``loss_weight``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import global_count
from ..utils.layers import ConvModule, resize_nearest

IGNORE_INDEX = 255


class FusedSemanticHead(nn.Module):
    def __init__(self, num_ins: int = 5, fusion_level: int = 1, num_convs: int = 4,
                 in_channels: int = 256, conv_out_channels: int = 256,
                 num_classes: int = 183, loss_weight: float = 0.2, dtype=None):
        super().__init__()
        self.num_ins, self.fusion_level = num_ins, fusion_level
        self.num_classes, self.loss_weight = num_classes, loss_weight
        self.lateral_convs = nn.ModuleList(
            [ConvModule(in_channels, in_channels, 1, dtype=dtype) for _ in range(num_ins)])
        chans = [in_channels] + [conv_out_channels] * num_convs
        self.convs = nn.ModuleList([ConvModule(chans[i], chans[i + 1], 3, dtype=dtype)
                                    for i in range(num_convs)])
        self.conv_embedding = ConvModule(chans[-1], conv_out_channels, 1, dtype=dtype)
        self.conv_logits = nn.Conv2d(chans[-1], num_classes, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        """He-normal (fan_out) ConvModules and LeCun-normal ``conv_logits``,
        ``ioudet``'s initializers without their truncation; zero biases."""
        with torch.no_grad():
            for m in [c.conv for c in self.lateral_convs] + [c.conv for c in self.convs] + \
                    [self.conv_embedding.conv, self.conv_logits]:
                o, i, kh, kw = m.weight.shape
                std = math.sqrt(1.0 / (i * kh * kw)) if m is self.conv_logits else \
                    math.sqrt(2.0 / (o * kh * kw))
                m.weight.normal_(0.0, std, generator=generator)
                m.bias.zero_()

    def forward(self, feats: Sequence[torch.Tensor]) -> tuple:
        """FPN levels (NCHW) -> (seg_pred (B, num_classes, h, w), feature
        (B, C, h, w)) on the ``fusion_level``'s grid."""
        size = feats[self.fusion_level].shape[2:]
        x = self.lateral_convs[self.fusion_level](feats[self.fusion_level])
        for i, f in enumerate(feats[:self.num_ins]):
            if i != self.fusion_level:
                x = x + resize_nearest(self.lateral_convs[i](f), size)
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(x), self.conv_embedding(x)

    def loss(self, seg_pred: torch.Tensor, gt_semantic_seg: torch.Tensor) -> torch.Tensor:
        """seg_pred (B, C, h, w) logits, gt_semantic_seg (B, h, w) labels."""
        valid = gt_semantic_seg != IGNORE_INDEX
        safe = torch.where(valid, gt_semantic_seg, 0).long()
        logp = F.log_softmax(seg_pred.float(), dim=1)
        ll = torch.gather(logp, 1, safe[:, None])[:, 0]
        total = -(ll * valid).sum()
        return self.loss_weight * total / global_count(valid.sum().float()).clamp(min=1.0)
