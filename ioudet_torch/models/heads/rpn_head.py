"""RPN head (counterpart of ``ioudet/models/heads/rpn_head.py``).

A 3x3 ``rpn_conv`` + ReLU shared across levels, then 1x1 ``rpn_cls`` (A
objectness logits: sigmoid, one class) and 1x1 ``rpn_reg`` (A * 4
deltas).  Init: normal(0.01) weights, zero biases.  Proposals are
``AnchorHead.get_bboxes``: per level the top ``nms_pre`` anchors, decode,
then one batched ``multiclass_nms`` (K1 once for the whole batch).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.layers import Conv2d
from .anchor_head import AnchorHead, normal_init
from .retina_head import nhwc


class RPNHead(AnchorHead):
    def __init__(self, num_classes: int = 2, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.rpn_conv = Conv2d(self.in_channels, self.feat_channels, 3, padding=1,
                               compute_dtype=self.dtype)
        self.rpn_cls = Conv2d(self.feat_channels, self.num_anchors * self.cls_out_channels,
                              1, compute_dtype=self.dtype)
        self.rpn_reg = Conv2d(self.feat_channels, self.num_anchors * 4, 1,
                              compute_dtype=self.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        for conv in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
            normal_init(conv, generator)

    def forward(self, feats):
        """NCHW levels -> (cls_scores, bbox_preds), NHWC per level."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            t = F.relu(self.rpn_conv(x))
            cls_scores.append(nhwc(self.rpn_cls(t)))
            bbox_preds.append(nhwc(self.rpn_reg(t)))
        return cls_scores, bbox_preds
