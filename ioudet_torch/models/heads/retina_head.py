"""RetinaNet head (counterpart of ``ioudet/models/heads/retina_head.py``).

Two towers of ``stacked_convs`` x (3x3 conv + ReLU) shared across FPN levels,
then 3x3 ``retina_cls`` (A * (num_classes - 1) sigmoid logits) and
``retina_reg`` (A * 4 deltas).  Init: normal(0.01) weights, cls bias
-log((1 - p) / p) with p = 0.01.  Anchors: scales 4 * 2^(i / 3), i < 3,
ratios (0.5, 1, 2) -> A = 9.  As in ``ioudet``, the scales are
``octave_scales()`` whatever ``octave_base_scale`` and
``scales_per_octave`` say (mmdet derives them from the two); only an
explicit ``anchor_scales`` changes them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..utils.layers import Conv2d, ConvModule, bias_init_with_prob
from .anchor_head import AnchorHead, normal_init


def octave_scales(octave_base_scale: int = 4, scales_per_octave: int = 3):
    return tuple(octave_base_scale * 2 ** (i / scales_per_octave)
                 for i in range(scales_per_octave))


class RetinaHead(AnchorHead):
    def __init__(self, stacked_convs: int = 4, octave_base_scale: int = 4,
                 scales_per_octave: int = 3,
                 anchor_scales: Optional[Sequence[float]] = None, **kwargs):
        super().__init__(anchor_scales=anchor_scales or octave_scales(), **kwargs)
        self.stacked_convs = stacked_convs
        chans = [self.in_channels] + [self.feat_channels] * stacked_convs
        self.cls_convs = nn.ModuleList(
            [ConvModule(chans[i], self.feat_channels, 3, padding=1, dtype=self.dtype)
             for i in range(stacked_convs)])
        self.reg_convs = nn.ModuleList(
            [ConvModule(chans[i], self.feat_channels, 3, padding=1, dtype=self.dtype)
             for i in range(stacked_convs)])
        self.retina_cls = Conv2d(self.feat_channels,
                                 self.num_anchors * self.cls_out_channels,
                                 3, padding=1, compute_dtype=self.dtype)
        self.retina_reg = Conv2d(self.feat_channels, self.num_anchors * 4,
                                 3, padding=1, compute_dtype=self.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_init(m, generator)
        with torch.no_grad():
            self.retina_cls.bias.fill_(bias_init_with_prob(0.01))

    def forward_single(self, x: torch.Tensor):
        """NCHW level feature -> (cls logits, deltas, last reg-tower feature),
        all NCHW."""
        cls_feat, reg_feat = x, x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        for conv in self.reg_convs:
            reg_feat = conv(reg_feat)
        return self.retina_cls(cls_feat), self.retina_reg(reg_feat), reg_feat

    def forward(self, feats):
        """NCHW levels -> (cls_scores, bbox_preds), NHWC per level."""
        outs = [self.forward_single(x)[:2] for x in feats]
        return tuple([nhwc(o[i]) for o in outs] for i in range(2))


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)
