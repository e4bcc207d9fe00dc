"""Guided anchoring's parts (counterpart of
``ioudet/models/heads/guided_anchor_head.py``).  Only ``FeatureAdaption``
is ported so far (FoveaBox's align variant takes it); the guided-anchoring
heads themselves are in ROADMAP.md queue 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import DeformConv
from ..utils.layers import Conv2d


class FeatureAdaption(nn.Module):
    """A 3x3 deformable conv whose offsets come from the shape prediction
    (``ioudet``'s ``FeatureAdaption``, mmdet's ``FeatureAdaption`` /
    ``FeatureAlign``): ``conv_offset`` (1x1, no bias, 18 channels) on the
    detached shape field, then ``conv_adaption`` (a ``DeformConv``, one
    deformable group as in ``ioudet``; mmdet's FoveaBox uses 4), then ReLU.
    Init (``ioudet``'s): ``conv_offset`` normal(0.1), ``conv_adaption``
    normal(0.01)."""

    def __init__(self, in_channels: int, out_channels: int, shape_channels: int = 4,
                 kernel_size: int = 3):
        super().__init__()
        self.conv_offset = Conv2d(shape_channels, 2 * kernel_size * kernel_size, 1, bias=False)
        self.conv_adaption = DeformConv(in_channels, out_channels, kernel_size)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.conv_offset.weight.normal_(0.0, 0.1, generator=generator)
            self.conv_adaption.weight.normal_(0.0, 0.01, generator=generator)

    def forward(self, x: torch.Tensor, shape_pred: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv_adaption(x, self.conv_offset(shape_pred.detach())))
