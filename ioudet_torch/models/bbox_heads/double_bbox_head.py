"""Double-Head box head (counterpart of
``ioudet/models/bbox_heads/double_bbox_head.py``, mmdet's
``DoubleConvFCBBoxHead``): the RoI feature goes through two branches.

  * the conv branch regresses: ``res_block`` (a 3x3 ConvModule, then a 1x1
    to ``conv_out_channels`` beside a 1x1 projection of the input, ReLU of
    the sum), ``num_convs`` residual bottlenecks at that width
    (``conv_branch.<i>``, the ResNet's ``Bottleneck`` with planes a quarter
    of it), the global average pool, then ``fc_reg``;
  * the fc branch classifies: the flattened (C, S, S) feature through
    ``num_fcs`` fcs + ReLU (``fc_branch.<i>``), then ``fc_cls``.

Every conv has the head's ``norm_cfg``, BN when it has none, as ``ioudet``
has it: ``models/utils/layers.BatchNorm``, batch statistics in training and
running statistics in eval (``ioudet`` passes the mode to flax's BN twice
and raises at the first call, so the port's BN follows what its call site
states).  mmdet's state_dict names throughout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..backbones.resnet import Bottleneck
from ..utils.layers import ConvModule
from .bbox_head import BBoxHead


class BasicResBlock(nn.Module):
    """3x3 conv (norm, ReLU) then 1x1 conv (norm) plus a 1x1 projection of
    the input (norm), ReLU after the sum."""

    def __init__(self, in_channels: int, out_channels: int, norm_cfg: dict,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = ConvModule(in_channels, in_channels, 3, norm_cfg=norm_cfg, dtype=dtype)
        self.conv2 = ConvModule(in_channels, out_channels, 1, norm_cfg=norm_cfg, act=None,
                                dtype=dtype)
        self.conv_identity = ConvModule(in_channels, out_channels, 1, norm_cfg=norm_cfg,
                                        act=None, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.conv_identity(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)


class DoubleConvFCBBoxHead(BBoxHead):
    def __init__(self, num_convs: int = 4, num_fcs: int = 2, conv_out_channels: int = 1024,
                 fc_out_channels: int = 1024, norm_cfg: Optional[dict] = None, **kwargs):
        self.num_convs, self.num_fcs = num_convs, num_fcs
        self.conv_out_channels, self.fc_out_channels = conv_out_channels, fc_out_channels
        self.norm_cfg = dict(norm_cfg or dict(type="BN"))
        super().__init__(**kwargs)

    def build_fcs(self) -> None:
        c = self.conv_out_channels
        self.res_block = BasicResBlock(self.in_channels, c, self.norm_cfg, self.dtype)
        self.conv_branch = nn.ModuleList(
            [Bottleneck(c, c // 4, dtype=self.dtype, norm_cfg=self.norm_cfg)
             for _ in range(self.num_convs)])
        dims = [self.in_channels * self.roi_feat_size ** 2] + [self.fc_out_channels] * self.num_fcs
        self.fc_branch = nn.ModuleList([self.linear(dims[i], dims[i + 1])
                                        for i in range(self.num_fcs)])
        self.fc_cls = self.linear(dims[-1], self.num_classes)
        self.fc_reg = self.linear(c, 4 if self.reg_class_agnostic else 4 * self.num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        """``BBoxHead``'s for ``fc_cls`` / ``fc_reg``, He normal (fan_out)
        convs, unit norms, Xavier uniform ``fc_branch``."""
        super().init_weights(generator)
        with torch.no_grad():
            for m in list(self.res_block.modules()) + list(self.conv_branch.modules()):
                if isinstance(m, nn.Conv2d):
                    o, _, kh, kw = m.weight.shape
                    m.weight.normal_(0.0, (2.0 / (o * kh * kw)) ** 0.5, generator=generator)
            for fc in self.fc_branch:
                nn.init.xavier_uniform_(fc.weight, generator=generator)
                fc.bias.zero_()

    def conv_branch_forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, C, S, S) -> the pooled (R, conv_out_channels) of the conv branch."""
        x = self.res_block(x)
        for block in self.conv_branch:
            x = block(x)
        return x.mean(dim=(2, 3))

    def fc_branch_forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = x.flatten(1)
        for fc in self.fc_branch:
            feat = F.relu(fc(feat))
        return feat

    def forward(self, x: torch.Tensor):
        return self.fc_cls(self.fc_branch_forward(x)), self.fc_reg(self.conv_branch_forward(x))
