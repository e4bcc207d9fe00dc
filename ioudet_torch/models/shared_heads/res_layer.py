"""Shared res5 head (counterpart of ``ioudet/models/shared_heads/res_layer.py``,
mmdet's ``ResLayer``): the C4 detectors pool their rois at 14x14 from the
stride-16 map and run the ResNet's last stage over them before the box head
(stride 2 in its first block, so 7x7 out).  It is the port's own
``Bottleneck``, as the backbone builds it (``style``, FrozenBN by default),
under mmdet's names ``layer4.<j>``, so a C4 checkpoint's
``shared_head.layer4.*`` loads as it is.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..backbones.resnet import ARCH_SETTINGS, FROZEN_BN, Bottleneck
from ..utils.layers import compute_dtype


class ResLayer(nn.Module):
    def __init__(self, depth: int = 50, stage: int = 3, stride: int = 2,
                 style: str = "pytorch", norm_cfg: Optional[dict] = None,
                 dtype: Union[None, str, torch.dtype] = None):
        super().__init__()
        block, stage_blocks = ARCH_SETTINGS[depth]
        if block is not Bottleneck:
            raise ValueError(f"ResLayer takes a bottleneck depth, not {depth}")
        planes = 64 * 2 ** stage
        inplanes = planes * block.expansion // 2
        dtype = compute_dtype(dtype)
        blocks = []
        for j in range(stage_blocks[stage]):
            blocks.append(Bottleneck(inplanes, planes, stride if j == 0 else 1,
                                     downsample=j == 0, style=style, dtype=dtype,
                                     norm_cfg=dict(norm_cfg or FROZEN_BN)))
            inplanes = planes * block.expansion
        self.stage = stage
        self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    @property
    def layer(self) -> nn.Sequential:
        return getattr(self, f"layer{self.stage + 1}")

    def init_weights(self, generator: torch.Generator) -> None:
        """He normal (fan_out) convs; FrozenBN stays the identity."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    o, _, kh, kw = m.weight.shape
                    m.weight.normal_(0.0, (2.0 / (o * kh * kw)) ** 0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, C, 14, 14) RoI features -> (R, 2C, 7, 7)."""
        return self.layer(x)
