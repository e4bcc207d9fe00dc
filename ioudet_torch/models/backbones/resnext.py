"""ResNeXt backbone (counterpart of ``ioudet/models/backbones/resnext.py``):
ResNet with grouped 3x3 convs, 64 groups of base width 4 unless the config
says otherwise (the x101-32x4d config sets ``groups=32``)."""

from __future__ import annotations

from .resnet import ResNet


class ResNeXt(ResNet):
    def __init__(self, groups: int = 64, base_width: int = 4, **kwargs):
        super().__init__(groups=groups, base_width=base_width, **kwargs)
