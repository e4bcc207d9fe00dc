"""Feature Pyramid Network (counterpart of ``ioudet/models/necks/fpn.py``).

RetinaNet configuration: in_channels=[256, 512, 1024, 2048], out=256,
start_level=1, add_extra_convs=True, num_outs=5 -> P3..P7, with P6/P7 from
stride-2 3x3 convs on C5 (extra convs on the inputs) and no ReLU before an
extra conv unless ``relu_before_extra_convs``.  mmdet names: the extra convs
are ``fpn_convs[num_laterals + j]``.  NCHW in and out.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.layers import ConvModule, resize_nearest


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs: bool = False,
                 extra_convs_on_inputs: bool = True,
                 relu_before_extra_convs: bool = False,
                 conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 act: Optional[str] = None,
                 dtype: Union[None, str, torch.dtype] = None):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.num_outs = num_outs
        self.start_level = start_level
        self.end_level = len(in_channels) if end_level == -1 else end_level
        self.add_extra_convs = add_extra_convs
        self.extra_convs_on_inputs = extra_convs_on_inputs
        self.relu_before_extra_convs = relu_before_extra_convs
        used = self.in_channels[start_level:self.end_level]
        kw = dict(conv_cfg=conv_cfg, norm_cfg=norm_cfg, dtype=dtype)
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1, act=act, **kw) for c in used])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, act=act, **kw)
             for _ in used])
        extra = num_outs - len(used)
        if add_extra_convs and extra > 0:
            for i in range(extra):
                cin = (self.in_channels[self.end_level - 1]
                       if i == 0 and extra_convs_on_inputs else out_channels)
                self.fpn_convs.append(
                    ConvModule(cin, out_channels, 3, stride=2, act=None, **kw))

    def init_weights(self, generator: torch.Generator) -> None:
        """Xavier-uniform convs, zero biases, drawn from ``generator``."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                    fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                    a = (6.0 / (fan_in + fan_out)) ** 0.5
                    m.weight.uniform_(-a, a, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()

    def forward(self, inputs: Sequence[torch.Tensor]):
        if len(inputs) != len(self.in_channels):
            raise ValueError(f"expected {len(self.in_channels)} inputs, "
                             f"got {len(inputs)}")
        laterals = [conv(inputs[self.start_level + i])
                    for i, conv in enumerate(self.lateral_convs)]
        for i in range(len(laterals) - 1, 0, -1):
            # exact x2 on pad-32 canvases
            laterals[i - 1] = laterals[i - 1] + resize_nearest(laterals[i],
                                                               laterals[i - 1].shape[2:])
        n_lat = len(laterals)
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n_lat)]
        extra = self.num_outs - n_lat
        if extra > 0 and self.add_extra_convs:
            src = inputs[self.end_level - 1] if self.extra_convs_on_inputs \
                else outs[-1]
            for i in range(extra):
                if i > 0 and self.relu_before_extra_convs:
                    src = F.relu(src)
                src = self.fpn_convs[n_lat + i](src)
                outs.append(src)
        elif extra > 0:
            for _ in range(extra):
                outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)
