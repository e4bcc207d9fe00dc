"""SSD-VGG16 backbone (counterpart of ``ioudet/models/backbones/ssd_vgg.py``).

VGG-16 through conv5_3, fc6 / fc7 as a dilated 3x3 and a 1x1 conv, then the
SSD tower of extra convs; conv4_3's output is L2-normalized with a learned
per-channel scale (20 at init).  Returns (conv4_3, fc7, extra1..extraN), NCHW.

mmdet's module names: ``features.N`` at torchvision's VGG-16 indices (conv,
ReLU and pool modules in one Sequential; fc6 and fc7 at 31 and 33),
``extra.N`` (convs only, a ReLU after each in ``forward``) and
``l2_norm.weight``.  As in ``ioudet``:

  * the 2x2 pools floor (flax's VALID ``max_pool``), so SSD300 gives maps
    of 37 / 18 / 9 / 5 / 3 / 1, where mmdet's ``ceil_mode`` pools give 38 /
    19 / 10 / 5 / 3 / 1;
  * pool5 is a 3x3 stride-1 max pool padded by 1 with -inf;
  * extra pair i's 3x3 has stride 2 and padding 1 for i < 2, and at 512
    for every pair, else stride 1 and no padding (SSD512's last extra is a
    3x3 stride-2 conv).
"""

from __future__ import annotations

import math
from typing import Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.layers import compute_dtype

VGG16 = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
EXTRA = {
    300: (256, 512, 128, 256, 128, 256, 128, 256),
    512: (256, 512, 128, 256, 128, 256, 128, 256, 128, 256),
}
CONV4_3_RELU = 22   # the features index whose output is normalized


class L2Norm(nn.Module):
    """``weight * x / (sqrt(sum_c x^2) + eps)`` over the channels of NCHW x."""

    def __init__(self, channels: int, scale: float = 20.0, eps: float = 1e-10):
        super().__init__()
        self.scale = scale
        self.eps = eps
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + self.eps
        return self.weight[None, :, None, None] * x / norm


class SSDVGG(nn.Module):
    def __init__(self, input_size: int = 300, dtype: Union[None, str, torch.dtype] = None):
        super().__init__()
        if input_size not in EXTRA:
            raise NotImplementedError(f"SSDVGG input_size {input_size} is not ported; "
                                      f"available: {sorted(EXTRA)}")
        if compute_dtype(dtype) != torch.float32:
            raise NotImplementedError(f"SSD in {dtype} is not ported yet")
        layers, cin = [], 3
        for stage, (n, ch) in enumerate(VGG16):
            for _ in range(n):
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU(inplace=True)]
                cin = ch
            layers.append(nn.MaxPool2d(2, 2) if stage < 4 else nn.MaxPool2d(3, 1, 1))
        layers += [nn.Conv2d(512, 1024, 3, padding=6, dilation=6), nn.ReLU(inplace=True),
                   nn.Conv2d(1024, 1024, 1), nn.ReLU(inplace=True)]
        self.features = nn.Sequential(*layers)
        extra, cin = [], 1024
        widths = EXTRA[input_size]
        for i in range(0, len(widths), 2):
            stride = 2 if i // 2 < 2 or input_size == 512 else 1
            extra += [nn.Conv2d(cin, widths[i], 1),
                      nn.Conv2d(widths[i], widths[i + 1], 3, stride, 1 if stride == 2 else 0)]
            cin = widths[i + 1]
        self.extra = nn.ModuleList(extra)
        self.l2_norm = L2Norm(512)

    def init_weights(self, generator: torch.Generator) -> None:
        """LeCun-normal convs (flax's default, ``ioudet``'s init) and zero
        biases, drawn from ``generator``; the L2Norm scale at 20.  On SSD's
        pixel-scale inputs (std 1) the activations shrink layer by layer to
        O(1) at fc7, so that random head outputs stay off saturation."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    _, i, kh, kw = m.weight.shape
                    m.weight.normal_(0.0, math.sqrt(1.0 / (i * kh * kw)), generator=generator)
                    m.bias.zero_()
            self.l2_norm.weight.fill_(self.l2_norm.scale)

    def forward(self, x: torch.Tensor):
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i == CONV4_3_RELU:
                outs.append(self.l2_norm(x))
        outs.append(x)
        for i, conv in enumerate(self.extra):
            x = F.relu(conv(x))
            if i % 2:
                outs.append(x)
        return tuple(outs)
