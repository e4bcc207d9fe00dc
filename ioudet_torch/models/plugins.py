"""Plugins (counterpart of ``ioudet/models/plugins.py``): the
global-context block (GCNet) and the embedded-Gaussian non-local block
(``NonLocal2D``, Libra R-CNN's BFP refine).  ``GeneralizedAttention`` is not
ported yet.

mmdet's state_dict layout: ``conv_mask``, ``channel_add_conv.{0,1,3}`` and
``channel_mul_conv.{0,1,3}`` (1x1 conv, LayerNorm over (planes, 1, 1), ReLU,
1x1 conv).  The LayerNorm's eps is flax's 1e-6, as in ``ioudet`` (mmdet's
is 1e-5), and the fusions apply in the order of ``fusion_types``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .utils.layers import Conv2d, ConvModule

FUSIONS = ("channel_add", "channel_mul")


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over (C, 1, 1) in f32, output in ``compute_dtype`` (flax's
    ``nn.LayerNorm(dtype=...)`` over the channels)."""

    def __init__(self, channels: int, eps: float = 1e-6,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__([channels, 1, 1], eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


class ContextBlock(nn.Module):
    """Global context (``pooling_type`` 'att': softmax attention over the
    positions; 'avg': the mean), a bottleneck transform of it, fused into x
    by 'channel_add' and / or 'channel_mul' (x * sigmoid)."""

    def __init__(self, inplanes: int, ratio: float = 1.0 / 16, pooling_type: str = "att",
                 fusion_types: Sequence[str] = ("channel_add",),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pooling_type not in ("att", "avg"):
            raise ValueError(f"pooling_type must be 'att' or 'avg', got {pooling_type!r}")
        if not fusion_types or any(f not in FUSIONS for f in fusion_types):
            raise ValueError(f"fusion_types must be taken from {FUSIONS}, got {fusion_types!r}")
        self.pooling_type = pooling_type
        self.fusion_types = tuple(fusion_types)
        planes = max(int(inplanes * ratio), 1)
        if pooling_type == "att":
            self.conv_mask = Conv2d(inplanes, 1, 1, compute_dtype=dtype)
        for fusion in self.fusion_types:
            setattr(self, f"{fusion}_conv", nn.Sequential(
                Conv2d(inplanes, planes, 1, compute_dtype=dtype),
                ChannelLayerNorm(planes, compute_dtype=dtype),
                nn.ReLU(inplace=True),
                Conv2d(planes, inplanes, 1, compute_dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        if self.pooling_type == "att":
            attn = torch.softmax(self.conv_mask(x).view(b, 1, h * w), dim=-1)
            context = torch.matmul(x.reshape(b, c, h * w), attn.transpose(1, 2))
        else:
            context = x.mean(dim=(2, 3))
        context = context.view(b, c, 1, 1)
        out = x
        for fusion in self.fusion_types:
            t = getattr(self, f"{fusion}_conv")(context)
            out = out + t if fusion == "channel_add" else out * torch.sigmoid(t)
        return out


class NonLocal2D(nn.Module):
    """Embedded-Gaussian non-local block as BFP builds it (``ioudet``'s
    ``NonLocal2D(reduction=1, use_scale=False)``): 1x1 convs ``theta``,
    ``phi``, ``g`` at ``in_channels``, the softmax over the positions of
    theta . phi, the attention-weighted sum of ``g``, and ``conv_out`` added
    to the input.  mmdet's names: ``theta.conv``, ``phi.conv``, ``g.conv``,
    ``conv_out.conv``.  The two products are ``torch.matmul``, as they are
    XLA products in ``ioudet``; at Libra Faster R-CNN's refine level (P4 of
    832x1344, 4368 positions) the attention is 76 MB an image.  f32 only
    (BFP, its one user, runs in f32)."""

    INT8 = False   # w8a8 serving of the non-local block is not ported

    def __init__(self, in_channels: int):
        super().__init__()
        for name in ("theta", "phi", "g", "conv_out"):
            setattr(self, name, ConvModule(in_channels, in_channels, 1, act=None))

    def init_weights(self, generator: torch.Generator) -> None:
        """theta, phi, g normal(0.01), ``conv_out`` zero (the block starts as
        the identity, as ``ioudet``'s), biases 0."""
        with torch.no_grad():
            for name in ("theta", "phi", "g", "conv_out"):
                conv = getattr(self, name).conv
                if name == "conv_out":
                    conv.weight.zero_()
                else:
                    conv.weight.normal_(0.0, 0.01, generator=generator)
                conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q = self.theta(x).reshape(b, c, h * w).transpose(1, 2)
        k = self.phi(x).reshape(b, c, h * w)
        v = self.g(x).reshape(b, c, h * w).transpose(1, 2)
        attn = torch.softmax(torch.matmul(q, k), dim=-1)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.conv_out(y)
