"""Balanced Feature Pyramid (counterpart of ``ioudet/models/necks/bfp.py``;
Libra R-CNN).

Every level is brought to the size of level ``refine_level`` (the finer
ones by ``F.adaptive_max_pool2d``, the coarser ones by ``resize_nearest``)
and averaged; the mean is refined by a 3x3 ``ConvModule`` (``refine_type``
'conv'), by ``NonLocal2D`` ('non_local', the Libra configs'), or not at all
(None), and brought back to every level's size (nearest up, adaptive max
down) as a residual.  On 832x1344 the coarse levels do not divide evenly
(P5 26x42 -> P7 7x11); ``ioudet``'s ``adaptive_max_pool`` keeps torch's
bins there, so the values are the library pool's bit for bit.  Where a
window holds exactly tied values, torch's gradient goes to one of them and
``ioudet``'s splits evenly; either is a gradient of the max.  NCHW in and
out; mmdet's names (``refine.conv``, ``refine.{theta,phi,g,conv_out}.conv``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..plugins import NonLocal2D
from ..utils.layers import ConvModule, compute_dtype, resize_nearest

REFINES = ("conv", "non_local", None)


class BFP(nn.Module):
    INT8 = False   # w8a8 serving of the balanced pyramid is not ported

    def __init__(self, in_channels: int = 256, num_levels: int = 5, refine_level: int = 2,
                 refine_type: Optional[str] = "conv",
                 dtype: Union[None, str, torch.dtype] = None):
        super().__init__()
        dtype = compute_dtype(dtype)
        if dtype != torch.float32:
            raise NotImplementedError(f"BFP in {dtype} is not ported yet (it runs in float32)")
        if refine_type not in REFINES:
            raise ValueError(f"refine_type must be one of {REFINES}, got {refine_type!r}")
        if not 0 <= refine_level < num_levels:
            raise ValueError(f"refine_level {refine_level} is not one of {num_levels} levels")
        self.num_levels = num_levels
        self.refine_level = refine_level
        self.refine_type = refine_type
        if refine_type == "conv":
            self.refine = ConvModule(in_channels, in_channels, 3)
        elif refine_type == "non_local":
            self.refine = NonLocal2D(in_channels)

    def init_weights(self, generator: torch.Generator) -> None:
        """The refine conv Xavier-uniform with a zero bias (mmdet's); the
        non-local block its own init (``conv_out`` zero)."""
        if self.refine_type == "non_local":
            self.refine.init_weights(generator)
        elif self.refine_type == "conv":
            conv = self.refine.conv
            fan = conv.in_channels * 9 + conv.out_channels * 9
            with torch.no_grad():
                conv.weight.uniform_(-(6.0 / fan) ** 0.5, (6.0 / fan) ** 0.5, generator=generator)
                if conv.bias is not None:
                    conv.bias.zero_()

    def forward(self, inputs: Sequence[torch.Tensor]):
        if len(inputs) != self.num_levels:
            raise ValueError(f"expected {self.num_levels} levels, got {len(inputs)}")
        size = inputs[self.refine_level].shape[2:]
        gathered = [F.adaptive_max_pool2d(x, size) if i < self.refine_level else
                    resize_nearest(x, size) if i > self.refine_level else x
                    for i, x in enumerate(inputs)]
        bsf = sum(gathered) / len(gathered)
        if self.refine_type is not None:
            bsf = self.refine(bsf)
        return tuple(
            x + (resize_nearest(bsf, x.shape[2:]) if i < self.refine_level else
                 F.adaptive_max_pool2d(bsf, x.shape[2:]) if i > self.refine_level else bsf)
            for i, x in enumerate(inputs))
