"""Single-level RoI extractor (counterpart of
``ioudet/models/roi_extractors/single_level.py``).

Each roi goes to one FPN level by its scale, floor(log2(sqrt(area) / 56)),
clamped to the levels, and is RoIAligned on that level only
(``ops/roi_align.roi_align_levels``).  ``ioudet`` aligns every roi on every
level and sums with a one-hot level mask; the terms it masks are exact
zeros, so the two agree, at a quarter of the gathers.  With a deformable
RoI pooling layer (``DeformRoIPoolingPack`` / ``ModulatedDeformRoIPoolingPack``)
the extractor holds one pack a level (``roi_layers.<i>``, mmdet's names) and
pools each roi on its own level with its level's pack
(``ops/deform_pool.deform_pool_levels``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.deform_pool import (DeformRoIPoolingPack, ModulatedDeformRoIPoolingPack,
                                deform_pool_levels)
from ...ops.roi_align import roi_align_levels

DEFORM_POOLS = {"DeformRoIPoolingPack": DeformRoIPoolingPack,
                "ModulatedDeformRoIPoolingPack": ModulatedDeformRoIPoolingPack}


class SingleRoIExtractor(nn.Module):
    def __init__(self, out_channels: int = 256,
                 featmap_strides: Sequence[int] = (4, 8, 16, 32),
                 roi_layer: Optional[dict] = None, finest_scale: int = 56):
        super().__init__()
        cfg = dict(roi_layer or {})
        layer_type = cfg.get("type", "RoIAlign")
        if layer_type != "RoIAlign" and layer_type not in DEFORM_POOLS:
            raise KeyError(f"roi layer {layer_type!r} is not ported; available: "
                           f"{['RoIAlign'] + sorted(DEFORM_POOLS)}")
        self.out_channels = out_channels
        self.featmap_strides = tuple(featmap_strides)
        self.out_size = cfg.get("out_size", 7)
        self.sample_num = cfg.get("sample_num", 2)
        self.finest_scale = finest_scale
        self.roi_layers = None
        if layer_type in DEFORM_POOLS:
            self.roi_layers = nn.ModuleList([DEFORM_POOLS[layer_type](
                self.out_size, out_channels, 1.0 / s, self.sample_num,
                cfg.get("trans_std", 0.1)) for s in self.featmap_strides])

    @property
    def num_inputs(self) -> int:
        return len(self.featmap_strides)

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in self.roi_layers or ():
            layer.init_weights(generator)

    def map_roi_levels(self, rois: torch.Tensor) -> torch.Tensor:
        """(R, 5) rois -> (R,) level index."""
        scale = torch.sqrt((rois[:, 3] - rois[:, 1] + 1) * (rois[:, 4] - rois[:, 2] + 1))
        lvl = torch.floor(torch.log2(scale / self.finest_scale + 1e-6))
        return lvl.clamp(0, self.num_inputs - 1).long()

    def forward(self, feats: Sequence[torch.Tensor], rois: torch.Tensor) -> torch.Tensor:
        """feats: NCHW levels (the first ``len(featmap_strides)`` are used);
        rois (R, 5).  Returns (R, C, out_size, out_size)."""
        if self.roi_layers is not None:
            return deform_pool_levels(self.roi_layers, feats[:self.num_inputs], rois,
                                      self.map_roi_levels(rois))
        return roi_align_levels(feats[:self.num_inputs], rois, self.map_roi_levels(rois),
                                [1.0 / s for s in self.featmap_strides],
                                self.out_size, self.sample_num)
