"""Deformable RoI pooling (counterpart of ``ioudet/ops/deform_pool.py``) in
plain torch, on ``ops/roi_align.py``'s sampling: ``ioudet`` computes it in
XLA, outside any Pallas kernel, so there is no hand kernel here.

``deform_roi_pool`` is RoIAlign whose bin (i, j) has its s x s samples
shifted by ``offset[i, j] * trans_std * (roi_h, roi_w)`` (the roi's size on
the map), added after the grid position ``y1 + (i + .5) / s * bin_h`` as
``ioudet`` adds it, then the mean of each bin's samples; a roi with a
batch index below 0 gives zeros.  Offsets are (R, P, P, 2) as (dy, dx).

The packs hold mmdet's ``offset_fc`` (``Linear, ReLU, Linear, ReLU,
Linear``: indices 0, 2, 4) on the flattened (C, P, P) feature of an
offset-free first pass; the last layer starts at zero, so training starts
as RoIAlign.  Its output is laid out as mmdet's, (K, P, P) with channel 0
the x offset and 1 the y offset; the modulated pack predicts a third
channel, the logit of a per-bin sigmoid that multiplies the pooled
feature, from the same stack (``ioudet``'s; mmdet has a separate
``mask_fc``).  ``deform_pool_levels`` runs a pack a level, each roi on its
own level only: ``ioudet`` pools every roi with every level's pack and sums
with a one-hot level mask, whose other terms are exact zeros, so each
level's parameters get gradient from that level's rois alone in both.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .roi_align import roi_align_levels


def deform_roi_pool(feats: torch.Tensor, rois: torch.Tensor, offsets=None,
                    pooled_size: int = 7, spatial_scale: float = 1.0 / 16,
                    sample_num: int = 2, trans_std: float = 0.1) -> torch.Tensor:
    """feats (B, C, H, W); rois (R, 5); offsets (R, P, P, 2) as (dy, dx) in
    units of the roi's size over ``trans_std``, or None for RoIAlign.
    Returns (R, C, P, P)."""
    levels = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    return roi_align_levels([feats], rois, levels, [spatial_scale], pooled_size, sample_num,
                            offsets, trans_std)


class DeformRoIPoolingPack(nn.Module):
    """Two passes: RoIAlign without offsets, ``offset_fc`` on its flattened
    feature to (2, P, P) offsets, then ``deform_roi_pool`` with them (on one
    map, ``deform_pool_levels`` of one level)."""

    extra_channels = 2

    def __init__(self, out_size: int = 7, out_channels: int = 256,
                 spatial_scale: float = 1.0 / 16, sample_num: int = 2,
                 trans_std: float = 0.1, deform_fc_channels: int = 1024):
        super().__init__()
        self.out_size, self.spatial_scale = out_size, spatial_scale
        self.sample_num, self.trans_std = sample_num, trans_std
        fc = deform_fc_channels
        self.offset_fc = nn.Sequential(
            nn.Linear(out_channels * out_size ** 2, fc), nn.ReLU(inplace=True),
            nn.Linear(fc, fc), nn.ReLU(inplace=True),
            nn.Linear(fc, self.extra_channels * out_size ** 2))

    def init_weights(self, generator: torch.Generator) -> None:
        """LeCun normal hidden layers, zero biases, the last layer zero."""
        with torch.no_grad():
            for i in (0, 2):
                fc = self.offset_fc[i]
                fc.weight.normal_(0.0, 1.0 / math.sqrt(fc.in_features), generator=generator)
                fc.bias.zero_()
            self.offset_fc[4].weight.zero_()
            self.offset_fc[4].bias.zero_()

    def predict(self, base: torch.Tensor) -> torch.Tensor:
        """The first pass's (R, C, P, P) feature -> (R, K, P, P)."""
        p = self.out_size
        return self.offset_fc(base.flatten(1)).reshape(-1, self.extra_channels, p, p)

    @staticmethod
    def yx_offsets(pred: torch.Tensor) -> torch.Tensor:
        """(R, K, P, P) with x, y in channels 0, 1 -> (R, P, P, 2) as (dy, dx)."""
        return torch.stack([pred[:, 1], pred[:, 0]], dim=-1)

    def modulate(self, pooled: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        return pooled

    def forward(self, feats: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """One map: feats (B, C, H, W), rois (R, 5) -> (R, C, P, P)."""
        levels = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
        return deform_pool_levels([self], [feats], rois, levels)


class ModulatedDeformRoIPoolingPack(DeformRoIPoolingPack):
    """``DeformRoIPoolingPack`` with a third output channel a bin: its
    sigmoid multiplies the pooled feature."""

    extra_channels = 3

    def modulate(self, pooled: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        return pooled * torch.sigmoid(pred[:, 2])[:, None]


def deform_pool_levels(packs: Sequence[DeformRoIPoolingPack], feats: Sequence[torch.Tensor],
                       rois: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """The packs of ``SingleRoIExtractor`` (one a level), each roi on its own
    level: the offset-free pass, every level's ``offset_fc`` on every roi
    and each roi's own level's prediction kept, then the second pass.
    Running each level's fcs on its own rois alone would need the level
    counts on the host, and ``predict`` makes no host sync.  Returns
    (R, C, P, P)."""
    first = packs[0]
    scales = [pk.spatial_scale for pk in packs]
    kw = dict(pooled_size=first.out_size, sample_num=first.sample_num)
    base = roi_align_levels(feats, rois, levels, scales, **kw)
    pred = None
    for i, pk in enumerate(packs):
        own = pk.predict(base)
        pred = own if pred is None else torch.where((levels == i)[:, None, None, None], own, pred)
    pooled = roi_align_levels(feats, rois, levels, scales, offsets=first.yx_offsets(pred),
                              trans_std=first.trans_std, **kw)
    return first.modulate(pooled, pred)
