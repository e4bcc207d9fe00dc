"""RoIAlign / RoIPool (counterpart of ``ioudet/ops/roi_align.py``) in plain
torch: one row gather a bilinear corner on the feature maps laid out as a
(positions, C) table, then the mean (RoIAlign) or the max (RoIPool) of each
bin's samples.  ``ioudet`` computes it in XLA, outside any Pallas kernel,
so there is no hand kernel here; ``chip_smoke.py`` times it on the card.

v1 semantics, as ``ioudet``: rois are (batch_idx, x1, y1, x2, y2) in image
coordinates, scaled by the map's ``spatial_scale``; no +0.5 offset;
``sample_num`` regular samples a bin axis (at least 1; 0 does not mean
adaptive); samples are clamped into the map; a roi with ``batch_idx < 0``
(padding) gives zeros.  RoIAlign's bin is (x2 - x1) / P (at least 1e-6
wide); RoIPool's is max(x2 - x1 + 1, 1) / P, maxed over the samples (the
exact kernel maxes over whole cells; this converges to it as
``sample_num`` grows).

``roi_align_levels`` takes several maps and a level a roi: each roi is
sampled on its own level only.  It equals ``ioudet``'s extractor, which
samples every roi on every level and sums with a one-hot level mask: the
other levels' terms are exact zeros.  Outputs are NCHW, (R, C, P, P).
"""

from __future__ import annotations

from typing import Sequence

import torch


def _corner_rows(table, base, w, yi, xi):
    """table rows at (yi, xi) of each roi's map: base (R,), w (R,) the map's
    width, yi (R, n, 1) and xi (R, 1, n) -> (R, n, n, C)."""
    return table[base[:, None, None] + yi * w[:, None, None] + xi]


def _pooled(feats: Sequence[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
            scales: Sequence[float], pooled_size: int, sample_num: int,
            pool: bool) -> torch.Tensor:
    p, s = pooled_size, max(sample_num, 1)
    bsz, chans = feats[0].shape[:2]
    dev = rois.device
    table = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, chans) for f in feats])
    # the per-level constants of each roi, selected without a host copy
    scale = torch.zeros(rois.shape[0], device=dev)
    hm1, wm1 = torch.zeros_like(scale), torch.zeros_like(scale)
    hmax = torch.zeros(rois.shape[0], dtype=torch.long, device=dev)
    wmax, wid, start = torch.zeros_like(hmax), torch.zeros_like(hmax), torch.zeros_like(hmax)
    offset = 0
    for i, (f, sc) in enumerate(zip(feats, scales)):
        h, w = f.shape[2:]
        on = levels == i
        scale = torch.where(on, sc, scale)
        hm1, wm1 = torch.where(on, h - 1.0, hm1), torch.where(on, w - 1.0, wm1)
        hmax, wmax = torch.where(on, h - 1, hmax), torch.where(on, w - 1, wmax)
        wid = torch.where(on, w, wid)
        start = torch.where(on, offset, start)
        offset += bsz * h * w
    bidx = rois[:, 0].long()
    base = start + bidx.clamp(0, bsz - 1) * (hmax + 1) * wid

    x1, y1 = rois[:, 1] * scale, rois[:, 2] * scale
    x2, y2 = rois[:, 3] * scale, rois[:, 4] * scale
    if pool:
        bin_w = (x2 - x1 + 1).clamp(min=1.0) / p
        bin_h = (y2 - y1 + 1).clamp(min=1.0) / p
    else:
        bin_w = (x2 - x1).clamp(min=1e-6) / p
        bin_h = (y2 - y1).clamp(min=1e-6) / p
    # the sample positions y1 + i * bin_h with one rounding (a fused
    # multiply-add, as XLA contracts it in ioudet): at 50 pixels, a second
    # rounding moves a bilinear weight by ~4e-6
    ii = (torch.arange(p * s, dtype=torch.float32, device=dev) + 0.5) / s
    ys = torch.addcmul(y1[:, None], ii, bin_h[:, None]).clamp(min=0.0)
    xs = torch.addcmul(x1[:, None], ii, bin_w[:, None]).clamp(min=0.0)
    ys, xs = torch.minimum(ys, hm1[:, None]), torch.minimum(xs, wm1[:, None])
    # a NaN position (a diverged model's roi) indexes the map's first row or
    # column, as ioudet's gather clamps it, not outside the table
    y0 = torch.minimum(ys.floor().long().clamp(min=0), hmax[:, None])
    x0 = torch.minimum(xs.floor().long().clamp(min=0), wmax[:, None])
    y1i = torch.minimum(y0 + 1, hmax[:, None])
    x1i = torch.minimum(x0 + 1, wmax[:, None])
    wy, wx = (ys - y0)[:, :, None], (xs - x0)[:, None, :]
    y0, y1i = y0[:, :, None], y1i[:, :, None]
    x0, x1i = x0[:, None, :], x1i[:, None, :]
    samples = (_corner_rows(table, base, wid, y0, x0) * ((1 - wy) * (1 - wx))[..., None] +
               _corner_rows(table, base, wid, y0, x1i) * ((1 - wy) * wx)[..., None] +
               _corner_rows(table, base, wid, y1i, x0) * (wy * (1 - wx))[..., None] +
               _corner_rows(table, base, wid, y1i, x1i) * (wy * wx)[..., None])
    bins = samples.reshape(-1, p, s, p, s, chans)
    out = bins.amax(dim=(2, 4)) if pool else bins.mean(dim=(2, 4))
    out = torch.where((bidx >= 0)[:, None, None, None], out, 0.0)
    return out.permute(0, 3, 1, 2)


def roi_align_levels(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                     levels: torch.Tensor, spatial_scales: Sequence[float],
                     pooled_size: int = 7, sample_num: int = 2) -> torch.Tensor:
    """RoIAlign of each roi on its own level: feats NCHW maps of one batch,
    rois (R, 5), levels (R,) int in [0, len(feats)), ``spatial_scales`` one
    a map.  Returns (R, C, P, P)."""
    return _pooled(feats, rois, levels, spatial_scales, pooled_size, sample_num, False)


def roi_align(feats: torch.Tensor, rois: torch.Tensor, pooled_size: int = 7,
              spatial_scale: float = 1.0 / 16, sample_num: int = 2) -> torch.Tensor:
    """feats (B, C, H, W); rois (R, 5).  Returns (R, C, P, P)."""
    levels = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    return _pooled([feats], rois, levels, [spatial_scale], pooled_size, sample_num, False)


def roi_pool(feats: torch.Tensor, rois: torch.Tensor, pooled_size: int = 7,
             spatial_scale: float = 1.0 / 16, sample_num: int = 4) -> torch.Tensor:
    """Max over a sample_num x sample_num grid a bin.  feats (B, C, H, W);
    rois (R, 5).  Returns (R, C, P, P)."""
    levels = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    return _pooled([feats], rois, levels, [spatial_scale], pooled_size, sample_num, True)
