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

The rois are pooled in chunks of at most ``chunk_rois`` (from
``CHUNK_BYTES``): a chunk's corner gathers and their weighted sum stay
under ~4 GiB of temporaries whatever the map's width (C4's 1000 rois an
image at 14x14 on 1024 channels gather 25.7 GB a corner at batch 8).  Each
roi is sampled on its own, so the output is bit-equal to one chunk; the
gradient of the maps sums the chunks' scatter-adds in another order.

``offsets`` (R, P, P, 2) shift each bin's samples by ``offset * trans_std *
(roi_h, roi_w)`` (``ops/deform_pool.py``, deformable RoI pooling).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# bytes of one gathered (rois, samples, samples, C) f32 tensor of a chunk; a
# chunk holds about four such temporaries at once (the corners and the sum)
CHUNK_BYTES = 2 ** 30


def chunk_rois(samples: int, chans: int) -> int:
    """The rois a chunk pools: (samples x samples) positions of ``chans``
    f32 values each, ``CHUNK_BYTES`` a gathered tensor."""
    return max(1, CHUNK_BYTES // (samples * samples * chans * 4))


class _RowGather(torch.autograd.Function):
    """``table[idx]`` whose backward adds the rows back with ``index_add_``
    into an f32 gradient (atomic adds on the card), cast to the table's dtype
    once.  Autograd's own backward of the gather, ``index_put_`` with
    ``accumulate``, sorts the indices and sums each index's run in one warp:
    once a model's rois crowd onto a few map positions, a run holds thousands
    of rows, and that kernel took 85% of a C4 train step on the card."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        chans = grad.shape[-1]
        out = grad.new_zeros((ctx.rows, chans), dtype=torch.float32)
        out.index_add_(0, idx.reshape(-1), grad.reshape(-1, chans).float())
        return out.to(grad.dtype), None


def _corner_rows(table, base, w, yi, xi):
    """table rows at (yi, xi) of each roi's map: base (R,), w (R,) the map's
    width, yi and xi broadcasting to (R, n, n) -> (R, n, n, C)."""
    return _RowGather.apply(table, base[:, None, None] + yi * w[:, None, None] + xi)


class _Levels:
    """The maps of one batch as one (positions, C) table, and each level's
    (start row, height, width, scale)."""

    def __init__(self, feats: Sequence[torch.Tensor], scales: Sequence[float]):
        self.bsz, self.chans = feats[0].shape[:2]
        self.table = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, self.chans) for f in feats])
        self.levels, offset = [], 0
        for f, sc in zip(feats, scales):
            h, w = f.shape[2:]
            self.levels.append((offset, h, w, sc))
            offset += self.bsz * h * w


def _pooled_chunk(lv: _Levels, rois: torch.Tensor, levels: torch.Tensor, p: int, s: int,
                  pool: bool, offsets: Optional[torch.Tensor], trans_std: float
                  ) -> torch.Tensor:
    dev = rois.device
    # the per-level constants of each roi, selected without a host copy
    scale = torch.zeros(rois.shape[0], device=dev)
    hm1, wm1 = torch.zeros_like(scale), torch.zeros_like(scale)
    hmax = torch.zeros(rois.shape[0], dtype=torch.long, device=dev)
    wmax, wid, start = torch.zeros_like(hmax), torch.zeros_like(hmax), torch.zeros_like(hmax)
    for i, (offset, h, w, sc) in enumerate(lv.levels):
        on = levels == i
        scale = torch.where(on, sc, scale)
        hm1, wm1 = torch.where(on, h - 1.0, hm1), torch.where(on, w - 1.0, wm1)
        hmax, wmax = torch.where(on, h - 1, hmax), torch.where(on, w - 1, wmax)
        wid = torch.where(on, w, wid)
        start = torch.where(on, offset, start)
    bidx = rois[:, 0].long()
    base = start + bidx.clamp(0, lv.bsz - 1) * (hmax + 1) * wid

    x1, y1 = rois[:, 1] * scale, rois[:, 2] * scale
    x2, y2 = rois[:, 3] * scale, rois[:, 4] * scale
    if pool:
        bin_w = (x2 - x1 + 1).clamp(min=1.0) / p
        bin_h = (y2 - y1 + 1).clamp(min=1.0) / p
    else:
        roi_w, roi_h = (x2 - x1).clamp(min=1e-6), (y2 - y1).clamp(min=1e-6)
        bin_w, bin_h = roi_w / p, roi_h / p
    # the sample positions y1 + i * bin_h with one rounding (a fused
    # multiply-add, as XLA contracts it in ioudet): at 50 pixels, a second
    # rounding moves a bilinear weight by ~4e-6
    ii = (torch.arange(p * s, dtype=torch.float32, device=dev) + 0.5) / s
    ys = torch.addcmul(y1[:, None], ii, bin_h[:, None])[:, :, None]
    xs = torch.addcmul(x1[:, None], ii, bin_w[:, None])[:, None, :]
    if offsets is not None:
        # each bin's shift, on its s x s samples, added after the grid's FMA
        # as ioudet adds it
        dy = (offsets[..., 0] * trans_std) * roi_h[:, None, None]
        dx = (offsets[..., 1] * trans_std) * roi_w[:, None, None]
        ys = ys + dy.repeat_interleave(s, 1).repeat_interleave(s, 2)
        xs = xs + dx.repeat_interleave(s, 1).repeat_interleave(s, 2)
    hm1, wm1 = hm1[:, None, None], wm1[:, None, None]
    ys, xs = torch.minimum(ys.clamp(min=0.0), hm1), torch.minimum(xs.clamp(min=0.0), wm1)
    # a NaN position (a diverged model's roi) indexes the map's first row or
    # column, as ioudet's gather clamps it, not outside the table
    hmax, wmax = hmax[:, None, None], wmax[:, None, None]
    y0 = torch.minimum(ys.floor().long().clamp(min=0), hmax)
    x0 = torch.minimum(xs.floor().long().clamp(min=0), wmax)
    y1i, x1i = torch.minimum(y0 + 1, hmax), torch.minimum(x0 + 1, wmax)
    wy, wx = ys - y0, xs - x0
    table = lv.table
    samples = (_corner_rows(table, base, wid, y0, x0) * ((1 - wy) * (1 - wx))[..., None] +
               _corner_rows(table, base, wid, y0, x1i) * ((1 - wy) * wx)[..., None] +
               _corner_rows(table, base, wid, y1i, x0) * (wy * (1 - wx))[..., None] +
               _corner_rows(table, base, wid, y1i, x1i) * (wy * wx)[..., None])
    bins = samples.reshape(-1, p, s, p, s, lv.chans)
    out = bins.amax(dim=(2, 4)) if pool else bins.mean(dim=(2, 4))
    out = torch.where((bidx >= 0)[:, None, None, None], out, 0.0)
    return out.permute(0, 3, 1, 2)


def _pooled(feats: Sequence[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
            scales: Sequence[float], pooled_size: int, sample_num: int, pool: bool,
            offsets: Optional[torch.Tensor] = None, trans_std: float = 0.1) -> torch.Tensor:
    p, s = pooled_size, max(sample_num, 1)
    lv = _Levels(feats, scales)
    step = chunk_rois(p * s, lv.chans)
    parts = [_pooled_chunk(lv, rois[i:i + step], levels[i:i + step], p, s, pool,
                           None if offsets is None else offsets[i:i + step], trans_std)
             for i in range(0, max(rois.shape[0], 1), step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def roi_align_levels(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                     levels: torch.Tensor, spatial_scales: Sequence[float],
                     pooled_size: int = 7, sample_num: int = 2,
                     offsets: Optional[torch.Tensor] = None,
                     trans_std: float = 0.1) -> torch.Tensor:
    """RoIAlign of each roi on its own level: feats NCHW maps of one batch,
    rois (R, 5), levels (R,) int in [0, len(feats)), ``spatial_scales`` one
    a map; with ``offsets`` (R, P, P, 2), (dy, dx) a bin in units of the
    roi's size over ``trans_std``, each bin's samples shifted by them.
    Returns (R, C, P, P)."""
    return _pooled(feats, rois, levels, spatial_scales, pooled_size, sample_num, False,
                   offsets, trans_std)


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
