"""Mask targets (counterpart of ``ioudet/core/mask/mask_target.py``).

Each gt instance's mask is a fixed (S, S) uint8 crop in its own box frame
(S = 112), rasterized once on the host from its polygons
(``rasterize_polygons``), never a full-image bitmap: samples stay
rectangular (max_gt x S x S), resizing leaves the crops alone and a flip
mirrors them.  ``mask_target`` resamples each positive roi's gt crop into
the roi's window at 28 x 28 by bilinear sampling, zero outside the crop:
one gather of every roi's four taps at once, on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .rle import fill_polygon


def rasterize_polygons(polygons, box, out_size: int = 112) -> np.ndarray:
    """COCO polygons (lists of x, y) -> the (S, S) uint8 mask in the frame of
    ``box`` (x1, y1, x2, y2): vertices ((x - x1) / w * S, (y - y1) / h * S)
    in float32, w and h floored at 1e-3, each polygon of at least 3
    vertices filled as ``ioudet``'s ``PIL.ImageDraw.polygon`` fills it."""
    x1, y1, x2, y2 = np.asarray(box, np.float32)[:4]
    w = np.maximum(x2 - x1, np.float32(1e-3))
    h = np.maximum(y2 - y1, np.float32(1e-3))
    out = np.zeros((out_size, out_size), np.uint8)
    for poly in polygons:
        pts = np.asarray(poly, np.float32).reshape(-1, 2)
        pts = np.stack([(pts[:, 0] - x1) / w * np.float32(out_size),
                        (pts[:, 1] - y1) / h * np.float32(out_size)], axis=1)
        if len(pts) >= 3:
            fill_polygon(pts, out_size, out_size, out)
    return out


def _sample_coords(roi_lo, roi_hi, gt_lo, gt_size, out_size: int, size: int) -> tuple:
    """Along one axis: (floor index (R, out), fraction (R, out)) of each
    output's sample in the gt crop, ys = lo + (i + 0.5) / out * (hi - lo)
    and m = (ys - gt_lo) / gt_size * S - 0.5, rounded as XLA rounds them:
    the division by ``out`` a product with its f32 reciprocal, and both
    sums contracted into one FMA each (addcmul)."""
    dev = roi_lo.device
    step = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * \
        float(np.float32(1.0 / out_size))
    pos = torch.addcmul(roi_lo[:, None], step[None, :], (roi_hi - roi_lo)[:, None])
    t = (pos - gt_lo[:, None]) / gt_size[:, None]
    m = torch.addcmul(torch.full_like(t, -0.5), t, torch.full_like(t, float(size)))
    m0 = torch.floor(m)
    return m0.long(), m - m0


def crop_mask_to_roi(gt_masks: torch.Tensor, gt_boxes: torch.Tensor, rois: torch.Tensor,
                     out_size: int = 28) -> torch.Tensor:
    """Resample box-frame gt masks (R, S, S) with their boxes (R, 4) into
    the windows rois (R, 4) at (out, out): a point p of a roi maps to
    (p - gt_xy) / gt_wh * S in the crop, sampled bilinearly, 0 outside
    [0, S)."""
    S = gt_masks.shape[-1]
    r = gt_masks.shape[0]
    gw = (gt_boxes[:, 2] - gt_boxes[:, 0]).clamp(min=1e-3)
    gh = (gt_boxes[:, 3] - gt_boxes[:, 1]).clamp(min=1e-3)
    y0, wy = _sample_coords(rois[:, 1], rois[:, 3], gt_boxes[:, 1], gh, out_size, S)
    x0, wx = _sample_coords(rois[:, 0], rois[:, 2], gt_boxes[:, 0], gw, out_size, S)
    flat = gt_masks.reshape(r, S * S)

    def at(yi, xi):
        inb = ((yi >= 0) & (yi < S))[:, :, None] & ((xi >= 0) & (xi < S))[:, None, :]
        idx = yi.clamp(0, S - 1)[:, :, None] * S + xi.clamp(0, S - 1)[:, None, :]
        v = torch.gather(flat, 1, idx.reshape(r, -1)).reshape(idx.shape).float()
        return torch.where(inb, v, 0.0)

    wx_, wy_ = wx[:, None, :], wy[:, :, None]
    top = at(y0, x0) * (1 - wx_) + at(y0, x0 + 1) * wx_
    bottom = at(y0 + 1, x0) * (1 - wx_) + at(y0 + 1, x0 + 1) * wx_
    return top * (1 - wy_) + bottom * wy_


def mask_target(gt_masks: torch.Tensor, gt_boxes: torch.Tensor, rois: torch.Tensor,
                roi_gt_idx: torch.Tensor, pos_mask: torch.Tensor,
                out_size: int = 28) -> torch.Tensor:
    """Batched: gt_masks (B, G, S, S) uint8, gt_boxes (B, G, 4), rois (B, N,
    4), roi_gt_idx (B, N) each roi's assigned gt, pos_mask (B, N).  Returns
    (B, N, out, out) f32 targets, 0 for the rois that are not positive."""
    bsz, g = gt_masks.shape[:2]
    n = rois.shape[1]
    safe = roi_gt_idx.long().clamp(0, g - 1)
    gi = (safe + torch.arange(bsz, device=safe.device)[:, None] * g).reshape(-1)
    masks = gt_masks.reshape(bsz * g, *gt_masks.shape[2:])[gi]
    boxes = gt_boxes.reshape(bsz * g, 4)[gi].float()
    t = crop_mask_to_roi(masks, boxes, rois.reshape(-1, 4).float(), out_size)
    return (t * pos_mask.reshape(-1, 1, 1).float()).reshape(bsz, n, out_size, out_size)
