"""On-device image preprocessing (counterpart of ``ioudet/ops/preprocess.py``):
the reference's host Resize -> Normalize -> Pad as tensor ops on the image's
device, writing straight onto the fixed canvas.

Keep-ratio factor = min(long / max(h, w), short / min(h, w)), or without
keep_ratio the exact (h, w) of ``max_scale`` and the factors (w_scale,
h_scale, w_scale, h_scale) of ``ioudet``'s Resize (SSD's); bilinear
resize with half-pixel centres (cv2's sampling); the content lands at the
canvas origin and the pad region is 0 after normalisation (Pad(pad_val=0) on
the normalised image).  Plain torch, no image library.
"""

from __future__ import annotations

from typing import Tuple

import torch

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def preprocess_batch(imgs: torch.Tensor, src_shapes: torch.Tensor,
                     canvas: Tuple[int, int] = (832, 1344),
                     max_scale: Tuple[int, int] = (1333, 800),
                     mean: Tuple[float, ...] = IMAGENET_MEAN,
                     std: Tuple[float, ...] = IMAGENET_STD,
                     flip_channels: bool = False, keep_ratio: bool = True):
    """imgs (B, H, W, 3) uint8 (content in the top-left (src_h, src_w));
    src_shapes (B, 2) int.  Returns (canvas (B, ch, cw, 3) f32, img_shapes
    (B, 2) int32, scale_factors (B,) f32, or (B, 4) without keep_ratio)."""
    if flip_channels:  # BGR buffers -> RGB
        imgs = imgs.flip(-1)
    bsz, h, w, _ = imgs.shape
    dev = imgs.device
    src_h = src_shapes[:, 0].float()
    src_w = src_shapes[:, 1].float()
    if keep_ratio:
        long_t, short_t = float(max(max_scale)), float(min(max_scale))
        factor = torch.minimum(long_t / torch.maximum(src_h, src_w),
                               short_t / torch.minimum(src_h, src_w))
        new_h = torch.round(src_h * factor).int()
        new_w = torch.round(src_w * factor).int()
    else:
        new_h = torch.full_like(src_shapes[:, 0], max_scale[0], dtype=torch.int32)
        new_w = torch.full_like(src_shapes[:, 1], max_scale[1], dtype=torch.int32)
        # the quotient in f64, rounded once to f32, as the host Resize's
        fw = (max_scale[1] / src_shapes[:, 1].double()).float()
        fh = (max_scale[0] / src_shapes[:, 0].double()).float()
        factor = torch.stack([fw, fh, fw, fh], dim=1)

    ch, cw = canvas
    # sample the full canvas grid scaled for the valid region, then mask out
    # beyond (new_h, new_w)
    sh = src_h * (ch / new_h.clamp(min=1))
    sw = src_w * (cw / new_w.clamp(min=1))
    ys = ((torch.arange(ch, device=dev) + 0.5) * (sh / ch)[:, None] - 0.5)
    xs = ((torch.arange(cw, device=dev) + 0.5) * (sw / cw)[:, None] - 0.5)
    ys = torch.minimum(ys.clamp(min=0.0), (sh - 1.0)[:, None])
    xs = torch.minimum(xs.clamp(min=0.0), (sw - 1.0)[:, None])
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    f = imgs.float()
    b = torch.arange(bsz, device=dev)[:, None, None]

    def at(yi, xi):
        # canvas pixels past (new_h, new_w) sample beyond the buffer and are
        # masked below; clamp their indices as XLA's gather does
        yi, xi = yi.clamp(max=h - 1), xi.clamp(max=w - 1)
        return f[b, yi[:, :, None], xi[:, None, :]]

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    resized = top * (1 - wy) + bot * wy
    # per channel with Python scalars: no constant tensor copied to the device
    norm = torch.stack([(resized[..., c] - mean[c]) / std[c] for c in range(3)],
                       dim=-1)
    row = torch.arange(ch, device=dev)[None, :] < new_h[:, None]
    col = torch.arange(cw, device=dev)[None, :] < new_w[:, None]
    out = norm * (row[:, :, None] & col[:, None, :])[..., None]
    return out, torch.stack([new_h, new_w], dim=1), factor


def preprocess(img: torch.Tensor, src_shape: torch.Tensor, **kwargs):
    """One image: img (H, W, 3) uint8, src_shape (2,).  Returns (canvas
    (ch, cw, 3) f32, img_shape (2,) int32, scale_factor () f32, or (4,)
    without keep_ratio)."""
    out, shape, factor = preprocess_batch(img[None], src_shape[None], **kwargs)
    return out[0], shape[0], factor[0]
