"""Host-side image and box transforms (counterpart of
``ioudet/data/pipelines/transforms.py``: Resize, RandomFlip, Normalize,
Pad).

  * Resize keep_ratio: factor = min(long / max(h, w), short / min(h, w))
    (mmcv imrescale), output size int(dim * factor + 0.5);
  * ``imresize`` is the port's own bilinear resize in numpy, bit-exact
    with ``cv2.resize(..., INTER_LINEAR)`` on uint8 (see its docstring); it
    is used on every machine, whether cv2 is there or not;
  * flip mirrors boxes with the +1 convention (x2' = w - x1 - 1) and the
    box-frame gt masks with them; Resize leaves those masks alone;
  * Normalize: (img - mean) / std in f32 after BGR -> RGB when to_rgb;
  * Pad: to ``size_divisor`` (``pad_shape``) and onto a fixed canvas, one
    per orientation (one for both with ``orient_aware=False``);
  * a float32 image (after ``PhotoMetricDistortion``) is resized by
    ``imresize_float``, OpenCV's float ``INTER_LINEAR`` bit for bit;
  * Resize and RandomFlip take a view's ``scale_override`` /
    ``flip_override`` from ``MultiScaleFlipAug`` (``test_aug.py``);
  * a semantic label map (``gt_semantic_seg``) is resized by
    ``imresize_nearest`` (cv2's INTER_NEAREST rule, in numpy), flipped with
    the image, padded with 255 (ignore) onto the canvas, and scaled to the
    semantic head's stride by ``SegRescale``.

The SSD augmentations, drawing from the sample's stream in ``ioudet``'s
order: ``PhotoMetricDistortion`` (brightness, contrast before or after the
HSV steps, saturation, hue, a channel swap; OpenCV's float BGR <-> HSV
written in numpy, ``bgr_to_hsv`` / ``hsv_to_bgr``), ``Expand`` (onto a
canvas of the mean, up to 4x) and ``MinIoURandomCrop`` (up to 50 tries a
drawn minimum IoU, the gts whose centres stay, clipped).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ...core.mask.rle import _fma, resize_bilinear
from ..rng import sample_rng

COEF_BITS = 11   # cv2's INTER_RESIZE_COEF_BITS: coefficients in steps of 1/2048
COEF_SCALE = 1 << COEF_BITS


def imrescale_size(h: int, w: int, scale: Tuple[int, int]) -> Tuple[int, int, float]:
    """mmcv.imrescale sizing: scale = (long, short) bound."""
    max_long, max_short = max(scale), min(scale)
    factor = min(max_long / max(h, w), max_short / min(h, w))
    return int(h * factor + 0.5), int(w * factor + 0.5), factor


def _taps(dst: int, src: int):
    """cv2's source index and fraction of each output pixel along one axis:
    half-pixel centres, the coordinate rounded to f32 once, the fraction
    taken in f32, both coefficients rounded to 1/2048 (half to even)."""
    scale = 1.0 / (dst / src)   # cv2 inverts the inverse scale
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    return s, f


def _coefs(f: np.ndarray):
    one = np.float32(1)
    return (np.rint((one - f) * np.float32(COEF_SCALE)).astype(np.int32),
            np.rint(f * np.float32(COEF_SCALE)).astype(np.int32))


def imresize(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an (H, W[, C]) uint8 image to ``size_hw``,
    bit-exact with ``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)``:

      * the same size is a copy; exactly half in both axes is cv2's area
        path, (a + b + c + d + 2) >> 2;
      * otherwise two fixed-point passes.  Along x, a source index below 0
        or at the last column clamps with weight 0 on the second tap, and
        each row becomes int32 sums in units of 1/2048.  Along y the row
        indices clamp but the weights do not, and the two rows combine as
        cv2's uint8 kernel does: (((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >>
        4)) >> 16) + 2) >> 2.
    """
    if img.dtype != np.uint8:
        raise ValueError(f"imresize takes uint8 images, got {img.dtype}")
    h, w = img.shape[:2]
    dh, dw = size_hw
    if (dh, dw) == (h, w):
        return img.copy()
    if 2 * dh == h and 2 * dw == w:
        s = img.astype(np.int32)
        s = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    src = img.reshape(h, w, -1).astype(np.int32)
    sx, fx = _taps(dw, w)
    edge = (sx < 0) | (sx >= w - 1)
    fx[edge] = 0
    sx = np.clip(sx, 0, w - 1)
    a0, a1 = _coefs(fx)
    sy, fy = _taps(dh, h)
    b0, b1 = _coefs(fy)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    # only the source rows that some output row reads
    rows, inv = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    part = src[rows]
    hor = part[:, sx] * a0[:, None] + part[:, np.minimum(sx + 1, w - 1)] * a1[:, None]
    hor >>= 4
    r0, r1 = hor[inv[:dh]], hor[inv[dh:]]
    out = ((b0[:, None, None] * r0) >> 16) + ((b1[:, None, None] * r1) >> 16)
    out = (out + 2) >> 2
    return out.astype(np.uint8).reshape((dh, dw) + img.shape[2:])


def imresize_float(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an (H, W, C) float32 image, bit-exact with
    ``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)``: each channel
    through ``core.mask.rle.resize_bilinear`` (OpenCV's float path)."""
    return np.stack([resize_bilinear(img[..., c], size_hw) for c in range(img.shape[2])],
                    axis=-1)


def imresize_nearest(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest resize of a label map, as ``cv2.resize(img, (w, h),
    interpolation=INTER_NEAREST)``: source index floor(dst * (1 / (dst /
    src))) in double, clamped to the last row or column."""
    h, w = img.shape[:2]
    dh, dw = size_hw
    rows = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / h))).astype(np.int64), h - 1)
    cols = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / w))).astype(np.int64), w - 1)
    return np.ascontiguousarray(img[rows][:, cols])


class Resize:
    """keep_ratio rescale into ``img_scale`` (long, short), or to it exactly
    without keep_ratio; several scales are sampled per image ('range': long
    and short edges uniformly between the ends; 'value': one of them).  A
    sample's ``scale_override`` (set by ``MultiScaleFlipAug`` for its view)
    takes the place of ``img_scale``, and nothing is drawn then."""

    def __init__(self, img_scale=(1333, 800), keep_ratio: bool = True,
                 multiscale_mode: str = "range"):
        self.img_scale = img_scale if isinstance(img_scale[0], (tuple, list)) \
            else [tuple(img_scale)]
        self.keep_ratio = keep_ratio
        self.multiscale_mode = multiscale_mode

    def _pick_scale(self):
        if len(self.img_scale) == 1:
            return self.img_scale[0]
        if self.multiscale_mode == "value":
            return sample_rng().choice(self.img_scale)
        longs = [max(s) for s in self.img_scale]
        shorts = [min(s) for s in self.img_scale]
        return (sample_rng().randint(min(longs), max(longs)),
                sample_rng().randint(min(shorts), max(shorts)))

    def __call__(self, results: dict) -> dict:
        img = results["img"]
        h, w = img.shape[:2]
        scale = results.get("scale_override") or self._pick_scale()
        if self.keep_ratio:
            nh, nw, factor = imrescale_size(h, w, scale)
        else:
            nh, nw = scale
            factor = np.array([nw / w, nh / h, nw / w, nh / h], np.float32)
        resize = imresize_float if img.dtype == np.float32 else imresize
        results["img"] = resize(img, (nh, nw))
        results["img_shape"] = (nh, nw)
        results["scale_factor"] = factor
        # the proposals' padding rows are zeros and stay zeros
        for key in ("gt_bboxes", "gt_bboxes_ignore", "proposals"):
            if key in results and len(results[key]):
                results[key] = results[key] * factor
        if "gt_semantic_seg" in results:
            results["gt_semantic_seg"] = imresize_nearest(results["gt_semantic_seg"], (nh, nw))
        return results


class RandomFlip:
    """Horizontal flip with probability ``flip_ratio``, drawn from the
    sample's stream; a sample's ``flip_override`` (``MultiScaleFlipAug``'s
    view) decides instead, and then nothing is drawn, so the stream stays
    ``ioudet``'s."""

    def __init__(self, flip_ratio: float = 0.5):
        self.flip_ratio = flip_ratio

    def __call__(self, results: dict) -> dict:
        if "flip_override" in results:
            flip = bool(results["flip_override"])
        else:
            flip = sample_rng().random() < self.flip_ratio
        results["flip"] = flip
        if flip:
            results["img"] = np.ascontiguousarray(results["img"][:, ::-1])
            w = results["img_shape"][1]
            for key in ("gt_bboxes", "gt_bboxes_ignore", "proposals"):
                if key in results and len(results[key]):
                    b = results[key].copy()
                    b[:, 0] = w - results[key][:, 2] - 1
                    b[:, 2] = w - results[key][:, 0] - 1
                    if key == "proposals" and "prop_valid" in results:
                        b[~results["prop_valid"]] = 0.0   # the padding rows stay 0
                    results[key] = b
            if "gt_masks" in results and len(results["gt_masks"]):
                # a box-frame mask mirrors with its box
                results["gt_masks"] = np.ascontiguousarray(results["gt_masks"][:, :, ::-1])
            if "gt_semantic_seg" in results:
                results["gt_semantic_seg"] = np.ascontiguousarray(
                    results["gt_semantic_seg"][:, ::-1])
        return results


class Normalize:
    def __init__(self, mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375), to_rgb: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results: dict) -> dict:
        img = results["img"].astype(np.float32)
        if self.to_rgb and results.get("channel_order", "bgr") == "bgr":
            img = img[..., ::-1]
        results["img"] = (img - self.mean) / self.std
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std, to_rgb=self.to_rgb)
        return results


class Pad:
    """Pad with zeros to ``size_divisor`` (recorded as ``pad_shape``) and
    onto the fixed canvas ``size``, turned for portrait images unless
    ``orient_aware`` is False (SSD's square canvas); a semantic label map
    onto the same canvas with 255."""

    def __init__(self, size: Optional[Tuple[int, int]] = None,
                 size_divisor: Optional[int] = None, orient_aware: bool = True):
        self.size = tuple(size) if size else None
        self.size_divisor = size_divisor
        self.orient_aware = orient_aware

    def __call__(self, results: dict) -> dict:
        img = results["img"]
        h, w = img.shape[:2]
        if self.size_divisor:
            ph = int(np.ceil(h / self.size_divisor)) * self.size_divisor
            pw = int(np.ceil(w / self.size_divisor)) * self.size_divisor
        else:
            ph, pw = h, w
        results["pad_shape"] = (ph, pw)
        if self.size:
            th, tw = self.size
            if self.orient_aware and (h > w) != (th > tw):
                th, tw = tw, th
        else:
            th, tw = ph, pw
        if th < h or tw < w:
            raise ValueError(f"canvas {(th, tw)} is smaller than the image {(h, w)}")
        canvas = np.zeros((th, tw) + img.shape[2:], img.dtype)
        canvas[:h, :w] = img
        results["img"] = canvas
        if "gt_semantic_seg" in results:
            seg = results["gt_semantic_seg"]
            seg_canvas = np.full((th, tw), 255, seg.dtype)
            seg_canvas[:seg.shape[0], :seg.shape[1]] = seg
            results["gt_semantic_seg"] = seg_canvas
        return results


class SegRescale:
    """The semantic label map scaled by ``scale_factor`` (HTC's 1/8: the
    semantic head's stride) with ``imresize_nearest``, to
    int(side * scale_factor)."""

    def __init__(self, scale_factor: float = 1.0):
        self.scale_factor = scale_factor

    def __call__(self, results: dict) -> dict:
        if "gt_semantic_seg" in results and self.scale_factor != 1.0:
            seg = results["gt_semantic_seg"]
            size = (int(seg.shape[0] * self.scale_factor), int(seg.shape[1] * self.scale_factor))
            results["gt_semantic_seg"] = imresize_nearest(seg, size)
        return results


# OpenCV's float HSV (H in degrees [0, 360), S in [0, 1], V on the input's
# scale).  Its vector path, bit for bit: the hue offset added inside an FMA
# (and 360 with it where the hue would be negative), the inverse conversion's
# 1 - s * h and 1 - s * (1 - h) as FMAs.  OpenCV's scalar loop takes the last
# (width mod vector width) pixels of each row and rounds a hue once more
# there: within one f32 step of the hue.
_EPS = np.float32(np.finfo(np.float32).eps)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def bgr_to_hsv(img: np.ndarray, order: str = "bgr") -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2HSV)`` (``COLOR_RGB2HSV`` for
    ``order='rgb'``) of a float32 (H, W, 3) image."""
    f32 = np.float32
    img = np.asarray(img, f32)
    b, g, r = (img[..., i] for i in ((0, 1, 2) if order == "bgr" else (2, 1, 0)))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _EPS)
    scale = f32(60) / (diff + _EPS)
    r_max, g_max = v == r, (v != r) & (v == g)
    x = np.where(r_max, g - b, np.where(g_max, b - r, r - g))
    offset = np.where(r_max, f32(0), np.where(g_max, f32(120), f32(240)))
    h = _fma(x, scale, offset)
    h = np.where(h < 0, _fma(x, scale, offset + f32(360)), h)
    return np.stack([h, s, v], axis=-1)


def hsv_to_bgr(hsv: np.ndarray, order: str = "bgr") -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2BGR)`` (``COLOR_HSV2RGB`` for
    ``order='rgb'``) of a float32 (H, W, 3) HSV image."""
    f32 = np.float32
    hsv = np.asarray(hsv, f32)
    s, v = hsv[..., 1], hsv[..., 2]
    h = hsv[..., 0] * f32(6.0 / 360.0)
    while (h < 0).any():
        h = np.where(h < 0, h + f32(6), h)
    while (h >= 6).any():
        h = np.where(h >= 6, h - f32(6), h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    one = np.ones_like(h)
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, one), v * _fma(-s, one - h, one)],
                   axis=-1)
    out = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    out = np.where((s == 0)[..., None], v[..., None], out)
    return out if order == "bgr" else out[..., ::-1]


class PhotoMetricDistortion:
    """SSD's colour jitter on float32 pixels, unclipped: brightness, then
    contrast before or after the HSV steps (a coin), saturation and hue in
    float HSV (degrees, wrapped into [0, 360]), then a random channel
    swap; each step on a coin of 1/2."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, results: dict) -> dict:
        img = results["img"].astype(np.float32)
        order = results.get("channel_order", "bgr")
        rng = sample_rng()
        if rng.random() < 0.5:
            img = img + rng.uniform(-self.brightness_delta, self.brightness_delta)
        contrast_first = rng.random() < 0.5
        if contrast_first and rng.random() < 0.5:
            img = img * rng.uniform(*self.contrast_range)
        hsv = bgr_to_hsv(img, order)
        if rng.random() < 0.5:
            hsv[..., 1] *= rng.uniform(*self.saturation_range)
        if rng.random() < 0.5:
            hsv[..., 0] += rng.uniform(-self.hue_delta, self.hue_delta)
            hsv[..., 0][hsv[..., 0] > 360] -= 360
            hsv[..., 0][hsv[..., 0] < 0] += 360
        img = hsv_to_bgr(hsv, order)
        if not contrast_first and rng.random() < 0.5:
            img = img * rng.uniform(*self.contrast_range)
        if rng.random() < 0.5:
            img = img[..., rng.sample(range(3), 3)]
        results["img"] = img
        return results


class Expand:
    """With probability 1/2, the image onto a canvas ``ratio`` in
    ``ratio_range`` times its size, filled with the mean (given in RGB;
    reversed for a BGR image when ``to_rgb``), at a random offset; the gt
    boxes move with it."""

    def __init__(self, mean=(0, 0, 0), to_rgb=True, ratio_range=(1, 4)):
        self.mean = tuple(mean[::-1]) if to_rgb else tuple(mean)
        self.mean_rgb = tuple(mean)
        self.ratio_range = ratio_range

    def __call__(self, results: dict) -> dict:
        rng = sample_rng()
        if rng.random() < 0.5:
            return results
        img = results["img"]
        fill = self.mean_rgb if results.get("channel_order", "bgr") == "rgb" else self.mean
        h, w, c = img.shape
        ratio = rng.uniform(*self.ratio_range)
        eh, ew = int(h * ratio), int(w * ratio)
        top = rng.randint(0, eh - h)
        left = rng.randint(0, ew - w)
        canvas = np.empty((eh, ew, c), img.dtype)
        canvas[...] = fill
        canvas[top:top + h, left:left + w] = img
        results["img"] = canvas
        results["img_shape"] = (eh, ew)
        if "gt_bboxes" in results and len(results["gt_bboxes"]):
            results["gt_bboxes"] = results["gt_bboxes"] + np.array(
                [left, top, left, top], np.float32)
        return results


class MinIoURandomCrop:
    """SSD's crop: draw a minimum IoU from (1, *min_ious, 0) (1 returns the
    sample unchanged), then up to 50 crops of [min_crop_size, 1] of each
    side; a crop stands if its aspect is within [1/2, 2], every gt's IoU
    with it reaches the minimum, and some gt's centre lies inside it.  Those
    gts stay, clipped to the crop and shifted into it.  After 50 failures a
    new minimum is drawn."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), min_crop_size=0.3):
        self.min_ious = (1,) + tuple(min_ious) + (0,)
        self.min_crop_size = min_crop_size

    def __call__(self, results: dict) -> dict:
        rng = sample_rng()
        img = results["img"]
        h, w = img.shape[:2]
        boxes = results.get("gt_bboxes", np.zeros((0, 4), np.float32))
        while True:
            min_iou = rng.choice(self.min_ious)
            if min_iou == 1:
                return results
            for _ in range(50):
                cw = rng.uniform(self.min_crop_size * w, w)
                ch = rng.uniform(self.min_crop_size * h, h)
                if ch / cw < 0.5 or ch / cw > 2:
                    continue
                left = rng.uniform(0, w - cw)
                top = rng.uniform(0, h - ch)
                patch = np.array([left, top, left + cw, top + ch])
                if len(boxes):
                    ix1 = np.maximum(boxes[:, 0], patch[0])
                    iy1 = np.maximum(boxes[:, 1], patch[1])
                    ix2 = np.minimum(boxes[:, 2], patch[2])
                    iy2 = np.minimum(boxes[:, 3], patch[3])
                    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
                    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
                    ious = inter / np.maximum(area + cw * ch - inter, 1e-10)
                    if ious.min() < min_iou:
                        continue
                    ctr = (boxes[:, :2] + boxes[:, 2:]) / 2
                    keep = ((ctr[:, 0] > patch[0]) & (ctr[:, 0] < patch[2]) &
                            (ctr[:, 1] > patch[1]) & (ctr[:, 1] < patch[3]))
                    if not keep.any():
                        continue
                    kept = boxes[keep].copy()
                    kept[:, 0::2] = np.clip(kept[:, 0::2], patch[0], patch[2]) - patch[0]
                    kept[:, 1::2] = np.clip(kept[:, 1::2], patch[1], patch[3]) - patch[1]
                    results["gt_bboxes"] = kept.astype(np.float32)
                    if "gt_labels" in results:
                        results["gt_labels"] = results["gt_labels"][keep]
                x1, y1, x2, y2 = patch.astype(int)
                results["img"] = img[y1:y2, x1:x2]
                results["img_shape"] = results["img"].shape[:2]
                return results
