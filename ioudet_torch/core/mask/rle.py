"""COCO run-length encoding and the host side of instance masks, in numpy
(counterpart of ``ioudet/core/mask/rle.py``; pycocotools, PIL and cv2
are not dependencies).

  * RLE: runs are column-major and start with the count of zeros; the
    string form difference-codes the counts from the third on and packs
    each in 5-bit groups with a continuation bit, +48 (pycocotools').
  * ``fill_polygon`` is the scan conversion ``ioudet`` gets from
    ``PIL.ImageDraw.polygon(fill=1)`` (Pillow 12's ``polygon_generic``),
    pixel for pixel: vertices truncated to integers, one float32
    intersection an edge a row, corners joined, spans rounded half away
    from the pixel centre.  ``ann_to_rle`` rasterizes COCO polygons with it.
  * ``resize_bilinear`` is ``cv2.resize(prob, (w, h), INTER_LINEAR)`` on
    float32 (OpenCV 5), bit for bit; ``paste_mask`` resizes a box-frame
    probability map into the image with it and thresholds at 0.5.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

RLE = Dict  # {"size": [h, w], "counts": str | list}

f32 = np.float32


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """(h, w) {0, 1} -> column-major run counts, starting with a 0-run."""
    flat = np.asarray(mask, np.uint8).reshape(-1, order="F")
    if flat.size == 0:
        return np.zeros((0,), np.int64)
    change = np.nonzero(np.diff(flat))[0] + 1
    counts = np.diff(np.concatenate([[0], change, [flat.size]]))
    if flat[0] == 1:   # runs start with zeros
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def counts_to_mask(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, np.asarray(counts, np.int64))
    if flat.size != h * w:
        raise ValueError(f"RLE counts sum {flat.size} != {h}*{w}")
    return flat.reshape((h, w), order="F")


def counts_to_string(counts: Sequence[int]) -> str:
    """pycocotools' rleToString, for all counts at once: each count from
    the third on less the one two before it, then 5-bit groups from the
    lowest, 0x20 on all but the last, +48; a group is the last when the
    rest of the value is its sign's extension."""
    x = np.asarray(counts, np.int64).copy()
    if x.size == 0:
        return ""
    x[3:] -= np.asarray(counts, np.int64)[1:-2]
    bits = int(np.abs(x).max()).bit_length() + 1     # with the sign
    shifts = 5 * np.arange(bits // 5 + 1)
    group = (x[:, None] >> shifts) & 0x1F
    rest = x[:, None] >> (shifts + 5)
    more = np.where(group & 0x10, rest != -1, rest != 0)
    emit = np.ones_like(more)
    emit[:, 1:] = np.logical_and.accumulate(more[:, :-1], axis=1)
    chars = (group | np.where(more, 0x20, 0)) + 48
    return chars[emit].astype(np.uint8).tobytes().decode("ascii")


def string_to_counts(s: Union[str, bytes]) -> List[int]:
    """pycocotools' rleFrString."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
        if c & 0x10:
            x |= -1 << (5 * k)   # sign extension
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _counts_of(rle: RLE) -> List[int]:
    c = rle["counts"]
    return string_to_counts(c) if isinstance(c, (str, bytes)) else list(c)


def encode(mask: np.ndarray) -> RLE:
    """(h, w) binary mask -> compressed RLE dict."""
    h, w = mask.shape
    return dict(size=[int(h), int(w)], counts=counts_to_string(mask_to_counts(mask)))


def decode(rle: RLE) -> np.ndarray:
    h, w = rle["size"]
    return counts_to_mask(_counts_of(rle), int(h), int(w))


def area(rle: RLE) -> int:
    return int(np.sum(np.asarray(_counts_of(rle), np.int64)[1::2]))


def merge(rles: Sequence[RLE]) -> RLE:
    """Union of masks (pycocotools' merge with intersect=False)."""
    if len(rles) == 1:
        return dict(rles[0])
    m = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m |= decode(r).astype(bool)
    return encode(m.astype(np.uint8))


def _runs(counts: Sequence[int]) -> tuple:
    """(starts, ends) of the runs of ones, as flat column-major offsets."""
    bounds = np.cumsum(np.asarray(counts, np.int64))
    ends = bounds[1::2]
    return ends - np.asarray(counts, np.int64)[1::2], ends


def _covered(starts: np.ndarray, ends: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Pixels of the runs [starts, ends) below each offset x."""
    if not len(starts):
        return np.zeros(x.shape, np.int64)
    before = np.concatenate([[0], np.cumsum(ends - starts)])
    k = np.searchsorted(starts, x, side="right") - 1
    kc = np.maximum(k, 0)
    part = np.minimum(x, ends[kc]) - starts[kc]
    return np.where(k >= 0, before[kc] + part, 0)


def iou(dt: Sequence[RLE], gt: Sequence[RLE], iscrowd: Sequence[int]) -> np.ndarray:
    """(D, G) mask IoU from the runs, without decoding; against a crowd gt
    the intersection over the det's area (pycocotools' rleIou).  f64, as
    ``inter / max(union, 1e-10)``."""
    D, G = len(dt), len(gt)
    out = np.zeros((D, G))
    if D * G == 0:
        return out
    d_runs = [_runs(_counts_of(r)) for r in dt]
    g_runs = [_runs(_counts_of(r)) for r in gt]
    d_area = [int((e - s).sum()) for s, e in d_runs]
    g_area = [int((e - s).sum()) for s, e in g_runs]
    for j, (gs, ge) in enumerate(g_runs):
        for i, (ds, de) in enumerate(d_runs):
            inter = int((_covered(gs, ge, de) - _covered(gs, ge, ds)).sum())
            union = d_area[i] if iscrowd[j] else d_area[i] + g_area[j] - inter
            out[i, j] = inter / max(float(union), 1e-10)
    return out


# ---------------------------------------------------------------------------
# polygons: Pillow's scan conversion
# ---------------------------------------------------------------------------

def _roundf(v: np.ndarray) -> np.ndarray:
    """C's roundf on float32: half away from zero."""
    v = np.asarray(v, f32)
    return np.copysign(np.floor(np.abs(v.astype(np.float64)) + 0.5), v).astype(f32)


def _round_up(v: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_UP: floorf(v + 0.5f) from 0 up, -floor(|v| + 0.5) below."""
    v = np.asarray(v, f32)
    pos = np.floor(v + f32(0.5)).astype(np.int64)
    neg = -np.floor(np.abs(v.astype(np.float64)) + 0.5).astype(np.int64)
    return np.where(v >= 0, pos, neg)


def _round_down(v: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_DOWN: ceilf(v - 0.5f) from 0 up, -ceil(|v| - 0.5) below."""
    v = np.asarray(v, f32)
    pos = np.ceil(v - f32(0.5)).astype(np.int64)
    neg = -np.ceil(np.abs(v.astype(np.float64)) - 0.5).astype(np.int64)
    return np.where(v >= 0, pos, neg)


def _edges(pts: np.ndarray) -> np.ndarray:
    """Pillow's edge list of integer vertices (E, 8): x0, y0 (the start),
    xmin, xmax, ymin, ymax, x1, y1 (the end).  A horizontal edge that
    continues the last one in the same direction widens it; the polygon is
    closed unless its last vertex is its first."""
    xy = pts.reshape(-1).tolist()
    n = len(pts)
    edges: List[list] = []
    for i in range(n - 1):
        x0, y0, x1, y1 = xy[2 * i:2 * i + 4]
        if y0 == y1 and i != 0 and y0 == xy[2 * i - 1]:
            if x1 > x0 > xy[2 * i - 2]:
                edges[-1][3] = x1
                continue
            if x1 < x0 < xy[2 * i - 2]:
                edges[-1][2] = x1
                continue
        edges.append([x0, y0, min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1), x1, y1])
    if xy[-2] != xy[0] or xy[-1] != xy[1]:
        x0, y0, x1, y1 = xy[-2], xy[-1], xy[0], xy[1]
        edges.append([x0, y0, min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1), x1, y1])
    return np.asarray(edges, np.int64).reshape(-1, 8)


def _spans(out: np.ndarray, rows: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> None:
    """Pillow's hline8 for each (row, x0, x1): x0 below 0 starts at 0, x1 past
    the image ends at its last column, nothing where x0 is past the image
    or x1 before it, or x0 > x1 after that."""
    h, w = out.shape
    x0 = np.maximum(x0, 0)
    x1 = np.minimum(x1, w - 1)
    ok = (rows >= 0) & (rows < h) & (x0 < w) & (x1 >= 0) & (x0 <= x1)
    if not ok.any():
        return
    diff = np.zeros((h, w + 1), np.int32)
    np.add.at(diff, (rows[ok], x0[ok]), 1)
    np.add.at(diff, (rows[ok], x1[ok] + 1), -1)
    out |= (np.cumsum(diff[:, :w], axis=1) > 0).astype(np.uint8)


def fill_polygon(points, h: int, w: int, out: np.ndarray = None) -> np.ndarray:
    """Fill one polygon (vertices (N, 2) x, y) into an (h, w) uint8 mask as
    ``ImageDraw.Draw(img).polygon(points, fill=1)`` fills it on an "L"
    image, and return the mask (``out``, ORed into, if given).

    Pillow's rules, in order: the vertices are truncated toward zero; each
    horizontal edge is drawn as a line; every other edge gives, at each row
    it spans, x = (y - y0) * dx + x0 in float32, and one more copy of it at
    its last row unless that is the polygon's last row.  At the first or
    last row of edge i, if an earlier edge k (k < i, ending or starting on
    the same row, dx != 0, the same x after roundf, also spanning the next
    row, or the previous one at edge i's last row) forms a corner with it,
    and the corner points outward beyond both edges' x on that next row by
    more than a pixel, edge i's x moves to one pixel beyond the nearer of
    them (roundf, then +-1).  Each row's x values are sorted and taken in
    pairs (ROUND_UP of the first, ROUND_DOWN of the second)."""
    if out is None:
        out = np.zeros((h, w), np.uint8)
    pts = np.trunc(np.asarray(points, np.float64).reshape(-1, 2)).astype(np.int64)
    if len(pts) == 0:
        return out
    e = _edges(pts)
    flat = e[:, 4] == e[:, 5]
    ymin_all = min(h - 1, int(e[:, 4].min()))
    ymax_all = max(0, int(e[:, 5].max()))
    _spans(out, e[flat, 4], e[flat, 2], e[flat, 3])
    t = e[~flat]
    if not len(t):
        return out
    x0, y0, ymin, ymax = t[:, 0], t[:, 1], t[:, 4], t[:, 5]
    dx = (t[:, 6] - x0).astype(f32) / (t[:, 7] - y0).astype(f32)
    ylast = min(ymax_all, h)
    rows = np.arange(max(ymin_all, 0), min(ylast, h - 1) + 1)
    if not len(rows):
        return out

    def at(y, idx=slice(None)):
        # x of the edges idx at rows y, as Pillow computes it
        return (y - y0[idx]).astype(f32) * dx[idx] + x0[idx].astype(f32)

    # corners: (edge i, its first or last row) against the earlier edges
    n = len(t)
    x = at(rows[:, None])                                          # (R, E)
    for y_end, last in ((ymin, False), (ymax, True)):
        cand = np.arange(n) >= 1
        if last:    # the copy rule takes an edge's last row unless it is the polygon's
            cand &= y_end >= ylast
        cand &= (dx != 0) & (y_end >= rows[0]) & (y_end <= rows[-1])
        for i in np.nonzero(cand)[0]:
            y = int(y_end[i])
            xi = at(np.asarray(y), i)
            k = np.arange(i)
            ok = ((ymin[k] == y) | (ymax[k] == y)) & (dx[k] != 0)
            ok &= _roundf(at(np.asarray(y), k)) == _roundf(xi)
            yo = y + (-1 if y == ymax[i] else 1)
            ok &= (ymin[k] <= yo) & (yo <= ymax[k])
            if not ok.any():
                continue
            kk = int(np.argmax(ok))
            a, b = at(np.asarray(yo), i), at(np.asarray(yo), kk)
            if xi > a + f32(1) and xi > b + f32(1):
                x[y - rows[0], i] = _roundf(max(a, b)) + f32(1)
            elif xi < a - f32(1) and xi < b - f32(1):
                x[y - rows[0], i] = _roundf(min(a, b)) - f32(1)

    yy = rows[:, None]
    active = (ymin <= yy) & (yy <= ymax)
    dup = active & (yy == ymax) & (yy < ylast)
    vals = np.concatenate([np.where(active, x, f32(np.inf)),
                           np.where(dup, x, f32(np.inf))], axis=1)
    vals.sort(axis=1)
    count = active.sum(1) + dup.sum(1)
    pairs = vals.shape[1] // 2
    first, second = vals[:, 0:2 * pairs:2], vals[:, 1:2 * pairs:2]
    use = (2 * np.arange(pairs) + 1)[None, :] < count[:, None]
    r = np.broadcast_to(yy, use.shape)[use]
    _spans(out, r, _round_up(first[use]), _round_down(second[use]))
    return out


def ann_to_rle(segm, h: int, w: int) -> RLE:
    """A COCO ``segmentation`` (polygon list, uncompressed or compressed
    RLE dict) -> compressed RLE; polygons are filled at the full image
    size, each with at least 3 vertices (f64 coordinates)."""
    if isinstance(segm, dict):
        counts = segm["counts"]
        if isinstance(counts, list):
            return dict(size=list(segm["size"]), counts=counts_to_string(counts))
        return dict(size=list(segm["size"]), counts=counts)
    mask = np.zeros((int(h), int(w)), np.uint8)
    for poly in segm:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) >= 3:
            fill_polygon(pts, int(h), int(w), mask)
    return encode(mask)


# ---------------------------------------------------------------------------
# box-frame probabilities -> image masks
# ---------------------------------------------------------------------------

def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 a * b + c rounded once (an FMA): the exact product plus c in
    f64 (TwoSum keeps its rounding error), then to f32, moved off an f32
    midpoint by the sign of that error."""
    p = a.astype(np.float64) * b.astype(np.float64)   # exact: 24 + 24 bits
    c = c.astype(np.float64)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    r = s.astype(f32)
    lo, hi = np.nextafter(r, f32(-np.inf)), np.nextafter(r, f32(np.inf))
    r = np.where((s == (r.astype(np.float64) + lo) / 2) & (err < 0), lo, r)
    return np.where((s == (r.astype(np.float64) + hi) / 2) & (err > 0), hi, r)


def _linear_taps(dst: int, src: int) -> tuple:
    """Source index and float32 fraction of each output pixel: half-pixel
    centres in f64 with scale src / dst, the fraction rounded to f32."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(f).astype(np.int64)
    return s, (f - s).astype(f32)


def resize_bilinear(img: np.ndarray, size_hw) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)`` of a 2-D
    float32 map, bit for bit (OpenCV 5's float path): the same size is a
    copy; otherwise along x a source index before the first or at the last
    column takes that column alone, and each output is fma(b - a, fx, a) in
    float32; along y the rows clamp (their weights do not) and combine the
    same way.  Halving both axes takes this path too: OpenCV's switch to
    area averaging is for integer images."""
    img = np.asarray(img, f32)
    h, w = img.shape
    dh, dw = int(size_hw[0]), int(size_hw[1])
    if (dh, dw) == (h, w):
        return img.copy()
    sx, fx = _linear_taps(dw, w)
    edge = (sx < 0) | (sx >= w - 1)
    fx = np.where(edge, f32(0), fx)
    sx = np.clip(sx, 0, w - 1)
    left, right = img[:, sx], img[:, np.minimum(sx + 1, w - 1)]
    rows = _fma(right - left, np.broadcast_to(fx, left.shape), left)
    sy, fy = _linear_taps(dh, h)
    top, bottom = rows[np.clip(sy, 0, h - 1)], rows[np.clip(sy + 1, 0, h - 1)]
    return _fma(bottom - top, np.broadcast_to(fy[:, None], top.shape), top)


def resize_above(img: np.ndarray, size_hw, thr: float = 0.5) -> np.ndarray:
    """``resize_bilinear(img, size_hw) > thr`` as uint8, without the f32
    map: the x pass on the source rows, then each output of the y pass,
    fma(b - a, fy, a) = p + a with the product p exact in f64, is above thr
    exactly where p + a lies above the midpoint between f32(thr) and the
    next f32 (on it: where its rounding goes up, by the sum's error and
    ties to even)."""
    img = np.asarray(img, f32)
    h, w = img.shape
    dh, dw = int(size_hw[0]), int(size_hw[1])
    t = f32(thr)
    if (dh, dw) == (h, w):
        return (img > t).astype(np.uint8)
    sx, fx = _linear_taps(dw, w)
    edge = (sx < 0) | (sx >= w - 1)
    fx = np.where(edge, f32(0), fx)
    sx = np.clip(sx, 0, w - 1)
    left, right = img[:, sx], img[:, np.minimum(sx + 1, w - 1)]
    rows = _fma(right - left, np.broadcast_to(fx, left.shape), left)      # (h, dw)
    # row k + 1 - row k; past the last row both clamp to it: 0
    diff = np.concatenate([rows[1:] - rows[:-1], np.zeros_like(rows[:1])])
    sy, fy = _linear_taps(dh, h)
    top = np.clip(sy, 0, h - 1)
    fy = np.where(sy < 0, f32(0), fy)   # both rows clamp to the first: b - a = 0
    p = diff[top].astype(np.float64) * fy[:, None].astype(np.float64)
    a = rows[top].astype(np.float64)
    s = p + a
    hi = np.nextafter(t, f32(np.inf))
    mid = (float(t) + float(hi)) / 2
    out = s > mid
    on = np.nonzero(s == mid)
    if len(on[0]):   # on the midpoint: the sum's error decides, else ties to even
        pa, aa, sa = p[on], a[on], s[on]
        bp = sa - pa
        err = (pa - (sa - bp)) + (aa - bp)
        odd_t = bool(np.frombuffer(t.tobytes(), np.uint32)[0] & 1)
        out[on] = (err > 0) | ((err == 0) & odd_t)
    return out.astype(np.uint8)


def _pasted_crop(box_xyxy, mask_prob, h: int, w: int, thr: float) -> tuple:
    """(y1, x1, the thresholded (bh, bw) uint8 crop, or None where the
    box misses the image) of ``paste_mask``."""
    x1, y1, x2, y2 = box_xyxy[:4]
    x1 = int(max(np.floor(x1), 0))
    y1 = int(max(np.floor(y1), 0))
    x2 = int(min(np.ceil(x2) + 1, w))
    y2 = int(min(np.ceil(y2) + 1, h))
    if x2 - x1 <= 0 or y2 - y1 <= 0:
        return y1, x1, None
    return y1, x1, resize_above(mask_prob, (y2 - y1, x2 - x1), thr)


def paste_mask(box_xyxy: np.ndarray, mask_prob: np.ndarray, h: int, w: int,
               thr: float = 0.5) -> np.ndarray:
    """A box-frame (S, S) probability map -> the (h, w) uint8 image mask
    (mmdet's get_seg_masks): the box widened to whole pixels (x1 floored,
    x2 ceiled + 1) and clipped to the image, the map resized to it
    (``resize_bilinear``) and thresholded (> thr)."""
    out = np.zeros((h, w), np.uint8)
    y1, x1, crop = _pasted_crop(box_xyxy, mask_prob, h, w, thr)
    if crop is not None:
        out[y1:y1 + crop.shape[0], x1:x1 + crop.shape[1]] = crop
    return out


def encode_pasted(box_xyxy: np.ndarray, mask_prob: np.ndarray, h: int, w: int,
                  thr: float = 0.5) -> RLE:
    """``encode(paste_mask(...))`` from the pasted crop alone: the runs of
    ones of each crop column, offset to the image's column-major order, so
    the cost follows the box, not the image."""
    y1, x1, crop = _pasted_crop(box_xyxy, mask_prob, h, w, thr)
    if crop is None or not crop.any():
        return dict(size=[int(h), int(w)], counts=counts_to_string([h * w]))
    bh, bw = crop.shape
    col = np.zeros((bw, bh + 2), np.int8)
    col[:, 1:-1] = crop.T
    step = np.diff(col, axis=1)                       # +1 at a run's start, -1 past its end
    c, r = np.nonzero(step)                           # column-major: columns, then rows
    bounds = (x1 + c) * h + y1 + r
    # a run that ends at the image's last row and one that starts the next
    # column's first row are one run
    joined = np.zeros(len(bounds), bool)
    joined[1:] = bounds[1:] == bounds[:-1]
    joined[:-1] |= joined[1:]
    counts = np.diff(np.concatenate([[0], bounds[~joined], [h * w]]))
    if counts[-1] == 0:   # the last run reaches the image's end
        counts = counts[:-1]
    return dict(size=[int(h), int(w)], counts=counts_to_string(counts))
