"""Loading transforms (counterpart of ``ioudet/data/pipelines/loading.py``)
and the image decoder they use.

``imread`` decodes binary netpbm (P5 grey, P6 colour: ``.pgm`` / ``.ppm``
/ ``.pnm``) itself in numpy, to what ``cv2.imread(path, IMREAD_COLOR)``
gives: (H, W, 3) uint8 in BGR order, grey replicated into the three
channels.  Any other format goes to ``cv2.imread``, imported inside the
call; without cv2 it raises an ``ImportError`` naming the file.  There is
no PIL route: PIL decodes and orders channels differently, and would
change the pixels without a word.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

NETPBM_MAGIC = (b"P5", b"P6")


def _header_fields(buf: bytes, count: int, pos: int):
    """``count`` integers of a netpbm header from ``pos`` (comments from '#'
    to the end of the line), and the offset just past the last one."""
    fields = []
    while len(fields) < count:
        while pos < len(buf) and buf[pos:pos + 1].isspace():
            pos += 1
        if buf[pos:pos + 1] == b"#":
            end = buf.find(b"\n", pos)
            pos = len(buf) if end < 0 else end + 1
            continue
        start = pos
        while pos < len(buf) and buf[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError("malformed netpbm header")
        fields.append(int(buf[start:pos]))
    return fields, pos


def decode_netpbm(buf: bytes) -> np.ndarray:
    """Binary P5 / P6 bytes with maxval 255 -> (H, W, 3) uint8, BGR."""
    magic = buf[:2]
    if magic not in NETPBM_MAGIC:
        raise ValueError(f"not a binary netpbm image (magic {magic!r})")
    (width, height, maxval), pos = _header_fields(buf, 3, 2)
    if maxval != 255:
        raise ValueError(f"netpbm maxval {maxval}: only 8-bit images with maxval 255 "
                         "are decoded here")
    channels = 3 if magic == b"P6" else 1
    # exactly one whitespace byte ends the header
    data = np.frombuffer(buf, np.uint8, height * width * channels, pos + 1)
    img = data.reshape(height, width, channels)
    if channels == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., ::-1])  # stored RGB


def encode_netpbm(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 BGR -> P6 bytes, or (H, W) uint8 -> P5 bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or \
            (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected (H, W, 3) or (H, W) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    magic = b"P6" if img.ndim == 3 else b"P5"
    body = img[..., ::-1] if img.ndim == 3 else img
    return b"%s\n%d %d\n255\n" % (magic, w, h) + np.ascontiguousarray(body).tobytes()


def imwrite_netpbm(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_netpbm(img))


def imread(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR, as ``cv2.imread(path, cv2.IMREAD_COLOR)``."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] in NETPBM_MAGIC:
        return decode_netpbm(buf)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"decoding {path} needs cv2 (opencv-python); without it the "
                          "port reads binary netpbm (.ppm, .pgm) only") from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"cv2 could not decode {path}")
    return img


class LoadImageFromFile:
    """Reads ``img_prefix/img_info['filename']`` into an (H, W, 3) uint8
    BGR array (``channel_order='bgr'``, as ``ioudet``'s cv2 route)."""

    def __call__(self, results: dict) -> dict:
        path = results["img_info"]["filename"]
        prefix = results.get("img_prefix")
        if prefix:
            path = os.path.join(prefix, path)
        img = imread(path)
        results["filename"] = path
        results["img"] = img
        results["channel_order"] = "bgr"
        results["img_shape"] = img.shape[:2]
        results["ori_shape"] = img.shape[:2]
        return results


class LoadAnnotations:
    """Boxes (f32) and 1-based labels (int64) from ``ann_info``; the
    ignored boxes ride along as ``gt_bboxes_ignore``.  ``with_mask``
    rasterizes each instance's polygons into its box's frame as a
    (mask_size, mask_size) uint8 crop, ``gt_masks`` (G, S, S)
    (``core/mask/mask_target.rasterize_polygons``).  ``with_seg`` reads the
    semantic label map ``seg_prefix/<annotation's seg_map>``, by default
    ``seg_prefix/<image stem>.png``, with the port's own PNG reader
    (``png.read_png``; a 3-channel map gives its first channel), as
    ``gt_semantic_seg`` (H, W) uint8; where the file is missing the map is
    all 255 (ignored), as in ``ioudet``."""

    def __init__(self, with_bbox: bool = True, with_label: bool = True,
                 with_mask: bool = False, with_seg: bool = False, mask_size: int = 112):
        self.with_bbox = with_bbox
        self.with_label = with_label
        self.with_mask = with_mask
        self.with_seg = with_seg
        self.mask_size = mask_size

    def __call__(self, results: dict) -> dict:
        ann = results["ann_info"]
        if self.with_bbox:
            results["gt_bboxes"] = ann["bboxes"].astype(np.float32)
            results["gt_bboxes_ignore"] = ann.get(
                "bboxes_ignore", np.zeros((0, 4), np.float32)).astype(np.float32)
        if self.with_label:
            results["gt_labels"] = ann["labels"].astype(np.int64)
        if self.with_mask:
            from ...core.mask.mask_target import rasterize_polygons
            crops = [rasterize_polygons(poly, box, self.mask_size)
                     for box, poly in zip(ann["bboxes"], ann.get("masks", []))]
            results["gt_masks"] = np.stack(crops) if crops else \
                np.zeros((0, self.mask_size, self.mask_size), np.uint8)
        if self.with_seg:
            name = ann.get("seg_map")
            if name is None:
                stem = os.path.splitext(os.path.basename(results["img_info"]["filename"]))[0]
                name = stem + ".png"
            path = os.path.join(results.get("seg_prefix") or "", name)
            if os.path.exists(path):
                from .png import read_png
                seg = read_png(path)
                results["gt_semantic_seg"] = seg[..., 0] if seg.ndim == 3 else seg
            else:
                results["gt_semantic_seg"] = np.full(results["img"].shape[:2], 255, np.uint8)
        return results


class LoadProposals:
    """The dataset's precomputed proposals of the image (``results
    ['proposals']``, an (n, 4) or (n, 5) array): a 5-column array is sorted
    by score, descending, with a stable sort, and the score dropped; then
    cut to ``num_max_proposals`` and zero-padded to it with ``prop_valid``
    marking the real rows (``ioudet``'s fixed-shape departure from mmdet,
    which keeps the cut rows only).  Without ``num_max_proposals`` every
    row is kept and valid."""

    def __init__(self, num_max_proposals: Optional[int] = None):
        self.num_max_proposals = num_max_proposals

    def __call__(self, results: dict) -> dict:
        proposals = np.asarray(results["proposals"], np.float32)
        if proposals.ndim != 2 or proposals.shape[1] not in (4, 5):
            raise ValueError(f"proposals must be (n, 4|5), got {proposals.shape}")
        if proposals.shape[1] == 5:
            proposals = proposals[np.argsort(-proposals[:, 4], kind="stable")][:, :4]
        if self.num_max_proposals is None:
            results["proposals"] = proposals
            results["prop_valid"] = np.ones((len(proposals),), bool)
            return results
        proposals = proposals[:self.num_max_proposals]
        padded = np.zeros((self.num_max_proposals, 4), np.float32)
        padded[:len(proposals)] = proposals
        valid = np.zeros((self.num_max_proposals,), bool)
        valid[:len(proposals)] = True
        results["proposals"], results["prop_valid"] = padded, valid
        return results
