"""Formatting transforms (counterpart of
``ioudet/data/pipelines/formatting.py``): fixed-shape numpy samples.

  * gt boxes and labels padded to ``max_gt`` slots with a validity mask,
    the box-frame gt masks to as many (S, S) crops, the semantic label map
    as int32;
  * shape metas (img_shape, pad_shape, ori_shape), scale_factor and flip as
    arrays, so that a batch stacks into rectangular arrays.

Samples stay numpy: the loader's consumer pins them and moves them to the
device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


MAX_IGNORE = 20   # ignored-box slots of a sample, as ioudet's default


class DefaultFormatBundle:
    """Pads the annotations to fixed shapes (train path)."""

    def __init__(self, max_gt: int = 100):
        self.max_gt = max_gt

    def __call__(self, results: dict) -> dict:
        boxes = results.get("gt_bboxes", np.zeros((0, 4), np.float32))
        labels = results.get("gt_labels", np.zeros((0,), np.int64))
        n = min(len(boxes), self.max_gt)
        gt_bboxes = np.zeros((self.max_gt, 4), np.float32)
        gt_labels = np.zeros((self.max_gt,), np.int32)
        gt_valid = np.zeros((self.max_gt,), bool)
        gt_bboxes[:n] = boxes[:n]
        gt_labels[:n] = labels[:n]
        gt_valid[:n] = True
        results["gt_bboxes"] = gt_bboxes
        results["gt_labels"] = gt_labels
        results["gt_valid"] = gt_valid
        if "gt_bboxes_ignore" in results:
            ig = results["gt_bboxes_ignore"]
            ni = min(len(ig), MAX_IGNORE)
            gt_ig = np.zeros((MAX_IGNORE, 4), np.float32)
            ig_valid = np.zeros((MAX_IGNORE,), bool)
            gt_ig[:ni] = ig[:ni]
            ig_valid[:ni] = True
            results["gt_bboxes_ignore"] = gt_ig
            results["gt_ignore_valid"] = ig_valid
        if "gt_masks" in results:
            m = results["gt_masks"]
            s = m.shape[-1] if m.size else 112
            gt_masks = np.zeros((self.max_gt, s, s), np.uint8)
            gt_masks[:n] = m[:n]
            results["gt_masks"] = gt_masks
        if "gt_semantic_seg" in results:   # on the canvas already (Pad)
            results["gt_semantic_seg"] = np.ascontiguousarray(results["gt_semantic_seg"], np.int32)
        results["img"] = np.ascontiguousarray(results["img"], np.float32)
        return results


class ImageToTensor:
    """Kept for config parity: images stay (H, W, C) f32 numpy."""

    def __init__(self, keys: Sequence[str] = ("img",)):
        self.keys = keys

    def __call__(self, results: dict) -> dict:
        for k in self.keys:
            results[k] = np.ascontiguousarray(results[k], np.float32)
        return results


class Collect:
    """The final sample dict: ``keys``, the meta keys as arrays, and the
    dataset index as ``idx``."""

    DEFAULT_META = ("ori_shape", "img_shape", "pad_shape", "scale_factor", "flip")

    def __init__(self, keys: Sequence[str], meta_keys: Sequence[str] = DEFAULT_META):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results: dict) -> dict:
        out = {k: results[k] for k in self.keys}
        for k in self.meta_keys:
            v = results.get(k)
            if k in ("ori_shape", "img_shape", "pad_shape"):
                v = np.asarray(v[:2], np.int32)
            elif k == "scale_factor":
                v = np.asarray(v, np.float32)
            elif k == "flip":
                v = np.asarray(bool(v))
            out[k] = v
        if "idx" in results:
            out["idx"] = np.asarray(results["idx"], np.int32)
        return out
