"""Numpy IoU for host-side evaluation (counterpart of
``ioudet/core/evaluation/bbox_overlaps.py``).

Two conventions coexist, as in the reference: VOC-style evaluation
(``mean_ap``, ``recall``) uses the +1 pixel convention here; COCO-style
evaluation works on xywh boxes without it (``coco_eval.iou_xywh``).
"""

import numpy as np


def bbox_overlaps_np(bboxes1: np.ndarray, bboxes2: np.ndarray,
                     mode: str = "iou") -> np.ndarray:
    """(n, 4) and (k, 4) xyxy boxes -> (n, k) f64 IoU, or IoF (intersection
    over the area of ``bboxes1``) with ``mode='iof'``."""
    if mode not in ("iou", "iof"):
        raise ValueError(f"mode must be 'iou' or 'iof', got {mode!r}")
    bboxes1 = bboxes1.astype(np.float64)
    bboxes2 = bboxes2.astype(np.float64)
    rows, cols = bboxes1.shape[0], bboxes2.shape[0]
    if rows * cols == 0:
        return np.zeros((rows, cols))
    x_start = np.maximum(bboxes1[:, None, 0], bboxes2[None, :, 0])
    y_start = np.maximum(bboxes1[:, None, 1], bboxes2[None, :, 1])
    x_end = np.minimum(bboxes1[:, None, 2], bboxes2[None, :, 2])
    y_end = np.minimum(bboxes1[:, None, 3], bboxes2[None, :, 3])
    overlap = np.clip(x_end - x_start + 1, 0, None) * \
        np.clip(y_end - y_start + 1, 0, None)
    area1 = (bboxes1[:, 2] - bboxes1[:, 0] + 1) * (bboxes1[:, 3] - bboxes1[:, 1] + 1)
    if mode == "iou":
        area2 = (bboxes2[:, 2] - bboxes2[:, 0] + 1) * \
            (bboxes2[:, 3] - bboxes2[:, 1] + 1)
        union = area1[:, None] + area2[None, :] - overlap
    else:
        union = np.broadcast_to(area1[:, None], overlap.shape)
    return overlap / np.maximum(union, 1e-10)
