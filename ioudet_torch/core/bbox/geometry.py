"""IoU / IoF box overlaps (counterpart of ``ioudet/core/bbox/geometry.py``).

Keeps the v1 "+1 pixel" area convention: ``area = (x2 - x1 + 1) * (y2 - y1 + 1)``
and the ``1e-10`` floor on the denominator.  The order of operations is the
one the NMS kernel (``ioudet_torch/csrc/nms_kernel.cu``) reproduces, so that
the plain and the kernel suppression masks agree bit for bit: keep the two in
step when either changes.
"""

from __future__ import annotations

import torch


def bbox_overlaps(bboxes1: torch.Tensor, bboxes2: torch.Tensor,
                  mode: str = "iou", is_aligned: bool = False,
                  eps: float = 0.0) -> torch.Tensor:
    """Pairwise or aligned overlaps.

    bboxes1: (..., M, 4); bboxes2: (..., N, 4) (or (..., M, 4) if aligned).
    mode: 'iou' (union) or 'iof' (intersection over bboxes1's area).
    Returns (..., M, N), or (..., M) if aligned.
    """
    if mode not in ("iou", "iof"):
        raise ValueError(f"mode must be 'iou' or 'iof', got {mode!r}")
    b1 = bboxes1.float()
    b2 = bboxes2.float()
    if not is_aligned:
        b1 = b1[..., :, None, :]
        b2 = b2[..., None, :, :]
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt + 1.0).clamp(min=0.0)
    overlap = wh[..., 0] * wh[..., 1]
    area1 = (b1[..., 2] - b1[..., 0] + 1.0) * (b1[..., 3] - b1[..., 1] + 1.0)
    if mode == "iou":
        area2 = (b2[..., 2] - b2[..., 0] + 1.0) * (b2[..., 3] - b2[..., 1] + 1.0)
        denom = area1 + area2 - overlap
    else:
        denom = area1.expand_as(overlap)
    return overlap / denom.clamp(min=eps if eps > 0 else 1e-10)
