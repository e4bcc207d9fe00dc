"""Fixed-shape max-IoU target assignment (counterpart of
``ioudet/core/bbox/assigners.py``), in plain torch, for one image or a
batch of images (leading dimensions).

The reference's rules (mmdet ``MaxIoUAssigner.assign_wrt_overlaps``):
  1. every anchor starts as ignore (-1);
  2. best IoU in ``[0, neg_iou_thr)`` -> background (0);
  3. best IoU >= ``pos_iou_thr`` -> that gt (index + 1, first gt on ties);
  4. every anchor tying a gt's best IoU is forced positive for that gt when
     the best is >= ``min_pos_iou`` (``gt_max_assign_all``); later gts
     overwrite earlier ones;
  5. anchors with IoF > ``ignore_iof_thr`` against an ignore region go back
     to -1.
Padded gts and invalid anchors have their overlaps masked to -1 before any
max.  This is the general path; the default configuration of the focal
family goes through the fused kernels of ``ioudet_torch/ops/assign_cuda.py``.
``ApproxMaxIoUAssigner`` (guided anchoring's) takes each square's best IoU
over its approxs before the same rules.  ``PointAssigner`` is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .geometry import bbox_overlaps


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor       # (..., A) int32 in {-1, 0, 1..G}
    max_overlaps: torch.Tensor  # (..., A) float32 (masked entries = -1)
    labels: torch.Tensor        # (..., A) int32 category of assigned gt (0 if none)


def assign_max_iou(overlaps: torch.Tensor, gt_valid: torch.Tensor,
                   anchor_valid: torch.Tensor,
                   gt_labels: Optional[torch.Tensor] = None,
                   pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                   min_pos_iou: float = 0.0,
                   gt_max_assign_all: bool = True) -> AssignResult:
    """Assign from a (..., G, A) overlap matrix (gt-major, like the
    reference); leading dimensions are images.

    gt_valid (..., G) bool: False rows are padding; anchor_valid (..., A)
    bool: False anchors are left out; gt_labels (..., G) 1-based category ids
    (optional).
    """
    G, A = overlaps.shape[-2:]
    dev = overlaps.device
    av = anchor_valid[..., None, :]
    masked = torch.where(gt_valid[..., :, None] & av, overlaps, -1.0)
    max_overlaps, argmax_overlaps = masked.max(dim=-2)   # first max on ties
    gt_max_overlaps = masked.amax(dim=-1)

    assigned = torch.full_like(max_overlaps, -1, dtype=torch.int32)
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           0, assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr,
                           argmax_overlaps.int() + 1, assigned)

    # step 4: the reference's sequential later-wins loop is "the highest gt
    # index whose best-anchor set holds this anchor"
    ok = gt_valid & (gt_max_overlaps >= min_pos_iou)
    if gt_max_assign_all:
        hit = masked == gt_max_overlaps[..., :, None]
    else:
        hit = torch.arange(A, device=dev) == masked.argmax(dim=-1)[..., :, None]
    hit = hit & ok[..., :, None] & av
    ids = torch.arange(1, G + 1, dtype=torch.int32, device=dev)[:, None]
    forced = torch.where(hit, ids, 0).amax(dim=-2)
    assigned = torch.where(forced > 0, forced, assigned)

    if gt_labels is not None:
        safe = (assigned - 1).clamp(0, G - 1).long()
        labels = torch.where(assigned > 0,
                             torch.gather(gt_labels.int().expand(
                                 assigned.shape[:-1] + (G,)), -1, safe), 0)
    else:
        labels = torch.zeros_like(assigned)
    return AssignResult(assigned, max_overlaps, labels)


class MaxIoUAssigner:
    """Computes the overlaps, then ``assign_max_iou`` and the ignore-region
    rule.  Signature as the reference class; ``bboxes`` (A, 4) may be shared
    by a batch of gts (B, G, 4)."""

    def __init__(self, pos_iou_thr: float, neg_iou_thr: float,
                 min_pos_iou: float = 0.0, gt_max_assign_all: bool = True,
                 ignore_iof_thr: float = -1.0):
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.gt_max_assign_all = gt_max_assign_all
        self.ignore_iof_thr = ignore_iof_thr

    def assign(self, bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
               gt_valid: torch.Tensor, anchor_valid: torch.Tensor,
               gt_labels: Optional[torch.Tensor] = None,
               gt_bboxes_ignore: Optional[torch.Tensor] = None,
               gt_ignore_valid: Optional[torch.Tensor] = None) -> AssignResult:
        overlaps = bbox_overlaps(gt_bboxes, bboxes)  # (..., G, A)
        result = assign_max_iou(
            overlaps, gt_valid, anchor_valid, gt_labels,
            pos_iou_thr=self.pos_iou_thr, neg_iou_thr=self.neg_iou_thr,
            min_pos_iou=self.min_pos_iou,
            gt_max_assign_all=self.gt_max_assign_all)
        if (self.ignore_iof_thr > 0 and gt_bboxes_ignore is not None
                and gt_ignore_valid is not None):
            iof = bbox_overlaps(bboxes, gt_bboxes_ignore, mode="iof")  # (..., A, I)
            iof = torch.where(gt_ignore_valid[..., None, :], iof, 0.0)
            hit_ignore = iof.amax(dim=-1) > self.ignore_iof_thr
            result = AssignResult(
                torch.where(hit_ignore, -1, result.gt_inds), result.max_overlaps,
                torch.where(hit_ignore, 0, result.labels))
        return result


class ApproxMaxIoUAssigner(MaxIoUAssigner):
    """Guided anchoring's assigner (``ioudet``'s ``ApproxMaxIoUAssigner``,
    mmdet's ``approx_max_iou_assigner.py``): one square a cell is placed,
    but it is judged by the best IoU over the cell's ``n_approx`` approxs
    (the 9 RetinaNet anchors), then by ``assign_max_iou``'s rules; the
    ignore regions are tested against the squares."""

    def assign_approx(self, approxs: torch.Tensor, squares: torch.Tensor,
                      gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                      square_valid: torch.Tensor,
                      gt_labels: Optional[torch.Tensor] = None,
                      gt_bboxes_ignore: Optional[torch.Tensor] = None,
                      gt_ignore_valid: Optional[torch.Tensor] = None) -> AssignResult:
        """approxs (A, n_approx, 4) grouped by square; squares (A, 4);
        gt_bboxes (..., G, 4) (leading dimensions are images), gt_valid
        (..., G), square_valid (..., A); ignore regions (..., I, 4) / (..., I)."""
        num, n_approx = approxs.shape[:2]
        overlaps = bbox_overlaps(gt_bboxes, approxs.reshape(num * n_approx, 4))
        overlaps = overlaps.unflatten(-1, (num, n_approx)).amax(dim=-1)   # (..., G, A)
        result = assign_max_iou(
            overlaps, gt_valid, square_valid, gt_labels,
            pos_iou_thr=self.pos_iou_thr, neg_iou_thr=self.neg_iou_thr,
            min_pos_iou=self.min_pos_iou, gt_max_assign_all=self.gt_max_assign_all)
        if (self.ignore_iof_thr > 0 and gt_bboxes_ignore is not None
                and gt_ignore_valid is not None):
            iof = bbox_overlaps(squares, gt_bboxes_ignore, mode="iof")   # (..., A, I)
            iof = torch.where(gt_ignore_valid[..., None, :], iof, 0.0)
            hit = iof.amax(dim=-1) > self.ignore_iof_thr
            result = AssignResult(torch.where(hit, -1, result.gt_inds), result.max_overlaps,
                                  torch.where(hit, 0, result.labels))
        return result
