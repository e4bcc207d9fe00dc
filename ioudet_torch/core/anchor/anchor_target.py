"""Fixed-shape anchor target computation (counterpart of
``ioudet/core/anchor/anchor_target.py``).

Every anchor keeps its slot and exclusion is expressed with weights, so one
shape covers every image.  Per image:
  inside = valid_flags [& border check]
  assign = MaxIoUAssigner over the masked (G, A) IoU
  pos / neg = every assigned anchor, or the sampler's subset of them (the
  RPN's RandomSampler 256 at 0.5: only the sampled anchors carry weight)
  bbox_targets = bbox2delta(anchors, gt[assigned]) on positives
  labels[pos] = gt label (1-based); label_weights = pos_weight on positives,
  1 on negatives, 0 on ignored anchors.
``num_total_pos`` is the ``avg_factor`` of the focal family's losses.  The
counts stay on the device: nothing here copies to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ...ops import assign_cuda
from ..bbox.assigners import MaxIoUAssigner
from ..bbox.transforms import bbox2delta


class AnchorTargets(NamedTuple):
    labels: torch.Tensor          # (B, A) int32; 0 = bg, 1..C fg
    label_weights: torch.Tensor   # (B, A) float32
    bbox_targets: torch.Tensor    # (B, A, 4) float32
    bbox_weights: torch.Tensor    # (B, A, 4) float32
    pos_gt_boxes: torch.Tensor    # (B, A, 4) gt box assigned to each positive
    num_total_pos: torch.Tensor   # () int32
    num_total_neg: torch.Tensor   # () int32


def anchor_inside_flags(flat_anchors: torch.Tensor, valid_flags: torch.Tensor,
                        img_shapes: torch.Tensor,
                        allowed_border: int = -1) -> torch.Tensor:
    """valid_flags (B, A) and, with ``allowed_border >= 0``, the anchors that
    stay within the border of each image's (h, w) ``img_shapes`` (B, 2)."""
    if allowed_border < 0:
        return valid_flags
    h, w = img_shapes[:, 0, None], img_shapes[:, 1, None]
    inside = ((flat_anchors[:, 0] >= -allowed_border) &
              (flat_anchors[:, 1] >= -allowed_border) &
              (flat_anchors[:, 2] < w + allowed_border) &
              (flat_anchors[:, 3] < h + allowed_border))
    return valid_flags & inside


def anchor_target_single(flat_anchors: torch.Tensor, valid_flags: torch.Tensor,
                         gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                         gt_labels: torch.Tensor, img_shapes: torch.Tensor,
                         assigner: MaxIoUAssigner,
                         target_means: Sequence[float],
                         target_stds: Sequence[float],
                         allowed_border: int = -1, pos_weight: float = -1.0,
                         gt_bboxes_ignore: Optional[torch.Tensor] = None,
                         gt_ignore_valid: Optional[torch.Tensor] = None,
                         sampler=None, generator: Optional[torch.Generator] = None):
    """The general path in plain torch, for a batch: valid_flags (B, A),
    gt_* (B, G, ...), img_shapes (B, 2); ``sampler`` draws from
    ``generator``.  Returns (labels, label_weights, bbox_targets,
    bbox_weights, pos_gt_boxes, num_pos (B,), num_neg (B,))."""
    inside = anchor_inside_flags(flat_anchors, valid_flags, img_shapes, allowed_border)
    assign = assigner.assign(flat_anchors, gt_bboxes, gt_valid, inside, None,
                             gt_bboxes_ignore, gt_ignore_valid)
    if sampler is not None:
        pos, neg = sampler.sample(assign, generator)
    else:
        pos = assign.gt_inds > 0
        neg = assign.gt_inds == 0
    G = gt_bboxes.shape[-2]
    safe_gt = (assign.gt_inds - 1).clamp(0, G - 1).long()
    table = torch.cat([gt_bboxes.float(), gt_labels.float()[..., None]], dim=-1)
    fetched = torch.gather(table, -2, safe_gt[..., None].expand(safe_gt.shape + (5,)))
    matched_gt = fetched[..., :4]
    deltas = bbox2delta(flat_anchors, matched_gt, target_means, target_stds)
    posf = pos.float()
    bbox_targets = deltas * posf[..., None]
    bbox_weights = posf[..., None].expand(posf.shape + (4,))
    pos_gt_boxes = matched_gt * posf[..., None]
    labels = torch.where(pos, fetched[..., 4].round().int(), 0)
    pw = 1.0 if pos_weight <= 0 else float(pos_weight)
    label_weights = posf * pw + neg.float()
    return (labels, label_weights, bbox_targets, bbox_weights, pos_gt_boxes,
            pos.sum(dim=-1), neg.sum(dim=-1))


def anchor_target(flat_anchors: torch.Tensor, valid_flags: torch.Tensor,
                  gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                  gt_labels: torch.Tensor, img_shapes: torch.Tensor,
                  assigner: MaxIoUAssigner,
                  target_means: Sequence[float] = (0., 0., 0., 0.),
                  target_stds: Sequence[float] = (1., 1., 1., 1.),
                  allowed_border: int = -1, pos_weight: float = -1.0,
                  sampler=None, generator: Optional[torch.Generator] = None,
                  gt_bboxes_ignore=None, gt_ignore_valid=None) -> AnchorTargets:
    """Batched targets.

    flat_anchors (A, 4), all levels, shared by the images; valid_flags (B, A)
    bool; gt_bboxes (B, G, 4); gt_valid (B, G); gt_labels (B, G) 1-based;
    img_shapes (B, 2) content (h, w); gt_bboxes_ignore / gt_ignore_valid
    (B, I, 4) / (B, I): anchors overlapping these regions above the
    assigner's ``ignore_iof_thr`` are left out of the loss; ``sampler``
    (drawing from ``generator``) subsamples each image's anchors, which
    always takes the general path.
    """
    if (sampler is None and gt_bboxes_ignore is None and allowed_border < 0
            and type(assigner) is MaxIoUAssigner
            and assigner.gt_max_assign_all
            and assigner.ignore_iof_thr <= 0
            and 1 <= gt_valid.shape[1] <= 128):
        # the default (focal-family) configuration: the fused kernels, one
        # sweep in registers with nothing of size (G, A) in device memory
        pw = 1.0 if pos_weight <= 0 else float(pos_weight)
        labels, lw, posf, bt, pgb = assign_cuda.fused_anchor_assign(
            flat_anchors, valid_flags, gt_bboxes, gt_valid, gt_labels,
            pos_iou_thr=float(assigner.pos_iou_thr),
            neg_iou_thr=float(assigner.neg_iou_thr),
            min_pos_iou=float(assigner.min_pos_iou), pos_weight=pw,
            target_means=tuple(target_means), target_stds=tuple(target_stds))
        bw = posf[..., None].expand(posf.shape + (4,))
        npos = posf.sum().to(torch.int32)
        nneg = (lw - posf * pw).sum().round().to(torch.int32)
        return AnchorTargets(labels, lw, bt, bw, pgb, npos, nneg)

    labels, lw, bt, bw, pgb, npos, nneg = anchor_target_single(
        flat_anchors, valid_flags, gt_bboxes, gt_valid, gt_labels, img_shapes,
        assigner, target_means, target_stds, allowed_border, pos_weight,
        gt_bboxes_ignore, gt_ignore_valid, sampler, generator)
    return AnchorTargets(labels, lw, bt, bw, pgb, npos.sum().to(torch.int32),
                         nneg.sum().to(torch.int32))


def images_to_levels(target: torch.Tensor, num_level_anchors: Sequence[int]):
    """Split an all-level (B, A, ...) tensor into the per-level list."""
    return list(torch.split(target, list(num_level_anchors), dim=1))
