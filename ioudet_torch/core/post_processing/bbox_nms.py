"""Fixed-shape batched multiclass NMS (counterpart of
``ioudet/core/post_processing/bbox_nms.py``).

One suppression pass per image with the class-offset trick: each candidate's
box is shifted by ``label * (max_coord + 1)``, so boxes of different classes
never overlap and one greedy pass equals per-class NMS.  Candidates are cut
to a static ``pre_nms_total`` by score (scores at or below ``score_thr`` are
gated to 0 first), and the output is a fixed ``(B, max_per_img, 5)`` block
with label -1 padding.  The batch dimension is written out: no Python loop
over images and no host sync.

Every selection is ``torch.sort(descending=True, stable=True)`` so that ties
go to the lower index, which is ``lax.top_k``'s rule in ``ioudet``
(``tests/test_nms_select.py``); ``torch.topk`` does not promise it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...ops import nms_cuda

NOT_PORTED = ("nms type {!r} is not ported yet: soft and matrix NMS are in "
              "ROADMAP.md queue 1 (next modules)")


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: descending, ties by ascending index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def multiclass_nms(multi_bboxes: torch.Tensor,
                   multi_scores: torch.Tensor,
                   score_thr: float,
                   iou_thr: float = 0.5,
                   max_per_img: int = 100,
                   score_factors: Optional[torch.Tensor] = None,
                   valid: Optional[torch.Tensor] = None,
                   pre_nms_total: int = 2000,
                   nms_type: str = "nms",
                   class_topk: Optional[int] = None,
                   approx_topk: bool = False,
                   exact_select: str = "sort",
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Args:
        multi_bboxes: (B, N, 4) class-agnostic or (B, N, C*4) per-class boxes.
        multi_scores: (B, N, C) foreground class scores (no bg column).
        score_factors: optional (B, N) multiplier.
        valid: optional (B, N) candidate mask.
        nms_type: 'nms' or 'pallas_greedy', both the exact greedy kernel.
        class_topk: keep each anchor's top-k classes before the global
            candidate selection (None: all N*C compete).
        approx_topk, exact_select: only the exact ``'sort'`` selection is
            ported; anything else raises.

    Returns:
        dets: (B, max_per_img, 5) [x1, y1, x2, y2, score], zero-padded.
        labels: (B, max_per_img) int64 0-based class, -1 for padding.
    """
    if approx_topk or exact_select != "sort":
        raise ValueError("only exact_select='sort' without approx_topk is "
                         f"supported, got exact_select={exact_select!r}, "
                         f"approx_topk={approx_topk}")
    if nms_type not in ("nms", "pallas_greedy"):
        if nms_type in ("matrix", "soft_nms", "soft_nms_linear"):
            raise NotImplementedError(NOT_PORTED.format(nms_type))
        raise ValueError(f"unknown nms type {nms_type!r}")

    bsz, n, num_classes = multi_scores.shape
    scores = multi_scores
    if score_factors is not None:
        scores = scores * score_factors[..., None]
    if valid is not None:
        scores = torch.where(valid[..., None], scores, 0.0)

    if class_topk is not None and class_topk < num_classes:
        cls_scores, cls_idx = topk_stable(scores, class_topk)   # (B, N, k)
        flat_scores = cls_scores.reshape(bsz, -1)
        flat_labels = cls_idx.reshape(bsz, -1)
        sel_div = class_topk
    else:
        flat_scores = scores.reshape(bsz, -1)
        flat_labels = torch.arange(num_classes, device=scores.device).repeat(n)
        flat_labels = flat_labels.expand(bsz, -1)
        sel_div = num_classes

    k = min(pre_nms_total, flat_scores.shape[1])
    gated = torch.where(flat_scores > score_thr, flat_scores, 0.0)
    top_scores, top_idx = topk_stable(gated, k)
    anchor_idx = top_idx // sel_div
    top_labels = torch.gather(flat_labels, 1, top_idx)
    if multi_bboxes.shape[-1] != 4:  # per-class boxes
        per_class = multi_bboxes.reshape(bsz, n * num_classes, 4)
        box_idx = anchor_idx * num_classes + top_labels
    else:
        per_class, box_idx = multi_bboxes, anchor_idx
    top_boxes = torch.gather(per_class, 1, box_idx[..., None].expand(-1, -1, 4))
    top_valid = top_scores > score_thr

    # class offset: boxes of different classes can never overlap
    max_coord = torch.where(top_valid[..., None], top_boxes, 0.0).amax(
        dim=(1, 2), keepdim=True) + 1.0
    offs_boxes = top_boxes + top_labels.float()[..., None] * max_coord

    keep = nms_cuda.greedy_keep(offs_boxes.contiguous(), top_valid.contiguous(),
                                iou_thr)
    kept_scores = torch.where(keep, top_scores, 0.0)

    k_out = min(max_per_img, k)
    final_scores, keep_idx = topk_stable(kept_scores, k_out)
    final_valid = final_scores > score_thr
    final_boxes = torch.gather(top_boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    dets = torch.cat([final_boxes, final_scores[..., None]], dim=-1)
    dets = dets * final_valid[..., None].to(dets.dtype)
    labels = torch.where(final_valid, torch.gather(top_labels, 1, keep_idx), -1)
    if k_out < max_per_img:
        pad = max_per_img - k_out
        dets = torch.cat([dets, dets.new_zeros(bsz, pad, 5)], dim=1)
        labels = torch.cat([labels, labels.new_full((bsz, pad), -1)], dim=1)
    return dets, labels
