"""Test-time-augmentation merges (counterpart of
``ioudet/core/post_processing/merge_augs.py``).

A single-stage detector's views give independent candidate sets: their boxes
are mapped back to the original image, concatenated, and one NMS runs over
the union (``merge_aug_bboxes``; ``apis/test.py`` ``aug_test``).

A two-stage detector's views share one proposal set: each view's RPN
proposals are mapped back and merged by one greedy NMS through K1
(``merge_aug_proposals``), every view refines the same merged proposals, so
their boxes and scores align one to one and are averaged after the map back
(``merge_aug_bboxes_mean``), and the box-frame mask probabilities of the
final detections are averaged with flipped views mirrored back
(``merge_aug_masks``; ``apis/test.py`` ``aug_test_two_stage``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ...ops import nms_cuda
from ...ops.nms import NEG_INF
from ..bbox.transforms import bbox_mapping_back
from .bbox_nms import topk_stable


def merge_aug_bboxes(aug_bboxes: Sequence[torch.Tensor], aug_scores: Sequence[torch.Tensor],
                     img_metas: Sequence[dict]) -> Tuple[torch.Tensor, torch.Tensor]:
    """aug_bboxes: (N_v, 4) a view; aug_scores: (N_v, C) a view; img_metas:
    dict(img_shape, scale_factor, flip) a view.  Returns the boxes in
    original-image coordinates and the scores, concatenated in view order."""
    recovered = [bbox_mapping_back(b, m["img_shape"], m["scale_factor"], m["flip"])
                 for b, m in zip(aug_bboxes, img_metas)]
    return torch.cat(recovered, dim=0), torch.cat(list(aug_scores), dim=0)


def merge_aug_scores(aug_scores: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean of the views' aligned scores."""
    return torch.stack(list(aug_scores)).mean(dim=0)


def merge_aug_proposals(aug_proposals: Sequence[torch.Tensor], img_metas: Sequence[dict],
                        rpn_test_cfg: dict) -> torch.Tensor:
    """Each view's (P, 5) RPN proposals (view coordinates, score-0 padding
    rows) mapped back to the original image and concatenated, then one
    greedy NMS at ``nms_thr`` (K1 on a CUDA tensor, its plain version on the
    CPU) and the kept ones by score, ``max_num`` of them, as ``ioudet``'s:
    the candidates in a stable descending sort of their scores (the padding
    rows last, in order), the top-k over the kept scores (0 elsewhere) with
    ties by ascending index.  A padding row of the result keeps the box of
    the candidate it came from, as ``ioudet``'s does.  Returns (k, 5), k =
    min(``max_num``, the candidates)."""
    recovered = [torch.cat([bbox_mapping_back(p[:, :4], m["img_shape"], m["scale_factor"],
                                              m["flip"]), p[:, 4:5]], dim=-1)
                 for p, m in zip(aug_proposals, img_metas)]
    merged = torch.cat(recovered, dim=0)
    s = torch.where(merged[:, 4] > 0, merged[:, 4], NEG_INF)
    s, order = torch.sort(s, descending=True, stable=True)
    boxes = merged[order, :4]
    keep = nms_cuda.greedy_keep(boxes[None].contiguous(), (s > NEG_INF / 2)[None],
                                float(rpn_test_cfg.get("nms_thr", 0.7)))[0]
    k = min(int(rpn_test_cfg.get("max_num", 1000)), merged.shape[0])
    top, idx = topk_stable(torch.where(keep, s, 0.0), k)
    return torch.cat([boxes[idx], top[:, None]], dim=-1)


def merge_aug_bboxes_mean(aug_bboxes: Sequence[torch.Tensor], aug_scores: Sequence[torch.Tensor],
                          img_metas: Sequence[dict]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The views' boxes of the same proposals (..., 4) mapped back to the
    original image and averaged element by element, and their scores
    averaged."""
    recovered = [bbox_mapping_back(b, m["img_shape"], m["scale_factor"], m["flip"])
                 for b, m in zip(aug_bboxes, img_metas)]
    return torch.stack(recovered).mean(dim=0), torch.stack(list(aug_scores)).mean(dim=0)


def merge_aug_masks(aug_masks: Sequence[torch.Tensor], img_metas: Sequence[dict],
                    weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """The views' box-frame mask probabilities (..., S, S) of the same
    detections, a flipped view's mirrored along x (its box was mapped back
    already, so the frames align), averaged, or weighted by ``weights``
    normalized to sum 1."""
    out = torch.stack([m.flip(-1) if meta["flip"] else m for m, meta in zip(aug_masks, img_metas)])
    if weights is None:
        return out.mean(dim=0)
    w = torch.tensor([float(x) for x in weights], dtype=torch.float32).to(out.device)
    return torch.tensordot(w / w.sum(), out, dims=1)
