"""Proposal recall (counterpart of ``ioudet/core/evaluation/recall.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .bbox_overlaps import bbox_overlaps_np


def eval_recalls(gts: Sequence[np.ndarray], proposals: Sequence[np.ndarray],
                 proposal_nums: Sequence[int] = (100, 300, 1000),
                 iou_thrs: Optional[Sequence[float]] = None) -> np.ndarray:
    """Returns the (len(proposal_nums), len(iou_thrs)) recall matrix: each gt
    takes its best proposal, best pair first, among the top ``num``
    proposals (by score where they carry one)."""
    if iou_thrs is None:
        iou_thrs = [0.5]
    proposal_nums = np.asarray(proposal_nums)
    iou_thrs = np.asarray(iou_thrs)
    all_ious = []
    for gt, prop in zip(gts, proposals):
        if prop.shape[1] == 5:
            prop = prop[np.argsort(-prop[:, 4], kind="mergesort"), :4]
        img_ious = []
        for num in proposal_nums:
            p = prop[:num]
            if gt.size == 0 or p.size == 0:
                img_ious.append(np.zeros((gt.shape[0], 1)))
            else:
                img_ious.append(bbox_overlaps_np(gt, p))
        all_ious.append(img_ious)

    recalls = np.zeros((len(proposal_nums), len(iou_thrs)))
    for ni in range(len(proposal_nums)):
        gt_max = []
        for img_ious in all_ious:
            ious = img_ious[ni].copy()
            n_gt = ious.shape[0]
            best = np.zeros(n_gt)
            for _ in range(n_gt):
                if ious.size == 0:
                    break
                idx = np.unravel_index(ious.argmax(), ious.shape)
                val = ious[idx]
                if val <= 0:
                    break
                best[idx[0]] = val
                ious[idx[0], :] = -1
                ious[:, idx[1]] = -1
            gt_max.append(best)
        flat = np.concatenate(gt_max) if gt_max else np.zeros(0)
        for ti, thr in enumerate(iou_thrs):
            recalls[ni, ti] = (flat >= thr).mean() if flat.size else 0.0
    return recalls
