"""VOC-style mAP (counterpart of ``ioudet/core/evaluation/mean_ap.py``).

Per-class greedy matching at one IoU threshold (0.5 by default) with
ignored gts, then 'area' (every-point) or '11points' interpolated AP, on
the +1 IoU convention of ``bbox_overlaps_np``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .bbox_overlaps import bbox_overlaps_np


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area") -> float:
    recalls = recalls.ravel()
    precisions = precisions.ravel()
    if mode == "area":
        mrec = np.concatenate(([0.0], recalls, [1.0]))
        mpre = np.concatenate(([0.0], precisions, [0.0]))
        # precision envelope: the running maximum from the right
        mpre = np.maximum.accumulate(mpre[::-1])[::-1]
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    if mode == "11points":
        ap = 0.0
        for thr in np.arange(0, 1.1, 0.1):
            prs = precisions[recalls >= thr]
            ap += (prs.max() if prs.size else 0.0) / 11.0
        return float(ap)
    raise ValueError(mode)


def tpfp_default(det_bboxes: np.ndarray, gt_bboxes: np.ndarray,
                 gt_ignore: Optional[np.ndarray] = None,
                 iou_thr: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy TP / FP flags of one image and class: dets (n, 5) taken by
    descending score; a det on an ignored gt counts as neither."""
    num_dets = det_bboxes.shape[0]
    num_gts = gt_bboxes.shape[0]
    if gt_ignore is None:
        gt_ignore = np.zeros(num_gts, bool)
    tp = np.zeros(num_dets)
    fp = np.zeros(num_dets)
    if num_gts == 0:
        fp[:] = 1
        return tp, fp
    ious = bbox_overlaps_np(det_bboxes[:, :4], gt_bboxes)
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    order = np.argsort(-det_bboxes[:, 4], kind="mergesort")
    covered = np.zeros(num_gts, bool)
    for d in order:
        if ious_max[d] >= iou_thr:
            g = ious_argmax[d]
            if gt_ignore[g]:
                continue
            if not covered[g]:
                covered[g] = True
                tp[d] = 1
            else:
                fp[d] = 1
        else:
            fp[d] = 1
    return tp, fp


def eval_map(det_results: Sequence[Sequence[np.ndarray]],
             gt_bboxes: Sequence[np.ndarray],
             gt_labels: Sequence[np.ndarray],
             gt_ignore: Optional[Sequence[np.ndarray]] = None,
             iou_thr: float = 0.5,
             num_classes: Optional[int] = None,
             mode: str = "area",
             dataset: Optional[str] = None,
             print_summary: bool = False):
    """det_results: per image, per class (n, 5) arrays (the ``bbox2result``
    format); gt_labels are 1-based (0 = background).  Returns (mAP, one
    dict a class)."""
    num_imgs = len(det_results)
    if num_classes is None:
        num_classes = len(det_results[0])
    eval_results = []
    for c in range(num_classes):
        tp_all, fp_all, scores_all = [], [], []
        num_gt = 0
        for i in range(num_imgs):
            dets = det_results[i][c]
            mask = gt_labels[i] == c + 1
            gts = gt_bboxes[i][mask]
            ig = gt_ignore[i][mask] if gt_ignore is not None else \
                np.zeros(int(mask.sum()), bool)
            tp, fp = tpfp_default(dets, gts, ig, iou_thr)
            tp_all.append(tp)
            fp_all.append(fp)
            scores_all.append(dets[:, 4] if len(dets) else np.zeros(0))
            num_gt += int((~ig).sum())
        scores = np.concatenate(scores_all)
        tp = np.concatenate(tp_all)
        fp = np.concatenate(fp_all)
        order = np.argsort(-scores, kind="mergesort")
        tp_cum = np.cumsum(tp[order])
        fp_cum = np.cumsum(fp[order])
        recalls = tp_cum / max(num_gt, 1)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(np.float64).eps)
        ap = average_precision(recalls, precisions, mode) if num_gt > 0 else 0.0
        eval_results.append(dict(
            num_gts=num_gt, num_dets=int(tp.size), ap=ap,
            recall=float(recalls[-1]) if recalls.size and num_gt > 0 else 0.0,
            precision=float(precisions[-1]) if precisions.size else 0.0))
    aps = [r["ap"] for r in eval_results if r["num_gts"] > 0]
    mean_ap = float(np.mean(aps)) if aps else 0.0
    if print_summary:
        print(print_map_summary(mean_ap, eval_results, dataset))
    return mean_ap, eval_results


def print_map_summary(mean_ap: float, results: List[dict],
                      dataset: Optional[str] = None) -> str:
    from .class_names import get_classes
    names = get_classes(dataset) if dataset else [str(i) for i in range(len(results))]
    lines = [f"{'class':<20}{'gts':>8}{'dets':>8}{'recall':>8}{'ap':>8}"]
    for name, r in zip(names, results):
        lines.append(f"{name:<20}{r['num_gts']:>8}{r['num_dets']:>8}"
                     f"{r['recall']:>8.3f}{r['ap']:>8.3f}")
    lines.append(f"{'mAP':<20}{'':>8}{'':>8}{'':>8}{mean_ap:>8.3f}")
    return "\n".join(lines)
