"""COCO-protocol evaluation in numpy, boxes (``bbox``) and instance masks
(``segm``) (counterpart of ``ioudet/core/evaluation/coco_eval.py``;
pycocotools is not a dependency).

  * IoU thresholds 0.50:0.05:0.95 (10), recall points 0:0.01:1 (101);
  * area ranges all / small (< 32^2) / medium / large (> 96^2) on the gt's
    ``area`` (bbox w * h where it has none), and for an unmatched det on
    its box's area, or in ``segm`` its mask's;
  * maxDets (1, 10, 100); crowd and ``ignore`` gts are ignored, and a det
    on a crowd gt is matched by intersection over the det's area;
  * greedy matching per (image, category): dets by descending score, each
    takes the best gt not yet taken with IoU >= t, non-ignored gts first;
  * -1 where a (class, area) cell has no ground truth; stable sorts.

IoU follows pycocotools (xywh, no +1); ``xyxy2xywh`` uses the reference's
+1.  In ``segm`` the gts' polygons are rasterized at the image size
(``core/mask/rle.ann_to_rle``), the dets carry RLEs, and IoUs are mask
IoUs from the runs.  ``ioudet`` matches on IoUs rounded to float32 (its
native matcher, ``csrc/host_ops.cpp`` ``coco_match_cpu``), so
``match_dets`` rounds them the same way: a det whose f64 IoU sits within
an f32 ulp of a threshold lands on the side ``ioudet`` puts it.  A cell's
IoUs are computed once, and its match once at the largest maxDet and cut
for the smaller ones (greedy matching in score order makes the match of
the first m dets a prefix of the match of all of them).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..mask import rle

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def xyxy2xywh(bbox: np.ndarray) -> np.ndarray:
    """+1 convention, matching the reference's results2json."""
    out = bbox.copy().astype(np.float64)
    out[..., 2] = bbox[..., 2] - bbox[..., 0] + 1
    out[..., 3] = bbox[..., 3] - bbox[..., 1] + 1
    return out


def iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """pycocotools' bbox IoU, (D, G); against a crowd gt, IoF on the det."""
    D, G = dets.shape[0], gts.shape[0]
    if D * G == 0:
        return np.zeros((D, G))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None, :]) -
                 np.maximum(dx1[:, None], gx1[None, :]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None, :]) -
                 np.maximum(dy1[:, None], gy1[None, :]), 0, None)
    inter = iw * ih
    d_area = dets[:, 2] * dets[:, 3]
    g_area = gts[:, 2] * gts[:, 3]
    union = np.where(iscrowd[None, :].astype(bool), d_area[:, None],
                     d_area[:, None] + g_area[None, :] - inter)
    return inter / np.maximum(union, 1e-10)


def match_dets(ious: np.ndarray, gt_ignore: np.ndarray,
               iscrowd: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """pycocotools' greedy matching of score-sorted dets to gts sorted with
    the non-ignored first: (dtm (T, D) int64, the matched gt + 1 or 0;
    dt_ignore (T, D) bool).  Vectorized over thresholds and gts: each det
    takes, among the gts it may still take with IoU >= t, the last one of
    the largest IoU, from the non-ignored ones when there are any (the
    reference's loop keeps the last gt at the running maximum and stops at
    the first ignored gt once it has a non-ignored one)."""
    D, G = ious.shape
    T = len(IOU_THRS)
    dtm = np.zeros((T, D), np.int64)
    dt_ignore = np.zeros((T, D), bool)
    if D == 0 or G == 0:
        return dtm, dt_ignore
    ious = ious.astype(np.float32).astype(np.float64)
    gt_ignore = gt_ignore.astype(bool)
    iscrowd = iscrowd.astype(bool)
    thrs = np.minimum(IOU_THRS, 1 - 1e-10)[:, None]
    taken = np.zeros((T, G), bool)
    for d in range(D):
        row = ious[d]
        ok = (row >= thrs) & (~taken | iscrowd)
        kept = ok & ~gt_ignore
        cand = np.where(kept.any(axis=1, keepdims=True), kept, ok)
        hit = cand.any(axis=1)
        if not hit.any():
            continue
        g = G - 1 - np.argmax(np.where(cand, row, -1.0)[:, ::-1], axis=1)
        ts, gs = np.nonzero(hit)[0], g[hit]
        dtm[ts, d] = gs + 1
        dt_ignore[ts, d] = gt_ignore[gs]
        taken[ts, gs] = True
    return dtm, dt_ignore


def _evaluate_img(ious: np.ndarray, det_scores: np.ndarray, det_areas: np.ndarray,
                  gt_ignore: np.ndarray, iscrowd: np.ndarray, gt_areas: np.ndarray,
                  area_rng: Tuple[float, float]) -> dict:
    """Match one (image, category) cell within one area range: ``ious``
    (D, G) of the dets in score order (at most the largest maxDet) against
    the gts in their own order."""
    gIg = gt_ignore | (gt_areas < area_rng[0]) | (gt_areas > area_rng[1])
    gt_order = np.argsort(gIg, kind="mergesort")
    gIg_s = gIg[gt_order]
    dtm, dtIg = match_dets(ious[:, gt_order], gIg_s, iscrowd[gt_order])
    # unmatched dets outside the area range are ignored
    out_of_rng = (det_areas < area_rng[0]) | (det_areas > area_rng[1])
    dtIg = dtIg | ((dtm == 0) & out_of_rng[None, :])
    return dict(dtm=dtm, dtIg=dtIg, scores=det_scores, num_gt=int((~gIg_s).sum()))


class CocoEvaluator:
    """Accumulates per-image gts and detections, then computes the 12 COCO
    metrics of ``mode`` ("bbox" or "segm").

    ``add_gt(image_id, anns, img_size)``: dicts with bbox (xywh), and
    optionally iscrowd, area, ignore; in ``segm`` each with its
    ``segmentation`` (polygons or RLE), rasterized at ``img_size`` (h, w).
    ``add_det_per_class(image_id, result, segms)``: per-class xyxy (n, 5)
    arrays (the ``bbox2result`` format), class index i -> ``cat_ids[i]``;
    in ``segm`` also per-class lists of RLE dicts aligned with their rows.
    """

    def __init__(self, cat_ids: Sequence[int], mode: str = "bbox"):
        if mode not in ("bbox", "segm"):
            raise KeyError(f"mode {mode!r} is not one of 'bbox', 'segm'")
        self.cat_ids = list(cat_ids)
        self.mode = mode
        self._gts: Dict[Tuple[int, int], list] = defaultdict(list)
        self._dts: Dict[Tuple[int, int], list] = defaultdict(list)
        self.img_ids: List[int] = []

    def add_gt(self, image_id: int, anns: Sequence[dict],
               img_size: Optional[Tuple[int, int]] = None) -> None:
        if image_id not in self.img_ids:
            self.img_ids.append(image_id)
        for ann in anns:
            ig = bool(ann.get("ignore", False)) or bool(ann.get("iscrowd", 0))
            bbox = np.asarray(ann["bbox"], np.float64)
            area = float(ann.get("area", bbox[2] * bbox[3]))
            g_rle = None
            if self.mode == "segm":
                segm = ann.get("segmentation")
                if segm is None:
                    raise ValueError("segm evaluation needs a 'segmentation' on every gt")
                h, w = img_size if img_size is not None else ann["size"]
                g_rle = rle.ann_to_rle(segm, h, w)
            self._gts[(image_id, ann["category_id"])].append(
                (bbox, ig, bool(ann.get("iscrowd", 0)), area, g_rle))

    def add_det_per_class(self, image_id: int, result: Sequence[np.ndarray],
                          segms: Optional[Sequence[list]] = None) -> None:
        if len(result) > len(self.cat_ids):
            raise ValueError(
                f"model predicts {len(result)} foreground classes but the "
                f"dataset has {len(self.cat_ids)} categories: check the "
                f"config's num_classes against the annotation file")
        if self.mode == "segm" and segms is None:
            raise ValueError("segm evaluation needs the dets' RLE masks")
        if image_id not in self.img_ids:
            self.img_ids.append(image_id)
        for ci, dets in enumerate(result):
            if len(dets) == 0:
                continue
            xywh = xyxy2xywh(dets[:, :4])
            rles = segms[ci] if self.mode == "segm" else [None] * len(dets)
            self._dts[(image_id, self.cat_ids[ci])].extend(
                zip(xywh, dets[:, 4].astype(np.float64).tolist(), rles))

    def _cells(self, cat: int) -> list:
        """The images with a gt or a det of ``cat``: their IoUs (dets in
        score order, the first MAX_DETS[-1]), det areas and gt arrays."""
        cells = []
        for img in self.img_ids:
            gt = self._gts.get((img, cat), [])
            dt = self._dts.get((img, cat), [])
            if not gt and not dt:
                continue
            gts = np.array([g[0] for g in gt]).reshape(-1, 4)
            iscrowd = np.array([g[2] for g in gt], bool)
            scores = np.array([d[1] for d in dt], np.float64)
            order = np.argsort(-scores, kind="mergesort")[:MAX_DETS[-1]]
            dt = [dt[i] for i in order]
            if self.mode == "segm":
                d_rles = [d[2] for d in dt]
                ious = rle.iou(d_rles, [g[4] for g in gt], iscrowd.astype(int))
                det_areas = np.array([rle.area(r) for r in d_rles], np.float64)
            else:
                dets = np.array([d[0] for d in dt]).reshape(-1, 4)
                ious = iou_xywh(dets, gts, iscrowd)
                det_areas = dets[:, 2] * dets[:, 3]
            cells.append(dict(ious=ious.reshape(len(dt), len(gt)), det_scores=scores[order],
                              det_areas=det_areas,
                              gt_ignore=np.array([g[1] for g in gt], bool), iscrowd=iscrowd,
                              gt_areas=np.array([g[3] for g in gt], np.float64)))
        return cells

    def evaluate(self) -> Dict[str, float]:
        T, R = len(IOU_THRS), len(RECALL_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RANGES), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        eps = np.finfo(np.float64).eps
        for k, cat in enumerate(self.cat_ids):
            cells = self._cells(cat)
            if not cells:
                continue
            for a, rng in enumerate(AREA_RANGES.values()):
                evals = [_evaluate_img(area_rng=rng, **c) for c in cells]
                npig = sum(e["num_gt"] for e in evals)
                if npig == 0:
                    continue
                for m, max_det in enumerate(MAX_DETS):
                    dtm = np.concatenate([e["dtm"][:, :max_det] for e in evals], axis=1)
                    dtIg = np.concatenate([e["dtIg"][:, :max_det] for e in evals], axis=1)
                    scores = np.concatenate([e["scores"][:max_det] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm, dtIg = dtm[:, order], dtIg[:, order]
                    tp_sum = np.cumsum((dtm > 0) & ~dtIg, axis=1).astype(np.float64)
                    fp_sum = np.cumsum((dtm == 0) & ~dtIg, axis=1).astype(np.float64)
                    nd = tp_sum.shape[1]
                    rc = tp_sum / npig
                    pr = tp_sum / np.maximum(tp_sum + fp_sum, eps)
                    recall[:, k, a, m] = rc[:, -1] if nd else 0
                    # precision envelope: the running maximum from the right
                    pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                    for t in range(T):
                        inds = np.searchsorted(rc[t], RECALL_THRS, side="left")
                        q = np.zeros(R)
                        inside = inds < nd
                        q[inside] = pr[t, inds[inside]]
                        precision[t, :, k, a, m] = q

        def _summarize(ap=True, iou=None, area="all", max_det=100):
            a = list(AREA_RANGES).index(area)
            m = MAX_DETS.index(max_det)
            t = slice(None) if iou is None else \
                [np.where(np.isclose(IOU_THRS, iou))[0][0]]
            s = precision[t, :, :, a, m] if ap else recall[t, :, a, m]
            valid = s[s > -1]
            return float(np.mean(valid)) if valid.size else -1.0

        self.precision = precision
        self.recall = recall
        return {
            "AP": _summarize(True),
            "AP50": _summarize(True, iou=0.5),
            "AP75": _summarize(True, iou=0.75),
            "APs": _summarize(True, area="small"),
            "APm": _summarize(True, area="medium"),
            "APl": _summarize(True, area="large"),
            "AR1": _summarize(False, max_det=1),
            "AR10": _summarize(False, max_det=10),
            "AR100": _summarize(False),
            "ARs": _summarize(False, area="small"),
            "ARm": _summarize(False, area="medium"),
            "ARl": _summarize(False, area="large"),
        }


def coco_eval_results(results_per_image: Sequence[Sequence[np.ndarray]],
                      gts_per_image: Sequence[Sequence[dict]],
                      image_ids: Sequence[int],
                      cat_ids: Sequence[int]) -> Dict[str, float]:
    """bbox2result-format detections + gt dicts -> the 12 metrics."""
    ev = CocoEvaluator(cat_ids)
    for img_id, gt in zip(image_ids, gts_per_image):
        ev.add_gt(img_id, gt)
    for img_id, res in zip(image_ids, results_per_image):
        ev.add_det_per_class(img_id, res)
    return ev.evaluate()


def print_coco_summary(metrics: Dict[str, float]) -> str:
    rows = (("AP", "Average Precision  (AP)", "0.50:0.95", "   all", 100),
            ("AP50", "Average Precision  (AP)", "0.50     ", "   all", 100),
            ("AP75", "Average Precision  (AP)", "0.75     ", "   all", 100),
            ("APs", "Average Precision  (AP)", "0.50:0.95", " small", 100),
            ("APm", "Average Precision  (AP)", "0.50:0.95", "medium", 100),
            ("APl", "Average Precision  (AP)", "0.50:0.95", " large", 100),
            ("AR1", "Average Recall     (AR)", "0.50:0.95", "   all", 1),
            ("AR10", "Average Recall     (AR)", "0.50:0.95", "   all", 10),
            ("AR100", "Average Recall     (AR)", "0.50:0.95", "   all", 100),
            ("ARs", "Average Recall     (AR)", "0.50:0.95", " small", 100),
            ("ARm", "Average Recall     (AR)", "0.50:0.95", "medium", 100),
            ("ARl", "Average Recall     (AR)", "0.50:0.95", " large", 100))
    return "\n".join(f" {name} @[ IoU={iou} | area={area} | maxDets={md:>3} ] = "
                     f"{metrics[key]:.3f}" for key, name, iou, area, md in rows)
