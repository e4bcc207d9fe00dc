"""COCO dataset (counterpart of ``ioudet/data/datasets/coco.py``).

The annotation file is read as plain JSON (no pycocotools):
  * cat2label is 1-based (0 = background), in the order of category ids;
  * crowd annotations go to ``bboxes_ignore``; ``ignore`` ones are dropped;
  * xywh -> xyxy with the +1 convention (x2 = x + w - 1), clipped to the
    image, degenerate boxes dropped;
  * in train mode images without annotations are dropped;
  * each kept annotation's polygons ride along as ``masks`` (an RLE
    segmentation, a crowd's, gives none).
``evaluate`` runs the port's COCOeval on the results in dataset order:
``bbox2result`` lists, or (bbox, segm) pairs of a mask detector for the
``segm`` metric.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import List

import numpy as np

from ...core.evaluation import CocoEvaluator, print_coco_summary, xyxy2xywh
from ...core.evaluation.class_names import COCO_CLASSES
from .custom import CustomDataset


class CocoDataset(CustomDataset):
    CLASSES = COCO_CLASSES

    def load_annotations(self, ann_file: str) -> List[dict]:
        with open(ann_file) as f:
            coco = json.load(f)
        self.cat_ids = [c["id"] for c in sorted(coco["categories"], key=lambda c: c["id"])]
        self.cat2label = {cid: i + 1 for i, cid in enumerate(self.cat_ids)}
        anns_by_img = defaultdict(list)
        for ann in coco.get("annotations", []):
            anns_by_img[ann["image_id"]].append(ann)
        self._anns_by_img = anns_by_img
        return [dict(id=img["id"], filename=img["file_name"], width=img["width"],
                     height=img["height"]) for img in coco["images"]]

    def get_ann_info(self, idx: int) -> dict:
        info = self.img_infos[idx]
        bboxes, labels, ignore, masks = [], [], [], []
        for ann in self._anns_by_img.get(info["id"], []):
            if ann.get("ignore", False):
                continue
            x, y, w, h = ann["bbox"]
            x1, y1 = max(x, 0), max(y, 0)
            ww = min(x + w, info["width"]) - x1
            hh = min(y + h, info["height"]) - y1
            if ww <= 0 or hh <= 0 or ann.get("area", ww * hh) <= 0:
                continue
            box = [x1, y1, x1 + ww - 1, y1 + hh - 1]
            if ann.get("iscrowd", 0):
                ignore.append(box)
            else:
                bboxes.append(box)
                labels.append(self.cat2label[ann["category_id"]])
                seg = ann.get("segmentation")
                masks.append(seg if isinstance(seg, list) else [])
        return dict(bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
                    labels=np.asarray(labels, np.int64),
                    bboxes_ignore=np.asarray(ignore, np.float32).reshape(-1, 4),
                    masks=masks)

    def _filter_imgs(self, min_size: int = 32) -> List[int]:
        valid = []
        for i, info in enumerate(self.img_infos):
            if min(info["width"], info["height"]) < min_size:
                continue
            if not self._anns_by_img.get(info["id"]):
                continue
            valid.append(i)
        return valid

    # ---- evaluation --------------------------------------------------------

    def gt_for_eval(self, idx: int, with_segm: bool = False) -> List[dict]:
        """COCO-protocol gt dicts of one image (xywh, no +1; ``area`` as the
        annotation gives it, since pycocotools gates area ranges on it);
        ``with_segm`` adds each annotation's ``segmentation``."""
        out = []
        for ann in self._anns_by_img.get(self.img_infos[idx]["id"], []):
            w, h = float(ann["bbox"][2]), float(ann["bbox"][3])
            d = dict(bbox=list(map(float, ann["bbox"])), category_id=ann["category_id"],
                     iscrowd=ann.get("iscrowd", 0), ignore=ann.get("ignore", False),
                     area=float(ann.get("area", w * h)))
            if with_segm:
                d["segmentation"] = ann.get("segmentation")
            out.append(d)
        return out

    def evaluate(self, results, metric="bbox", logger=None) -> dict:
        """results: one ``bbox2result`` list an image, or one (bbox list,
        segm list) pair of a mask detector, in dataset order.  ``metric``:
        "bbox", "segm" or a list of both.  Returns the 12 COCO metrics (AP,
        AP50, ..., ARl) of the one metric, or of each with a ``bbox_`` /
        ``segm_`` prefix."""
        metrics = [metric] if isinstance(metric, str) else list(metric)
        unknown = [m for m in metrics if m not in ("bbox", "segm")]
        if unknown:
            raise KeyError(f"metric {unknown[0]!r} is not one of 'bbox', 'segm'")
        if len(results) != len(self):
            raise ValueError(f"{len(results)} results for {len(self)} images")
        log = logger.info if logger else print
        out: dict = {}
        for m in metrics:
            ev = CocoEvaluator(self.cat_ids, mode=m)
            for idx, res in enumerate(results):
                info = self.img_infos[idx]
                bbox_res, segm_res = res if isinstance(res, tuple) else (res, None)
                ev.add_gt(info["id"], self.gt_for_eval(idx, with_segm=m == "segm"),
                          img_size=(info["height"], info["width"]))
                if m == "segm" and segm_res is None:
                    raise ValueError("the segm metric needs (bbox, segm) results: is the "
                                     "model a mask detector?")
                ev.add_det_per_class(info["id"], bbox_res,
                                     segms=segm_res if m == "segm" else None)
            mm = ev.evaluate()
            log(f"--- {m} ---")
            log(print_coco_summary(mm))
            out.update(mm if len(metrics) == 1 else {f"{m}_{k}": v for k, v in mm.items()})
        return out

    def results2json(self, results) -> List[dict]:
        """COCO result records (image_id, xywh bbox, score, category_id),
        with its RLE ``segmentation`` where the results carry masks."""
        out = []
        for idx, res in enumerate(results):
            img_id = self.img_infos[idx]["id"]
            per_cls, segms = res if isinstance(res, tuple) else (res, None)
            for ci, dets in enumerate(per_cls):
                for di, det in enumerate(dets):
                    rec = dict(image_id=img_id,
                               bbox=[float(v) for v in xyxy2xywh(det[None, :4])[0]],
                               score=float(det[4]), category_id=self.cat_ids[ci])
                    if segms is not None:
                        rec["segmentation"] = segms[ci][di]
                    out.append(rec)
        return out
