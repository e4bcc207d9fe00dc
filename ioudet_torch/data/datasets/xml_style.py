"""Pascal-VOC-style XML datasets (counterpart of
``ioudet/data/datasets/xml_style.py``): ``XMLDataset``, ``VOCDataset`` and
``WIDERFaceDataset``.

  * ``ann_file`` lists image ids, one a line; ``<img_prefix>/Annotations/
    <id>.xml`` gives the size and the objects, read with the standard
    library's ElementTree;
  * the image is ``JPEGImages/<id>.jpg`` (WIDER Face: ``<folder>/<id>.jpg``);
    ``imread`` picks its decoder by the file's magic bytes, so a netpbm file
    under that name needs no image library;
  * labels are 1-based through ``cat2label``; ``difficult`` objects go to
    ``bboxes_ignore``; objects of other classes are dropped;
  * ``evaluate`` is VOC mAP (``core/evaluation/mean_ap.eval_map``) at one
    IoU threshold, in '11points' mode for VOC2007 and 'area' mode otherwise.
    As in ``ioudet``, the ignored boxes are not passed to it.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from ...core.evaluation import eval_map
from ...core.evaluation.class_names import VOC_CLASSES, WIDER_FACE_CLASSES
from .custom import CustomDataset


class XMLDataset(CustomDataset):
    def _xml_root(self, img_id: str):
        return ET.parse(os.path.join(self.img_prefix, "Annotations", f"{img_id}.xml")).getroot()

    def _filename(self, img_id: str, root) -> str:
        return os.path.join("JPEGImages", f"{img_id}.jpg")

    def load_annotations(self, ann_file: str) -> List[dict]:
        self.cat2label = {c: i + 1 for i, c in enumerate(self.CLASSES)}
        with open(ann_file) as f:
            img_ids = [line.strip() for line in f if line.strip()]
        infos = []
        for img_id in img_ids:
            root = self._xml_root(img_id)
            size = root.find("size")
            infos.append(dict(id=img_id, filename=self._filename(img_id, root),
                              width=int(size.find("width").text),
                              height=int(size.find("height").text)))
        return infos

    def get_ann_info(self, idx: int) -> dict:
        bboxes, labels, ignore = [], [], []
        for obj in self._xml_root(self.img_infos[idx]["id"]).findall("object"):
            name = obj.find("name").text
            if name not in self.cat2label:
                continue
            tag = obj.find("difficult")
            difficult = int(tag.text or 0) if tag is not None else 0
            bb = obj.find("bndbox")
            box = [float(bb.find(t).text) for t in ("xmin", "ymin", "xmax", "ymax")]
            if difficult:
                ignore.append(box)
            else:
                bboxes.append(box)
                labels.append(self.cat2label[name])
        return dict(bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
                    labels=np.asarray(labels, np.int64),
                    bboxes_ignore=np.asarray(ignore, np.float32).reshape(-1, 4))

    def evaluate(self, results, metric: str = "mAP", iou_thr: float = 0.5,
                 logger=None) -> dict:
        """results: one ``bbox2result`` list an image, in dataset order.
        Returns dict(mAP, per_class)."""
        if len(results) != len(self):
            raise ValueError(f"{len(results)} results for {len(self)} images")
        gts = [self.get_ann_info(i) for i in range(len(self))]
        mean_ap, per_cls = eval_map(
            results, [g["bboxes"] for g in gts], [g["labels"] for g in gts],
            iou_thr=iou_thr, num_classes=len(self.CLASSES),
            mode="11points" if getattr(self, "year", 2012) == 2007 else "area")
        return dict(mAP=mean_ap, per_class=per_cls)


class VOCDataset(XMLDataset):
    CLASSES = VOC_CLASSES

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.year = 2007 if "VOC2007" in self.img_prefix else 2012


class WIDERFaceDataset(XMLDataset):
    """WIDER Face: XML annotations, images under the per-event folder that
    each annotation's ``<folder>`` names."""

    CLASSES = WIDER_FACE_CLASSES

    def _filename(self, img_id: str, root) -> str:
        return os.path.join(root.find("folder").text, f"{img_id}.jpg")
