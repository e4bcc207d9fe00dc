"""Base dataset (counterpart of ``ioudet/data/datasets/custom.py``).

Annotation contract: ``img_infos`` is a list of dict(filename, width,
height[, id]); ``get_ann_info(idx)`` returns dict(bboxes (n, 4) xyxy f32,
labels (n,) 1-based, bboxes_ignore (k, 4)); ``seg_prefix`` is where
``LoadAnnotations(with_seg=True)`` finds the semantic maps.  In train mode images smaller
than ``min_size`` or without annotations are dropped, and a sample whose
pipeline leaves no valid gt is replaced by another of the same orientation
(``_rand_another``).  ``flag`` is the
orientation group: 1 where w >= h, 0 for portrait.  Square images go with
the landscape ones, as ``Pad`` gives them the landscape canvas (``ioudet``
puts them in the portrait group, w / h > 1, where they cannot be stacked
with the portrait canvases, and its loader then ends the epoch early).
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from ..pipelines.compose import Compose
from ..rng import sample_rng


class CustomDataset:
    CLASSES: Optional[tuple] = None

    def __init__(self, ann_file: str, pipeline, img_prefix: str = "",
                 proposal_file: Optional[str] = None, test_mode: bool = False,
                 min_size: int = 32, seg_prefix: Optional[str] = ""):
        if proposal_file is not None:
            raise NotImplementedError("precomputed proposals (LoadProposals) are not ported yet")
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.seg_prefix = seg_prefix
        self.test_mode = test_mode
        self.img_infos = self.load_annotations(ann_file)
        if not test_mode:
            self.img_infos = [self.img_infos[i] for i in self._filter_imgs(min_size)]
        self._set_group_flag()
        self.pipeline = Compose(pipeline)

    def load_annotations(self, ann_file: str) -> List[dict]:
        with open(ann_file) as f:
            return json.load(f)

    def get_ann_info(self, idx: int) -> dict:
        return self.img_infos[idx]["ann"]

    def _filter_imgs(self, min_size: int = 32) -> List[int]:
        valid = []
        for i, info in enumerate(self.img_infos):
            if min(info["width"], info["height"]) < min_size:
                continue
            if len(self.get_ann_info(i)["bboxes"]) == 0:
                continue
            valid.append(i)
        return valid

    def _set_group_flag(self):
        self.flag = np.zeros(len(self), dtype=np.uint8)
        for i, info in enumerate(self.img_infos):
            if info["width"] >= info["height"]:
                self.flag[i] = 1

    def __len__(self) -> int:
        return len(self.img_infos)

    def _rand_another(self, idx: int) -> int:
        pool = np.where(self.flag == self.flag[idx])[0]
        return int(sample_rng().choice(list(pool)))

    def prepare_train_img(self, idx: int):
        return self.pipeline(dict(img_info=self.img_infos[idx],
                                  ann_info=self.get_ann_info(idx),
                                  img_prefix=self.img_prefix, seg_prefix=self.seg_prefix,
                                  idx=idx))

    def prepare_test_img(self, idx: int):
        return self.pipeline(dict(img_info=self.img_infos[idx],
                                  img_prefix=self.img_prefix, idx=idx))

    def __getitem__(self, idx: int):
        if self.test_mode:
            return self.prepare_test_img(idx)
        while True:
            data = self.prepare_train_img(idx)
            if data is None or not data.get("gt_valid", np.ones(1)).any():
                idx = self._rand_another(idx)
                continue
            return data
