"""Base dataset (counterpart of ``ioudet/data/datasets/custom.py``).

Annotation contract: ``img_infos`` is a list of dict(filename, width,
height[, id]); ``get_ann_info(idx)`` returns dict(bboxes (n, 4) xyxy f32,
labels (n,) 1-based, bboxes_ignore (k, 4)); ``seg_prefix`` is where
``LoadAnnotations(with_seg=True)`` finds the semantic maps.  In train mode images smaller
than ``min_size`` or without annotations are dropped, and a sample whose
pipeline leaves no valid gt is replaced by another of the same orientation
(``_rand_another``).  ``proposal_file`` (a ``.pkl`` / ``.pickle`` list of
(n, 4|5) arrays, or an ``.npy`` object array, one an image in annotation
order) gives each sample its ``proposals`` for ``LoadProposals``; a filtered
image's proposals go with it.  ``flag`` is the
orientation group: 1 where w >= h, 0 for portrait.  Square images go with
the landscape ones, as ``Pad`` gives them the landscape canvas (``ioudet``
puts them in the portrait group, w / h > 1, where they cannot be stacked
with the portrait canvases, and its loader then ends the epoch early).
"""

from __future__ import annotations

import json
import pickle
from typing import List, Optional

import numpy as np

from ..pipelines.compose import Compose
from ..rng import sample_rng


class CustomDataset:
    CLASSES: Optional[tuple] = None

    def __init__(self, ann_file: str, pipeline, img_prefix: str = "",
                 proposal_file: Optional[str] = None, test_mode: bool = False,
                 min_size: int = 32, seg_prefix: Optional[str] = ""):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.seg_prefix = seg_prefix
        self.test_mode = test_mode
        self.img_infos = self.load_annotations(ann_file)
        self.proposals = self.load_proposals(proposal_file) if proposal_file else None
        if not test_mode:
            valid = self._filter_imgs(min_size)
            self.img_infos = [self.img_infos[i] for i in valid]
            if self.proposals is not None:
                self.proposals = [self.proposals[i] for i in valid]
        self._set_group_flag()
        self.pipeline = Compose(pipeline)

    def load_annotations(self, ann_file: str) -> List[dict]:
        with open(ann_file) as f:
            return json.load(f)

    def get_ann_info(self, idx: int) -> dict:
        return self.img_infos[idx]["ann"]

    @staticmethod
    def load_proposals(proposal_file: str) -> list:
        """The per-image proposal arrays of a ``.pkl`` / ``.pickle`` (a list)
        or ``.npy`` (an object array) file."""
        if proposal_file.endswith((".pkl", ".pickle")):
            with open(proposal_file, "rb") as f:
                return list(pickle.load(f))
        if proposal_file.endswith(".npy"):
            return list(np.load(proposal_file, allow_pickle=True))
        raise ValueError(f"unsupported proposal file {proposal_file} (.pkl, .pickle or .npy)")

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

    def _results(self, idx: int, **extra) -> dict:
        results = dict(img_info=self.img_infos[idx], img_prefix=self.img_prefix, idx=idx,
                       **extra)
        if self.proposals is not None:
            results["proposals"] = self.proposals[idx]
        return results

    def prepare_train_img(self, idx: int):
        return self.pipeline(self._results(idx, ann_info=self.get_ann_info(idx),
                                           seg_prefix=self.seg_prefix))

    def prepare_test_img(self, idx: int):
        return self.pipeline(self._results(idx))

    def __getitem__(self, idx: int):
        if self.test_mode:
            return self.prepare_test_img(idx)
        while True:
            data = self.prepare_train_img(idx)
            if data is None or not data.get("gt_valid", np.ones(1)).any():
                idx = self._rand_another(idx)
                continue
            return data
