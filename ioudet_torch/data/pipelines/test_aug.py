"""Multi-scale / flip test-time augmentation (counterpart of
``ioudet/data/pipelines/test_aug.py``): the inner pipeline runs once a view
and the sample becomes the list of views, scale-major, then flip False /
True.  Each view carries ``scale_override`` and ``flip_override`` for the
inner ``Resize`` and ``RandomFlip``."""

from __future__ import annotations

import copy
from typing import List, Sequence


class MultiScaleFlipAug:
    def __init__(self, transforms: Sequence[dict], img_scale, flip: bool = False):
        from .compose import Compose
        self.transforms = Compose(transforms)
        self.img_scales = img_scale if isinstance(img_scale, list) else [img_scale]
        self.flip = flip

    def __call__(self, results: dict) -> List[dict]:
        views = []
        for scale in self.img_scales:
            for flip in ((False, True) if self.flip else (False,)):
                r = copy.deepcopy(results)
                r["scale_override"] = tuple(scale)
                r["flip_override"] = flip
                views.append(self.transforms(r))
        return views
