"""Test-time-augmentation merges (counterpart of
``ioudet/core/post_processing/merge_augs.py``), the single-stage ones.

A single-stage detector's views give independent candidate sets: their boxes
are mapped back to the original image, concatenated, and one NMS runs over
the union (``apis/test.py`` ``aug_test``).  The proposal and mask merges of
the two-stage family are not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..bbox.transforms import bbox_mapping_back


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
