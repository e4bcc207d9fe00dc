from .bbox_nms import multiclass_nms
from .merge_augs import (merge_aug_bboxes, merge_aug_bboxes_mean, merge_aug_masks,
                         merge_aug_proposals, merge_aug_scores)

__all__ = ["multiclass_nms", "merge_aug_bboxes", "merge_aug_bboxes_mean", "merge_aug_masks",
           "merge_aug_proposals", "merge_aug_scores"]
