"""Mask Scoring R-CNN (counterpart of
``ioudet/models/detectors/mask_scoring_rcnn.py``, mmdet's
``MaskScoringRCNN``): Mask R-CNN with a ``MaskIoUHead`` that predicts each
mask's IoU with its gt.

  * training: the mask-IoU branch runs on the mask branch's own sampled rois,
    RoI features and logits (``mask_rcnn.mask_losses`` hands them out): the
    sigmoid of each roi's class channel goes into the head beside its
    feature, and its target is ``MaskIoUHead.mask_iou_target_ref`` of that
    mask binarized at ``train_cfg.rcnn.mask_thr_binary`` (0.5 by default)
    against the roi's mask target, the matched gt's box and the fraction of
    its box-frame crop that is mask; the target carries no gradient, the
    prediction does (into the mask head and the features, as in ``ioudet``
    and mmdet).  The loss is ``loss_mask_iou`` over the positives;
  * test: Mask R-CNN's detections and masks, each detection's score
    multiplied by its class's predicted mask IoU clipped to [0, 1].  The
    backbone and the mask RoIAlign run once (``ioudet`` runs them again for
    the mask-IoU head, to the same result).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..heads.anchor_head import sigmoid
from .mask_rcnn import MaskRCNN, mask_branch, mask_losses


class MaskScoringRCNN(MaskRCNN):
    parts = MaskRCNN.parts + ("mask_iou_head",)

    def __init__(self, backbone: nn.Module, rpn_head: nn.Module,
                 bbox_roi_extractor: nn.Module, bbox_head: nn.Module,
                 mask_roi_extractor: nn.Module, mask_head: nn.Module,
                 mask_iou_head: nn.Module, neck: Optional[nn.Module] = None,
                 train_cfg: Optional[dict] = None, test_cfg: Optional[dict] = None):
        super().__init__(backbone, rpn_head, bbox_roi_extractor, bbox_head, mask_roi_extractor,
                         mask_head, neck=neck, train_cfg=train_cfg, test_cfg=test_cfg)
        self.mask_iou_head = mask_iou_head

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                      gt_masks: Optional[torch.Tensor] = None, gt_bboxes_ignore=None,
                      gt_ignore_valid=None, generator: Optional[torch.Generator] = None):
        """``MaskRCNN.forward_train`` plus, with ``gt_masks``, ``loss_mask_iou``."""
        losses, aux = self.train_core(img, gt_bboxes, gt_labels, gt_valid, img_shapes,
                                      pad_shapes, gt_bboxes_ignore, gt_ignore_valid, generator)
        if gt_masks is None:
            return losses
        losses["loss_mask"] = mask_losses(self, aux, gt_masks, gt_bboxes)
        pred_cls = sigmoid(self.mask_head.own_class(aux["mask_pred"], aux["labels"]))
        thr = dict(dict(self.train_cfg or {}).get("rcnn", {})).get("mask_thr_binary", 0.5)
        with torch.no_grad():
            crop_fracs = gt_masks.float().mean(dim=(2, 3))
            matched_frac = torch.gather(crop_fracs, 1, aux["gt_idx"].long())
            iou_target = self.mask_iou_head.mask_iou_target_ref(
                pred_cls, aux["mask_targets"].flatten(0, 1), aux["sel_boxes"].flatten(0, 1),
                aux["matched_gt"].flatten(0, 1), matched_frac.flatten(), thr=thr)
        iou_pred = self.mask_iou_head(aux["mask_feats"], pred_cls)
        losses["loss_mask_iou"] = self.mask_iou_head.loss(iou_pred, iou_target, aux["labels"],
                                                          aux["sel_pos"].flatten())
        return losses

    def simple_test(self, img, img_shapes, scale_factors, pad_shapes, rescale: bool = True):
        """(dets (B, max_per_img, 5) with the scores rescored by the mask IoU,
        labels (B, max_per_img), masks (B, max_per_img, 28, 28))."""
        feats = self.extract_feat(img)
        dets, labels = self.simple_test_bboxes(feats, img_shapes, scale_factors, pad_shapes,
                                               rescale)
        boxes = dets[..., :4]
        if rescale:
            boxes = boxes * scale_factors.float()[:, None, None]
        mask_feats, masks = mask_branch(self, feats, boxes, labels)
        iou_pred = self.mask_iou_head(mask_feats, masks.flatten(0, 1))
        safe = labels.reshape(-1, 1).clamp(0, iou_pred.shape[-1] - 1)
        mask_scores = torch.gather(iou_pred.float(), 1, safe).reshape(labels.shape)
        dets = torch.cat([dets[..., :4], dets[..., 4:] * mask_scores.clamp(0.0, 1.0)[..., None]],
                         dim=-1)
        return dets, labels, masks
