"""Mask R-CNN (counterpart of ``ioudet/models/detectors/mask_rcnn.py``):
Faster R-CNN with an FCN mask branch on the same features.

  * training: the gt masks come as fixed (B, G, 112, 112) uint8 crops in
    their boxes' frames (``core/mask/mask_target.py``); the mask branch runs
    on every roi that ``sample_rois_batch`` selected (RoIAlign at 14x14, the
    mask head), each roi's target is its assigned gt's crop resampled into
    the roi at 28x28, and the loss counts the positives only, as
    ``ioudet``'s does;
  * test: ``simple_test`` returns (dets, labels, masks (B, max_per_img, 28,
    28)): the sigmoid of each detection's own class channel, in its box's
    frame, the boxes scaled back to the canvas for the RoIAlign.  The
    backbone and FPN run once (``ioudet`` runs them twice, to the same
    result); the paste into the image is the host's (``apis/test.py``).
    In bf16 the sigmoid is written out as XLA's (``anchor_head.sigmoid``)
    and the probabilities come back as f32 holding those bf16 values.

``mask_losses`` / ``mask_test`` are the branch's two halves, shared with
``FastMaskRCNN`` (``fast_rcnn.py``) and ``MaskScoringRCNN``
(``mask_scoring_rcnn.py``).  ``mask_test_boxes`` is the per-view primitive of
the two-stage TTA (``apis/test.py`` ``aug_test_two_stage``): the masks of
given boxes and labels on a view's features.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.mask import mask_target
from ..heads.anchor_head import sigmoid
from .two_stage import TwoStageDetector, to_rois


def mask_losses(det, aux: dict, gt_masks: torch.Tensor, gt_bboxes: torch.Tensor):
    """``loss_mask`` of the mask branch on a train step's sampled rois
    (``train_core``'s aux dict), with ``gt_masks`` (B, G, S, S) uint8
    box-frame crops.  The branch's RoI features, logits and targets (B, N,
    S, S) go into ``aux`` as ``mask_feats``, ``mask_pred`` and
    ``mask_targets``."""
    mask_feats = det.mask_roi_extractor(aux["feats"], aux["rois"])
    mask_pred = det.mask_head(mask_feats)
    targets = mask_target(gt_masks, gt_bboxes, aux["sel_boxes"], aux["gt_idx"],
                          aux["sel_pos"], out_size=mask_pred.shape[-1])
    aux.update(mask_feats=mask_feats, mask_pred=mask_pred, mask_targets=targets)
    return det.mask_head.loss(mask_pred, targets.flatten(0, 1), aux["labels"],
                              aux["sel_pos"].flatten())


def mask_branch(det, feats, boxes: torch.Tensor, labels: torch.Tensor) -> tuple:
    """The mask branch on boxes (B, N, 4) on the canvas and their 0-based
    labels (B, N): (the RoI features (B * N, C, 14, 14), the f32 mask
    probabilities (B, N, 28, 28) of each box's class)."""
    mask_feats = det.mask_roi_extractor(feats, to_rois(boxes))
    mask_pred = det.mask_head(mask_feats)
    bsz, n = labels.shape
    own = det.mask_head.own_class(mask_pred, labels.reshape(-1).clamp(min=0) + 1)
    return mask_feats, sigmoid(own).float().reshape(bsz, n, *own.shape[1:])


def mask_test(det, feats, dets: torch.Tensor, labels: torch.Tensor,
              scale_factors: torch.Tensor, rescale: bool) -> torch.Tensor:
    """(B, N, 28, 28) f32 mask probabilities of the detections' own classes,
    the boxes scaled back to the canvas for the RoIAlign."""
    boxes = dets[..., :4]
    if rescale:
        boxes = boxes * scale_factors.float()[:, None, None]
    return mask_branch(det, feats, boxes, labels)[1]


class MaskRCNN(TwoStageDetector):
    parts = TwoStageDetector.parts + ("mask_roi_extractor", "mask_head")

    def __init__(self, backbone: nn.Module, rpn_head: nn.Module,
                 bbox_roi_extractor: nn.Module, bbox_head: nn.Module,
                 mask_roi_extractor: nn.Module, mask_head: nn.Module,
                 neck: Optional[nn.Module] = None,
                 train_cfg: Optional[dict] = None, test_cfg: Optional[dict] = None):
        super().__init__(backbone, rpn_head, bbox_roi_extractor, bbox_head, neck=neck,
                         train_cfg=train_cfg, test_cfg=test_cfg)
        self.mask_roi_extractor = mask_roi_extractor
        self.mask_head = mask_head

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                      gt_masks: Optional[torch.Tensor] = None, gt_bboxes_ignore=None,
                      gt_ignore_valid=None, generator: Optional[torch.Generator] = None):
        """``TwoStageDetector.forward_train`` plus, with ``gt_masks`` (B, G,
        S, S) uint8 box-frame crops, ``loss_mask``."""
        losses, aux = self.train_core(img, gt_bboxes, gt_labels, gt_valid, img_shapes,
                                      pad_shapes, gt_bboxes_ignore, gt_ignore_valid, generator)
        if gt_masks is not None:
            losses["loss_mask"] = mask_losses(self, aux, gt_masks, gt_bboxes)
        return losses

    def simple_test(self, img, img_shapes, scale_factors, pad_shapes, rescale: bool = True):
        """(dets (B, max_per_img, 5), labels (B, max_per_img), masks (B,
        max_per_img, 28, 28) probabilities of each detection's class)."""
        feats = self.extract_feat(img)
        dets, labels = self.simple_test_bboxes(feats, img_shapes, scale_factors, pad_shapes,
                                               rescale)
        return dets, labels, mask_test(self, feats, dets, labels, scale_factors, rescale)

    def mask_test_boxes(self, feats, boxes: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The TTA's per-view mask primitive: the (B, N, 28, 28) probabilities
        of given boxes (B, N, 4) in the view's coordinates and their 0-based
        labels (B, N), on the view's features."""
        return mask_branch(self, feats, boxes, labels)[1]
