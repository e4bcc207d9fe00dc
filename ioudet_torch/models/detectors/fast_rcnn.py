"""Fast R-CNN and Fast Mask R-CNN (counterpart of
``ioudet/models/detectors/fast_rcnn.py``): the two-stage detector without an
RPN, on proposals that come from the dataset's ``proposal_file``
(``LoadProposals`` pads them to a fixed count with a validity mask).

  * training: ``sample_rois_batch`` over the proposals and the gts (the
    step's one draw; there is no anchor subsampling), RoIAlign, the box
    head's losses; Fast Mask R-CNN adds ``loss_mask`` on the sampled rois;
  * test: the box head on every proposal, the softmax (uncast, as
    ``ioudet``'s), the class-specific decode clipped to the image, and one
    ``multiclass_nms`` (K1) with the padding rows kept out by
    ``prop_valid``; Fast Mask R-CNN adds the mask of each detection.

``requires_proposals`` tells the entry points (``apis/test.py``,
``apis/train.py``, ``apis/inference.predict``) to pass the batch's
``proposals`` and ``prop_valid``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .mask_rcnn import mask_losses, mask_test
from .two_stage import TwoStageDetector


class FastRCNN(TwoStageDetector):
    requires_proposals = True

    def __init__(self, backbone: nn.Module, bbox_roi_extractor: nn.Module,
                 bbox_head: nn.Module, neck: Optional[nn.Module] = None,
                 shared_head: Optional[nn.Module] = None,
                 train_cfg: Optional[dict] = None, test_cfg: Optional[dict] = None):
        super().__init__(backbone, None, bbox_roi_extractor, bbox_head, neck=neck,
                         shared_head=shared_head, train_cfg=train_cfg, test_cfg=test_cfg)

    def forward(self, img: torch.Tensor):
        """The features, NCHW per level (there is no RPN)."""
        return self.extract_feat(img)

    @staticmethod
    def _valid(proposals, prop_valid) -> torch.Tensor:
        """``prop_valid``, every row where it is None; raises without
        proposals."""
        if proposals is None:
            raise ValueError("FastRCNN needs the pipeline's proposals (LoadProposals); "
                             "pass proposals and prop_valid")
        if prop_valid is None:
            return torch.ones(proposals.shape[:2], dtype=torch.bool, device=proposals.device)
        return prop_valid

    def train_core(self, img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                   proposals=None, prop_valid=None, generator=None) -> tuple:
        """The box head's losses on ``proposals`` (B, P, 4), ``prop_valid``
        (B, P) bool, and ``TwoStageDetector.train_core``'s aux dict."""
        prop_valid = self._valid(proposals, prop_valid)
        if generator is None:
            generator = torch.Generator(img.device).manual_seed(0)
        return self.rcnn_train(self.extract_feat(img), proposals, prop_valid, gt_bboxes,
                               gt_labels, gt_valid, generator)

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                      proposals=None, prop_valid=None, gt_bboxes_ignore=None,
                      gt_ignore_valid=None, generator: Optional[torch.Generator] = None):
        """{loss_cls, loss_bbox}; the ignored boxes are not used, as in
        ``ioudet``."""
        return self.train_core(img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                               proposals, prop_valid, generator)[0]

    def simple_test_bboxes(self, feats, img_shapes, scale_factors, pad_shapes, proposals,
                           prop_valid=None, rescale: bool = True):
        return self.detect(feats, proposals, self._valid(proposals, prop_valid), img_shapes,
                           scale_factors, rescale)

    def simple_test(self, img, img_shapes, scale_factors, pad_shapes, proposals=None,
                    prop_valid=None, rescale: bool = True):
        """img (B, H, W, 3) f32 canvas, proposals (B, P, 4) on the canvas,
        prop_valid (B, P).  Returns (dets (B, max_per_img, 5), labels (B,
        max_per_img)), label -1 padding."""
        return self.simple_test_bboxes(self.extract_feat(img), img_shapes, scale_factors,
                                       pad_shapes, proposals, prop_valid, rescale)


class FastMaskRCNN(FastRCNN):
    """``FastRCNN`` with Mask R-CNN's FCN mask branch on the sampled rois
    and on the detections (``mask_rcnn.mask_losses`` / ``mask_test``)."""

    parts = FastRCNN.parts + ("mask_roi_extractor", "mask_head")

    def __init__(self, backbone: nn.Module, bbox_roi_extractor: nn.Module,
                 bbox_head: nn.Module, mask_roi_extractor: nn.Module, mask_head: nn.Module,
                 neck: Optional[nn.Module] = None, shared_head: Optional[nn.Module] = None,
                 train_cfg: Optional[dict] = None, test_cfg: Optional[dict] = None):
        super().__init__(backbone, bbox_roi_extractor, bbox_head, neck=neck,
                         shared_head=shared_head, train_cfg=train_cfg, test_cfg=test_cfg)
        self.mask_roi_extractor = mask_roi_extractor
        self.mask_head = mask_head

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                      proposals=None, prop_valid=None, gt_masks: Optional[torch.Tensor] = None,
                      gt_bboxes_ignore=None, gt_ignore_valid=None,
                      generator: Optional[torch.Generator] = None):
        """``FastRCNN.forward_train`` plus, with ``gt_masks``, ``loss_mask``."""
        losses, aux = self.train_core(img, gt_bboxes, gt_labels, gt_valid, img_shapes,
                                      pad_shapes, proposals, prop_valid, generator)
        if gt_masks is not None:
            losses["loss_mask"] = mask_losses(self, aux, gt_masks, gt_bboxes)
        return losses

    def simple_test(self, img, img_shapes, scale_factors, pad_shapes, proposals=None,
                    prop_valid=None, rescale: bool = True):
        """(dets, labels, masks (B, max_per_img, 28, 28))."""
        feats = self.extract_feat(img)
        dets, labels = self.simple_test_bboxes(feats, img_shapes, scale_factors, pad_shapes,
                                               proposals, prop_valid, rescale)
        return dets, labels, mask_test(self, feats, dets, labels, scale_factors, rescale)
