"""Single-stage detector (counterpart of
``ioudet/models/detectors/single_stage.py``): backbone -> neck -> head.

Public inputs are NHWC images, as in ``ioudet``; the convolutions run NCHW.
  * ``forward(img)``      -> raw head outputs, NHWC per level;
  * ``forward_train(...)``-> the loss dict of ``bbox_head.loss``;
  * ``simple_test(...)``  -> (dets (B, max_per_img, 5), labels), fixed shape.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class SingleStageDetector(nn.Module):
    def __init__(self, backbone: nn.Module, bbox_head: nn.Module,
                 neck: Optional[nn.Module] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg

    @property
    def num_result_classes(self) -> int:
        """``num_classes`` (background included) of the detections that
        ``simple_test`` returns."""
        return self.bbox_head.num_classes

    def init_weights(self, generator: torch.Generator) -> None:
        for part in (self.backbone, self.neck, self.bbox_head):
            if part is not None:
                part.init_weights(generator)

    def extract_feat(self, img: torch.Tensor):
        x = self.backbone(img.permute(0, 3, 1, 2).contiguous())
        return self.neck(x) if self.neck is not None else x

    def forward(self, img: torch.Tensor):
        return self.bbox_head(self.extract_feat(img))

    def forward_train(self, img: torch.Tensor, gt_bboxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                      img_shapes: torch.Tensor, pad_shapes: torch.Tensor,
                      gt_bboxes_ignore: Optional[torch.Tensor] = None,
                      gt_ignore_valid: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
        """img (B, H, W, 3) f32 canvas; gt_bboxes (B, G, 4), gt_labels (B, G)
        1-based, gt_valid (B, G) bool; img_shapes / pad_shapes (B, 2) int;
        optional ignore regions (B, I, 4) / (B, I); ``generator`` draws the
        anchor subsampling of a head that samples.  Returns the loss dict."""
        outs = self(img)
        kw = dict(generator=generator)
        if gt_bboxes_ignore is not None:
            kw.update(gt_bboxes_ignore=gt_bboxes_ignore,
                      gt_ignore_valid=gt_ignore_valid)
        return self.bbox_head.loss(*outs, gt_bboxes, gt_labels, gt_valid,
                                   img_shapes, pad_shapes,
                                   dict(self.train_cfg or {}), **kw)

    def simple_test(self, img: torch.Tensor, img_shapes: torch.Tensor,
                    scale_factors: torch.Tensor, pad_shapes: torch.Tensor,
                    rescale: bool = True):
        """img (B, H, W, 3) f32 canvas; img_shapes / pad_shapes (B, 2) int;
        scale_factors (B,) f32, or (B, 4) from a Resize without keep_ratio."""
        outs = self(img)
        return self.bbox_head.get_bboxes(*outs, img_shapes, scale_factors,
                                         pad_shapes, dict(self.test_cfg or {}),
                                         rescale=rescale)


class RetinaNet(SingleStageDetector):
    """Registration name of the reference's RetinaNet."""


class IoUAwareRetinaNet(SingleStageDetector):
    """The paper's detector: SingleStageDetector + IoUAwareRetinaHead."""


class SSD(SingleStageDetector):
    """SSD: the SSDVGG backbone and the SSDHead, no neck."""


class FCOS(SingleStageDetector):
    """Registration name of the reference's FCOS: SingleStageDetector +
    FCOSHead."""


class FOVEA(SingleStageDetector):
    """Registration name of the reference's FoveaBox: SingleStageDetector +
    FoveaHead."""
