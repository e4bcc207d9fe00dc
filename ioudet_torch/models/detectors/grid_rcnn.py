"""Grid R-CNN (counterpart of ``ioudet/models/detectors/grid_rcnn.py``,
mmdet's ``GridRCNN``): Faster R-CNN whose detections are re-located by the
grid head (``mask_heads/grid_head.py``).

  * training: the box path of ``TwoStageDetector.train_core``, then the grid
    branch on every sampled roi (fixed shapes; the loss counts the
    positives only, where mmdet runs the branch on the positives alone):
    each box jittered by uniform draws of ``jitter_amplitude`` (0.15) of its
    width and height a side from the step's generator, after the sampler's
    draws; extended by ``extend_factor`` (2), RoIAligned by
    ``grid_roi_extractor``, and its heatmaps held to the matched gt's grid
    points (``loss_grid``);
  * test: the box path without the rescale, then the grid head on each of
    the ``max_per_img`` detections an image on its box extended by
    ``test_cfg.rcnn.grid_extend_factor`` (2), the refined boxes clipped to
    the image; score-0 padding rows keep their boxes; the rescale comes
    last.  The backbone runs once (``ioudet`` runs it again for the grid
    head, to the same result).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.bbox.samplers import uniform
from ..heads.anchor_head import clip_boxes
from ..mask_heads.grid_head import extend_box
from .two_stage import TwoStageDetector, to_rois


class GridRCNN(TwoStageDetector):
    parts = TwoStageDetector.parts + ("grid_roi_extractor", "grid_head")

    def __init__(self, backbone: nn.Module, rpn_head: nn.Module,
                 bbox_roi_extractor: nn.Module, bbox_head: nn.Module,
                 grid_roi_extractor: nn.Module, grid_head: nn.Module,
                 neck: Optional[nn.Module] = None,
                 train_cfg: Optional[dict] = None, test_cfg: Optional[dict] = None):
        super().__init__(backbone, rpn_head, bbox_roi_extractor, bbox_head, neck=neck,
                         train_cfg=train_cfg, test_cfg=test_cfg)
        self.grid_roi_extractor = grid_roi_extractor
        self.grid_head = grid_head

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                      gt_bboxes_ignore=None, gt_ignore_valid=None,
                      generator: Optional[torch.Generator] = None):
        """Faster R-CNN's four losses and ``loss_grid``."""
        if generator is None:
            generator = torch.Generator(img.device).manual_seed(0)
        losses, aux = self.train_core(img, gt_bboxes, gt_labels, gt_valid, img_shapes,
                                      pad_shapes, gt_bboxes_ignore, gt_ignore_valid, generator)
        gcfg = dict(dict(dict(self.train_cfg or {}).get("rcnn", {})).get("grid", {}))
        amp = gcfg.get("jitter_amplitude", 0.15)
        boxes = aux["sel_boxes"].flatten(0, 1)
        wh = (boxes[:, 2:4] - boxes[:, 0:2]).repeat(1, 2)
        jitter = (uniform(boxes.shape, generator, boxes.device) * 2 - 1) * amp * wh
        grid_boxes = extend_box(boxes + jitter, gcfg.get("extend_factor", 2.0))
        grid_rois = torch.cat([aux["rois"][:, :1], grid_boxes], dim=-1)
        heatmaps = self.grid_head(self.grid_roi_extractor(aux["feats"], grid_rois))
        targets, point_w = self.grid_head.get_targets(grid_boxes,
                                                      aux["matched_gt"].flatten(0, 1))
        losses["loss_grid"] = self.grid_head.loss(heatmaps, targets, point_w,
                                                  aux["sel_pos"].flatten())
        return losses

    def simple_test(self, img, img_shapes, scale_factors, pad_shapes, rescale: bool = True):
        """(dets (B, max_per_img, 5) with the grid's boxes, labels (B,
        max_per_img)), label -1 padding."""
        feats = self.extract_feat(img)
        dets, labels = self.simple_test_bboxes(feats, img_shapes, scale_factors, pad_shapes,
                                               rescale=False)
        extend = dict(dict(self.test_cfg or {}).get("rcnn", {})).get("grid_extend_factor", 2.0)
        boxes = dets[..., :4]
        heatmaps = self.grid_head(self.grid_roi_extractor(feats,
                                                          to_rois(extend_box(boxes, extend))))
        refined = self.grid_head.get_bboxes(boxes.flatten(0, 1), heatmaps, extend)
        refined = clip_boxes(refined.reshape(boxes.shape), img_shapes)
        refined = torch.where(dets[..., 4:] > 0, refined, boxes)
        if rescale:
            refined = refined / scale_factors.float()[:, None, None]
        return torch.cat([refined, dets[..., 4:]], dim=-1), labels
