"""Cascade R-CNN (counterpart of ``ioudet/models/detectors/cascade_rcnn.py``):
the R-CNN head run as a cascade of stages, each with its own box head
(``bbox_head.{i}``, an ``nn.ModuleList``), IoU threshold and loss weight.

  * training: stage ``s`` assigns its candidates with ``MaxIoUAssigner``
    at ``stage_pos_thrs[s]`` (positive, negative and minimum positive IoU
    alike), samples them by ``sample_rois_batch`` (the gts added again at
    every stage, as ``ioudet`` does), and its losses are scaled by
    ``stage_loss_weights[s]``.  The next stage's candidates are this
    stage's sampled rois decoded by their class-specific deltas of the
    argmax class (background included), without gradient, valid where the
    sample was;
  * test: the proposals go through every stage, each decoding its boxes
    for the next by the argmax class; the scores are the mean of the
    stages' softmaxes, the boxes the last stage's, class-agnostic, and one
    ``multiclass_nms`` over the 80 classes keeps the padded proposals out.

Every stage samples from the step's generator in turn, as ``ioudet``
splits its key a stage.  The two-stage TTA's per-view primitives are
``test_proposals`` and ``rcnn_test_raw`` (the mean of the stages' softmaxes
and the last stage's box broadcast over the classes); HTC inherits them as
``ioudet``'s does, so its TTA pools no semantic feature and returns boxes
only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox import MaxIoUAssigner, delta2bbox
from ..heads.anchor_head import clip_boxes
from .two_stage import _Extract, final_nms, rcnn_losses, sample_rois_batch, to_rois


def decode_stage(head, rois: torch.Tensor, bbox_pred: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """A stage's refined boxes (R, 4): the rois (R, 5) moved by the deltas
    of each roi's class ``labels`` (R,) (clamped into range; a
    class-agnostic head has one set)."""
    if not head.reg_class_agnostic:
        per_class = bbox_pred.reshape(bbox_pred.shape[0], head.num_classes, 4)
        safe = labels.long().clamp(0, head.num_classes - 1)
        bbox_pred = torch.gather(per_class, 1, safe[:, None, None].expand(-1, 1, 4))[:, 0]
    return delta2bbox(rois[:, 1:], bbox_pred, head.target_means, head.target_stds)


class CascadeRCNN(_Extract):
    parts = ("backbone", "neck", "rpn_head", "bbox_roi_extractor", "bbox_head")

    def __init__(self, backbone: nn.Module, rpn_head: nn.Module,
                 bbox_roi_extractor: nn.Module, bbox_head: Sequence[nn.Module],
                 neck: Optional[nn.Module] = None, num_stages: int = 3,
                 stage_loss_weights: Sequence[float] = (1.0, 0.5, 0.25),
                 stage_pos_thrs: Sequence[float] = (0.5, 0.6, 0.7),
                 train_cfg: Optional[dict] = None, test_cfg: Optional[dict] = None):
        super().__init__()
        if len(bbox_head) != num_stages:
            raise ValueError(f"{len(bbox_head)} box heads for {num_stages} stages")
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.bbox_roi_extractor = bbox_roi_extractor
        self.bbox_head = nn.ModuleList(bbox_head)
        self.num_stages = num_stages
        self.stage_loss_weights = tuple(float(w) for w in stage_loss_weights)
        self.stage_pos_thrs = tuple(float(t) for t in stage_pos_thrs)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg

    @property
    def num_result_classes(self) -> int:
        return self.bbox_head[-1].num_classes

    def forward(self, img: torch.Tensor):
        """Raw RPN outputs, NHWC per level."""
        return self.rpn_head(self.extract_feat(img))

    def bbox_feats(self, feats, rois: torch.Tensor, semantic_feat=None) -> torch.Tensor:
        """The box heads' RoI features of rois (R, 5)."""
        return self.bbox_roi_extractor(feats, rois)

    def stage_assigner(self, stage: int) -> MaxIoUAssigner:
        thr = self.stage_pos_thrs[stage]
        return MaxIoUAssigner(pos_iou_thr=thr, neg_iou_thr=thr, min_pos_iou=thr)

    def sampler_cfg(self) -> dict:
        return dict(dict(dict(self.train_cfg or {}).get("rcnn", {})).get("sampler", {}))

    def sample(self, generator, stage: int, boxes, box_valid, gt_bboxes, gt_valid, gt_labels):
        """``sample_rois_batch`` of candidates (B, N, 4) at the stage's IoU
        threshold and the config's sampler."""
        scfg = self.sampler_cfg()
        return sample_rois_batch(generator, boxes, box_valid, gt_bboxes, gt_valid, gt_labels,
                                 self.stage_assigner(stage), scfg.get("num", 512),
                                 scfg.get("pos_fraction", 0.25), sampler_cfg=scfg)

    # ------------------------------------------------------------- train

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                      gt_bboxes_ignore=None, gt_ignore_valid=None,
                      generator: Optional[torch.Generator] = None):
        """Returns {rpn_loss_cls, rpn_loss_bbox, s<i>_loss_cls, s<i>_loss_bbox}."""
        if generator is None:
            generator = torch.Generator(img.device).manual_seed(0)
        feats = self.extract_feat(img)
        losses, props = self.rpn_train(feats, gt_bboxes, gt_labels, gt_valid, img_shapes,
                                       pad_shapes, gt_bboxes_ignore, gt_ignore_valid, generator)
        boxes, box_valid = props[..., :4], props[..., 4] > 0
        for stage in range(self.num_stages):
            head = self.bbox_head[stage]
            sel_boxes, sel_pos, sel_valid, matched_gt, labels, _ = self.sample(
                generator, stage, boxes, box_valid, gt_bboxes, gt_valid, gt_labels)
            rois = to_rois(sel_boxes)
            cls_score, bbox_pred = head(self.bbox_feats(feats, rois))
            stage_losses, _ = rcnn_losses(head, cls_score, bbox_pred, sel_boxes, sel_pos,
                                          sel_valid, matched_gt, labels)
            w = self.stage_loss_weights[stage]
            losses.update({f"s{stage}_{k}": v * w for k, v in stage_losses.items()})
            if stage < self.num_stages - 1:
                boxes = decode_stage(head, rois, bbox_pred.detach(),
                                     cls_score.argmax(-1)).reshape(sel_boxes.shape)
                box_valid = sel_valid
        return losses

    # -------------------------------------------------------------- test

    def refine(self, feats, props: torch.Tensor, semantic_feat=None) -> tuple:
        """Proposals (B, P, 4 or 5) through every stage: (scores (B, P, C - 1),
        the mean of the stages' softmaxes without the background; boxes (B,
        P, 4), the last stage's decode)."""
        bsz, num = props.shape[:2]
        boxes, scores = props[..., :4], None
        for head in self.bbox_head:
            rois = to_rois(boxes)
            cls_score, bbox_pred = head(self.bbox_feats(feats, rois, semantic_feat))
            p = F.softmax(cls_score, dim=-1)
            scores = p if scores is None else scores + p
            boxes = decode_stage(head, rois, bbox_pred, cls_score.argmax(-1)).reshape(bsz, num, 4)
        scores = scores / self.num_stages
        return scores[:, 1:].reshape(bsz, num, -1), boxes

    def simple_test(self, img, img_shapes, scale_factors, pad_shapes, rescale: bool = True):
        """img (B, H, W, 3) f32 canvas; img_shapes / pad_shapes (B, 2) int;
        scale_factors (B,) f32.  Returns (dets (B, max_per_img, 5), labels
        (B, max_per_img)), label -1 padding."""
        return self.simple_test_bboxes(self.extract_feat(img), img_shapes, scale_factors,
                                       pad_shapes, rescale)

    def simple_test_bboxes(self, feats, img_shapes, scale_factors, pad_shapes,
                           rescale: bool = True, semantic_feat=None):
        props = self.test_proposals(feats, img_shapes, pad_shapes)
        scores, boxes = self.rcnn_test_raw(feats, props[..., :4], img_shapes, semantic_feat)
        return final_nms(self.test_cfg, boxes, scores, scale_factors, rescale, props[..., 4] > 0)

    def rcnn_test_raw(self, feats, proposals, img_shapes, semantic_feat=None) -> tuple:
        """``refine`` of proposals (B, P, 4) without an NMS: (scores (B, P,
        C - 1), boxes (B, P, C - 1, 4), the last stage's box clipped to the
        image and broadcast over the classes)."""
        scores, boxes = self.refine(feats, proposals, semantic_feat)
        boxes = clip_boxes(boxes, img_shapes)[:, :, None].expand(-1, -1, scores.shape[-1], 4)
        return scores, boxes
