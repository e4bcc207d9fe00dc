"""Hybrid Task Cascade (counterpart of ``ioudet/models/detectors/htc.py``):
Cascade R-CNN with one mask head a stage (``mask_head.{i}``) and, as the
flags and parts say,

  * the semantic branch (``semantic_head``, a ``FusedSemanticHead``): a
    stride-8 feature that ``semantic_roi_extractor`` RoIAligns at 14x14
    and adds to the mask branch's RoI features, and after a 2x2 average
    pool to the box branch's; its loss is ``loss_semantic_seg`` where the
    batch has ``gt_semantic_seg``;
  * ``interleaved``: each stage's mask branch runs on that stage's refined
    boxes, assigned and sampled again at the stage's threshold with a fresh
    draw; without it the mask branch takes the stage's own sample;
  * ``mask_info_flow``: stage s's mask head takes the pre-upsample feature
    of stage s - 1's head on the same rois (``HTCMaskHead``'s ``conv_res``).
    In training the heads 0..s-1 run again on stage s's rois, as
    ``ioudet`` runs them, and the stage's loss reaches them too; at test
    time the rois are the detections' for every stage, so each head runs
    once and hands its feature on (``ioudet`` runs heads 0..s-1 again a
    stage, to the same result).

Cascade Mask R-CNN is this detector with ``interleaved`` and
``mask_info_flow`` off and no semantic branch.  Each stage's mask loss is
scaled by the stage's weight.  ``simple_test`` returns (dets, labels,
masks (B, max_per_img, 28, 28)): the mean of the stages' sigmoid masks in
each detection's class channel, in its box's frame.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.mask import mask_target
from .cascade_rcnn import CascadeRCNN, decode_stage
from .two_stage import rcnn_losses, to_rois


class HybridTaskCascade(CascadeRCNN):
    parts = CascadeRCNN.parts + ("mask_roi_extractor", "mask_head", "semantic_head")

    def __init__(self, backbone: nn.Module, rpn_head: nn.Module,
                 bbox_roi_extractor: nn.Module, bbox_head: Sequence[nn.Module],
                 mask_roi_extractor: nn.Module, mask_head: Sequence[nn.Module],
                 neck: Optional[nn.Module] = None,
                 semantic_roi_extractor: Optional[nn.Module] = None,
                 semantic_head: Optional[nn.Module] = None,
                 interleaved: bool = True, mask_info_flow: bool = True, **kwargs):
        super().__init__(backbone, rpn_head, bbox_roi_extractor, bbox_head, neck=neck, **kwargs)
        if len(mask_head) != self.num_stages:
            raise ValueError(f"{len(mask_head)} mask heads for {self.num_stages} stages")
        self.mask_roi_extractor = mask_roi_extractor
        self.mask_head = nn.ModuleList(mask_head)
        self.semantic_roi_extractor = semantic_roi_extractor
        self.semantic_head = semantic_head
        self.interleaved = interleaved
        self.mask_info_flow = mask_info_flow

    # ------------------------------------------------------------ parts

    def semantic_rois(self, semantic_feat, rois: torch.Tensor):
        if semantic_feat is None or self.semantic_roi_extractor is None:
            return None
        return self.semantic_roi_extractor([semantic_feat], rois)

    def bbox_feats(self, feats, rois: torch.Tensor, semantic_feat=None) -> torch.Tensor:
        roi_feats = self.bbox_roi_extractor(feats, rois)
        sem = self.semantic_rois(semantic_feat, rois)
        if sem is not None:
            if sem.shape[-1] != roi_feats.shape[-1]:   # 14 -> 7
                k = sem.shape[-1] // roi_feats.shape[-1]
                sem = F.avg_pool2d(sem, k, k)
            roi_feats = roi_feats + sem
        return roi_feats

    def mask_feats(self, feats, rois: torch.Tensor, semantic_feat=None) -> torch.Tensor:
        mask_feats = self.mask_roi_extractor(feats, rois)
        sem = self.semantic_rois(semantic_feat, rois)
        return mask_feats if sem is None else mask_feats + sem

    def mask_stage(self, stage: int, mask_feats: torch.Tensor) -> torch.Tensor:
        """Stage ``stage``'s mask logits; with information flow, heads
        0..stage-1 run first on the same features and hand their feature on."""
        last = None
        if self.mask_info_flow:
            for j in range(stage):
                _, last = self.mask_head[j](mask_feats, last)
        return self.mask_head[stage](mask_feats, last)[0]

    # ------------------------------------------------------------- train

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                      gt_masks: Optional[torch.Tensor] = None, gt_bboxes_ignore=None,
                      gt_ignore_valid=None, gt_semantic_seg: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
        """The cascade's losses, ``s<i>_loss_mask`` with ``gt_masks`` (B, G,
        S, S) uint8 box-frame crops, and ``loss_semantic_seg`` with
        ``gt_semantic_seg`` (B, H / 8, W / 8) int labels (255 ignored)."""
        if generator is None:
            generator = torch.Generator(img.device).manual_seed(0)
        feats = self.extract_feat(img)
        losses, props = self.rpn_train(feats, gt_bboxes, gt_labels, gt_valid, img_shapes,
                                       pad_shapes, gt_bboxes_ignore, gt_ignore_valid, generator)
        semantic_feat = None
        if self.semantic_head is not None:
            seg_pred, semantic_feat = self.semantic_head(feats)
            if gt_semantic_seg is not None:
                losses["loss_semantic_seg"] = self.semantic_head.loss(seg_pred, gt_semantic_seg)

        boxes, box_valid = props[..., :4], props[..., 4] > 0
        for stage in range(self.num_stages):
            head = self.bbox_head[stage]
            sample = self.sample(generator, stage, boxes, box_valid, gt_bboxes, gt_valid,
                                 gt_labels)
            sel_boxes, sel_pos, sel_valid, matched_gt, labels, gt_idx = sample
            rois = to_rois(sel_boxes)
            cls_score, bbox_pred = head(self.bbox_feats(feats, rois, semantic_feat))
            stage_losses, _ = rcnn_losses(head, cls_score, bbox_pred, sel_boxes, sel_pos,
                                          sel_valid, matched_gt, labels)
            w = self.stage_loss_weights[stage]
            losses.update({f"s{stage}_{k}": v * w for k, v in stage_losses.items()})
            refined = decode_stage(head, rois, bbox_pred.detach(),
                                   cls_score.argmax(-1)).reshape(sel_boxes.shape)

            if gt_masks is not None:
                if self.interleaved:
                    m_boxes, m_pos, _, _, m_labels, m_gt_idx = self.sample(
                        generator, stage, refined, sel_valid, gt_bboxes, gt_valid, gt_labels)
                else:
                    m_boxes, m_pos, m_labels, m_gt_idx = sel_boxes, sel_pos, labels, gt_idx
                mask_pred = self.mask_stage(
                    stage, self.mask_feats(feats, to_rois(m_boxes), semantic_feat))
                targets = mask_target(gt_masks, gt_bboxes, m_boxes, m_gt_idx, m_pos,
                                      out_size=mask_pred.shape[-1])
                losses[f"s{stage}_loss_mask"] = w * self.mask_head[stage].loss(
                    mask_pred, targets.flatten(0, 1), m_labels.flatten(), m_pos.flatten())
            boxes, box_valid = refined, sel_valid
        return losses

    # -------------------------------------------------------------- test

    def simple_test(self, img, img_shapes, scale_factors, pad_shapes, rescale: bool = True):
        """(dets (B, max_per_img, 5), labels (B, max_per_img), masks (B,
        max_per_img, 28, 28) probabilities of each detection's class)."""
        feats = self.extract_feat(img)
        semantic_feat = None
        if self.semantic_head is not None:
            semantic_feat = self.semantic_head(feats)[1]
        dets, labels = self.simple_test_bboxes(feats, img_shapes, scale_factors, pad_shapes,
                                               rescale, semantic_feat)
        boxes = dets[..., :4]
        if rescale:
            boxes = boxes * scale_factors.float()[:, None, None]
        mask_feats = self.mask_feats(feats, to_rois(boxes), semantic_feat)
        lab = labels.reshape(-1).clamp(min=0) + 1
        probs, last = None, None
        for stage in range(self.num_stages):
            logits, feat = self.mask_head[stage](mask_feats, last)
            if self.mask_info_flow:
                last = feat
            p = torch.sigmoid(self.mask_head[stage].own_class(logits, lab))
            probs = p if probs is None else probs + p
        probs = probs / self.num_stages
        bsz, n = labels.shape
        return dets, labels, probs.reshape(bsz, n, *probs.shape[1:])
