"""IoU-aware RetinaNet head (counterpart of
``ioudet/models/heads/iou_aware_retina_head.py``): RetinaHead plus a 3x3
``retina_iou`` conv (A IoU logits per cell) on the last regression-tower
feature.

Inference, batched over images: per level, top ``nms_pre`` anchors by the max
class logit (the ranking of max_c sigmoid), rescoring of the survivors with
S = p^alpha * IoU^(1 - alpha) (paper eq. 4), ``delta2bbox`` and clipping, then
the class-offset multiclass NMS.  ``rescore_before_topk=True`` ranks by the
rescored proxy instead.

Training: focal(cls) + smooth-L1(reg) + ``loss_iou_weight`` * BCE(iou logit,
IoU(decoded regression, assigned gt)) on the positives, every term divided by
the number of positives.  The IoU target is recomputed every step from the
current regression output and detached: the IoU branch learns to predict the
regressor's quality, and no gradient reaches the regressor through its own
target.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.bbox import bbox_overlaps, delta2bbox
from ...core.post_processing.bbox_nms import topk_stable
from ..losses import binary_cross_entropy_with_logits
from ..utils.layers import Conv2d
from .anchor_head import batched_nms, clip_boxes, level_cls_loss, sigmoid, take
from .retina_head import RetinaHead, nhwc


class IoUAwareRetinaHead(RetinaHead):
    def __init__(self, loss_iou_weight: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.loss_iou_weight = loss_iou_weight
        self.retina_iou = Conv2d(self.feat_channels, self.num_anchors, 3,
                                 padding=1, compute_dtype=self.dtype)

    def forward(self, feats):
        """NCHW levels -> (cls_scores, bbox_preds, iou_preds), NHWC per level."""
        cls_scores, bbox_preds, iou_preds = [], [], []
        for x in feats:
            cls, reg, reg_feat = self.forward_single(x)
            cls_scores.append(nhwc(cls))
            bbox_preds.append(nhwc(reg))
            iou_preds.append(nhwc(self.retina_iou(reg_feat)))
        return cls_scores, bbox_preds, iou_preds

    def loss(self, cls_scores, bbox_preds, iou_preds, gt_bboxes, gt_labels,
             gt_valid, img_shapes, pad_shapes, train_cfg, gt_bboxes_ignore=None,
             gt_ignore_valid=None, generator=None):
        featmap_sizes = [tuple(p.shape[1:3]) for p in cls_scores]
        anchors, targets, num_pos = self._targets(
            featmap_sizes, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
            train_cfg, gt_bboxes_ignore, gt_ignore_valid, generator)
        box_flat = self._flatten_levels(bbox_preds, 4)
        iou_flat = self._flatten_levels(iou_preds, 1)[..., 0]  # (B, A_tot)

        loss_cls = level_cls_loss(self.loss_cls, self.loss_cls_fn, cls_scores, targets.labels,
                                  targets.label_weights, num_pos, self.num_anchors)
        loss_bbox = self.loss_bbox_fn(
            box_flat.reshape(-1, 4), targets.bbox_targets.reshape(-1, 4),
            weight=targets.bbox_weights.reshape(-1, 4), avg_factor=num_pos)

        pos_mask = targets.bbox_weights[..., 0]  # (B, A_tot), 1.0 on positives
        with torch.no_grad():
            decoded = delta2bbox(anchors, box_flat, self.target_means,
                                 self.target_stds)
            iou_target = bbox_overlaps(decoded, targets.pos_gt_boxes,
                                       is_aligned=True)
        loss_iou = binary_cross_entropy_with_logits(iou_flat, iou_target)
        loss_iou = self.loss_iou_weight * (loss_iou * pos_mask).sum() / num_pos
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_iou=loss_iou)

    def decode_candidates(self, cls_scores, bbox_preds, iou_preds,
                          img_shapes: torch.Tensor, test_cfg: dict,
                          eps: float = 1e-6):
        """Batched pre-NMS candidates: boxes (B, N, 4), scores (B, N, C)."""
        nms_pre = test_cfg.get("nms_pre", 1000)
        alpha = test_cfg.get("rescoring_alpha", 0.5)
        before = test_cfg.get("rescore_before_topk", False)
        sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.level_anchors(sizes, cls_scores[0].device)
        C = self.cls_out_channels
        cand_boxes, cand_scores = [], []
        for lvl, (s, bp, q) in enumerate(zip(cls_scores, bbox_preds, iou_preds)):
            bsz, h, w, _ = s.shape
            n = h * w * self.num_anchors
            logits = s.reshape(bsz, n, C)
            iou_logit = q.reshape(bsz, n)
            proxy = logits.amax(dim=-1).float()
            if before:
                proxy = alpha * F.logsigmoid(proxy) + \
                    (1.0 - alpha) * F.logsigmoid(iou_logit.float())
            _, idx = topk_stable(proxy, min(nms_pre, n))
            cls_p = sigmoid(take(logits, idx))
            iou_p = sigmoid(take(iou_logit, idx))
            rescored = cls_p.clamp(min=eps).pow(alpha) * \
                iou_p.clamp(min=eps).pow(1.0 - alpha)[..., None]
            boxes = delta2bbox(anchors[lvl][idx], take(bp.reshape(bsz, n, 4), idx),
                               self.target_means, self.target_stds)
            cand_scores.append(rescored)
            cand_boxes.append(clip_boxes(boxes, img_shapes))
        return torch.cat(cand_boxes, dim=1), torch.cat(cand_scores, dim=1)

    def get_bboxes(self, cls_scores, bbox_preds, iou_preds, img_shapes,
                   scale_factors, pad_shapes, test_cfg: dict,
                   rescale: bool = False):
        """(dets (B, max_per_img, 5), labels (B, max_per_img)), label -1
        padding."""
        boxes, scores = self.decode_candidates(cls_scores, bbox_preds,
                                               iou_preds, img_shapes, test_cfg)
        return batched_nms(boxes, scores, scale_factors, test_cfg, rescale)
