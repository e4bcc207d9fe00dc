"""FreeAnchor RetinaNet head (counterpart of
``ioudet/models/heads/free_anchor_retina_head.py``; "FreeAnchor: Learning
to Match Anchors for Visual Object Detection", NeurIPS 2019).

The network and the inference are ``RetinaHead``'s.  The loss replaces the
hard assignment by anchor bags:
  * each gt's bag is its ``pre_anchor_topk`` anchors of the highest IoU
    (``topk_stable``: ties by the lower anchor index, as ``lax.top_k``);
  * positive loss: -log of the mean-max over the bag of P_cls(anchor, the
    gt's class) * exp(-2 * smooth-L1(beta 0.11) of its deltas), the bag's
    members weighted 1 / (1 - p);
  * negative loss: the focal-weighted BCE of P_cls * (1 - P{matched}), with
    P{matched} saturated-linear in the decoded box's IoU with a gt between
    ``bbox_thr`` and that gt's best IoU, the largest over the gts of the
    class.
The fixed numbers (beta 0.11, the factor 2.0 in exp(-.)) and the outputs
(``loss_cls`` the positive bags, ``loss_bbox`` the negative one) are
``ioudet``'s.  As there, gradient flows through P{matched} and the per-gt
best IoU into the box deltas (mmdet computes them without gradient).

P{matched} of class c is the largest ``obj_prob`` over the gts of class c:
``ioudet`` takes it as the max over a (G, A, C) product with the gts'
one-hot (6.7 GB an image at 832x1344 with 100 gt slots); here a
scatter-amax of ``obj_prob`` (G, A) into (A, C) by each gt's label,
starting from zeros (the other classes' products are 0 and ``obj_prob`` >=
0).  Both split the gradient of a max evenly among ties, and the clips are
``jnp.clip``'s maximum-then-minimum, whose gradient at a bound is half.

One departure: where a gt's best IoU is at most ``bbox_thr`` (a padded gt
slot, a zero box, practically always), ``ioudet`` divides by t2 - t1 = 0
and its gradient is 0 * inf = NaN in every box delta; here that gt's
``obj_prob`` is 0 without the division, the value ``ioudet``'s clip gives it
(except at an IoU of exactly ``bbox_thr``, where ``ioudet``'s is NaN), and
its gradient is 0.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...core.bbox import bbox2delta, bbox_overlaps, delta2bbox
from ...core.post_processing.bbox_nms import topk_stable
from ...parallel.mesh import global_count
from .anchor_head import take
from .retina_head import RetinaHead


def clip(x: torch.Tensor, lo: Optional[float] = None, hi: Optional[float] = None
         ) -> torch.Tensor:
    """``jnp.clip``: ``maximum(x, lo)`` then ``minimum(., hi)``, the bounds
    f32; at a bound the gradient is half (``torch.clamp`` passes all of it)."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


class FreeAnchorRetinaHead(RetinaHead):
    INT8 = False   # w8a8 serving of FreeAnchor is not ported

    def __init__(self, pre_anchor_topk: int = 50, bbox_thr: float = 0.6, gamma: float = 2.0,
                 alpha: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        if self.dtype != torch.float32:
            raise NotImplementedError(f"FreeAnchorRetinaHead in {self.dtype} is not ported yet "
                                      "(it runs in float32)")
        self.pre_anchor_topk = pre_anchor_topk
        self.bbox_thr = bbox_thr
        self.gamma = gamma
        self.alpha = alpha

    @staticmethod
    def positive_bag_loss(matched_prob: torch.Tensor, bag_valid: torch.Tensor) -> torch.Tensor:
        """matched_prob (..., K): -log of the mean-max, weights 1 / (1 - p)
        normalized over the bag.  Returns (...,)."""
        p = clip(matched_prob, 0.0, 1.0 - 1e-6) * bag_valid
        w = 1.0 / clip(1.0 - p, 1e-12) * bag_valid
        w = w / clip(w.sum(-1, keepdim=True), 1e-12)
        return -torch.log(clip((w * p).sum(-1), 1e-12))

    def negative_bag_loss(self, cls_prob: torch.Tensor, box_prob: torch.Tensor) -> torch.Tensor:
        """The focal-weighted BCE of cls_prob * (1 - box_prob)."""
        prob = clip(cls_prob * (1.0 - box_prob), 1e-12, 1.0 - 1e-12)
        return prob ** self.gamma * -torch.log(1.0 - prob)

    def box_prob(self, obj_iou: torch.Tensor, gt_labels: torch.Tensor,
                 gt_valid: torch.Tensor) -> torch.Tensor:
        """P{anchor matched to a gt of class c}: obj_iou (B, G, A), the IoU of
        each gt with each decoded box -> (B, A, C)."""
        t1 = self.bbox_thr
        t2 = clip(obj_iou.amax(-1, keepdim=True), t1 + 1e-12)
        span = t2 - t1
        above = span > 0
        ratio = torch.where(above, (obj_iou - t1) / torch.where(above, span, 1.0), 0.0)
        obj_prob = clip(ratio, 0.0, 1.0) * gt_valid[..., None]
        B, G, A = obj_iou.shape
        C = self.cls_out_channels
        index = (gt_labels.long() - 1).clamp(0, C - 1)[..., None].expand(B, G, A)
        out = obj_prob.new_zeros(B, C, A).scatter_reduce(1, index, obj_prob, "amax",
                                                         include_self=True)
        return out.transpose(1, 2)

    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_labels, gt_valid, img_shapes,
             pad_shapes, train_cfg, gt_bboxes_ignore=None, gt_ignore_valid=None,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """gt_bboxes (B, G, 4), gt_labels (B, G) 1-based, gt_valid (B, G)
        bool.  In a process group the denominator counts every rank's gts
        (``ioudet`` divides by the global batch's)."""
        if gt_bboxes_ignore is not None:
            raise NotImplementedError("FreeAnchorRetinaHead takes no ignored regions, as "
                                      "ioudet's")
        sizes = [tuple(p.shape[1:3]) for p in cls_scores]
        anchors = torch.cat(self.level_anchors(sizes, cls_scores[0].device))   # (A, 4)
        K, C = self.pre_anchor_topk, self.cls_out_channels
        cls_prob = torch.sigmoid(self._flatten_levels(cls_scores, C).float())   # (B, A, C)
        box = self._flatten_levels(bbox_preds, 4).float()                       # (B, A, 4)
        B, A = box.shape[:2]
        gb = gt_bboxes.float()
        gv = gt_valid.float()
        G = gb.shape[1]

        decoded = delta2bbox(anchors.expand(B, A, 4), box, self.target_means, self.target_stds)
        box_prob = self.box_prob(bbox_overlaps(gb, decoded), gt_labels, gv)
        neg = self.negative_bag_loss(cls_prob, box_prob).sum()

        with torch.no_grad():
            _, bag = topk_stable(bbox_overlaps(gb, anchors.expand(B, A, 4)), K)   # (B, G, K)
        labels0 = (gt_labels.long() - 1).clamp(0, C - 1)
        cls_bag = torch.gather(cls_prob.reshape(B, A * C), 1,
                               (bag * C + labels0[..., None]).reshape(B, G * K)
                               ).reshape(B, G, K)
        pred_bag = take(box, bag.reshape(B, G * K)).reshape(B, G, K, 4)
        target = bbox2delta(anchors[bag], gb[:, :, None].expand(B, G, K, 4),
                            self.target_means, self.target_stds)
        diff = (pred_bag - target).abs()
        beta = 0.11
        sl1 = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta).sum(-1)
        matched = cls_bag * torch.exp(-sl1 * 2.0)
        pos = (self.positive_bag_loss(matched, gv[..., None].expand(B, G, K)) * gv).sum()

        total_pos = global_count(gv.sum(-1).clamp(min=1.0).sum()).clamp(min=1.0)
        loss_pos = self.alpha * pos / total_pos
        loss_neg = (1 - self.alpha) * neg / (total_pos * K)
        return dict(loss_cls=loss_pos, loss_bbox=loss_neg)
