"""SSD head (counterpart of ``ioudet/models/heads/ssd_head.py``).

Per level a 3x3 ``cls_convs.i`` (A_i * num_classes softmax logits, the
background column 0 included) and a 3x3 ``reg_convs.i`` (A_i * 4 deltas)
over SSD's anchors: per level a min and a max size from
``basesize_ratio_range``, two squares (min, sqrt(min * max)) and the
ratio pairs at min, A_i = 4 or 6.  Outputs are NHWC per level, flattened in
(H, W, A) order.

Training: the plain assigner path (``gt_max_assign_all=False``), softmax
cross-entropy per anchor, 3:1 hard-negative mining per image and
smooth-L1 (beta 1), both divided by the batch's positive count.  The mining is
``ioudet``'s fixed-shape rule: the negatives' losses sorted descending,
the threshold at position k_neg - 1, every negative with a loss >= the
threshold mined (so each tie at the threshold is too; mmdet's
``loss_single`` takes exactly ``topk(num_neg)``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.anchor import AnchorGenerator, anchor_target
from ...core.bbox import MaxIoUAssigner, delta2bbox
from ...core.post_processing.bbox_nms import topk_stable
from ...parallel.mesh import global_count
from ..losses.cross_entropy_loss import cross_entropy
from ..losses.smooth_l1_loss import smooth_l1_loss
from .anchor_head import AnchorHead, clip_boxes, normal_init, take
from .retina_head import nhwc


def ssd_anchor_generators(input_size: int, in_channels: Sequence[int],
                          anchor_strides: Sequence[int],
                          basesize_ratio_range: Tuple[float, float],
                          anchor_ratios: Sequence[Sequence[float]]) -> List[AnchorGenerator]:
    """One generator a level: min / max sizes from the ratio range in
    integer percent (``ioudet``'s and mmdet's integer arithmetic, with the
    first level's own sizes for 300 and 512), centred at (stride - 1) / 2,
    scales [1, sqrt(max / min)], ratios [1, 1 / r, r, ...], keeping the
    ratio anchors at scale 1 and the square at the second scale."""
    min_ratio, max_ratio = basesize_ratio_range
    min_ratio, max_ratio = int(min_ratio * 100), int(max_ratio * 100)
    num_levels = len(in_channels)
    step = int(np.floor(max_ratio - min_ratio) / (num_levels - 2))
    min_sizes, max_sizes = [], []
    for r in range(min_ratio, max_ratio + 1, step):
        min_sizes.append(int(input_size * r / 100))
        max_sizes.append(int(input_size * (r + step) / 100))
    if input_size == 300:
        first = (7, 15) if basesize_ratio_range[0] == 0.15 else (10, 20)
    else:
        first = (4, 10)
    min_sizes.insert(0, int(input_size * first[0] / 100))
    max_sizes.insert(0, int(input_size * first[1] / 100))
    gens = []
    for k in range(num_levels):
        stride = anchor_strides[k]
        ratios = [1.0]
        for r in anchor_ratios[k]:
            ratios += [1 / r, r]
        gen = AnchorGenerator(min_sizes[k], [1.0, np.sqrt(max_sizes[k] / min_sizes[k])],
                              ratios, scale_major=False,
                              ctr=((stride - 1) / 2.0, (stride - 1) / 2.0))
        gen.base_anchors = gen.base_anchors[list(range(len(ratios))) + [len(ratios)]]
        gens.append(gen)
    return gens


class SSDHead(AnchorHead):
    SOFTMAX = True

    def __init__(self, input_size: int = 300, num_classes: int = 81,
                 in_channels_list: Sequence[int] = (512, 1024, 512, 256, 256, 256),
                 basesize_ratio_range: Tuple[float, float] = (0.15, 0.9),
                 anchor_ratios_per_level: Sequence[Sequence[float]] = (
                     (2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
                 anchor_strides: Sequence[int] = (8, 16, 32, 64, 100, 300),
                 neg_pos_ratio: int = 3,
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2), **kwargs):
        super().__init__(num_classes=num_classes, anchor_strides=anchor_strides,
                         target_means=target_means, target_stds=target_stds,
                         use_sigmoid_cls=False, **kwargs)
        self.in_channels_list = tuple(in_channels_list)
        self.neg_pos_ratio = neg_pos_ratio
        self.generators = ssd_anchor_generators(
            input_size, self.in_channels_list, self.anchor_strides,
            tuple(basesize_ratio_range), anchor_ratios_per_level)
        self.level_num_anchors = [g.num_base_anchors for g in self.generators]
        C = self.cls_out_channels
        self.cls_convs = nn.ModuleList(
            [nn.Conv2d(c, a * C, 3, padding=1)
             for c, a in zip(self.in_channels_list, self.level_num_anchors)])
        self.reg_convs = nn.ModuleList(
            [nn.Conv2d(c, a * 4, 3, padding=1)
             for c, a in zip(self.in_channels_list, self.level_num_anchors)])

    @property
    def cls_out_channels(self) -> int:
        return self.num_classes   # softmax over the background too

    def anchor_generators(self) -> List[AnchorGenerator]:
        return self.generators

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_init(m, generator)

    def forward(self, feats):
        """NCHW levels -> (cls_scores, bbox_preds), NHWC per level."""
        return ([nhwc(conv(x)) for conv, x in zip(self.cls_convs, feats)],
                [nhwc(conv(x)) for conv, x in zip(self.reg_convs, feats)])

    def decode_candidates(self, cls_scores, bbox_preds, img_shapes: torch.Tensor,
                          test_cfg: dict):
        """Per level: the softmax over every class, column 0 (background)
        dropped, the top ``nms_pre`` anchors by their largest class
        probability (ties by ascending index, as ``lax.top_k``), their
        deltas decoded and clipped.  Returns boxes (B, N, 4), scores
        (B, N, num_classes - 1)."""
        nms_pre = test_cfg.get("nms_pre", 1000)
        sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.level_anchors(sizes, cls_scores[0].device)
        C = self.cls_out_channels
        cand_boxes, cand_scores = [], []
        for lvl, (s, bp) in enumerate(zip(cls_scores, bbox_preds)):
            bsz, h, w, _ = s.shape
            n = h * w * self.level_num_anchors[lvl]
            probs = torch.softmax(s.reshape(bsz, n, C).float(), dim=-1)[..., 1:]
            _, idx = topk_stable(probs.amax(dim=-1), min(nms_pre, n))
            cand_scores.append(take(probs, idx))
            boxes = delta2bbox(anchors[lvl][idx], take(bp.reshape(bsz, n, 4), idx),
                               self.target_means, self.target_stds)
            cand_boxes.append(clip_boxes(boxes, img_shapes))
        return torch.cat(cand_boxes, dim=1), torch.cat(cand_scores, dim=1)

    def mine_negatives(self, ce: torch.Tensor, pos: torch.Tensor,
                       neg: torch.Tensor) -> torch.Tensor:
        """(B, A) bool: each image's hard negatives, k = min(3 * its
        positives, its negatives); every negative whose loss reaches the
        k-th largest is mined."""
        k_neg = torch.minimum(pos.sum(dim=1) * self.neg_pos_ratio, neg.sum(dim=1))
        neg_loss = torch.where(neg, ce, torch.full_like(ce, -1.0))
        sorted_neg = torch.sort(neg_loss, dim=1, descending=True).values
        at = (k_neg - 1).clamp(0, neg_loss.shape[1] - 1)
        thresh = torch.gather(sorted_neg, 1, at[:, None])
        return neg & (neg_loss >= thresh) & (k_neg > 0)[:, None]

    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_labels, gt_valid,
             img_shapes, pad_shapes, train_cfg, gt_bboxes_ignore=None,
             gt_ignore_valid=None, generator=None) -> Dict[str, torch.Tensor]:
        """gt_bboxes (B, G, 4), gt_labels (B, G) 1-based, gt_valid (B, G)
        bool, img_shapes / pad_shapes (B, 2).  In a process group the
        positive count is every rank's images' (``ioudet`` divides by the
        global batch's)."""
        if gt_bboxes_ignore is not None:
            raise NotImplementedError("SSDHead takes no ignored regions, as ioudet's")
        featmap_sizes = [tuple(p.shape[1:3]) for p in cls_scores]
        anchors, valid = self.get_anchors(featmap_sizes, pad_shapes)
        assigner = MaxIoUAssigner(**{k: v for k, v in train_cfg["assigner"].items()
                                     if k != "type"})
        t = anchor_target(anchors, valid, gt_bboxes, gt_valid, gt_labels, img_shapes,
                          assigner, self.target_means, self.target_stds,
                          allowed_border=train_cfg.get("allowed_border", -1),
                          pos_weight=train_cfg.get("pos_weight", -1))
        ce = cross_entropy(self._flatten_levels(cls_scores, self.cls_out_channels), t.labels,
                           reduction="none")
        pos = t.bbox_weights[..., 0] > 0
        neg = (t.label_weights > 0) & ~pos
        mined = self.mine_negatives(ce.detach(), pos, neg)
        num_pos = global_count(pos.sum().float()).clamp(min=1)
        loss_cls = torch.sum(ce * (pos | mined)) / num_pos
        loss_bbox = smooth_l1_loss(self._flatten_levels(bbox_preds, 4), t.bbox_targets,
                                   weight=t.bbox_weights, avg_factor=num_pos, beta=1.0)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

