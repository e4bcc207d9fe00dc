"""FCOS head (counterpart of ``ioudet/models/heads/fcos_head.py``; mmdet's
``FCOSHead``).

Anchor-free: one point a cell at ``stride * i + stride // 2``.  Two towers of
``stacked_convs`` x (3x3 conv with a bias, GN of 32 groups at flax's eps,
ReLU) shared across the FPN levels, then 3x3 ``fcos_cls`` (C sigmoid
logits), ``fcos_reg`` (l, t, r, b distances as ``exp(scales.i(x))``, a
learned scalar a level) and ``fcos_centerness``, which reads the **cls**
tower (mmdet v1's place).

Targets, batched over images: every point against every (padded) gt as one
(B, P, G) computation: inside the box, the largest distance within the
level's regress range, the smallest area winning (the first index among
equal areas, as ``jnp.argmin``).  Loss: the sigmoid focal loss (gamma 2,
alpha 0.25) through ``fused_level_focal_sum`` a level (K3 at A = 1),
divided by the positives; ``iou_loss`` of the decoded boxes weighted by the
centerness target, divided by the weights' sum; the centerness BCE on the
positives, divided by the positives.  As in ``ioudet``, the config's
``loss_cls`` / ``loss_bbox`` are taken and not read.

Inference: per level score x centerness, the top ``nms_pre`` points by
their largest product (ties to the lower index), ``distance2bbox`` and
clipping, then the one ``multiclass_nms`` (K1) with ``score_thr`` on the
product (mmdet v1 thresholds the raw score; ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ...core.bbox import distance2bbox
from ...core.post_processing.bbox_nms import topk_stable
from ...parallel.mesh import global_count
from ..losses import binary_cross_entropy_with_logits, iou_loss
from ..utils.layers import Conv2d, ConvModule, Scale, bias_init_with_prob, compute_dtype
from .anchor_head import batched_nms, clip_boxes, level_cls_loss, sigmoid, take
from .retina_head import nhwc

INF = 1e8
FOCAL = dict(type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25, loss_weight=1.0)


def level_points(featmap_size: Tuple[int, int], stride: int, device) -> torch.Tensor:
    """(h*w, 2) f32 (x, y) point centres of one level, row-major, at
    ``stride * i + stride // 2``; made on the device (no host copy)."""
    h, w = featmap_size
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride + stride // 2
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride + stride // 2
    return torch.stack([xs.repeat(h), ys.repeat_interleave(w)], dim=-1)


def init_anchor_free(head: nn.Module, generator: torch.Generator, std: float = 0.01) -> None:
    """``ioudet``'s init of the anchor-free heads: every conv weight
    normal(``std``), biases 0; the norms' affines stay 1 / 0."""
    with torch.no_grad():
        for m in head.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


def f32_only(head: str, dtype) -> None:
    if compute_dtype(dtype) != torch.float32:
        raise NotImplementedError(f"{head} in {compute_dtype(dtype)} is not ported yet "
                                  "(it runs in float32)")


class FCOSHead(nn.Module):
    INT8 = False   # w8a8 serving of the anchor-free heads is not ported
    TTA = False    # nor their multi-scale / flip test

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 regress_ranges: Sequence[Tuple[float, float]] = (
                     (-1, 64), (64, 128), (128, 256), (256, 512), (512, INF)),
                 loss_cls=None, loss_bbox=None, dtype=None):
        super().__init__()
        f32_only("FCOSHead", dtype)
        self.num_classes = num_classes
        self.in_channels, self.feat_channels = in_channels, feat_channels
        self.stacked_convs = stacked_convs
        self.strides = tuple(strides)
        self.regress_ranges = tuple(tuple(float(v) for v in r) for r in regress_ranges)
        self.loss_cls, self.loss_bbox = loss_cls, loss_bbox   # not read, as in ioudet
        gn = dict(type="GN", num_groups=32)
        chans = [in_channels] + [feat_channels] * stacked_convs
        self.cls_convs = nn.ModuleList(
            [ConvModule(chans[i], feat_channels, 3, padding=1, norm_cfg=gn, bias=True)
             for i in range(stacked_convs)])
        self.reg_convs = nn.ModuleList(
            [ConvModule(chans[i], feat_channels, 3, padding=1, norm_cfg=gn, bias=True)
             for i in range(stacked_convs)])
        self.fcos_cls = Conv2d(feat_channels, self.cls_out_channels, 3, padding=1)
        self.fcos_reg = Conv2d(feat_channels, 4, 3, padding=1)
        self.fcos_centerness = Conv2d(feat_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList([Scale(1.0) for _ in self.strides])

    @property
    def cls_out_channels(self) -> int:
        return self.num_classes - 1

    def init_weights(self, generator: torch.Generator) -> None:
        init_anchor_free(self, generator)
        with torch.no_grad():
            self.fcos_cls.bias.fill_(bias_init_with_prob(0.01))

    def forward(self, feats):
        """NCHW levels -> (cls_scores, bbox_preds, centernesses), NHWC per
        level; the distances are already exp'd."""
        cls_scores, bbox_preds, centernesses = [], [], []
        for x, scale in zip(feats, self.scales):
            cls_feat, reg_feat = x, x
            for conv in self.cls_convs:
                cls_feat = conv(cls_feat)
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            cls_scores.append(nhwc(self.fcos_cls(cls_feat)))
            centernesses.append(nhwc(self.fcos_centerness(cls_feat)))
            bbox_preds.append(nhwc(torch.exp(scale(self.fcos_reg(reg_feat)))))
        return cls_scores, bbox_preds, centernesses

    # ------------------------------------------------------------ training

    def points(self, featmap_sizes, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(points (P, 2), regress ranges (P, 2)) of every level, in level
        order."""
        pts, rngs = [], []
        for fs, s, (lo, hi) in zip(featmap_sizes, self.strides, self.regress_ranges):
            p = level_points(fs, s, device)
            pts.append(p)
            rngs.append(torch.stack([torch.full((p.shape[0],), lo, device=device),
                                     torch.full((p.shape[0],), hi, device=device)], -1))
        return torch.cat(pts), torch.cat(rngs)

    @staticmethod
    def targets(points: torch.Tensor, ranges: torch.Tensor, gt_bboxes: torch.Tensor,
                gt_valid: torch.Tensor, gt_labels: torch.Tensor):
        """points / ranges (P, 2); gts (B, G, 4), (B, G), (B, G).  Returns
        labels (B, P) int32, 0 = background, and (l, t, r, b) targets (B, P,
        4), zero at the background."""
        gt = gt_bboxes.float()
        areas = (gt[..., 2] - gt[..., 0] + 1) * (gt[..., 3] - gt[..., 1] + 1)   # (B, G)
        xs, ys = points[None, :, 0, None], points[None, :, 1, None]             # (1, P, 1)
        ltrb = torch.stack([xs - gt[:, None, :, 0], ys - gt[:, None, :, 1],
                            gt[:, None, :, 2] - xs, gt[:, None, :, 3] - ys], -1)  # (B, P, G, 4)
        maxd = ltrb.amax(-1)
        ok = ((ltrb.amin(-1) > 0) & (maxd >= ranges[None, :, 0, None]) &
              (maxd <= ranges[None, :, 1, None]) & gt_valid[:, None, :].bool())
        cand = torch.where(ok, areas[:, None, :], INF)
        idx = cand.argmin(-1)                                                    # (B, P)
        has = cand.amin(-1) < INF
        labels = torch.where(has, torch.gather(gt_labels.long(), 1, idx), 0).to(torch.int32)
        bt = torch.gather(ltrb, 2, idx[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
        return labels, bt * has[..., None]

    @staticmethod
    def centerness_target(ltrb: torch.Tensor) -> torch.Tensor:
        lr, tb = ltrb[..., 0::2], ltrb[..., 1::2]
        num = lr.amin(-1) * tb.amin(-1)
        den = (lr.amax(-1) * tb.amax(-1)).clamp(min=1e-10)
        return torch.sqrt((num / den).clamp(min=0.0))

    def loss(self, cls_scores, bbox_preds, centernesses, gt_bboxes, gt_labels, gt_valid,
             img_shapes, pad_shapes, train_cfg, gt_bboxes_ignore=None, gt_ignore_valid=None,
             generator=None) -> Dict[str, torch.Tensor]:
        """gt_bboxes (B, G, 4), gt_labels (B, G) 1-based, gt_valid (B, G)
        bool.  In a process group the denominators are every rank's
        (``ioudet`` divides by the global batch's)."""
        if gt_bboxes_ignore is not None:
            raise NotImplementedError("FCOSHead takes no ignored regions, as ioudet's")
        sizes = [tuple(c.shape[1:3]) for c in cls_scores]
        points, ranges = self.points(sizes, cls_scores[0].device)
        labels, ltrb_t = self.targets(points, ranges, gt_bboxes, gt_valid, gt_labels)
        B = labels.shape[0]
        reg_flat = torch.cat([b.reshape(B, -1, 4) for b in bbox_preds], 1)
        ctr_flat = torch.cat([c.reshape(B, -1) for c in centernesses], 1)
        pos = (labels > 0).float()
        num_pos = global_count(pos.sum()).clamp(min=1)
        loss_cls = level_cls_loss(FOCAL, None, cls_scores, labels, torch.ones_like(pos),
                                  num_pos, 1)
        ctr_t = self.centerness_target(ltrb_t)
        pts = points[None].expand(B, -1, -1)
        w = pos * ctr_t
        loss_bbox = iou_loss(distance2bbox(pts, reg_flat), distance2bbox(pts, ltrb_t),
                             weight=w, avg_factor=global_count(w.sum()).clamp(min=1e-6))
        loss_centerness = (binary_cross_entropy_with_logits(ctr_flat, ctr_t) * pos).sum() / num_pos
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_centerness=loss_centerness)

    # ------------------------------------------------------------ inference

    def decode_candidates(self, cls_scores, bbox_preds, centernesses,
                          img_shapes: torch.Tensor, test_cfg: dict):
        """Per level: sigmoid score x sigmoid centerness, the top ``nms_pre``
        points by their largest product, their boxes decoded and clipped.
        Returns boxes (B, N, 4), scores (B, N, C), the products."""
        nms_pre = test_cfg.get("nms_pre", 1000)
        cand_boxes: List[torch.Tensor] = []
        cand_scores: List[torch.Tensor] = []
        for s, bp, ctr, stride in zip(cls_scores, bbox_preds, centernesses, self.strides):
            bsz, h, w, C = s.shape
            n = h * w
            scores = sigmoid(s.reshape(bsz, n, C)) * torch.sigmoid(ctr.reshape(bsz, n, 1))
            _, idx = topk_stable(scores.amax(dim=-1), min(nms_pre, n))
            pts = level_points((h, w), stride, s.device)[idx]
            boxes = distance2bbox(pts, take(bp.reshape(bsz, n, 4), idx))
            cand_boxes.append(clip_boxes(boxes, img_shapes))
            cand_scores.append(take(scores, idx))
        return torch.cat(cand_boxes, dim=1), torch.cat(cand_scores, dim=1)

    def get_bboxes(self, cls_scores, bbox_preds, centernesses, img_shapes, scale_factors,
                   pad_shapes, test_cfg: dict, rescale: bool = False):
        boxes, scores = self.decode_candidates(cls_scores, bbox_preds, centernesses,
                                               img_shapes, test_cfg)
        return batched_nms(boxes, scores, scale_factors, test_cfg, rescale)
