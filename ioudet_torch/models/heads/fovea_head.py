"""FoveaBox head (counterpart of ``ioudet/models/heads/fovea_head.py``;
mmdet's ``FoveaHead``).

Per level, each cell whose index falls in a gt's shrunken "fovea" region
(the box's centre area scaled by ``sigma``) and whose gt's edge sqrt(w * h)
lies in the level's scale range is that gt's; the smallest gt wins a
contested cell.  The regression is log-space distances from the cell
centre ((i + 0.5) * stride) to the box's sides over the level's base edge,
clipped to [1/16, 16].  Towers: ``stacked_convs`` x (3x3 conv, GN with
``norm="GN"``, ReLU), the conv with a bias only without GN; ``fovea_reg``
(4) on the reg tower, ``fovea_cls`` (C) on the cls tower.  The align
variant (``with_deform``) first realigns the cls input by
``FeatureAdaption`` from the detached exp(``fovea_reg``) field, then runs a
widened cls tower (3x3 to 4x the channels, 1x1 at 4x).

Targets, batched over images: one (B, P, G) mask a level, the region by
ceil / floor of f32 arithmetic in ``ioudet``'s order, then the first index
of the smallest area.  Loss: the config's focal loss (gamma 1.5, alpha 0.4)
through ``fused_level_focal_sum`` a level (K3 at A = 1, its gamma != 2
instance), divided by positives + images; smooth-L1 (beta 0.11, weight
0.75) on the positives, divided by the positives.  Inference: per level the
top ``nms_pre`` cells by their largest sigmoid score, the distances
exp(pred) * base edge around the cell centre, clipped, then one
``multiclass_nms`` (K1).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...core.post_processing.bbox_nms import topk_stable
from ...parallel.mesh import global_count
from ..utils.layers import Conv2d, ConvModule, bias_init_with_prob
from .anchor_head import batched_nms, clip_boxes, level_cls_loss, sigmoid, take
from .fcos_head import f32_only, init_anchor_free
from .guided_anchor_head import FeatureAdaption
from .retina_head import nhwc

INF = 1e8
DEFAULT_LOSS_CLS = dict(type="FocalLoss", use_sigmoid=True, gamma=1.5, alpha=0.4,
                        loss_weight=1.0)
DEFAULT_LOSS_BBOX = dict(type="SmoothL1Loss", beta=0.11, loss_weight=0.75)


def cell_centres(featmap_size: Tuple[int, int], stride: int, device) -> torch.Tensor:
    """(h*w, 2) f32 (x, y) centres (i + 0.5) * stride of one level's cells,
    row-major; made on the device."""
    h, w = featmap_size
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * stride
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * stride
    return torch.stack([xs.repeat(h), ys.repeat_interleave(w)], dim=-1)


class FoveaHead(nn.Module):
    INT8 = False   # w8a8 serving of the anchor-free heads is not ported
    TTA = False    # nor their multi-scale / flip test

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 base_edge_list: Sequence[int] = (16, 32, 64, 128, 256),
                 scale_ranges: Sequence[Tuple[float, float]] = (
                     (1, 64), (32, 128), (64, 256), (128, 512), (256, 2048)),
                 sigma: float = 0.4, with_deform: bool = False, norm: Optional[str] = None,
                 loss_cls: Optional[dict] = None, loss_bbox: Optional[dict] = None,
                 dtype=None):
        super().__init__()
        f32_only("FoveaHead", dtype)
        if norm not in (None, "GN"):
            raise NotImplementedError(f"FoveaHead norm {norm!r} is not ported (None or 'GN')")
        from ..builder import build_loss  # models/builder.py imports the heads
        self.num_classes = num_classes
        self.in_channels, self.feat_channels = in_channels, feat_channels
        self.stacked_convs = stacked_convs
        self.strides = tuple(strides)
        self.base_edge_list = tuple(base_edge_list)
        self.scale_ranges = tuple(tuple(r) for r in scale_ranges)
        self.sigma, self.with_deform, self.norm = sigma, with_deform, norm
        self.loss_cls = dict(loss_cls or DEFAULT_LOSS_CLS)
        self.loss_bbox = dict(loss_bbox or DEFAULT_LOSS_BBOX)
        self.loss_cls_fn = build_loss(self.loss_cls)
        self.loss_bbox_fn = build_loss(self.loss_bbox)
        gn = dict(type="GN", num_groups=32) if norm == "GN" else None

        def block(cin, cout, k):
            return ConvModule(cin, cout, k, padding=k // 2, norm_cfg=gn)

        chans = [in_channels] + [feat_channels] * stacked_convs
        self.reg_convs = nn.ModuleList([block(chans[i], feat_channels, 3)
                                        for i in range(stacked_convs)])
        self.fovea_reg = Conv2d(feat_channels, 4, 3, padding=1)
        if with_deform:
            self.feature_adaption = FeatureAdaption(in_channels, feat_channels)
            self.cls_convs = nn.ModuleList([block(feat_channels, feat_channels * 4, 3),
                                            block(feat_channels * 4, feat_channels * 4, 1)])
        else:
            self.cls_convs = nn.ModuleList([block(chans[i], feat_channels, 3)
                                            for i in range(stacked_convs)])
        cls_in = feat_channels * 4 if with_deform else feat_channels
        self.fovea_cls = Conv2d(cls_in, self.cls_out_channels, 3, padding=1)

    @property
    def cls_out_channels(self) -> int:
        return self.num_classes - 1

    def init_weights(self, generator: torch.Generator) -> None:
        init_anchor_free(self, generator)
        if self.with_deform:
            self.feature_adaption.init_weights(generator)
        with torch.no_grad():
            self.fovea_cls.bias.fill_(bias_init_with_prob(0.01))

    def forward(self, feats):
        """NCHW levels -> (cls_scores, bbox_preds), NHWC per level; the
        regression in log space."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            reg_feat = x
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            bbox_pred = self.fovea_reg(reg_feat)
            cls_feat = x
            if self.with_deform:
                cls_feat = self.feature_adaption(cls_feat, torch.exp(bbox_pred))
            for conv in self.cls_convs:
                cls_feat = conv(cls_feat)
            cls_scores.append(nhwc(self.fovea_cls(cls_feat)))
            bbox_preds.append(nhwc(bbox_pred))
        return cls_scores, bbox_preds

    # ------------------------------------------------------------ training

    def targets_level(self, featmap_size: Tuple[int, int], stride: int, base_len: int,
                      scale_range: Tuple[float, float], gt_bboxes: torch.Tensor,
                      gt_valid: torch.Tensor, gt_labels: torch.Tensor):
        """One level: gts (B, G, 4) raw-pixel xyxy (padded), (B, G), (B, G).
        Returns labels (B, h*w) int32 and log-space targets (B, h*w, 4), zero
        at the background.  Every divisor is a 0-d tensor: on the card a
        tensor divided by a Python number is multiplied by its reciprocal."""
        h, w = featmap_size
        dev = gt_bboxes.device
        cell = torch.arange(h * w, device=dev)
        iy, ix = (cell // w).float(), (cell % w).float()
        gt = gt_bboxes.float()
        area = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])            # (B, G)
        edge = torch.sqrt(area.clamp(min=0.0))
        in_scale = (edge >= scale_range[0]) & (edge <= scale_range[1]) & gt_valid.bool()
        g = gt / torch.full((), float(stride), device=dev)
        half_w = 0.5 * (g[..., 2] - g[..., 0])
        half_h = 0.5 * (g[..., 3] - g[..., 1])
        # g + (1 -+ sigma) * half as one FMA (``addcmul``), as XLA contracts
        # it in ioudet: two roundings move a region's edge where the sum
        # lands on a whole number
        shrink = torch.full((), 1 - self.sigma, device=dev)
        grow = torch.full((), 1 + self.sigma, device=dev)
        left = torch.ceil(torch.addcmul(g[..., 0], half_w, shrink) - 0.5).clamp(0, w - 1)
        right = torch.floor(torch.addcmul(g[..., 0], half_w, grow) - 0.5).clamp(0, w - 1)
        top = torch.ceil(torch.addcmul(g[..., 1], half_h, shrink) - 0.5).clamp(0, h - 1)
        down = torch.floor(torch.addcmul(g[..., 1], half_h, grow) - 0.5).clamp(0, h - 1)
        x, y = ix[None, :, None], iy[None, :, None]
        ok = ((x >= left[:, None]) & (x <= right[:, None]) & (y >= top[:, None]) &
              (y <= down[:, None]) & in_scale[:, None])                          # (B, P, G)
        cand = torch.where(ok, area[:, None], INF)
        idx = cand.argmin(-1)                                                    # (B, P)
        has = cand.amin(-1) < INF
        labels = torch.where(has, torch.gather(gt_labels.long(), 1, idx), 0).to(torch.int32)
        sel = torch.gather(gt, 1, idx[..., None].expand(-1, -1, 4))            # (B, P, 4)
        px, py = ((ix + 0.5) * stride)[None], ((iy + 0.5) * stride)[None]
        base = torch.full((), float(base_len), device=dev)
        t = torch.stack([(px - sel[..., 0]) / base, (py - sel[..., 1]) / base,
                         (sel[..., 2] - px) / base, (sel[..., 3] - py) / base], -1)
        t = torch.log(t.clamp(1.0 / 16, 16.0))
        return labels, torch.where(has[..., None], t, 0.0)

    def targets(self, featmap_sizes, gt_bboxes, gt_valid, gt_labels):
        """Every level's ``targets_level``, concatenated in level order."""
        per_level = [self.targets_level(fs, s, bl, sr, gt_bboxes, gt_valid, gt_labels)
                     for fs, s, bl, sr in zip(featmap_sizes, self.strides,
                                              self.base_edge_list, self.scale_ranges)]
        return (torch.cat([lab for lab, _ in per_level], 1),
                torch.cat([t for _, t in per_level], 1))

    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_labels, gt_valid, img_shapes,
             pad_shapes, train_cfg, gt_bboxes_ignore=None, gt_ignore_valid=None,
             generator=None) -> Dict[str, torch.Tensor]:
        """gt_bboxes (B, G, 4), gt_labels (B, G) 1-based, gt_valid (B, G)
        bool.  In a process group the counts are every rank's (``ioudet``
        divides by the global batch's)."""
        if gt_bboxes_ignore is not None:
            raise NotImplementedError("FoveaHead takes no ignored regions, as ioudet's")
        sizes = [tuple(c.shape[1:3]) for c in cls_scores]
        labels, targets = self.targets(sizes, gt_bboxes, gt_valid, gt_labels)
        B = labels.shape[0]
        pos = (labels > 0).float()
        num_pos, with_imgs = global_count(torch.stack([pos.sum(), pos.sum() + B]))
        loss_cls = level_cls_loss(self.loss_cls, self.loss_cls_fn, cls_scores, labels,
                                  torch.ones_like(pos), with_imgs, 1)
        reg_flat = torch.cat([b.reshape(B, -1, 4) for b in bbox_preds], 1)
        loss_bbox = self.loss_bbox_fn(reg_flat.reshape(-1, 4), targets.reshape(-1, 4),
                                      weight=pos.reshape(-1, 1).expand(-1, 4),
                                      avg_factor=num_pos.clamp(min=1.0))
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    # ------------------------------------------------------------ inference

    def decode_candidates(self, cls_scores, bbox_preds, img_shapes: torch.Tensor,
                          test_cfg: dict):
        """Per level the top ``nms_pre`` cells by their largest sigmoid
        score; boxes from exp(pred) * base edge around the cell centres,
        clipped.  Returns boxes (B, N, 4), scores (B, N, C)."""
        nms_pre = test_cfg.get("nms_pre", 1000)
        cand_boxes, cand_scores = [], []
        for s, bp, stride, base in zip(cls_scores, bbox_preds, self.strides,
                                       self.base_edge_list):
            bsz, h, w, C = s.shape
            n = h * w
            scores = sigmoid(s.reshape(bsz, n, C))
            _, idx = topk_stable(scores.amax(dim=-1), min(nms_pre, n))
            c = cell_centres((h, w), stride, s.device)[idx]
            d = torch.exp(take(bp.reshape(bsz, n, 4), idx).float()) * base
            boxes = torch.stack([c[..., 0] - d[..., 0], c[..., 1] - d[..., 1],
                                 c[..., 0] + d[..., 2], c[..., 1] + d[..., 3]], -1)
            cand_boxes.append(clip_boxes(boxes, img_shapes))
            cand_scores.append(take(scores, idx))
        return torch.cat(cand_boxes, dim=1), torch.cat(cand_scores, dim=1)

    def get_bboxes(self, cls_scores, bbox_preds, img_shapes, scale_factors, pad_shapes,
                   test_cfg: dict, rescale: bool = False):
        boxes, scores = self.decode_candidates(cls_scores, bbox_preds, img_shapes, test_cfg)
        return batched_nms(boxes, scores, scale_factors, test_cfg, rescale)
