"""Guided anchoring (counterpart of ``ioudet/models/heads/guided_anchor_head.py``;
mmdet's ``guided_anchor_head.py``, ``ga_retina_head.py``, ``ga_rpn_head.py``
and ``guided_anchor_target.py``).

Guided anchoring predicts one anchor a cell instead of enumerating nine:
  * the loc branch (``conv_loc``, 1x1 to one channel) scores each cell for
    being a gt centre: sigmoid focal loss on centre-region targets, with
    the wider ignore region weighted 0 on the gt's level and its neighbours;
  * the shape branch (``conv_shape``, 1x1 to (dw, dh)) gives the anchor of
    each cell around its square (``octave_base_scale`` x stride, centred
    as every anchor is): bounded-IoU loss against the gt that the
    ``ApproxMaxIoUAssigner`` gives the cell (the best IoU over the cell's
    nine approxs);
  * ``FeatureAdaption`` (a 3x3 deformable conv, offsets from the detached
    shape field, one deformable group) realigns the features, and 1x1
    ``conv_cls`` / ``conv_reg`` score and regress the one predicted anchor
    a cell.  Their targets are the plain per-image ``anchor_target_single``
    on the detached predicted anchors (every image has its own anchors);
    the focal classification loss goes through K3 at A = 1.

Inference keeps every cell and multiplies the class probabilities by
``sigmoid(loc) > loc_filter_thr`` (mmdet gathers the masked-in cells
through its masked conv instead); per level the top ``nms_pre`` cells by
their largest masked probability, where every masked cell ties at 0 and the
lower index wins, as ``lax.top_k`` takes them; then one ``multiclass_nms``
(K1).

``GARetinaHead`` runs four-conv cls and reg towers first: the loc branch on
the cls tower, the shape branch on the reg tower and one ``FeatureAdaption``
on both (``ioudet``'s; mmdet has one for each tower).  ``GARPNHead`` runs
the RPN's 3x3 trunk, then the branches with one sigmoid objectness channel.
Head outputs are NHWC per level: (cls, reg, shape, loc).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchor import AnchorGenerator
from ...core.anchor.anchor_target import anchor_target_single
from ...core.bbox import ApproxMaxIoUAssigner, MaxIoUAssigner, delta2bbox
from ...core.post_processing.bbox_nms import topk_stable
from ...ops.deform_conv import DeformConv
from ...parallel.mesh import global_count
from ..losses.focal_loss import sigmoid_focal_loss_with_logits
from ..losses.iou_loss import bounded_iou_loss
from ..utils.layers import Conv2d, ConvModule, bias_init_with_prob
from .anchor_head import (AnchorHead, batched_nms, clip_boxes, level_cls_loss, normal_init,
                          sigmoid, take)
from .fcos_head import f32_only
from .retina_head import nhwc


class FeatureAdaption(nn.Module):
    """A 3x3 deformable conv whose offsets come from the shape prediction
    (``ioudet``'s ``FeatureAdaption``, mmdet's ``FeatureAdaption`` /
    ``FeatureAlign``): ``conv_offset`` (1x1, no bias, 18 channels) on the
    detached shape field, then ``conv_adaption`` (a ``DeformConv``, one
    deformable group as in ``ioudet``; mmdet's uses 4), then ReLU.  Init
    (``ioudet``'s): ``conv_offset`` normal(0.1), ``conv_adaption``
    normal(0.01).  ``shape_channels``: FoveaBox's 4, guided anchoring's 2."""

    def __init__(self, in_channels: int, out_channels: int, shape_channels: int = 4,
                 kernel_size: int = 3):
        super().__init__()
        self.conv_offset = Conv2d(shape_channels, 2 * kernel_size * kernel_size, 1, bias=False)
        self.conv_adaption = DeformConv(in_channels, out_channels, kernel_size)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.conv_offset.weight.normal_(0.0, 0.1, generator=generator)
            self.conv_adaption.weight.normal_(0.0, 0.01, generator=generator)

    def forward(self, x: torch.Tensor, shape_pred: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv_adaption(x, self.conv_offset(shape_pred.detach())))


class GuidedAnchorHead(AnchorHead):
    """The branches on the level features themselves (``ioudet``'s
    ``GuidedAnchorHead.__call__``); the subclasses put towers or a trunk
    before them."""

    INT8 = False   # w8a8 serving of guided anchoring is not ported

    def __init__(self, octave_base_scale: int = 8, scales_per_octave: int = 3,
                 anchoring_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 anchoring_stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 loc_filter_thr: float = 0.01, center_ratio: float = 0.2,
                 ignore_ratio: float = 0.5, **kwargs):
        f32_only(type(self).__name__, kwargs.get("dtype"))
        super().__init__(**kwargs)
        self.octave_base_scale = octave_base_scale
        self.scales_per_octave = scales_per_octave
        self.anchoring_means = tuple(float(m) for m in anchoring_means)
        self.anchoring_stds = tuple(float(s) for s in anchoring_stds)
        self.loc_filter_thr = loc_filter_thr
        self.center_ratio = center_ratio
        self.ignore_ratio = ignore_ratio
        ch = self.branch_channels
        self.conv_loc = Conv2d(ch, 1, 1)
        self.conv_shape = Conv2d(ch, 2, 1)
        self.feature_adaption = FeatureAdaption(ch, self.feat_channels, shape_channels=2)
        self.conv_cls = Conv2d(self.feat_channels, self.cls_out_channels, 1)
        self.conv_reg = Conv2d(self.feat_channels, 4, 1)

    @property
    def branch_channels(self) -> int:
        """Channels of the features the branches take."""
        return self.in_channels

    @property
    def num_anchors(self) -> int:
        """One predicted anchor a cell."""
        return 1

    @property
    def num_approx(self) -> int:
        return self.scales_per_octave * len(self.anchor_ratios)

    def init_weights(self, generator: torch.Generator) -> None:
        """``ioudet``'s init: every conv normal(0.01) with a zero bias, the
        loc and cls biases at the 0.01 prior, ``FeatureAdaption``'s own."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and m.bias is not None:
                normal_init(m, generator)
        self.feature_adaption.init_weights(generator)
        with torch.no_grad():
            self.conv_loc.bias.fill_(bias_init_with_prob(0.01))
            self.conv_cls.bias.fill_(bias_init_with_prob(0.01))

    def branches(self, cls_feat: torch.Tensor, reg_feat: torch.Tensor) -> tuple:
        """NCHW (cls, reg, shape, loc) of one level: loc on ``cls_feat``,
        shape on ``reg_feat``, the one adaption on each."""
        loc_pred = self.conv_loc(cls_feat)
        shape_pred = self.conv_shape(reg_feat)
        cls_score = self.conv_cls(self.feature_adaption(cls_feat, shape_pred))
        bbox_pred = self.conv_reg(self.feature_adaption(reg_feat, shape_pred))
        return cls_score, bbox_pred, shape_pred, loc_pred

    def forward_single(self, x: torch.Tensor) -> tuple:
        """``ioudet``'s ``forward_single``: the branches on x, one adaption
        for cls and reg together."""
        loc_pred = self.conv_loc(x)
        shape_pred = self.conv_shape(x)
        adapted = self.feature_adaption(x, shape_pred)
        return self.conv_cls(adapted), self.conv_reg(adapted), shape_pred, loc_pred

    def forward(self, feats) -> Tuple[List[torch.Tensor], ...]:
        """NCHW levels -> (cls_scores, bbox_preds, shape_preds, loc_preds),
        NHWC per level."""
        outs = [self.forward_single(x) for x in feats]
        return tuple([nhwc(o[i]) for o in outs] for i in range(4))

    # ------------------------------------------------------------ anchors

    def square_generators(self) -> List[AnchorGenerator]:
        """One square a cell, ``octave_base_scale`` x stride wide, centred on
        the cell as every anchor is (base size = stride)."""
        return [AnchorGenerator(s, [float(self.octave_base_scale)], [1.0])
                for s in self.anchor_strides]

    def approx_generators(self) -> List[AnchorGenerator]:
        """The ``num_approx`` RetinaNet anchors of a cell."""
        scales = [self.octave_base_scale * 2 ** (i / self.scales_per_octave)
                  for i in range(self.scales_per_octave)]
        return [AnchorGenerator(s, scales, list(self.anchor_ratios)) for s in self.anchor_strides]

    def _grid(self, kind: str, featmap_sizes, device) -> List[torch.Tensor]:
        """Per-level squares or approxs, cached per (kind, sizes, device)."""
        key = (kind, tuple(map(tuple, featmap_sizes)), str(device))
        if key not in self._anchor_cache:
            gens = self.square_generators() if kind == "squares" else self.approx_generators()
            self._anchor_cache[key] = [g.grid_anchors(fs, s, device) for g, fs, s in
                                       zip(gens, featmap_sizes, self.anchor_strides)]
        return self._anchor_cache[key]

    def level_squares(self, featmap_sizes, device) -> List[torch.Tensor]:
        """Per-level (H*W, 4) squares."""
        return self._grid("squares", featmap_sizes, device)

    def level_approxs(self, featmap_sizes, device) -> List[torch.Tensor]:
        """Per-level (H*W*num_approx, 4) approxs, a cell's together."""
        return self._grid("approxs", featmap_sizes, device)

    def decode_anchors(self, squares: torch.Tensor, shape: torch.Tensor) -> torch.Tensor:
        """Anchors of (dw, dh) ``shape`` (..., N, 2) around squares (N, 4):
        ``delta2bbox`` of (0, 0, dw, dh) by the anchoring means and stds,
        ``wh_ratio_clip`` 1e-6."""
        deltas = torch.cat([torch.zeros_like(shape), shape], dim=-1)
        return delta2bbox(squares, deltas, self.anchoring_means, self.anchoring_stds,
                          wh_ratio_clip=1e-6)

    def predicted_anchors(self, shape_preds) -> List[torch.Tensor]:
        """Per level the (B, H*W, 4) predicted anchors of (B, H, W, 2) shape
        predictions."""
        sizes = [tuple(p.shape[1:3]) for p in shape_preds]
        squares = self.level_squares(sizes, shape_preds[0].device)
        return [self.decode_anchors(sq, sp.reshape(sp.shape[0], -1, 2))
                for sq, sp in zip(squares, shape_preds)]

    # ------------------------------------------------------------ training

    def loc_targets(self, gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                    featmap_sizes) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Per level the (B, H*W) loc targets and weights (``ioudet``'s
        ``_loc_targets``, mmdet's ``ga_loc_target``): a gt goes to level
        round(log2(scale / (octave_base_scale * stride_0))), clipped, its
        scale the +1 convention's sqrt(w * h); the cells whose centres
        ((i + 0.5) * stride) lie within ``center_ratio`` of its box (``<=``)
        are positive on that level, those within ``ignore_ratio`` weigh 0
        there and on the neighbouring levels unless positive."""
        strides = self.anchor_strides
        gt = gt_bboxes.float()
        dev = gt.device
        gw = gt[..., 2] - gt[..., 0] + 1
        gh = gt[..., 3] - gt[..., 1] + 1
        scale = torch.sqrt(gw * gh)
        base = torch.full((), float(self.octave_base_scale * strides[0]), device=dev)
        lvl_of_gt = torch.round(torch.log2((scale / base).clamp(min=1e-6))).clamp(
            0, len(strides) - 1).int()
        cx = (gt[..., 0] + gt[..., 2]) * 0.5
        cy = (gt[..., 1] + gt[..., 3]) * 0.5
        valid = gt_valid.bool()
        targets, weights = [], []
        for lvl, ((h, w), s) in enumerate(zip(featmap_sizes, strides)):
            ys = (torch.arange(h, device=dev) + 0.5) * s
            xs = (torch.arange(w, device=dev) + 0.5) * s

            def region(ratio: float) -> torch.Tensor:
                in_x = (xs[None, :, None] - cx[:, None]).abs() <= (gw * ratio * 0.5)[:, None]
                in_y = (ys[None, :, None] - cy[:, None]).abs() <= (gh * ratio * 0.5)[:, None]
                return in_y[:, :, None] & in_x[:, None]                   # (B, H, W, G)

            on_lvl = (lvl_of_gt == lvl) & valid
            near_lvl = ((lvl_of_gt - lvl).abs() <= 1) & valid
            pos = (region(self.center_ratio) & on_lvl[:, None, None]).any(-1)
            ign = (region(self.ignore_ratio) & near_lvl[:, None, None]).any(-1) & ~pos
            targets.append(pos.float().reshape(pos.shape[0], -1))
            weights.append(torch.where(ign, 0.0, 1.0).reshape(pos.shape[0], -1))
        return targets, weights

    def shape_targets(self, featmap_sizes, gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                      train_cfg: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(positive (B, C) bool, assigned gt (B, C, 4)) of every cell by the
        approx assignment (``train_cfg.ga_assigner``'s thresholds, 0.5 / 0.4
        / 0.0 by default), an image at a time: the (G, C * num_approx)
        IoUs of one image at stride 4 are ~335 MB at G = 100."""
        dev = gt_bboxes.device
        squares = torch.cat(self.level_squares(featmap_sizes, dev))
        approxs = torch.cat(self.level_approxs(featmap_sizes, dev)).reshape(
            squares.shape[0], self.num_approx, 4)
        ga = dict(train_cfg.get("ga_assigner", {}))
        assigner = ApproxMaxIoUAssigner(pos_iou_thr=ga.get("pos_iou_thr", 0.5),
                                        neg_iou_thr=ga.get("neg_iou_thr", 0.4),
                                        min_pos_iou=ga.get("min_pos_iou", 0.0))
        every = torch.ones(squares.shape[0], dtype=torch.bool, device=dev)
        G = gt_bboxes.shape[1]
        pos, matched = [], []
        for gb, gv in zip(gt_bboxes.float(), gt_valid.bool()):
            res = assigner.assign_approx(approxs, squares, gb, gv, every)
            pos.append(res.gt_inds > 0)
            matched.append(gb[(res.gt_inds - 1).clamp(0, G - 1).long()])
        return torch.stack(pos), torch.stack(matched)

    def loss(self, cls_scores, bbox_preds, shape_preds, loc_preds, gt_bboxes, gt_labels,
             gt_valid, img_shapes, pad_shapes, train_cfg, gt_bboxes_ignore=None,
             gt_ignore_valid=None, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """gt_bboxes (B, G, 4), gt_labels (B, G) 1-based, gt_valid (B, G)
        bool, img_shapes / pad_shapes (B, 2).  Four terms, each divided by
        its own positives (in a process group, every rank's): ``loss_loc``
        (elementwise focal, gamma 2, alpha 0.25, times the ignore weights),
        ``loss_shape`` (bounded IoU, beta 0.2, summed over the coordinates,
        on the approx assignment's positives), ``loss_cls`` (the config's,
        through ``level_cls_loss`` at A = 1) and ``loss_bbox`` (the
        config's) on the detached predicted anchors.  No anchor sampling
        (``ioudet``'s: none whatever the classification loss)."""
        if gt_bboxes_ignore is not None:
            raise NotImplementedError(f"{type(self).__name__} takes no ignored regions, "
                                      "as ioudet's")
        sizes = [tuple(p.shape[1:3]) for p in cls_scores]
        B = cls_scores[0].shape[0]
        dev = cls_scores[0].device
        with torch.no_grad():
            loc_t, loc_w = self.loc_targets(gt_bboxes, gt_valid, sizes)
            loc_t, loc_w = torch.cat(loc_t, 1), torch.cat(loc_w, 1)
            shape_pos, shape_gt = self.shape_targets(sizes, gt_bboxes, gt_valid, train_cfg)

        squares = torch.cat(self.level_squares(sizes, dev))
        shape_flat = torch.cat([p.reshape(B, -1, 2) for p in shape_preds], 1)
        pred_anchors = self.decode_anchors(squares, shape_flat)              # (B, C, 4)

        assigner = MaxIoUAssigner(**{k: v for k, v in train_cfg["assigner"].items()
                                     if k != "type"})
        anchors = pred_anchors.detach()
        every = torch.ones((1, squares.shape[0]), dtype=torch.bool, device=dev)
        with torch.no_grad():
            per_image = [anchor_target_single(
                anchors[i], every, gt_bboxes[i:i + 1], gt_valid[i:i + 1], gt_labels[i:i + 1],
                img_shapes[i:i + 1], assigner, self.target_means, self.target_stds,
                allowed_border=train_cfg.get("allowed_border", -1)) for i in range(B)]
        labels, lw, bt, bw = (torch.cat([t[j] for t in per_image]) for j in range(4))
        num_pos = torch.cat([t[5] for t in per_image]).sum().float()
        num_loc, num_shape, num_pos = global_count(torch.stack([
            loc_t.sum(), shape_pos.sum().float(), num_pos])).clamp(min=1.0).unbind()

        loc_flat = torch.cat([p.reshape(B, -1) for p in loc_preds], 1)
        loss_loc = (sigmoid_focal_loss_with_logits(loc_flat, loc_t) * loc_w).sum() / num_loc
        shape_loss = bounded_iou_loss(pred_anchors.reshape(-1, 4), shape_gt.reshape(-1, 4),
                                      reduction="none", beta=0.2).sum(-1)
        loss_shape = (shape_loss * shape_pos.reshape(-1)).sum() / num_shape
        loss_cls = level_cls_loss(self.loss_cls, self.loss_cls_fn, cls_scores, labels, lw,
                                  num_pos, self.num_anchors)
        reg_flat = torch.cat([p.reshape(B, -1, 4) for p in bbox_preds], 1)
        loss_bbox = self.loss_bbox_fn(reg_flat.reshape(-1, 4), bt.reshape(-1, 4),
                                      weight=bw.reshape(-1, 4), avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_shape=loss_shape,
                    loss_loc=loss_loc)

    # ------------------------------------------------------------ inference

    def decode_candidates(self, cls_scores, bbox_preds, shape_preds, loc_preds,
                          img_shapes: torch.Tensor, test_cfg: dict):
        """Per level: the sigmoid scores times ``sigmoid(loc) >
        loc_filter_thr``, the top ``nms_pre`` cells by their largest masked
        score (ties by the lower index), the deltas decoded on their
        predicted anchors and clipped.  Returns boxes (B, N, 4), scores (B,
        N, C)."""
        nms_pre = test_cfg.get("nms_pre", 1000)
        C = self.cls_out_channels
        anchors = self.predicted_anchors(shape_preds)
        cand_boxes, cand_scores = [], []
        for s, bp, lp, anc in zip(cls_scores, bbox_preds, loc_preds, anchors):
            bsz, h, w, _ = s.shape
            n = h * w
            keep = sigmoid(lp.reshape(bsz, n)) > self.loc_filter_thr
            scores = sigmoid(s.reshape(bsz, n, C)) * keep[..., None]
            _, idx = topk_stable(scores.amax(dim=-1), min(nms_pre, n))
            boxes = delta2bbox(take(anc, idx), take(bp.reshape(bsz, n, 4), idx),
                               self.target_means, self.target_stds)
            cand_boxes.append(clip_boxes(boxes, img_shapes))
            cand_scores.append(take(scores, idx))
        return torch.cat(cand_boxes, dim=1), torch.cat(cand_scores, dim=1)

    def get_bboxes(self, cls_scores, bbox_preds, shape_preds, loc_preds, img_shapes,
                   scale_factors, pad_shapes, test_cfg: dict, rescale: bool = False):
        """(dets (B, max_per_img, 5), labels (B, max_per_img)), label -1
        padding."""
        boxes, scores = self.decode_candidates(cls_scores, bbox_preds, shape_preds, loc_preds,
                                               img_shapes, test_cfg)
        return batched_nms(boxes, scores, scale_factors, test_cfg, rescale)


class GARetinaHead(GuidedAnchorHead):
    """``stacked_convs`` x (3x3 conv + ReLU) cls and reg towers, then the
    branches: loc on the cls tower, shape on the reg tower, the one
    ``FeatureAdaption`` on each tower (its gradient the sum of both uses)."""

    def __init__(self, stacked_convs: int = 4, **kwargs):
        self.stacked_convs = stacked_convs
        super().__init__(**kwargs)
        chans = [self.in_channels] + [self.feat_channels] * stacked_convs
        self.cls_convs = nn.ModuleList([ConvModule(chans[i], self.feat_channels, 3, padding=1)
                                        for i in range(stacked_convs)])
        self.reg_convs = nn.ModuleList([ConvModule(chans[i], self.feat_channels, 3, padding=1)
                                        for i in range(stacked_convs)])

    @property
    def branch_channels(self) -> int:
        return self.feat_channels if self.stacked_convs else self.in_channels

    def towers(self, x: torch.Tensor) -> tuple:
        """The (cls, reg) tower features of one NCHW level."""
        cls_feat, reg_feat = x, x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        for conv in self.reg_convs:
            reg_feat = conv(reg_feat)
        return cls_feat, reg_feat

    def forward(self, feats):
        outs = [self.branches(*self.towers(x)) for x in feats]
        return tuple([nhwc(o[i]) for o in outs] for i in range(4))


class GARPNHead(GuidedAnchorHead):
    """The RPN's 3x3 ``rpn_conv`` + ReLU, then the branches; one sigmoid
    objectness channel (``num_classes`` 2)."""

    def __init__(self, num_classes: int = 2, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.rpn_conv = Conv2d(self.in_channels, self.feat_channels, 3, padding=1)

    @property
    def branch_channels(self) -> int:
        return self.feat_channels

    def forward(self, feats):
        outs = [self.forward_single(F.relu(self.rpn_conv(x))) for x in feats]
        return tuple([nhwc(o[i]) for o in outs] for i in range(4))
