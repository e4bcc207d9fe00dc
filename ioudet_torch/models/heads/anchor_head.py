"""Anchor-based head base (counterpart of ``ioudet/models/heads/anchor_head.py``):
configuration, anchors, the training loss (with the RPN's anchor
subsampling where the classification loss is not the focal family's, and
GHM's EMA bin counts as the head's buffers, ``call_loss``), the sigmoid
decode, box clipping and the batched multiclass NMS tail.

Head outputs are NHWC per level at the public functions, with the
anchor-major channel layout ``a*C + c``, so that flattening a level gives the
(H, W, A) anchor order of ``AnchorGenerator.grid_anchors``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...core.anchor import AnchorGenerator, anchor_target
from ...core.bbox import MaxIoUAssigner, delta2bbox
from ...core.bbox.samplers import build_sampler
from ...core.post_processing import multiclass_nms
from ...core.post_processing.bbox_nms import topk_stable
from ...parallel.mesh import global_count
from ..losses import fused_level_focal_sum
from ..losses.ghm_loss import GHM_LOSSES
from ..utils.layers import compute_dtype

DEFAULT_LOSS_CLS = dict(type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
                        loss_weight=1.0)
DEFAULT_LOSS_BBOX = dict(type="SmoothL1Loss", beta=1.0 / 9.0, loss_weight=1.0)
DEFAULT_SAMPLER = dict(type="RandomSampler", num=256, pos_fraction=0.5, neg_pos_ub=-1)


class AnchorHead(nn.Module):
    """Configuration and anchor helpers shared by the anchor heads;
    subclasses define the network."""

    SOFTMAX = False   # whether the subclass has a softmax classifier

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256,
                 anchor_scales: Sequence[float] = (8, 16, 32),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 anchor_strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchor_base_sizes: Optional[Sequence[int]] = None,
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 use_sigmoid_cls: bool = True,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 dtype: Union[None, str, torch.dtype] = None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        if not use_sigmoid_cls and not self.SOFTMAX:
            raise NotImplementedError(f"softmax classification in {type(self).__name__} is "
                                      "not ported (SSDHead has it)")
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.feat_channels = feat_channels
        self.anchor_scales = tuple(anchor_scales)
        self.anchor_ratios = tuple(anchor_ratios)
        self.anchor_strides = tuple(anchor_strides)
        self.anchor_base_sizes = tuple(anchor_base_sizes or anchor_strides)
        self.target_means = tuple(float(m) for m in target_means)
        self.target_stds = tuple(float(s) for s in target_stds)
        self.use_sigmoid_cls = use_sigmoid_cls
        from ..builder import build_loss  # models/builder.py imports the heads
        self.loss_cls = dict(loss_cls or DEFAULT_LOSS_CLS)
        self.loss_bbox = dict(loss_bbox or DEFAULT_LOSS_BBOX)
        self.loss_cls_fn = build_loss(self.loss_cls)
        self.loss_bbox_fn = build_loss(self.loss_bbox)
        for fn, state in ((self.loss_cls_fn, "cls_acc_sum"), (self.loss_bbox_fn, "bbox_acc_sum")):
            if isinstance(fn, GHM_LOSSES) and self.dtype != torch.float32:
                raise NotImplementedError(f"{type(fn).__name__} in {self.dtype} is not ported "
                                          "yet (it runs in float32)")
            if getattr(fn, "stateful", False):
                # GHM's EMA bin counts (ioudet's 'ghm' collection): zeros at
                # init, in the state_dict, written by training steps only
                self.register_buffer(state, torch.zeros(fn.bins))
        self._anchor_cache: Dict[tuple, List[torch.Tensor]] = {}

    @property
    def cls_out_channels(self) -> int:
        return self.num_classes - 1

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_ratios) * len(self.anchor_scales)

    def anchor_generators(self) -> List[AnchorGenerator]:
        return [AnchorGenerator(b, self.anchor_scales, self.anchor_ratios)
                for b in self.anchor_base_sizes]

    def level_anchors(self, featmap_sizes: Sequence[Tuple[int, int]],
                      device) -> List[torch.Tensor]:
        """Per-level (H*W*A, 4) anchors, cached per (sizes, device): the
        first call copies them to the device, later calls reuse them without
        a host-to-device copy."""
        key = (tuple(map(tuple, featmap_sizes)), str(device))
        if key not in self._anchor_cache:
            self._anchor_cache[key] = [
                g.grid_anchors(fs, s, device) for g, fs, s in
                zip(self.anchor_generators(), featmap_sizes, self.anchor_strides)]
        return self._anchor_cache[key]

    def get_anchors(self, featmap_sizes: Sequence[Tuple[int, int]],
                    pad_shapes: torch.Tensor):
        """Returns (flat_anchors (A_tot, 4), valid (B, A_tot) bool) for the
        per-image padded content shapes ``pad_shapes`` (B, 2)."""
        anchors = torch.cat(self.level_anchors(featmap_sizes, pad_shapes.device))
        flags = []
        for g, fs, s in zip(self.anchor_generators(), featmap_sizes,
                            self.anchor_strides):
            vh = torch.ceil(pad_shapes[:, 0] / s).long().clamp(max=fs[0])
            vw = torch.ceil(pad_shapes[:, 1] / s).long().clamp(max=fs[1])
            flags.append(g.valid_flags(fs, (vh, vw)))
        return anchors, torch.cat(flags, dim=1)

    # ------------------------------------------------------------ training

    def _flatten_levels(self, preds: Sequence[torch.Tensor], ch: int) -> torch.Tensor:
        """(B, H, W, A*ch) per level -> (B, A_tot, ch), in anchor order."""
        return torch.cat([p.reshape(p.shape[0], -1, ch) for p in preds], dim=1)

    def call_loss(self, fn, state: str, *args, **kwargs) -> torch.Tensor:
        """``fn(*args, **kwargs)``; a stateful loss (GHM with momentum) also
        takes the head's buffer ``state`` as its ``acc_sum`` and returns the
        new sums, which are written back to the buffer in a training step
        (the module in training mode with autograd on) and nowhere else: not
        in ``predict`` and not in a loss evaluated under ``torch.no_grad()``
        or in eval mode, where ``ioudet``'s 'ghm' collection is not mutable
        either."""
        if not getattr(fn, "stateful", False):
            return fn(*args, **kwargs)
        acc = getattr(self, state)
        out, new_acc = fn(*args, acc_sum=acc, **kwargs)
        if self.training and torch.is_grad_enabled():
            with torch.no_grad():
                acc.copy_(new_acc)
        return out

    @property
    def sampling(self) -> bool:
        """Anchor subsampling is on unless the classification loss handles
        the imbalance itself (the reference's rule)."""
        return self.loss_cls.get("type") not in ("FocalLoss", "GHMC")

    def _targets(self, featmap_sizes, gt_bboxes, gt_labels, gt_valid, img_shapes,
                 pad_shapes, train_cfg, gt_bboxes_ignore, gt_ignore_valid,
                 generator: Optional[torch.Generator] = None):
        """(flat anchors, AnchorTargets, the loss denominator as an f32
        device scalar >= 1).

        The denominator is the number of positives, or with anchor
        subsampling (``sampling``: the config's ``sampler``, drawing from
        ``generator``; a generator seeded 0 on the device where none is
        given) the sampled positives and negatives.  In a process group of
        more than one rank (data-parallel training) it is the count of every
        rank's images, all-reduced before the floor of 1: ``ioudet`` divides
        each loss by the global batch's count, not by this rank's share."""
        anchors, valid = self.get_anchors(featmap_sizes, pad_shapes)
        assigner = MaxIoUAssigner(**{k: v for k, v in train_cfg["assigner"].items()
                                     if k != "type"})
        sampler = None
        if self.sampling:
            sampler = build_sampler(train_cfg.get("sampler", DEFAULT_SAMPLER))
            if generator is None:
                generator = torch.Generator(anchors.device).manual_seed(0)
        targets = anchor_target(
            anchors, valid, gt_bboxes, gt_valid, gt_labels, img_shapes, assigner,
            self.target_means, self.target_stds,
            allowed_border=train_cfg.get("allowed_border", -1),
            pos_weight=train_cfg.get("pos_weight", -1),
            sampler=sampler, generator=generator,
            gt_bboxes_ignore=gt_bboxes_ignore, gt_ignore_valid=gt_ignore_valid)
        num = targets.num_total_pos.float()
        if self.sampling:
            num = num + targets.num_total_neg.float()
        return anchors, targets, global_count(num).clamp(min=1)

    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_labels, gt_valid,
             img_shapes, pad_shapes, train_cfg, gt_bboxes_ignore=None,
             gt_ignore_valid=None, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """gt_bboxes (B, G, 4), gt_labels (B, G) 1-based, gt_valid (B, G)
        bool, img_shapes / pad_shapes (B, 2).  Every term is divided by the
        number of positives (with subsampling: of sampled anchors), which
        stays on the device."""
        featmap_sizes = [tuple(p.shape[1:3]) for p in cls_scores]
        _, targets, num_pos = self._targets(
            featmap_sizes, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
            train_cfg, gt_bboxes_ignore, gt_ignore_valid, generator)
        loss_cls = level_cls_loss(self.loss_cls,
                                  functools.partial(self.call_loss, self.loss_cls_fn,
                                                    "cls_acc_sum"),
                                  cls_scores, targets.labels, targets.label_weights, num_pos,
                                  self.num_anchors)
        loss_bbox = self.call_loss(
            self.loss_bbox_fn, "bbox_acc_sum",
            self._flatten_levels(bbox_preds, 4).reshape(-1, 4),
            targets.bbox_targets.reshape(-1, 4),
            weight=targets.bbox_weights.reshape(-1, 4), avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    # ------------------------------------------------------------ inference

    def decode_candidates(self, cls_scores, bbox_preds, img_shapes: torch.Tensor,
                          test_cfg: dict):
        """Batched pre-NMS candidates of a sigmoid head: per level the top
        ``nms_pre`` anchors by max class logit (the ranking of max_c
        sigmoid), their sigmoid scores, ``delta2bbox`` and clipping.
        Returns boxes (B, N, 4), scores (B, N, C)."""
        nms_pre = test_cfg.get("nms_pre", 1000)
        sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.level_anchors(sizes, cls_scores[0].device)
        C = self.cls_out_channels
        cand_boxes, cand_scores = [], []
        for lvl, (s, bp) in enumerate(zip(cls_scores, bbox_preds)):
            bsz, h, w, _ = s.shape
            n = h * w * self.num_anchors
            logits = s.reshape(bsz, n, C)
            _, idx = topk_stable(logits.amax(dim=-1).float(), min(nms_pre, n))
            cand_scores.append(sigmoid(take(logits, idx)))
            boxes = delta2bbox(anchors[lvl][idx], take(bp.reshape(bsz, n, 4), idx),
                               self.target_means, self.target_stds)
            cand_boxes.append(clip_boxes(boxes, img_shapes))
        return torch.cat(cand_boxes, dim=1), torch.cat(cand_scores, dim=1)

    def get_bboxes(self, cls_scores, bbox_preds, img_shapes, scale_factors,
                   pad_shapes, test_cfg: dict, rescale: bool = False):
        """(dets (B, max_per_img, 5), labels (B, max_per_img)), label -1
        padding."""
        boxes, scores = self.decode_candidates(cls_scores, bbox_preds, img_shapes,
                                               test_cfg)
        return batched_nms(boxes, scores, scale_factors, test_cfg, rescale)


def level_cls_loss(cfg: dict, loss_fn, cls_scores, labels: torch.Tensor,
                   label_weights: torch.Tensor, avg_factor: torch.Tensor,
                   num_anchors: int) -> torch.Tensor:
    """Classification loss that consumes the per-level conv outputs where
    they are: cls_scores (B, H, W, A*C) a level, labels / label_weights
    (B, total positions * A) in level order.

    Flattening and concatenating the levels would copy every logit once
    (the heads' NHWC outputs are permuted views) only to reorder positions;
    the sum of an elementwise loss does not depend on the order, so each
    level goes to ``fused_level_focal_sum`` as it is.  Only for the sigmoid
    FocalLoss with 'mean' reduction (the retina family's, FCOS's and
    FoveaBox's loss); any other loss (``loss_fn``, built from ``cfg``) takes
    the flat layout.
    """
    C = cls_scores[0].shape[-1] // num_anchors
    if not (cfg.get("type") == "FocalLoss" and cfg.get("use_sigmoid", True)
            and cfg.get("reduction", "mean") == "mean"):
        flat = torch.cat([p.reshape(p.shape[0], -1, C) for p in cls_scores], dim=1)
        return loss_fn(flat.reshape(-1, C), labels.reshape(-1),
                       weight=label_weights.reshape(-1), avg_factor=avg_factor)
    gamma, alpha = cfg.get("gamma", 2.0), cfg.get("alpha", 0.25)
    total, start = 0.0, 0
    for p in cls_scores:
        n = p.shape[1] * p.shape[2] * num_anchors
        total = total + fused_level_focal_sum(
            p, labels[:, start:start + n], label_weights[:, start:start + n].float(), gamma,
            alpha, num_anchors)
        start += n
    return cfg.get("loss_weight", 1.0) * total / avg_factor.clamp(min=1e-12)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered at idx (B, k) along N."""
    return torch.gather(x, 1, idx.view(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid in x's dtype.  Below f32 it is written out as XLA expands it
    in ``ioudet``, 1 / (1 + exp(-x)) with every step rounded to the dtype:
    bf16 scores tie often, ties decide the selection, and so the scores have
    to be ``ioudet``'s bit for bit (``torch.sigmoid`` rounds once and differs
    in the last bit for about 2% of the bf16 values)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                scale_factors: torch.Tensor, test_cfg: dict, rescale: bool):
    """Rescale + multiclass NMS over a (B, N, ...) candidate set;
    scale_factors (B,), or (B, 4) for a Resize without keep_ratio (SSD's)."""
    if rescale:
        factors = scale_factors.float()
        boxes = boxes / (factors[:, None, None] if factors.dim() == 1 else factors[:, None])
    nms_cfg = test_cfg.get("nms", {})
    return multiclass_nms(
        boxes, scores, score_thr=test_cfg.get("score_thr", 0.05),
        iou_thr=nms_cfg.get("iou_thr", 0.5),
        max_per_img=test_cfg.get("max_per_img", 100),
        nms_type=nms_cfg.get("type", "nms"),
        pre_nms_total=test_cfg.get("pre_nms_total", 2000),
        class_topk=test_cfg.get("class_topk", None),
        approx_topk=bool(test_cfg.get("approx_topk", False)),
        exact_select=test_cfg.get("exact_select", "sort"))


def clip_boxes(boxes: torch.Tensor, img_shapes: torch.Tensor) -> torch.Tensor:
    """Clamp (B, N, 4) xyxy boxes to [0, size - 1] of each image's (h, w)."""
    h = img_shapes[:, 0].float()[:, None] - 1
    w = img_shapes[:, 1].float()[:, None] - 1
    x1 = torch.minimum(boxes[..., 0].clamp(min=0), w)
    y1 = torch.minimum(boxes[..., 1].clamp(min=0), h)
    x2 = torch.minimum(boxes[..., 2].clamp(min=0), w)
    y2 = torch.minimum(boxes[..., 3].clamp(min=0), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def normal_init(conv: nn.Conv2d, generator: torch.Generator,
                std: float = 0.01, bias: float = 0.0) -> None:
    with torch.no_grad():
        conv.weight.normal_(0.0, std, generator=generator)
        conv.bias.fill_(bias)

