"""Two-stage detectors (counterpart of
``ioudet/models/detectors/two_stage.py``): ``TwoStageDetector`` /
``FasterRCNN`` (backbone -> FPN -> RPN proposals -> RoIAlign -> box head),
``DoubleHeadRCNN`` (its box head's two branches are the head's own), the
C4 form (no FPN; a ``shared_head``, the ResNet's res5, between the
RoIAlign and the box head, in training and at test) and the proposal-only
``RPN``.

Fixed shapes throughout, as in ``ioudet``:
  * the RPN's proposals are its ``get_bboxes`` output, (B, P, 5), zero rows
    where there are fewer than P; at test time those rows stay in as
    (0, 0, 0, 0) rois and the final NMS masks them out by ``valid``;
  * the R-CNN's training rois are a rank-based fixed-k selection
    (``sample_rois_batch``): every candidate (proposals + gts) is assigned,
    the sampler picks positives and negatives by rank, and one top-k of
    (picked * 10 + noise) takes ``num`` of them an image;
  * the two NMS of ``simple_test`` (proposals: one class at ``nms_thr``;
    detections: the class-offset ``multiclass_nms`` over the proposals'
    class-specific boxes) each run K1 once for the whole batch.

The draws of a training step come from a ``torch.Generator`` the caller
passes (``make_train_step`` seeds one a step); without one, a generator
seeded 0 on the device.  In a process group of more than one rank, the
R-CNN loss's two denominators are the global batch's, as the RPN's are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox import MaxIoUAssigner, delta2bbox
from ...core.bbox.samplers import build_sampler, uniform
from ...core.post_processing import multiclass_nms
from ...core.post_processing.bbox_nms import topk_stable
from ...parallel.mesh import global_count
from ..bbox_heads.bbox_head import bbox_target_single
from ..heads.anchor_head import clip_boxes, take


def sample_rois_batch(generator, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
                      assigner, num_samples: int, pos_fraction: float,
                      add_gt: bool = True, sampler_cfg: Optional[dict] = None,
                      hardness_fn=None):
    """Fixed-shape R-CNN roi sampling over a batch: proposals (B, P, 4),
    prop_valid (B, P), gt_* (B, G, ...).

    Every candidate (the proposals, then the gts with ``add_gt``) is
    assigned; the configured sampler picks positives (at most
    ``num * pos_fraction``) and negatives by rank over its priorities, or,
    for OHEM with a ``hardness_fn(boxes (B, N, 4), labels (B, N)) -> (B, N)``,
    by that loss (an OHEM or pseudo sampler without one samples at random,
    as ``ioudet`` does).  Then one top-k of (picked * 10 + noise) takes
    ``num_samples`` candidates an image.  Draws, in order: the sampler's,
    then the top-k's noise.

    Returns (sel_boxes (B, N, 4), sel_pos (B, N) bool, sel_valid (B, N)
    bool, matched_gt (B, N, 4), labels (B, N) int (0 for negatives),
    gt_idx (B, N)), N = ``num_samples``."""
    G = gt_bboxes.shape[1]
    cfg = dict(sampler_cfg or {})
    styp = cfg.get("type", "RandomSampler")
    scfg = {k: v for k, v in cfg.items()
            if k not in ("type", "num", "pos_fraction", "add_gt_as_proposals")}
    use_ohem = styp == "OHEMSampler" and hardness_fn is not None
    if styp in ("OHEMSampler", "PseudoSampler") and not use_ohem:
        styp, scfg = "RandomSampler", {}
    sampler = build_sampler(dict(scfg, type=styp, num=num_samples, pos_fraction=pos_fraction))

    if add_gt:
        boxes = torch.cat([proposals, gt_bboxes.to(proposals.dtype)], dim=1)
        valid = torch.cat([prop_valid, gt_valid], dim=1)
    else:
        boxes, valid = proposals, prop_valid
    res = assigner.assign(boxes, gt_bboxes, gt_valid, valid, gt_labels)
    if use_ohem:
        pos, neg = sampler.sample_with_losses(res, hardness_fn(boxes, res.labels))
    else:
        pos, neg = sampler.sample(res, generator)
    sel = pos | neg
    prio = sel.float() * 10.0 + uniform(sel.shape, generator, sel.device)
    _, idx = topk_stable(prio, num_samples)
    safe_gt = (take(res.gt_inds, idx) - 1).clamp(0, G - 1).long()
    sel_pos = take(pos, idx)
    labels = torch.where(sel_pos, torch.gather(gt_labels, 1, safe_gt), 0)
    return (take(boxes, idx), sel_pos, take(sel, idx),
            take(gt_bboxes, safe_gt), labels, safe_gt)


def to_rois(boxes: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) -> (B * N, 5) with the image index in column 0."""
    bsz, n = boxes.shape[:2]
    bidx = torch.arange(bsz, dtype=boxes.dtype, device=boxes.device).repeat_interleave(n)
    return torch.cat([bidx[:, None], boxes.reshape(bsz * n, 4)], dim=-1)


def proposal_cfg(cfg: dict, nms_pre: int, max_num: int) -> dict:
    """A ``get_bboxes`` test config from an RPN config (``nms_pre``,
    ``max_num``, ``nms_thr``): score threshold 0, one class."""
    return dict(nms_pre=cfg.get("nms_pre", nms_pre), score_thr=0.0,
                nms=dict(iou_thr=cfg.get("nms_thr", 0.7)),
                max_per_img=cfg.get("max_num", max_num))


def final_nms(test_cfg: Optional[dict], boxes: torch.Tensor, scores: torch.Tensor,
              scale_factors: torch.Tensor, rescale: bool, valid: torch.Tensor):
    """The R-CNN's detections: boxes (B, P, C - 1, 4) clipped to the image,
    scaled back to the original with ``rescale``, and scores (B, P, C - 1)
    through one class-offset ``multiclass_nms`` by ``test_cfg.rcnn``; the
    proposals' ``valid`` (B, P) mask keeps the padding rows out."""
    rcnn_cfg = dict(dict(test_cfg or {}).get("rcnn", dict(score_thr=0.05, nms=dict(iou_thr=0.5),
                                                          max_per_img=100)))
    if rescale:
        boxes = boxes / scale_factors.float()[:, None, None, None]
    bsz, num = scores.shape[:2]
    return multiclass_nms(
        boxes.reshape(bsz, num, -1), scores, score_thr=rcnn_cfg.get("score_thr", 0.05),
        iou_thr=rcnn_cfg.get("nms", {}).get("iou_thr", 0.5),
        max_per_img=rcnn_cfg.get("max_per_img", 100), valid=valid)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in x's dtype.  Below f32 it is written out
    as XLA's CPU program computes ``jax.nn.softmax`` of bf16 logits: exp in
    f32 of the difference to the row's max rounded to the dtype, the sum of
    the f32 exps rounded once, the rounded exps divided by it (XLA sums 81
    classes in windows of 32, each by halves: 0.02-0.07% of such scores
    differ by one bf16 step from this sum's order)."""
    if x.dtype == torch.float32:
        return F.softmax(x, dim=-1)
    e = torch.exp((x - x.amax(-1, keepdim=True)).float())
    return e.to(x.dtype) / e.sum(-1, keepdim=True).to(x.dtype)


class _Extract(nn.Module):
    """backbone (+ neck) on NHWC images; init of every part."""

    parts = ("backbone", "neck")

    def init_weights(self, generator: torch.Generator) -> None:
        for name in self.parts:
            part = getattr(self, name, None)
            for m in (part if isinstance(part, nn.ModuleList) else [part]):
                if m is not None:
                    m.init_weights(generator)

    def extract_feat(self, img: torch.Tensor):
        x = self.backbone(img.permute(0, 3, 1, 2).contiguous())
        return self.neck(x) if self.neck is not None else x

    def proposals(self, rpn_outs, img_shapes, pad_shapes, cfg: dict):
        """The RPN's (B, max_num, 5) proposals of its outputs ``rpn_outs``,
        in canvas coordinates, without gradient."""
        with torch.no_grad():
            outs = [[o.detach() for o in level] for level in rpn_outs]
            ones = torch.ones(img_shapes.shape[0], device=img_shapes.device)
            dets, _ = self.rpn_head.get_bboxes(*outs, img_shapes, ones, pad_shapes, cfg,
                                               rescale=False)
        return dets

    def rpn_train(self, feats, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                  gt_bboxes_ignore=None, gt_ignore_valid=None,
                  generator: Optional[torch.Generator] = None) -> tuple:
        """The RPN's training half: its losses ({rpn_loss_cls, rpn_loss_bbox})
        and its (B, max_num, 5) proposals by ``train_cfg.rpn_proposal``,
        without gradient."""
        tcfg = dict(self.train_cfg or {})
        ig_kw = {} if gt_bboxes_ignore is None else dict(
            gt_bboxes_ignore=gt_bboxes_ignore, gt_ignore_valid=gt_ignore_valid)
        rpn_outs = self.rpn_head(feats)
        # the RPN is class-agnostic: every gt is class 1
        losses = self.rpn_head.loss(*rpn_outs, gt_bboxes, torch.ones_like(gt_labels), gt_valid,
                                    img_shapes, pad_shapes, dict(tcfg.get("rpn", {})),
                                    generator=generator, **ig_kw)
        dets = self.proposals(rpn_outs, img_shapes, pad_shapes,
                              proposal_cfg(dict(tcfg.get("rpn_proposal", {})), 2000, 2000))
        return {f"rpn_{k}": v for k, v in losses.items()}, dets

    def test_proposals(self, feats, img_shapes, pad_shapes) -> torch.Tensor:
        """The RPN's (B, max_num, 5) proposals by ``test_cfg.rpn`` (on a
        view's features, ``ioudet``'s TTA primitive ``extract_proposals``)."""
        cfg = dict(dict(self.test_cfg or {}).get("rpn", {}))
        return self.proposals(self.rpn_head(feats), img_shapes, pad_shapes,
                              proposal_cfg(cfg, 1000, 1000))


def rcnn_losses(head, cls_score, bbox_pred, sel_boxes, sel_pos, sel_valid, matched_gt,
                labels) -> tuple:
    """A box head's losses on its sampled rois (``sample_rois_batch``'s
    outputs), the two denominators the global batch's; and the flat labels."""
    labels_f, bbox_t, bbox_w = bbox_target_single(
        sel_boxes.flatten(0, 1), sel_pos.flatten(), matched_gt.flatten(0, 1),
        labels.flatten(), head.target_means, head.target_stds)
    label_w = sel_valid.flatten().float()
    losses = head.loss(cls_score, bbox_pred, labels_f, label_w, bbox_t, bbox_w,
                       label_count=global_count(label_w.sum()),
                       pos_count=global_count((bbox_w[:, 0] > 0).sum().float()))
    return losses, labels_f


class TwoStageDetector(_Extract):
    parts = ("backbone", "neck", "rpn_head", "bbox_roi_extractor", "shared_head", "bbox_head")

    def __init__(self, backbone: nn.Module, rpn_head: nn.Module,
                 bbox_roi_extractor: nn.Module, bbox_head: nn.Module,
                 neck: Optional[nn.Module] = None, shared_head: Optional[nn.Module] = None,
                 train_cfg: Optional[dict] = None, test_cfg: Optional[dict] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.bbox_roi_extractor = bbox_roi_extractor
        self.shared_head = shared_head
        self.bbox_head = bbox_head
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg

    @property
    def num_result_classes(self) -> int:
        """``num_classes`` (background included) of the detections that
        ``simple_test`` returns."""
        return self.bbox_head.num_classes

    def forward(self, img: torch.Tensor):
        """Raw RPN outputs, NHWC per level."""
        return self.rpn_head(self.extract_feat(img))

    def roi_feats(self, feats, rois: torch.Tensor) -> torch.Tensor:
        """The box head's input of rois (R, 5): RoIAlign, then the shared
        head where there is one."""
        x = self.bbox_roi_extractor(feats, rois)
        return x if self.shared_head is None else self.shared_head(x)

    def roi_head(self, feats, rois: torch.Tensor):
        """(cls_score, bbox_pred) of rois (R, 5)."""
        return self.bbox_head(self.roi_feats(feats, rois))

    # ------------------------------------------------------------- train

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                      gt_bboxes_ignore=None, gt_ignore_valid=None,
                      generator: Optional[torch.Generator] = None):
        """img (B, H, W, 3) f32 canvas; gt_bboxes (B, G, 4), gt_labels (B, G)
        1-based, gt_valid (B, G) bool; img_shapes / pad_shapes (B, 2) int.
        Returns {loss_cls, loss_bbox, rpn_loss_cls, rpn_loss_bbox}."""
        return self.train_core(img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                               gt_bboxes_ignore, gt_ignore_valid, generator)[0]

    def train_core(self, img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                   gt_bboxes_ignore=None, gt_ignore_valid=None,
                   generator: Optional[torch.Generator] = None) -> tuple:
        """``forward_train``'s losses, and what a mask or grid branch extends
        them with: the features, the sampled rois (B * N, 5) and their boxes,
        positives, assigned gt boxes, flat labels and assigned gt indices."""
        if generator is None:
            generator = torch.Generator(img.device).manual_seed(0)
        feats = self.extract_feat(img)
        rpn_losses, dets = self.rpn_train(feats, gt_bboxes, gt_labels, gt_valid, img_shapes,
                                          pad_shapes, gt_bboxes_ignore, gt_ignore_valid,
                                          generator)
        losses, aux = self.rcnn_train(feats, dets[..., :4], dets[..., 4] > 0, gt_bboxes,
                                      gt_labels, gt_valid, generator)
        losses.update(rpn_losses)
        return losses, aux

    def rcnn_train(self, feats, proposals, prop_valid, gt_bboxes, gt_labels, gt_valid,
                   generator: torch.Generator) -> tuple:
        """The R-CNN's half of a train step on proposals (B, P, 4) and their
        validity (B, P): ``sample_rois_batch`` by ``train_cfg.rcnn``, the
        box head's losses, and the ``train_core`` aux dict."""
        rcnn_cfg = dict(dict(self.train_cfg or {}).get("rcnn", {}))
        sampler_cfg = dict(rcnn_cfg.get("sampler", {}))
        num_samples = sampler_cfg.get("num", 512)
        assigner = MaxIoUAssigner(**{k: v for k, v in dict(rcnn_cfg.get(
            "assigner", dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5))).items()
            if k != "type"})
        hardness_fn = None
        if sampler_cfg.get("type") == "OHEMSampler":
            def hardness_fn(boxes_all, labels_all):
                return self.hardness(feats, boxes_all, labels_all)

        sel_boxes, sel_pos, sel_valid, matched_gt, labels, gt_idx = sample_rois_batch(
            generator, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
            assigner, num_samples, sampler_cfg.get("pos_fraction", 0.25),
            sampler_cfg=sampler_cfg, hardness_fn=hardness_fn)

        rois = to_rois(sel_boxes)
        cls_score, bbox_pred = self.roi_head(feats, rois)
        losses, labels_f = rcnn_losses(self.bbox_head, cls_score, bbox_pred, sel_boxes, sel_pos,
                                       sel_valid, matched_gt, labels)
        return losses, dict(feats=feats, rois=rois, sel_boxes=sel_boxes, sel_pos=sel_pos,
                            matched_gt=matched_gt, labels=labels_f, gt_idx=gt_idx)

    def hardness(self, feats, boxes_all: torch.Tensor, labels_all: torch.Tensor):
        """OHEM's per-candidate loss: the box head's CE of every candidate
        (B, N, 4) against its assigned label (background for the rest),
        without gradient."""
        with torch.no_grad():
            cls, _ = self.roi_head([f.detach() for f in feats], to_rois(boxes_all))
            tgt = labels_all.reshape(-1).clamp(min=0).long()
            logp = F.log_softmax(cls.float(), dim=-1)
            return -torch.gather(logp, 1, tgt[:, None])[:, 0].reshape(labels_all.shape)

    # -------------------------------------------------------------- test

    def simple_test(self, img, img_shapes, scale_factors, pad_shapes, rescale: bool = True):
        """img (B, H, W, 3) f32 canvas; img_shapes / pad_shapes (B, 2) int;
        scale_factors (B,) f32.  Returns (dets (B, max_per_img, 5), labels
        (B, max_per_img)), label -1 padding."""
        return self.simple_test_bboxes(self.extract_feat(img), img_shapes, scale_factors,
                                       pad_shapes, rescale)

    def simple_test_bboxes(self, feats, img_shapes, scale_factors, pad_shapes,
                           rescale: bool = True):
        """``simple_test`` on the features of its images."""
        props = self.test_proposals(feats, img_shapes, pad_shapes)
        return self.detect(feats, props[..., :4], props[..., 4] > 0, img_shapes,
                           scale_factors, rescale)

    def detect(self, feats, proposals, valid, img_shapes, scale_factors, rescale: bool):
        """The R-CNN's detections of proposals (B, P, 4), ``valid`` (B, P):
        ``rcnn_test_raw`` with the softmax in the head's dtype (uncast, as
        ``ioudet``'s ``simple_test``), then ``final_nms``."""
        scores, boxes = self.rcnn_test_raw(feats, proposals, img_shapes, f32_scores=False)
        return final_nms(self.test_cfg, boxes, scores, scale_factors, rescale, valid)

    def rcnn_test_raw(self, feats, proposals, img_shapes, f32_scores: bool = True) -> tuple:
        """The box head on proposals (B, P, 4) without an NMS: (scores (B, P,
        C - 1), the softmax without the background, in f32 as ``ioudet``'s
        TTA primitive casts it, or in the head's dtype; boxes (B, P, C - 1,
        4), the class-specific decode clipped to the image).  With the
        features of a view and proposals mapped into it, the two-stage TTA's
        per-view primitive."""
        bsz, num = proposals.shape[:2]
        rois = to_rois(proposals)
        cls_score, bbox_pred = self.roi_head(feats, rois)
        nc = self.bbox_head.num_classes
        scores = softmax(cls_score.float() if f32_scores else cls_score)[:, 1:]
        boxes = self.decode_rcnn(rois, bbox_pred).reshape(bsz, num * nc, 4)
        boxes = clip_boxes(boxes, img_shapes).reshape(bsz, num, nc, 4)[:, :, 1:]
        return scores.reshape(bsz, num, nc - 1), boxes

    def decode_rcnn(self, rois: torch.Tensor, bbox_pred: torch.Tensor) -> torch.Tensor:
        """Class-specific decode: (R, 4C) deltas on the rois' boxes."""
        if self.bbox_head.reg_class_agnostic:
            bbox_pred = bbox_pred.repeat(1, self.bbox_head.num_classes)
        return delta2bbox(rois[:, 1:], bbox_pred, self.bbox_head.target_means,
                          self.bbox_head.target_stds)


class FasterRCNN(TwoStageDetector):
    """Registration name of the reference's Faster R-CNN."""


class DoubleHeadRCNN(TwoStageDetector):
    """Registration name of the reference's Double-Head R-CNN: the
    conv-regression / fc-classification split is the box head's
    (``bbox_heads/double_bbox_head.py``)."""


class RPN(_Extract):
    """Proposal-only detector: its ``simple_test`` returns the proposals as
    (B, max_num, 5) dets of one class."""

    parts = ("backbone", "neck", "rpn_head")

    def __init__(self, backbone: nn.Module, rpn_head: nn.Module,
                 neck: Optional[nn.Module] = None, train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg

    @property
    def num_result_classes(self) -> int:
        """``num_classes`` (background included) of the detections that
        ``simple_test`` returns."""
        return self.rpn_head.num_classes

    def forward(self, img: torch.Tensor):
        return self.rpn_head(self.extract_feat(img))

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid, img_shapes, pad_shapes,
                      gt_bboxes_ignore=None, gt_ignore_valid=None,
                      generator: Optional[torch.Generator] = None):
        ig_kw = {} if gt_bboxes_ignore is None else dict(
            gt_bboxes_ignore=gt_bboxes_ignore, gt_ignore_valid=gt_ignore_valid)
        return self.rpn_head.loss(*self(img), gt_bboxes, torch.ones_like(gt_labels),
                                  gt_valid, img_shapes, pad_shapes,
                                  dict(self.train_cfg or {}), generator=generator, **ig_kw)

    def simple_test(self, img, img_shapes, scale_factors, pad_shapes, rescale: bool = True):
        return self.rpn_head.get_bboxes(*self(img), img_shapes, scale_factors, pad_shapes,
                                        proposal_cfg(dict(self.test_cfg or {}), 1000, 1000),
                                        rescale=rescale)
