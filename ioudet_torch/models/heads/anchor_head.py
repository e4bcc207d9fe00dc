"""Anchor-based head base (counterpart of ``ioudet/models/heads/anchor_head.py``):
configuration, anchors, box clipping and the batched multiclass NMS tail.

Head outputs are NHWC per level at the public functions, with the
anchor-major channel layout ``a*C + c``, so that flattening a level gives the
(H, W, A) anchor order of ``AnchorGenerator.grid_anchors``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...core.anchor import AnchorGenerator
from ...core.post_processing import multiclass_nms


class AnchorHead(nn.Module):
    """Configuration and anchor helpers shared by the anchor heads;
    subclasses define the network."""

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
                 loss_bbox: Optional[dict] = None):
        super().__init__()
        if not use_sigmoid_cls:
            raise NotImplementedError("softmax classification is not ported yet")
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
        # training-only settings, kept so a config round-trips; the losses
        # come with the train slice
        self.loss_cls, self.loss_bbox = loss_cls, loss_bbox
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


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                scale_factors: torch.Tensor, test_cfg: dict, rescale: bool):
    """Rescale + multiclass NMS over a (B, N, ...) candidate set."""
    if rescale:
        boxes = boxes / scale_factors.float()[:, None, None]
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

