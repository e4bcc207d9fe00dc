"""Builders (counterpart of ``ioudet/models/builder.py``): a detector from
the same nested config dicts ``ioudet`` takes (``type`` keys).

Only the components of the ported slice are known; any other ``type``
raises ``KeyError`` naming what is available.  A ``neck`` given as a list
builds the chain (``NeckSequence``, Libra R-CNN's FPN -> BFP).  A config
with ``rpn_head`` or ``bbox_roi_extractor`` builds a two-stage
detector (``FasterRCNN``, ``DoubleHeadRCNN``, ``RPN``, ``MaskRCNN`` with
``mask_roi_extractor`` and ``mask_head``, ``MaskScoringRCNN`` with a
``mask_iou_head`` too, ``GridRCNN`` with ``grid_roi_extractor`` and
``grid_head``, the C4 form with a ``shared_head``; ``FastRCNN`` /
``FastMaskRCNN`` without an RPN), or a
cascade from a list of box heads (``CascadeRCNN``; ``HybridTaskCascade``
with a list of mask heads and optionally ``semantic_roi_extractor`` and
``semantic_head``).  Of these, Faster R-CNN and Mask R-CNN with FPN and
RoIAlign also build in bf16 (``BF16_TWO_STAGE``); every other one raises
``NotImplementedError`` in bf16, as SSD, the anchor-free heads (FCOS,
FoveaBox), FreeAnchor, the guided-anchoring heads (GA-RPN too, inside a
Faster R-CNN), the GHM losses and BFP do.
"""

from __future__ import annotations

from typing import Optional

import torch

from .backbones.resnet import ResNet
from .backbones.resnext import ResNeXt
from .bbox_heads.bbox_head import BBoxHead, ConvFCBBoxHead, SharedFCBBoxHead
from .bbox_heads.double_bbox_head import DoubleConvFCBBoxHead
from .backbones.ssd_vgg import SSDVGG
from .detectors.single_stage import (FCOS, FOVEA, SSD, IoUAwareRetinaNet, RetinaNet,
                                     SingleStageDetector)
from .detectors.cascade_rcnn import CascadeRCNN
from .detectors.fast_rcnn import FastMaskRCNN, FastRCNN
from .detectors.grid_rcnn import GridRCNN
from .detectors.htc import HybridTaskCascade
from .detectors.mask_rcnn import MaskRCNN
from .detectors.mask_scoring_rcnn import MaskScoringRCNN
from .detectors.two_stage import RPN, DoubleHeadRCNN, FasterRCNN, TwoStageDetector
from .heads.fcos_head import FCOSHead
from .heads.fovea_head import FoveaHead
from .heads.free_anchor_retina_head import FreeAnchorRetinaHead
from .heads.guided_anchor_head import GARetinaHead, GARPNHead, GuidedAnchorHead
from .heads.iou_aware_retina_head import IoUAwareRetinaHead
from .heads.retina_head import RetinaHead
from .heads.rpn_head import RPNHead
from .heads.ssd_head import SSDHead
from .losses import (BoundedIoULoss, CrossEntropyLoss, FocalLoss, GIoULoss, IoULoss, L1Loss,
                     SmoothL1Loss)
from .losses.balanced_l1_loss import BalancedL1Loss
from .losses.ghm_loss import GHMC, GHMR, GHMCAdapter, GHMRAdapter
from .mask_heads.fcn_mask_head import FCNMaskHead, HTCMaskHead
from .mask_heads.fused_semantic_head import FusedSemanticHead
from .mask_heads.grid_head import GridHead
from .mask_heads.maskiou_head import MaskIoUHead
from .necks import BFP, FPN, NeckSequence
from .roi_extractors.single_level import DEFORM_POOLS, SingleRoIExtractor
from .shared_heads.res_layer import ResLayer
from .utils.layers import compute_dtype

BACKBONES = {"ResNet": ResNet, "ResNeXt": ResNeXt, "SSDVGG": SSDVGG}
NECKS = {"FPN": FPN, "BFP": BFP}
HEADS = {"RetinaHead": RetinaHead, "IoUAwareRetinaHead": IoUAwareRetinaHead,
         "RPNHead": RPNHead, "BBoxHead": BBoxHead, "ConvFCBBoxHead": ConvFCBBoxHead,
         "SharedFCBBoxHead": SharedFCBBoxHead, "DoubleConvFCBBoxHead": DoubleConvFCBBoxHead,
         "FCNMaskHead": FCNMaskHead, "HTCMaskHead": HTCMaskHead,
         "FusedSemanticHead": FusedSemanticHead, "ResLayer": ResLayer,
         "MaskIoUHead": MaskIoUHead, "GridHead": GridHead, "SSDHead": SSDHead,
         "FCOSHead": FCOSHead, "FoveaHead": FoveaHead,
         "FreeAnchorRetinaHead": FreeAnchorRetinaHead, "GuidedAnchorHead": GuidedAnchorHead,
         "GARetinaHead": GARetinaHead, "GARPNHead": GARPNHead}
ROI_EXTRACTORS = {"SingleRoIExtractor": SingleRoIExtractor}
DETECTORS = {"SingleStageDetector": SingleStageDetector,
             "RetinaNet": RetinaNet, "IoUAwareRetinaNet": IoUAwareRetinaNet,
             "TwoStageDetector": TwoStageDetector, "FasterRCNN": FasterRCNN, "RPN": RPN,
             "MaskRCNN": MaskRCNN, "CascadeRCNN": CascadeRCNN,
             "HybridTaskCascade": HybridTaskCascade, "DoubleHeadRCNN": DoubleHeadRCNN,
             "FastRCNN": FastRCNN, "FastMaskRCNN": FastMaskRCNN,
             "MaskScoringRCNN": MaskScoringRCNN, "GridRCNN": GridRCNN, "SSD": SSD,
             "FCOS": FCOS, "FOVEA": FOVEA}
# the two-stage detectors that run in bf16 (with FPN and RoIAlign; held
# against ioudet's in tests/test_torch_two_stage_bf16.py)
BF16_TWO_STAGE = ("TwoStageDetector", "FasterRCNN", "MaskRCNN")
# the detectors' own config entries besides their parts
CASCADE_OPTIONS = ("num_stages", "stage_loss_weights", "stage_pos_thrs")
DETECTOR_OPTIONS = {"CascadeRCNN": CASCADE_OPTIONS,
                    "HybridTaskCascade": CASCADE_OPTIONS + ("interleaved", "mask_info_flow")}
LOSSES = {"FocalLoss": FocalLoss, "SmoothL1Loss": SmoothL1Loss, "L1Loss": L1Loss,
          "CrossEntropyLoss": CrossEntropyLoss, "IoULoss": IoULoss,
          "BoundedIoULoss": BoundedIoULoss, "GIoULoss": GIoULoss,
          "BalancedL1Loss": BalancedL1Loss, "GHMC": GHMC, "GHMR": GHMR,
          "GHMCAdapter": GHMCAdapter, "GHMRAdapter": GHMRAdapter}


def _build(cfg: dict, table: dict, kind: str):
    # None-valued keys delete inherited config entries (ioudet's convention)
    args = {k: v for k, v in dict(cfg).items() if v is not None}
    name = args.pop("type")
    if name not in table:
        raise KeyError(f"{kind} {name!r} is not ported; available: {sorted(table)}")
    return table[name](**args)


def build_loss(cfg: dict):
    return _build(cfg, LOSSES, "loss")


def build_detector(cfg: dict, train_cfg: Optional[dict] = None,
                   test_cfg: Optional[dict] = None):
    """Build a detector from a model config (``FLAGSHIP`` or the ``model``
    entry of a config file).  ``dtype`` ("float32", the default, or
    "bfloat16") is the compute dtype of every convolution and FrozenBN; the
    parameters are f32 either way."""
    cfg = {k: v for k, v in dict(cfg).items() if v is not None}
    cfg.pop("pretrained", None)  # weights load through apis.checkpoint
    dtype = compute_dtype(cfg.pop("dtype", None))

    def with_dtype(part: dict) -> dict:
        # the detector's compute dtype reaches every part that names none
        part = dict(part)
        part.setdefault("dtype", dtype)
        return part

    det_type = cfg.pop("type")
    if det_type not in DETECTORS:
        raise KeyError(f"detector {det_type!r} is not ported; "
                       f"available: {sorted(DETECTORS)}")
    parts = dict(backbone=_build(with_dtype(cfg.pop("backbone")), BACKBONES, "backbone"))
    if "neck" in cfg:
        neck = cfg.pop("neck")
        parts["neck"] = (NeckSequence(*[_build(with_dtype(n), NECKS, "neck") for n in neck])
                         if isinstance(neck, (list, tuple)) else
                         _build(with_dtype(neck), NECKS, "neck"))
    if "rpn_head" in cfg or "bbox_roi_extractor" in cfg:
        # the two-stage family (ioudet's config keys)
        roi_layer = dict(dict(cfg.get("bbox_roi_extractor") or {}).get("roi_layer") or {})
        if dtype != torch.float32 and (det_type not in BF16_TWO_STAGE or "shared_head" in cfg
                                       or roi_layer.get("type") in DEFORM_POOLS):
            what = ("the C4 shared head" if "shared_head" in cfg else
                    roi_layer.get("type") if roi_layer.get("type") in DEFORM_POOLS else det_type)
            raise NotImplementedError(f"{what} in {dtype} is not ported yet (bf16 runs "
                                      f"{', '.join(BF16_TWO_STAGE)} with FPN and RoIAlign)")
        if "shared_head" in cfg:
            parts["shared_head"] = _build(with_dtype(cfg.pop("shared_head")), HEADS, "head")
        if "rpn_head" in cfg:
            parts["rpn_head"] = _build(with_dtype(cfg.pop("rpn_head")), HEADS, "head")
        if "bbox_roi_extractor" in cfg:
            parts["bbox_roi_extractor"] = _build(cfg.pop("bbox_roi_extractor"),
                                                 ROI_EXTRACTORS, "roi extractor")
        for key in ("mask_roi_extractor", "semantic_roi_extractor", "grid_roi_extractor"):
            if key in cfg:
                parts[key] = _build(cfg.pop(key), ROI_EXTRACTORS, "roi extractor")
        if "mask_head" in cfg:
            mask_head = cfg.pop("mask_head")
            if isinstance(mask_head, (list, tuple)):
                # HTC's, one a stage; the information flow enters through
                # conv_res from the second stage on (ioudet creates none elsewhere)
                flow = cfg.get("mask_info_flow", True)
                parts["mask_head"] = [
                    _build(with_dtype(dict(h, with_conv_res=flow and i > 0)), HEADS, "head")
                    for i, h in enumerate(mask_head)]
            else:
                parts["mask_head"] = _build(with_dtype(mask_head), HEADS, "head")
        for key in ("semantic_head", "mask_iou_head", "grid_head"):
            if key in cfg:
                parts[key] = _build(with_dtype(cfg.pop(key)), HEADS, "head")
    if "bbox_head" in cfg:
        bbox_head = cfg.pop("bbox_head")
        parts["bbox_head"] = ([_build(with_dtype(h), HEADS, "head") for h in bbox_head]
                              if isinstance(bbox_head, (list, tuple)) else
                              _build(with_dtype(bbox_head), HEADS, "head"))
    options = {k: cfg.pop(k) for k in DETECTOR_OPTIONS.get(det_type, ()) if k in cfg}
    if cfg:
        raise KeyError(f"unsupported detector keys: {sorted(cfg)}")
    return DETECTORS[det_type](train_cfg=train_cfg, test_cfg=test_cfg, **parts, **options)
