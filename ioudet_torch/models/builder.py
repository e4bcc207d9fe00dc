"""Builders (counterpart of ``ioudet/models/builder.py``): a detector from
the same nested config dicts ``ioudet`` takes (``type`` keys).

Only the components of the ported slice are known; any other ``type``
raises ``KeyError`` naming what is available.
"""

from __future__ import annotations

from typing import Optional

from .backbones.resnet import ResNet
from .backbones.resnext import ResNeXt
from .detectors.single_stage import (IoUAwareRetinaNet, RetinaNet,
                                     SingleStageDetector)
from .heads.iou_aware_retina_head import IoUAwareRetinaHead
from .heads.retina_head import RetinaHead
from .losses import CrossEntropyLoss, FocalLoss, L1Loss, SmoothL1Loss
from .necks.fpn import FPN
from .utils.layers import compute_dtype

BACKBONES = {"ResNet": ResNet, "ResNeXt": ResNeXt}
NECKS = {"FPN": FPN}
HEADS = {"RetinaHead": RetinaHead, "IoUAwareRetinaHead": IoUAwareRetinaHead}
DETECTORS = {"SingleStageDetector": SingleStageDetector,
             "RetinaNet": RetinaNet, "IoUAwareRetinaNet": IoUAwareRetinaNet}
LOSSES = {"FocalLoss": FocalLoss, "SmoothL1Loss": SmoothL1Loss, "L1Loss": L1Loss,
          "CrossEntropyLoss": CrossEntropyLoss}


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
    parts = dict(backbone=_build(with_dtype(cfg.pop("backbone")), BACKBONES, "backbone"),
                 bbox_head=_build(with_dtype(cfg.pop("bbox_head")), HEADS, "head"))
    if "neck" in cfg:
        parts["neck"] = _build(with_dtype(cfg.pop("neck")), NECKS, "neck")
    if cfg:
        raise KeyError(f"unsupported detector keys: {sorted(cfg)}")
    return DETECTORS[det_type](train_cfg=train_cfg, test_cfg=test_cfg, **parts)
