"""Inference API (counterpart of ``ioudet/apis/inference.py``).

``init_detector`` builds a detector from a config and either loads a
checkpoint or draws seeded random weights; ``predict`` runs the batched
fixed-shape ``simple_test``; ``inference_detector`` takes one HWC uint8
image (BGR, the cv2 contract) or a path, read as the data pipeline reads it
(``data/pipelines/loading.py``: netpbm without an image library),
preprocesses it on the model's device and returns the per-class list of
(k, 5) arrays (a mask detector's with the per-class lists of RLE masks in
the image's frame).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..data.pipelines.loading import imread
from ..models import build_detector
from ..ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, preprocess
from ..utils.config import Config
from .checkpoint import load_checkpoint
from .test import to_results

DEFAULT_CANVAS = (832, 1344)
DEFAULT_SCALE = (1333, 800)


@dataclass
class DetectorHandle:
    model: torch.nn.Module
    cfg: dict
    device: torch.device
    CLASSES: Optional[tuple] = None


def _as_dict(config) -> dict:
    if isinstance(config, str):
        config = Config.fromfile(config)
    return config.todict() if hasattr(config, "todict") else dict(config)


def init_detector(config, checkpoint: Optional[str] = None,
                  device: Union[str, torch.device] = "cuda",
                  seed: int = 0) -> DetectorHandle:
    """config: a path, an ``ioudet`` Config or a dict with ``model`` (and
    optionally ``test_cfg``, ``data``).  ``model['dtype']`` ("float32" or
    "bfloat16") is the compute dtype; the parameters are f32 either way.
    Without a checkpoint the weights are drawn from
    ``torch.Generator().manual_seed(seed)``.  For int8 serving run
    ``predict`` / ``inference_detector`` inside
    ``ioudet_torch.ops.quant.quantize_calls(handle.model, ...)``."""
    cfg = _as_dict(config)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    model = build_detector(cfg["model"], cfg.get("train_cfg"), cfg.get("test_cfg"))
    meta: dict = {}
    if checkpoint is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        meta = load_checkpoint(model, checkpoint)
    model.to(device).eval()
    return DetectorHandle(model, cfg, device, meta.get("CLASSES"))


@torch.inference_mode()
def predict(handle: DetectorHandle, imgs: torch.Tensor, img_shapes: torch.Tensor,
            scale_factors: torch.Tensor, pad_shapes: torch.Tensor,
            proposals: Optional[torch.Tensor] = None, prop_valid: Optional[torch.Tensor] = None,
            rescale: bool = True) -> Tuple[torch.Tensor, ...]:
    """Batched ``simple_test`` on device tensors: imgs (B, H, W, 3) f32
    canvas, img_shapes / pad_shapes (B, 2) int, scale_factors (B,) f32 ->
    (dets (B, max_per_img, 5), labels (B, max_per_img)), label -1 padding;
    a mask detector adds masks (B, max_per_img, 28, 28), each detection's
    class probabilities in its box's frame.  A detector that
    ``requires_proposals`` (Fast R-CNN) takes proposals (B, P, 4) on the
    canvas and prop_valid (B, P) bool."""
    model = handle.model
    if getattr(model, "requires_proposals", False):
        return model.simple_test(imgs, img_shapes, scale_factors, pad_shapes, proposals,
                                 prop_valid, rescale=rescale)
    if proposals is not None:
        raise ValueError(f"{type(model).__name__} makes its own proposals")
    return model.simple_test(imgs, img_shapes, scale_factors, pad_shapes, rescale=rescale)


def pipeline_settings(cfg: dict):
    """(canvas, img_scale, mean, std, to_rgb, keep_ratio) of the config's
    test pipeline, read as ``ioudet``'s device-preprocess route reads it:
    Pad and Normalize at the top level or inside MultiScaleFlipAug, Resize
    at the top level (SSD's without keep_ratio), ``ioudet``'s defaults for
    what is left out."""
    canvas, scale, keep_ratio = DEFAULT_CANVAS, DEFAULT_SCALE, True
    mean, std, to_rgb = IMAGENET_MEAN, IMAGENET_STD, True
    for s in cfg.get("data", {}).get("test", {}).get("pipeline", []):
        if s.get("type") == "Resize":
            scale, keep_ratio = tuple(s["img_scale"]), s.get("keep_ratio", True)
        for t in s.get("transforms", [s]):
            if t.get("type") == "Pad" and t.get("size"):
                canvas = tuple(t["size"])
            elif t.get("type") == "Normalize":
                mean = tuple(t.get("mean", mean))
                std = tuple(t.get("std", std))
                to_rgb = bool(t.get("to_rgb", True))
    return canvas, scale, mean, std, to_rgb, keep_ratio


def inference_detector(handle: DetectorHandle, img: Union[str, np.ndarray, torch.Tensor]):
    """img: (H, W, 3) uint8, BGR, or the path of an image file.  Returns
    ``num_classes - 1`` float32 (k, 5) arrays in original-image
    coordinates; for a mask detector (those arrays, per-class lists of RLE
    dicts of the (H, W) image), row for row (``apis.test.to_results``).  A
    detector that ``requires_proposals`` has no route here (nor in
    ``ioudet``): it raises, and ``predict`` takes its proposals."""
    if getattr(handle.model, "requires_proposals", False):
        raise NotImplementedError(f"{type(handle.model).__name__} needs precomputed proposals: "
                                  "inference_detector has no proposal route; call predict "
                                  "with proposals and prop_valid")
    if isinstance(img, str):
        img = imread(img)
    arr = img if isinstance(img, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(img))
    if arr.dtype != torch.uint8 or arr.dim() != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {tuple(arr.shape)} {arr.dtype}")
    canvas, scale, mean, std, to_rgb, keep_ratio = pipeline_settings(handle.cfg)
    h, w = arr.shape[:2]
    if h > w and canvas[0] < canvas[1]:  # portrait images get a portrait canvas
        canvas = (canvas[1], canvas[0])
    dev = handle.device
    canvas_img, img_shape, factor = preprocess(
        arr.to(dev), torch.tensor([h, w], dtype=torch.int32, device=dev),
        canvas=canvas, max_scale=scale, mean=mean, std=std, flip_channels=to_rgb,
        keep_ratio=keep_ratio)
    pad_shape = torch.tensor([canvas], dtype=torch.int32, device=dev)
    outs = predict(handle, canvas_img[None], img_shape[None], factor[None], pad_shape)
    raw = tuple(o[0].cpu().numpy() for o in outs)
    return to_results(raw + ((np.array([h, w]),) if len(raw) > 2 else ()),
                      handle.model.num_result_classes)
