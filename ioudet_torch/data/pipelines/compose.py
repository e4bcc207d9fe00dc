"""Pipeline composition (counterpart of
``ioudet/data/pipelines/compose.py``) and the port's table of pipeline
steps, in the idiom of the port's model tables (``build_detector``): a
config step names its class by ``type``; a type that is not ported raises
``KeyError`` naming those that are."""

from __future__ import annotations

from .formatting import Collect, DefaultFormatBundle, ImageToTensor
from .loading import LoadAnnotations, LoadImageFromFile, LoadProposals
from .test_aug import MultiScaleFlipAug
from .transforms import (Expand, MinIoURandomCrop, Normalize, Pad, PhotoMetricDistortion,
                         RandomFlip, Resize, SegRescale)

PIPELINES = {c.__name__: c for c in (
    LoadImageFromFile, LoadAnnotations, LoadProposals, Resize, RandomFlip, Normalize, Pad,
    SegRescale, PhotoMetricDistortion, Expand, MinIoURandomCrop, DefaultFormatBundle,
    ImageToTensor, Collect, MultiScaleFlipAug)}


def build_step(cfg: dict):
    args = dict(cfg)
    name = args.pop("type")
    if name not in PIPELINES:
        raise KeyError(f"pipeline step {name!r} is not ported; available: {sorted(PIPELINES)}")
    return PIPELINES[name](**args)


class Compose:
    """Runs the steps in order; a step that returns None ends the sample
    (None)."""

    def __init__(self, transforms):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                self.transforms.append(build_step(t))
            elif callable(t):
                self.transforms.append(t)
            else:
                raise TypeError(f"transform must be a dict or a callable, got {t!r}")

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results

    def __repr__(self):
        return f"Compose({self.transforms})"
