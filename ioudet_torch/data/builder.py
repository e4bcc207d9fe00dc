"""``build_dataset`` (counterpart of ``ioudet/data/builder.py``): a dataset
from the config dicts ``ioudet`` takes.  ``RepeatDataset`` and
``ConcatDataset`` nest; a list of annotation files is a concatenation.  A
``type`` that is not ported raises ``KeyError`` naming those that are."""

from __future__ import annotations

import copy

from .datasets import (CocoDataset, ConcatDataset, CustomDataset, RepeatDataset, VOCDataset,
                       WIDERFaceDataset, XMLDataset)

DATASETS = {c.__name__: c for c in (CustomDataset, CocoDataset, XMLDataset, VOCDataset,
                                    WIDERFaceDataset)}


def _build(cfg: dict):
    args = dict(cfg)
    name = args.pop("type")
    if name not in DATASETS:
        raise KeyError(f"dataset {name!r} is not ported; available: "
                       f"{sorted(DATASETS) + ['ConcatDataset', 'RepeatDataset']}")
    return DATASETS[name](**args)


def build_dataset(cfg: dict):
    cfg = copy.deepcopy(dict(cfg))
    if cfg["type"] == "RepeatDataset":
        return RepeatDataset(build_dataset(cfg["dataset"]), cfg["times"])
    if cfg["type"] == "ConcatDataset":
        return ConcatDataset([build_dataset(c) for c in cfg["datasets"]])
    if isinstance(cfg.get("ann_file"), (list, tuple)):
        prefixes = cfg.get("img_prefix")
        if not isinstance(prefixes, (list, tuple)):
            prefixes = [prefixes] * len(cfg["ann_file"])
        return ConcatDataset([_build(dict(cfg, ann_file=af, img_prefix=pref))
                              for af, pref in zip(cfg["ann_file"], prefixes)])
    return _build(cfg)
