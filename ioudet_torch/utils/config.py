"""Python-file config system (the port's own copy of
``ioudet/utils/config.py``, so that loading a config by path imports nothing
of the JAX package).

A config is a plain Python file whose module-level names become one nested
attribute-dict (the reference's ``Config.fromfile``); configs are
self-contained, with optional ``_base_`` inheritance.  Kept in step with
``ioudet``'s loader: ``tests/test_torch_inference.py`` holds the two to the
same dict on the flagship config.
"""

from __future__ import annotations

import copy
import os
import types
from typing import Any


class ConfigDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def _wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(ConfigDict._wrap(v) for v in obj)
        return obj


class Config:
    """Loads a python config file into a ConfigDict.

    Usage: ``cfg = Config.fromfile('configs/iou_aware_retinanet_r50_fpn_1x.py')``
    then ``cfg.model``, ``cfg.data.train`` etc.
    """

    def __init__(self, cfg_dict: dict, filename: str | None = None, text: str = ""):
        self._cfg_dict = ConfigDict._wrap(cfg_dict)
        self._filename = filename
        self._text = text

    @staticmethod
    def fromfile(filename: str) -> "Config":
        filename = os.path.abspath(os.path.expanduser(filename))
        if not filename.endswith(".py"):
            raise ValueError(f"only .py configs are supported, got {filename}")
        with open(filename, "r") as f:
            text = f.read()
        cfg_dict = Config._exec(filename, text)
        # optional lightweight `_base_` inheritance
        base = cfg_dict.pop("_base_", None)
        if base is not None:
            if isinstance(base, str):
                base = [base]
            merged: dict = {}
            for b in base:
                bcfg = Config.fromfile(os.path.join(os.path.dirname(filename), b))
                merged = _merge_dict(merged, dict(bcfg._cfg_dict))
            cfg_dict = _merge_dict(merged, cfg_dict)
        return Config(cfg_dict, filename=filename, text=text)

    @staticmethod
    def fromdict(cfg_dict: dict) -> "Config":
        return Config(copy.deepcopy(cfg_dict))

    @staticmethod
    def _exec(filename: str, text: str) -> dict:
        mod = types.ModuleType("_ioudet_config")
        mod.__file__ = filename
        exec(compile(text, filename, "exec"), mod.__dict__)
        return {
            k: v
            for k, v in mod.__dict__.items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)
            and not callable(v)
        }

    @property
    def filename(self):
        return self._filename

    @property
    def text(self):
        return self._text

    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def __getitem__(self, name: str) -> Any:
        return self._cfg_dict[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cfg_dict

    def get(self, name: str, default: Any = None) -> Any:
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def todict(self) -> dict:
        return copy.deepcopy(dict(self._cfg_dict))


def _merge_dict(base: dict, new: dict) -> dict:
    """Recursive override merge.  A child dict carrying ``_delete_=True``
    REPLACES the inherited dict instead of merging into it (the standard
    config convention for swapping a component type whose fields don't
    overlap, e.g. ResNet -> HRNet)."""
    out = dict(base)
    for k, v in new.items():
        if isinstance(v, dict) and v.get("_delete_"):
            v = {vk: vv for vk, vv in v.items() if vk != "_delete_"}
            out[k] = v
        elif k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge_dict(out[k], v)
        else:
            out[k] = v
    return out
