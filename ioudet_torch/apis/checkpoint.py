"""Weight bridge and checkpoint loading (counterpart of
``ioudet/apis/checkpoint.py``).

The port's modules use the mmdet state_dict key layout, so a reference
``.pth`` loads as it is.  ``state_dict_from_flax`` turns ``ioudet``'s
parameter tree for the RetinaNet family (nested dicts of arrays, HWIO conv
kernels) into that layout: it is the inverse of ``ioudet``'s
``convert_torch_retinanet`` and its resnet / fpn / retina-head parts.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _oihw(kernel) -> torch.Tensor:
    return _tensor(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _conv(sd: dict, prefix: str, leaf: dict) -> None:
    sd[prefix + ".weight"] = _oihw(leaf["kernel"])
    if "bias" in leaf:
        sd[prefix + ".bias"] = _tensor(leaf["bias"])


def _bn(sd: dict, prefix: str, leaf: dict) -> None:
    for k, v in leaf.items():
        sd[f"{prefix}.{_BN[k]}"] = _tensor(v)


def _backbone(sd: dict, tree: dict, prefix: str = "backbone") -> None:
    block = re.compile(r"layer(\d+)_(\d+)$")
    for name, node in tree.items():
        if name == "conv1":
            _conv(sd, f"{prefix}.conv1", node)
        elif name == "bn1":
            _bn(sd, f"{prefix}.bn1", node)
        elif block.match(name):
            stage, idx = block.match(name).groups()
            base = f"{prefix}.layer{stage}.{idx}"
            for sub, leaf in node.items():
                if sub == "downsample_conv":
                    _conv(sd, base + ".downsample.0", leaf)
                elif sub == "downsample_bn":
                    _bn(sd, base + ".downsample.1", leaf)
                elif re.fullmatch(r"conv\d", sub):
                    _conv(sd, f"{base}.{sub}", leaf)
                elif re.fullmatch(r"bn\d", sub):
                    _bn(sd, f"{base}.{sub}", leaf)
                else:
                    raise KeyError(f"unknown backbone param {name}/{sub}")
        else:
            raise KeyError(f"unknown backbone param {name}")


def _neck(sd: dict, tree: dict, prefix: str = "neck") -> None:
    num_laterals = sum(1 for k in tree if k.startswith("lateral_"))
    for name, node in tree.items():
        group, idx = name.rsplit("_", 1)
        idx = int(idx)
        if group == "lateral":
            dst = f"lateral_convs.{idx}"
        elif group == "fpn":
            dst = f"fpn_convs.{idx}"
        elif group == "extra":  # mmdet keeps the extra convs in fpn_convs
            dst = f"fpn_convs.{num_laterals + idx}"
        else:
            raise KeyError(f"unknown neck param {name}")
        _conv(sd, f"{prefix}.{dst}.conv", node["conv"])


def _head(sd: dict, tree: dict, prefix: str = "bbox_head") -> None:
    for name, leaf in tree.items():
        m = re.fullmatch(r"(cls|reg)_conv(\d+)", name)
        if m:
            _conv(sd, f"{prefix}.{m.group(1)}_convs.{m.group(2)}.conv", leaf)
        elif name in ("retina_cls", "retina_reg", "retina_iou"):
            _conv(sd, f"{prefix}.{name}", leaf)
        else:
            raise KeyError(f"unknown head param {name}")


def state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """``ioudet`` RetinaNet-family params {backbone, neck, bbox_head} -> a
    state_dict for the port's detector (mmdet key layout)."""
    unknown = set(params) - {"backbone", "neck", "bbox_head"}
    if unknown:
        raise KeyError(f"unsupported parameter groups: {sorted(unknown)}")
    sd: Dict[str, torch.Tensor] = {}
    _backbone(sd, params["backbone"])
    if "neck" in params:
        _neck(sd, params["neck"])
    _head(sd, params["bbox_head"])
    return sd


def load_checkpoint(model: torch.nn.Module, filename: str,
                    strict: bool = True) -> dict:
    """Load an mmdet-layout ``.pth`` (a state_dict, or a dict holding one
    under ``state_dict``) into ``model``.  Returns the checkpoint's ``meta``.
    ``ioudet``'s flax checkpoint directories are not read yet."""
    if os.path.isdir(filename):
        raise NotImplementedError(
            "flax msgpack checkpoint directories are not supported yet; "
            "convert with state_dict_from_flax")
    ckpt = torch.load(filename, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict):
        raise TypeError(f"{filename}: expected a dict, got {type(ckpt)}")
    sd = ckpt.get("state_dict", ckpt)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    model.load_state_dict(sd, strict=strict)
    return ckpt.get("meta", {})
