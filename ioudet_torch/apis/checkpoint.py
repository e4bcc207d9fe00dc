"""Weight bridge and checkpoint I/O (counterpart of
``ioudet/apis/checkpoint.py``).

The port's modules use the mmdet state_dict key layout, so a reference
``.pth`` loads as it is.  ``state_dict_from_flax`` turns ``ioudet``'s
parameter tree for the RetinaNet family (nested dicts of arrays, HWIO conv
kernels) into that layout: it is the inverse of ``ioudet``'s
``convert_torch_retinanet`` and its resnet / fpn / retina-head parts.  Any
tree of that structure goes through it, so gradients and momentum buffers of
``ioudet`` can be laid beside the port's as well.

A training checkpoint is one ``<work_dir>/<name>.pth`` holding the mmdet
payload {meta (epoch, step, ...), state_dict, optimizer}, and a ``latest``
marker file beside it for auto-resume.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

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


def save_checkpoint(work_dir: str, name: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    meta: Optional[dict] = None) -> str:
    """Write ``<work_dir>/<name>.pth`` and point ``<work_dir>/latest`` at it.
    Returns the path."""
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, name + ".pth")
    ckpt = dict(meta=meta or {}, state_dict=model.state_dict())
    if optimizer is not None:
        ckpt["optimizer"] = optimizer.state_dict()
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    with open(os.path.join(work_dir, "latest"), "w") as f:
        f.write(name + ".pth")
    return path


def latest_checkpoint(work_dir: str) -> Optional[str]:
    marker = os.path.join(work_dir, "latest")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return os.path.join(work_dir, f.read().strip())


def load_checkpoint(model: torch.nn.Module, filename: str, strict: bool = True,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> dict:
    """Load an mmdet-layout ``.pth`` (a state_dict, or a dict holding one
    under ``state_dict``) into ``model`` and, when ``optimizer`` is given and
    the file holds its state, into the optimizer.  Returns the checkpoint's
    ``meta``.  ``ioudet``'s flax checkpoint directories are not read yet."""
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
    if optimizer is not None and "optimizer" in ckpt:
        optimizer.load_state_dict(ckpt["optimizer"])
    return ckpt.get("meta", {})
