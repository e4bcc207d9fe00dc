"""Weight bridge and checkpoint I/O (counterpart of
``ioudet/apis/checkpoint.py``).

The port's modules use the mmdet state_dict key layout, so a reference
``.pth`` loads as it is.  ``state_dict_from_flax`` turns ``ioudet``'s
parameter tree for the RetinaNet family, SSD, FCOS, FoveaBox, Faster R-CNN /
RPN / Mask R-CNN,
Mask Scoring R-CNN, Grid R-CNN and the cascades (Cascade R-CNN, HTC: a head
a stage, the semantic head), with FPN or the FPN -> BFP chain,
with FrozenBN or GN and plain or weight-standardized convs (nested dicts of
arrays, HWIO conv kernels, (in, out) dense kernels) into that layout: it is
the inverse of ``ioudet``'s ``convert_torch_retinanet``,
``convert_torch_faster_rcnn`` and ``convert_torch_fcn_mask_head`` and their
parts.  Any
tree of that structure goes through it, so gradients and momentum buffers of
``ioudet`` can be laid beside the port's as well.

A training checkpoint is one ``<work_dir>/<name>.pth`` holding the mmdet
payload {meta (epoch, step, ...), state_dict, optimizer}, and a ``latest``
marker file beside it for auto-resume.  ``load_checkpoint`` also reads
``ioudet``'s checkpoint directories (``state.msgpack`` + ``meta.json``,
``ioudet/apis/checkpoint.py``): the parameters through
``state_dict_from_flax``, the optax state into the torch optimizer's
(``load_optax_state``), GHM's EMA bin counts (the 'ghm' collection of its
``model_state``) into the head's buffers, and the meta with its ``step`` and
``epoch``.  The port writes ``.pth`` files only.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.flax_msgpack import msgpack_restore

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _tensor(x) -> torch.Tensor:
    """An f32 copy of a numpy or JAX array or of a torch tensor (a tensor on
    the ``meta`` device stays one, so a tree of shapes bridges too)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _oihw(kernel) -> torch.Tensor:
    """HWIO -> OIHW; a grouped kernel (kh, kw, in / groups, out) becomes
    torch's (out, in / groups, kh, kw)."""
    return _tensor(kernel).permute(3, 2, 0, 1).contiguous()


def _conv(sd: dict, prefix: str, leaf: dict) -> None:
    sd[prefix + ".weight"] = _oihw(leaf["kernel"])
    if "bias" in leaf:
        sd[prefix + ".bias"] = _tensor(leaf["bias"])


def _bn(sd: dict, prefix: str, leaf: dict) -> None:
    for k, v in leaf.items():
        sd[f"{prefix}.{_BN[k]}"] = _tensor(v)


def _norm(sd: dict, parent: str, index: str, leaf: dict) -> None:
    """A norm leaf under mmdet's name: FrozenBN (it has statistics) as
    ``<parent>.bn<index>``, GN (``scale`` / ``bias`` only) as
    ``<parent>.gn<index>``."""
    _bn(sd, f"{parent}.{'bn' if 'mean' in leaf else 'gn'}{index}", leaf)


def _conv_module(sd: dict, prefix: str, node: dict) -> None:
    """``ioudet``'s ConvModule {conv[, norm]} -> ``<prefix>.conv``
    [``<prefix>.bn`` / ``<prefix>.gn``]."""
    for name, leaf in node.items():
        if name == "conv":
            _conv(sd, f"{prefix}.conv", leaf)
        elif name == "norm":
            _norm(sd, prefix, "", leaf)
        else:
            raise KeyError(f"unknown conv module param {prefix}/{name}")


def _context_block(sd: dict, prefix: str, tree: dict) -> None:
    """flax ``context_block/{conv_mask, <fusion>_down, <fusion>_ln,
    <fusion>_up}`` -> mmdet's ``conv_mask``, ``<fusion>_conv.{0,1,3}`` (the
    LayerNorm's affine as (planes, 1, 1))."""
    for name, leaf in tree.items():
        if name == "conv_mask":
            _conv(sd, f"{prefix}.conv_mask", leaf)
            continue
        m = re.fullmatch(r"(channel_(?:add|mul))_(down|ln|up)", name)
        if not m:
            raise KeyError(f"unknown context block param {name}")
        dst = f"{prefix}.{m.group(1)}_conv.{dict(down=0, ln=1, up=3)[m.group(2)]}"
        if m.group(2) == "ln":
            sd[dst + ".weight"] = _tensor(leaf["scale"]).reshape(-1, 1, 1)
            sd[dst + ".bias"] = _tensor(leaf["bias"]).reshape(-1, 1, 1)
        else:
            _conv(sd, dst, leaf)


def _res_block(sd: dict, base: str, node: dict, what: str) -> None:
    """A ResNet block's tree (``conv<i>``, ``bn<i>``, ``downsample_*``,
    DCN's and the context block's) -> mmdet's names under ``base``."""
    for sub, leaf in node.items():
        if sub == "downsample_conv":
            _conv(sd, base + ".downsample.0", leaf)
        elif sub == "downsample_bn":
            _bn(sd, base + ".downsample.1", leaf)
        elif re.fullmatch(r"conv\d", sub) or sub == "conv2_offset":
            _conv(sd, f"{base}.{sub}", leaf)
        elif sub == "conv2_kernel":   # the deformable 3x3, a bare kernel
            sd[f"{base}.conv2.weight"] = _oihw(leaf)
        elif sub == "context_block":
            _context_block(sd, f"{base}.context_block", leaf)
        elif re.fullmatch(r"bn\d", sub):
            _norm(sd, base, sub[2:], leaf)
        else:
            raise KeyError(f"unknown {what} param {sub}")


# flax conv name -> torchvision's VGG-16 ``features`` index (ioudet's
# ``_VGG16_FEATURE_IDX`` inverted; fc6 and fc7 follow pool5)
VGG16_FEATURE_IDX = {
    "conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7,
    "conv3_1": 10, "conv3_2": 12, "conv3_3": 14,
    "conv4_1": 17, "conv4_2": 19, "conv4_3": 21,
    "conv5_1": 24, "conv5_2": 26, "conv5_3": 28,
    "fc6": 31, "fc7": 33,
}


def _ssd_vgg(sd: dict, tree: dict, prefix: str = "backbone") -> None:
    """``SSDVGG``'s tree -> mmdet's ``features.N``, ``extra.N`` and
    ``l2_norm.weight``."""
    for name, leaf in tree.items():
        if name in VGG16_FEATURE_IDX:
            _conv(sd, f"{prefix}.features.{VGG16_FEATURE_IDX[name]}", leaf)
        elif re.fullmatch(r"extra\d+", name):
            _conv(sd, f"{prefix}.extra.{name[5:]}", leaf)
        elif name == "l2norm":
            sd[f"{prefix}.l2_norm.weight"] = _tensor(leaf["gamma"])
        else:
            raise KeyError(f"unknown SSD backbone param {name}")


def _backbone(sd: dict, tree: dict, prefix: str = "backbone", kind: str = "") -> None:
    if kind == "SSDVGG":
        _ssd_vgg(sd, tree, prefix)
        return
    block = re.compile(r"layer(\d+)_(\d+)$")
    for name, node in tree.items():
        if name == "conv1":
            _conv(sd, f"{prefix}.conv1", node)
        elif name == "bn1":
            _norm(sd, prefix, "1", node)
        elif block.match(name):
            stage, idx = block.match(name).groups()
            _res_block(sd, f"{prefix}.layer{stage}.{idx}", node, f"backbone {name}")
        else:
            raise KeyError(f"unknown backbone param {name}")


def _shared_head(sd: dict, tree: dict, prefix: str = "shared_head") -> None:
    """ResLayer's tree {layer<s>_block<j>} -> mmdet's ``layer<s>.<j>``."""
    for name, node in tree.items():
        m = re.fullmatch(r"layer(\d+)_block(\d+)", name)
        if not m:
            raise KeyError(f"unknown shared head param {name}")
        _res_block(sd, f"{prefix}.layer{m.group(1)}.{m.group(2)}", node, f"shared head {name}")


def _neck(sd: dict, tree: dict, prefix: str = "neck") -> None:
    """FPN's tree {lateral_<i>, fpn_<i>, extra_<j>} -> mmdet's lateral_convs /
    fpn_convs; BFP's {refine} -> ``_bfp``; a chain of necks (flax names a
    tuple of submodules ``necks_<i>``) -> mmdet's ``nn.Sequential`` names
    ``<prefix>.<i>``."""
    if any(re.fullmatch(r"necks_\d+", k) for k in tree):
        for name, node in tree.items():
            m = re.fullmatch(r"necks_(\d+)", name)
            if not m:
                raise KeyError(f"unknown neck chain param {name}")
            _neck(sd, node, f"{prefix}.{m.group(1)}")
        return
    if "refine" in tree:
        _bfp(sd, tree, prefix)
        return
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
        _conv_module(sd, f"{prefix}.{dst}", node)


def _bfp(sd: dict, tree: dict, prefix: str) -> None:
    """BFP's refine: a ConvModule {conv} -> ``refine.conv``; the non-local
    block {theta, phi, g, conv_out} -> ``refine.<name>.conv``."""
    for name, node in tree.items():
        if name != "refine":
            raise KeyError(f"unknown BFP param {name}")
        if "conv" in node:
            _conv_module(sd, f"{prefix}.refine", node)
            continue
        for sub, leaf in node.items():
            if sub not in ("theta", "phi", "g", "conv_out"):
                raise KeyError(f"unknown non-local param {sub}")
            _conv(sd, f"{prefix}.refine.{sub}.conv", leaf)


ROI_FEAT_SIZE = 7   # the RoI feature's side in every box head the port builds


def _dense(sd: dict, prefix: str, leaf: dict, roi_input: bool = False) -> None:
    """flax (in, out) kernel -> torch (out, in).  ``roi_input``: the layer
    takes ``ioudet``'s flattened (S, S, C) RoI feature, and the input axis is
    permuted to the port's (C, S, S) (the inverse of ``ioudet``'s
    ``convert_torch_shared_fc_bbox_head``)."""
    w = _tensor(leaf["kernel"]).t()
    if roi_input:
        out, s = w.shape[0], ROI_FEAT_SIZE
        w = w.reshape(out, s, s, -1).permute(0, 3, 1, 2).reshape(out, -1)
    sd[prefix + ".weight"] = w.contiguous()
    sd[prefix + ".bias"] = _tensor(leaf["bias"])


def _roi_head(sd: dict, tree: dict, prefix: str = "bbox_head") -> None:
    """ConvFCBBoxHead's tree {shared_conv<i>, shared_fc<i>, fc_cls, fc_reg}
    -> mmdet's shared_convs.<i>, shared_fcs.<i>, fc_cls, fc_reg; shared_fc0
    takes the flattened RoI feature (after the shared convs) and gets its
    input permuted.  The plain BBoxHead's {fc_cls, fc_reg} is bridged where
    it takes the avg-pooled feature (C4's); on the flattened one it is not."""
    if "shared_fc0" not in tree:
        fan_in = _tensor(tree["fc_cls"]["kernel"]).shape[0]
        if sorted(tree) != ["fc_cls", "fc_reg"] or fan_in % ROI_FEAT_SIZE ** 2 == 0:
            raise NotImplementedError(
                f"box head tree {sorted(tree)} ({fan_in} inputs): ConvFCBBoxHead's with shared "
                "fcs and the avg-pooled BBoxHead's are bridged")
    for name, leaf in tree.items():
        m = re.fullmatch(r"shared_(fc|conv)(\d+)", name)
        if m and m.group(1) == "conv":
            _conv_module(sd, f"{prefix}.shared_convs.{m.group(2)}", leaf)
        elif m:
            _dense(sd, f"{prefix}.shared_fcs.{m.group(2)}", leaf, roi_input=m.group(2) == "0")
        elif name in ("fc_cls", "fc_reg"):
            _dense(sd, f"{prefix}.{name}", leaf)
        else:
            raise KeyError(f"unknown box head param {name}")


# the guided-anchoring heads: their branches cross only where
# ``module_types`` names one of these
GA_HEADS = ("GuidedAnchorHead", "GARetinaHead", "GARPNHead")
GA_BRANCHES = ("conv_loc", "conv_shape", "conv_cls", "conv_reg")


def _head(sd: dict, tree: dict, prefix: str = "bbox_head", kind: str = "") -> None:
    # SSDHead's per-level output convs are bare convs (``cls_convs.i``); the
    # RetinaNet family's towers are ConvModules (``cls_convs.i.conv``)
    tower = "" if kind == "SSDHead" else ".conv"
    for name, leaf in tree.items():
        m = re.fullmatch(r"(cls|reg)_conv(\d+)", name)
        if m:
            _conv(sd, f"{prefix}.{m.group(1)}_convs.{m.group(2)}{tower}", leaf)
        elif name in ("retina_cls", "retina_reg", "retina_iou", "rpn_conv", "rpn_cls",
                      "rpn_reg") or (kind in GA_HEADS and name in GA_BRANCHES):
            _conv(sd, f"{prefix}.{name}", leaf)
        elif name == "feature_adaption" and kind in GA_HEADS:
            _feature_adaption(sd, f"{prefix}.feature_adaption", leaf)
        else:
            raise KeyError(f"unknown head param {name}")


def _feature_adaption(sd: dict, prefix: str, tree: dict) -> None:
    """flax ``FeatureAdaption``'s {conv_offset, adaption_kernel} -> mmdet's
    ``conv_offset`` and ``conv_adaption.weight``."""
    for sub, part in tree.items():
        if sub == "conv_offset":
            _conv(sd, f"{prefix}.conv_offset", part)
        elif sub == "adaption_kernel":
            sd[f"{prefix}.conv_adaption.weight"] = _oihw(part)
        else:
            raise KeyError(f"unknown feature adaption param {sub}")


def _anchor_free_head(sd: dict, tree: dict, prefix: str, kind: str) -> None:
    """FCOSHead's tree {cls_conv<i>, cls_gn<i>, reg_conv<i>, reg_gn<i>,
    fcos_cls, fcos_reg, fcos_centerness, scale<i>} or FoveaHead's
    {cls_conv<i>[_gn], reg_conv<i>[_gn], fovea_cls, fovea_reg,
    feature_adaption/{conv_offset, adaption_kernel}} -> mmdet's
    ``{cls,reg}_convs.<i>.conv`` / ``.gn``, the output convs by their names,
    ``scales.<i>.scale``, ``feature_adaption.conv_offset`` and
    ``feature_adaption.conv_adaption.weight``."""
    outputs = (("fcos_cls", "fcos_reg", "fcos_centerness") if kind == "FCOSHead" else
               ("fovea_cls", "fovea_reg"))
    for name, leaf in tree.items():
        conv = re.fullmatch(r"(cls|reg)_conv(\d+)", name)
        norm = re.fullmatch(r"(cls|reg)_gn(\d+)" if kind == "FCOSHead" else
                            r"(cls|reg)_conv(\d+)_gn", name)
        scale = re.fullmatch(r"scale(\d+)", name) if kind == "FCOSHead" else None
        if conv:
            _conv(sd, f"{prefix}.{conv.group(1)}_convs.{conv.group(2)}.conv", leaf)
        elif norm:
            _bn(sd, f"{prefix}.{norm.group(1)}_convs.{norm.group(2)}.gn", leaf)
        elif scale:
            sd[f"{prefix}.scales.{scale.group(1)}.scale"] = _tensor(leaf["scale"])
        elif name in outputs:
            _conv(sd, f"{prefix}.{name}", leaf)
        elif name == "feature_adaption" and kind == "FoveaHead":
            _feature_adaption(sd, f"{prefix}.feature_adaption", leaf)
        else:
            raise KeyError(f"unknown {kind} param {name}")


ANCHOR_FREE = ("FCOSHead", "FoveaHead")


def _mask_head(sd: dict, tree: dict, prefix: str = "mask_head") -> None:
    """FCNMaskHead's or HTCMaskHead's tree {conv<i>, [conv_res,] upsample,
    conv_logits} -> mmdet's convs.<i>.conv (a GN / WS head's conv<i> is a
    ConvModule: convs.<i>.conv and convs.<i>.gn), conv_res, upsample,
    conv_logits (the inverse of ``ioudet``'s ``convert_torch_fcn_mask_head``).
    flax's ``ConvTranspose`` kernel (kh, kw, in, out) is a forward conv of
    the dilated input, torch's ``ConvTranspose2d`` weight (in, out, kh, kw)
    the gradient of one: the kernel is flipped in both spatial axes on the
    way.  ``conv_logits`` crosses as it is (no background channel on either
    side)."""
    for name, leaf in tree.items():
        m = re.fullmatch(r"conv(\d+)", name)
        if m and "conv" in leaf:
            _conv_module(sd, f"{prefix}.convs.{m.group(1)}", leaf)
        elif m:
            _conv(sd, f"{prefix}.convs.{m.group(1)}.conv", leaf)
        elif name == "conv_res":
            _conv(sd, f"{prefix}.conv_res", leaf)
        elif name == "upsample":
            _deconv(sd, f"{prefix}.upsample", leaf)
        elif name == "conv_logits":
            _conv(sd, f"{prefix}.conv_logits", leaf)
        else:
            raise KeyError(f"unknown mask head param {name}")


def _deconv(sd: dict, prefix: str, leaf: dict) -> None:
    """flax's ``ConvTranspose`` {kernel (kh, kw, in, out), bias} -> torch's
    ``ConvTranspose2d`` (in, out, kh, kw), the kernel flipped in both
    spatial axes (``_mask_head`` says why)."""
    sd[prefix + ".weight"] = _tensor(leaf["kernel"]).flip(0, 1).permute(2, 3, 0, 1).contiguous()
    sd[prefix + ".bias"] = _tensor(leaf["bias"])


def _mask_iou_head(sd: dict, tree: dict, prefix: str = "mask_iou_head") -> None:
    """MaskIoUHead's tree {conv<i>, fc<i>, fc_mask_iou} -> mmdet's convs.<i>,
    fcs.<i>, fc_mask_iou; fc0 takes the flattened (7, 7, C) map after the
    stride-2 conv and gets its input permuted to the port's (C, 7, 7)."""
    for name, leaf in tree.items():
        m = re.fullmatch(r"(conv|fc)(\d+)", name)
        if m and m.group(1) == "conv":
            _conv(sd, f"{prefix}.convs.{m.group(2)}", leaf)
        elif m:
            _dense(sd, f"{prefix}.fcs.{m.group(2)}", leaf, roi_input=m.group(2) == "0")
        elif name == "fc_mask_iou":
            _dense(sd, f"{prefix}.fc_mask_iou", leaf)
        else:
            raise KeyError(f"unknown mask IoU head param {name}")


def _grid_head(sd: dict, tree: dict, prefix: str = "grid_head") -> None:
    """GridHead's tree {conv<i>, gn<i>, fuse_<order>_<j>to<i>, deconv1,
    gn_deconv1, deconv2} -> convs.<i>.conv, convs.<i>.gn,
    fusion_<order>.<j>to<i>, deconv1, norm1, deconv2 (``ioudet``'s
    structure; the pair convs have no mmdet counterpart)."""
    for name, leaf in tree.items():
        m = re.fullmatch(r"(conv|gn)(\d+)", name)
        f = re.fullmatch(r"fuse_(o[12])_(\d+to\d+)", name)
        if m and m.group(1) == "conv":
            _conv(sd, f"{prefix}.convs.{m.group(2)}.conv", leaf)
        elif m:
            _bn(sd, f"{prefix}.convs.{m.group(2)}.gn", leaf)
        elif f:
            _conv(sd, f"{prefix}.fusion_{f.group(1)}.{f.group(2)}", leaf)
        elif name in ("deconv1", "deconv2"):
            _deconv(sd, f"{prefix}.{name}", leaf)
        elif name == "gn_deconv1":
            _bn(sd, f"{prefix}.norm1", leaf)
        else:
            raise KeyError(f"unknown grid head param {name}")


def _semantic_head(sd: dict, tree: dict, prefix: str = "semantic_head") -> None:
    """FusedSemanticHead's tree {lateral<i>, conv<i>, conv_embedding} (each
    a ConvModule) and conv_logits -> mmdet's lateral_convs.<i>, convs.<i>,
    conv_embedding, conv_logits."""
    for name, node in tree.items():
        m = re.fullmatch(r"(lateral|conv)(\d+)", name)
        if m:
            group = "lateral_convs" if m.group(1) == "lateral" else "convs"
            _conv_module(sd, f"{prefix}.{group}.{m.group(2)}", node)
        elif name == "conv_embedding":
            _conv_module(sd, f"{prefix}.conv_embedding", node)
        elif name == "conv_logits":
            _conv(sd, f"{prefix}.conv_logits", node)
        else:
            raise KeyError(f"unknown semantic head param {name}")


def _double_head(sd: dict, tree: dict, prefix: str = "bbox_head") -> None:
    """DoubleConvFCBBoxHead's tree {res_block/{conv1, conv2, conv_identity},
    conv_branch<i>/{conv1, conv2, conv3}, fc_branch<i>, fc_cls, fc_reg} ->
    mmdet's res_block.<conv>, conv_branch.<i>.conv<k> / bn<k> (or gn<k>),
    fc_branch.<i> (fc_branch0's input permuted), fc_cls, fc_reg."""
    for name, node in tree.items():
        m = re.fullmatch(r"(conv|fc)_branch(\d+)", name)
        if name == "res_block":
            for sub, leaf in node.items():
                _conv_module(sd, f"{prefix}.res_block.{sub}", leaf)
        elif m and m.group(1) == "conv":
            for sub, leaf in node.items():
                base = f"{prefix}.conv_branch.{m.group(2)}"
                _conv(sd, f"{base}.{sub}", leaf["conv"])
                _norm(sd, base, sub[4:], leaf["norm"])
        elif m:
            _dense(sd, f"{prefix}.fc_branch.{m.group(2)}", node, roi_input=m.group(2) == "0")
        elif name in ("fc_cls", "fc_reg"):
            _dense(sd, f"{prefix}.{name}", node)
        else:
            raise KeyError(f"unknown double head param {name}")


def _roi_extractor(sd: dict, tree: dict, prefix: str = "bbox_roi_extractor") -> None:
    """The deformable RoI pooling packs {deform_pool<i>/{offset_fc1..3}} ->
    mmdet's roi_layers.<i>.offset_fc.{0,2,4}: offset_fc1's input permuted
    from ``ioudet``'s (S, S, C) flatten to (C, S, S), offset_fc3's outputs
    from (S, S, K) with K = (dy, dx[, mask]) to mmdet's (K', S, S) with K' =
    (dx, dy[, mask])."""
    for name, node in tree.items():
        m = re.fullmatch(r"deform_pool(\d+)", name)
        if not m:
            raise KeyError(f"unknown roi extractor param {name}")
        base = f"{prefix}.roi_layers.{m.group(1)}.offset_fc"
        for sub, leaf in node.items():
            k = {"offset_fc1": 0, "offset_fc2": 2, "offset_fc3": 4}.get(sub)
            if k is None:
                raise KeyError(f"unknown deformable pooling param {name}/{sub}")
            _dense(sd, f"{base}.{k}", leaf, roi_input=k == 0)
            if k == 4:
                s = ROI_FEAT_SIZE
                order = [1, 0, 2]
                for key in (f"{base}.4.weight", f"{base}.4.bias"):
                    t = sd[key]
                    kk = t.shape[0] // (s * s)
                    t = t.reshape(s, s, kk, *t.shape[1:]).movedim(2, 0)[order[:kk]]
                    sd[key] = t.reshape(s * s * kk, *t.shape[3:]).contiguous()


def _box_head(sd: dict, head: dict, prefix: str, kind: str = "") -> None:
    if kind in ANCHOR_FREE:
        _anchor_free_head(sd, head, prefix, kind)
    elif "res_block" in head:
        _double_head(sd, head, prefix)
    elif any(k.startswith(("shared_", "fc_")) for k in head):
        _roi_head(sd, head, prefix)
    elif head:
        _head(sd, head, prefix, kind)


_STAGE = re.compile(r"(bbox_head|mask_head)_(\d+)$")


def module_types(model: torch.nn.Module) -> Dict[str, str]:
    """{parameter group: the class name of the port's module there} of a
    detector: the ``types`` that ``state_dict_from_flax`` dispatches on."""
    return {name: type(child).__name__ for name, child in model.named_children()}


def state_dict_from_flax(params: dict, types: Optional[Dict[str, str]] = None
                         ) -> Dict[str, torch.Tensor]:
    """``ioudet`` params of the RetinaNet family {backbone, neck, bbox_head},
    of SSD {backbone (SSDVGG), bbox_head},
    of Faster R-CNN / RPN / Mask R-CNN {backbone, neck, rpn_head,
    bbox_head[, mask_head[, mask_iou_head]]} (Grid R-CNN's with grid_head;
    Fast R-CNN's without rpn_head; the C4 form's
    ``shared_head``; deformable pooling's ``bbox_roi_extractor``) or of a
    cascade (flax's ``bbox_head_<i>`` / ``mask_head_<i>`` a stage, HTC's
    ``semantic_head``) -> a state_dict for the port's detector (mmdet key
    layout, a stage's heads under ``bbox_head.<i>`` / ``mask_head.<i>``).
    A trainable BN's affine (the Double-Head's) crosses under GN's name:
    its statistics would be flax's ``batch_stats``, which no ``ioudet``
    checkpoint holds (its BN ConvModule cannot run).  A partial tree (a
    pretrained backbone alone, or the trainable leaves of an optimizer
    state) gives the entries it holds.  ``types`` (``module_types`` of the
    detector) names the backbone's and the box head's families where the
    tree's names alone do not: ``SSDVGG`` and ``SSDHead`` are bridged only
    when named there; without them the ResNet and RetinaNet forms are taken,
    and an SSD tree raises at its first VGG name.  FCOS's and FoveaBox's
    heads (``FCOSHead``, ``FoveaHead``) too are bridged only when named
    there; without them their names raise as unknown head params.  So are
    the guided-anchoring heads' branches (``GA_HEADS``, as ``bbox_head`` or
    ``rpn_head``): {conv_loc, conv_shape, feature_adaption/{conv_offset,
    adaption_kernel}, conv_cls, conv_reg} beside the towers or the trunk."""
    types = types or {}
    unknown = {k for k in params if not _STAGE.match(k)} - {
        "backbone", "neck", "rpn_head", "bbox_head", "mask_head", "semantic_head",
        "shared_head", "bbox_roi_extractor", "mask_iou_head", "grid_head"}
    if unknown:
        raise KeyError(f"unsupported parameter groups: {sorted(unknown)}")
    sd: Dict[str, torch.Tensor] = {}
    if "backbone" in params:
        _backbone(sd, params["backbone"], kind=types.get("backbone", ""))
    if "neck" in params:
        _neck(sd, params["neck"])
    if "rpn_head" in params:
        _head(sd, params["rpn_head"], "rpn_head", types.get("rpn_head", ""))
    if "bbox_roi_extractor" in params:
        _roi_extractor(sd, params["bbox_roi_extractor"])
    if "shared_head" in params:
        _shared_head(sd, params["shared_head"])
    _box_head(sd, params.get("bbox_head", {}), "bbox_head", types.get("bbox_head", ""))
    if "mask_head" in params:
        _mask_head(sd, params["mask_head"])
    for name, tree in params.items():
        m = _STAGE.match(name)
        if m and m.group(1) == "bbox_head":
            _box_head(sd, tree, f"bbox_head.{m.group(2)}")
        elif m:
            _mask_head(sd, tree, f"mask_head.{m.group(2)}")
    if "semantic_head" in params:
        _semantic_head(sd, params["semantic_head"])
    if "mask_iou_head" in params:
        _mask_iou_head(sd, params["mask_iou_head"])
    if "grid_head" in params:
        _grid_head(sd, params["grid_head"])
    return sd


def _prune(tree):
    """The tree without its empty dicts: optax's ``MaskedNode`` (a frozen
    leaf's place in a masked optimizer state) is written as ``{}``."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _prune(v) for k, v in tree.items()}
    return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}


def _optax_leaves(tree, found: list) -> list:
    """The optimizer states in an optax state tree, as flax writes it
    (``multi_transform``'s ``inner_states``, ``chain``'s '0', '1', ...): the
    dicts that hold a momentum ``trace`` or Adam's ``mu`` / ``nu`` /
    ``count``."""
    if isinstance(tree, dict):
        if "trace" in tree or {"mu", "nu", "count"} <= set(tree):
            found.append(tree)
        else:
            for v in tree.values():
                _optax_leaves(v, found)
    return found


def load_optax_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     opt_state: dict) -> None:
    """``ioudet``'s optax state (as restored from a checkpoint directory)
    into ``optimizer``'s: a momentum ``trace`` into SGD's
    ``momentum_buffer``, Adam's ``mu`` / ``nu`` / ``count`` into AdamW's
    ``exp_avg`` / ``exp_avg_sq`` / ``step``.  Every parameter the optimizer
    trains must find its state, and every state its parameter."""
    found = _optax_leaves(opt_state, [])
    if len(found) != 1:
        raise KeyError(f"expected one momentum or Adam state in the optax state, found "
                       f"{len(found)}")
    leaf, types = found[0], module_types(model)
    names = {id(p): n for n, p in model.named_parameters()}
    trained = {names[id(p)]: p for g in optimizer.param_groups for p in g["params"]}
    if "trace" in leaf:
        if not isinstance(optimizer, torch.optim.SGD):
            raise TypeError(f"a momentum trace needs SGD, not {type(optimizer).__name__}")
        slots = {"momentum_buffer": state_dict_from_flax(_prune(leaf["trace"]), types)}
    else:
        if not isinstance(optimizer, torch.optim.AdamW):
            raise TypeError(f"an Adam state needs AdamW, not {type(optimizer).__name__}")
        slots = {"exp_avg": state_dict_from_flax(_prune(leaf["mu"]), types),
                 "exp_avg_sq": state_dict_from_flax(_prune(leaf["nu"]), types)}
    slots = {slot: _norm_names(sd, trained) for slot, sd in slots.items()}
    for slot, sd in slots.items():
        if set(sd) != set(trained):
            raise KeyError(f"optax {slot} state for {sorted(set(sd) ^ set(trained))[:8]}: "
                           "not the parameters the optimizer trains")
    for name, p in trained.items():
        state = {slot: sd[name].to(p.device) for slot, sd in slots.items()}
        if "count" in leaf:
            state["step"] = torch.tensor(float(np.asarray(leaf["count"])))
        optimizer.state[p] = state


def _norm_names(sd: dict, names) -> dict:
    """A bridged partial tree's norm entries under the model's names: a
    FrozenBN's trainable leaves (scale and bias, without its statistics)
    bridge as GN's ``gn<i>``; where the model has ``bn<i>`` there instead,
    that name is taken."""
    out = {}
    for k, v in sd.items():
        alt = re.sub(r"\.gn(\d*)\.", r".bn\1.", k)
        out[alt if k not in names and alt in names else k] = v
    return out


def read_flax_checkpoint(path: str) -> Tuple[dict, dict]:
    """(state tree, meta) of an ``ioudet`` checkpoint directory."""
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        state = msgpack_restore(f.read())
    meta_path = os.path.join(path, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


_BLOCK = re.compile(r"backbone\.layer(\d+)\.(\d+)\.(conv\d|downsample\.0)$")
_FLAX_BLOCK = re.compile(r"backbone/layer(\d+)_(\d+)/(conv\d|downsample_conv)$")


def conv_path_to_flax(path: str, num_laterals: int) -> str:
    """The port's module path of a convolution -> ``ioudet``'s
    ("/".join(mod.path)), by the name map of ``state_dict_from_flax``."""
    m = _BLOCK.match(path)
    if m:
        leaf = "downsample_conv" if m.group(3).startswith("down") else m.group(3)
        return f"backbone/layer{m.group(1)}_{m.group(2)}/{leaf}"
    if path == "backbone.conv1":
        return "backbone/conv1"
    m = re.fullmatch(r"neck\.(lateral|fpn)_convs\.(\d+)\.conv", path)
    if m:
        group, idx = m.group(1), int(m.group(2))
        if group == "fpn" and idx >= num_laterals:
            group, idx = "extra", idx - num_laterals
        return f"neck/{group}_{idx}/conv"
    m = re.fullmatch(r"bbox_head\.(cls|reg)_convs\.(\d+)\.conv", path)
    if m:
        return f"bbox_head/{m.group(1)}_conv{m.group(2)}"
    m = re.fullmatch(r"bbox_head\.(retina_(?:cls|reg|iou))", path)
    if m:
        return f"bbox_head/{m.group(1)}"
    raise KeyError(f"unknown convolution path {path}")


def conv_path_from_flax(path: str, num_laterals: int) -> str:
    """The inverse of ``conv_path_to_flax``."""
    m = _FLAX_BLOCK.match(path)
    if m:
        leaf = "downsample.0" if m.group(3) == "downsample_conv" else m.group(3)
        return f"backbone.layer{m.group(1)}.{m.group(2)}.{leaf}"
    if path == "backbone/conv1":
        return "backbone.conv1"
    m = re.fullmatch(r"neck/(lateral|fpn|extra)_(\d+)/conv", path)
    if m:
        group, idx = m.group(1), int(m.group(2))
        if group == "extra":
            group, idx = "fpn", idx + num_laterals
        return f"neck.{group}_convs.{idx}.conv"
    m = re.fullmatch(r"bbox_head/(cls|reg)_conv(\d+)", path)
    if m:
        return f"bbox_head.{m.group(1)}_convs.{m.group(2)}.conv"
    m = re.fullmatch(r"bbox_head/(retina_(?:cls|reg|iou))", path)
    if m:
        return f"bbox_head.{m.group(1)}"
    raise KeyError(f"unknown convolution path {path}")


def act_scales_from_flax(scales: Dict[str, float],
                         num_laterals: Optional[int] = None) -> Dict[str, float]:
    """A ``calibrate`` dict of ``ioudet.ops.quant`` (keys "/".join(mod.path))
    -> one for ``ioudet_torch.ops.quant.quantize_calls`` (keys the port's
    module paths).  ``num_laterals`` defaults to the number of lateral convs
    the dict names."""
    if num_laterals is None:
        num_laterals = sum(1 for k in scales if k.startswith("neck/lateral_"))
    return {conv_path_from_flax(k, num_laterals): float(v) for k, v in scales.items()}


def act_scales_to_flax(scales: Dict[str, float],
                       num_laterals: Optional[int] = None) -> Dict[str, float]:
    """The inverse of ``act_scales_from_flax``: the port's ``calibrate`` dict
    -> one for ``ioudet.ops.quant.quantize_calls``."""
    if num_laterals is None:
        num_laterals = sum(1 for k in scales if k.startswith("neck.lateral_convs."))
    return {conv_path_to_flax(k, num_laterals): float(v) for k, v in scales.items()}


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


def read_weights(filename: str, types: Optional[Dict[str, str]] = None
                 ) -> Tuple[Dict[str, torch.Tensor], dict, dict]:
    """(state_dict, optimizer state, meta) of a checkpoint: an mmdet-layout
    ``.pth`` (a state_dict, or a dict holding one under ``state_dict``; the
    optimizer state is torch's) or an ``ioudet`` directory (the parameters
    bridged, ``types`` as ``state_dict_from_flax`` takes them; the optimizer
    state is optax's tree, ``{}`` where there is none)."""
    if os.path.isdir(filename):
        state, meta = read_flax_checkpoint(filename)
        model_state = dict(state.get("model_state") or {})
        ghm = model_state.pop("ghm", {})
        if model_state:
            raise NotImplementedError(f"{filename}: model_state collection(s) "
                                      f"{sorted(model_state)} are not ported (the port reads "
                                      "'ghm', GHM's EMA bin counts)")
        sd = state_dict_from_flax(state.get("params", state), types)
        sd.update(ghm_buffers(ghm))
        return sd, state.get("opt_state") or {}, meta
    ckpt = torch.load(filename, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict):
        raise TypeError(f"{filename}: expected a dict, got {type(ckpt)}")
    sd = ckpt.get("state_dict", ckpt)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    check_ga_adaption(sd, types or {})
    return sd, ckpt.get("optimizer") or {}, ckpt.get("meta", {})


def check_ga_adaption(sd: dict, types: Dict[str, str]) -> None:
    """Raise ``NotImplementedError`` where a state_dict's guided-anchoring
    head is mmdet's form: ``GARetinaHead`` there has two adaptions
    (``feature_adaption_cls`` / ``_reg``) and mmdet's adaptions 4
    deformable groups (a 72-channel ``conv_offset``); the port's head, as
    ``ioudet``'s, has one adaption of one group (18 channels)."""
    for part, kind in types.items():
        if kind not in GA_HEADS:
            continue
        offset = sd.get(f"{part}.feature_adaption.conv_offset.weight")
        if (any(k.startswith((f"{part}.feature_adaption_cls.", f"{part}.feature_adaption_reg."))
                for k in sd) or (offset is not None and offset.shape[0] != 18)):
            raise NotImplementedError(
                f"{part}: mmdet's {kind} weights (two feature adaptions with 4 deformable "
                "groups, a 72-channel conv_offset) are not bridged: the port's head, as "
                "ioudet's, has one adaption of one group (18 channels)")


def ghm_buffers(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``ioudet``'s 'ghm' collection ({head: {cls_acc_sum, bbox_acc_sum}})
    -> the heads' buffers under their state_dict names."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update(ghm_buffers(node, f"{prefix}{name}."))
        else:
            out[prefix + name] = _tensor(node)
    return out


def load_checkpoint(model: torch.nn.Module, filename: str, strict: bool = True,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> dict:
    """Load a checkpoint (``read_weights``: a ``.pth`` or an ``ioudet``
    directory) into ``model`` and, when ``optimizer`` is given and the
    checkpoint holds its state, into the optimizer.  Returns the
    checkpoint's ``meta`` (``epoch``, ``step``, ...)."""
    sd, opt_state, meta = read_weights(filename, module_types(model))
    model.load_state_dict(sd, strict=strict)
    if optimizer is not None and opt_state:
        if os.path.isdir(filename):
            load_optax_state(model, optimizer, opt_state)
        else:
            optimizer.load_state_dict(opt_state)
    return meta


def merge_weights(model: torch.nn.Module, filename: str) -> list:
    """``load_from``: the checkpoint's weights over the model's own (a
    partial tree, such as a pretrained backbone, leaves the rest as it
    was).  A name the model does not have or a shape that differs raises.
    Returns the names loaded."""
    sd, _, _ = read_weights(filename, module_types(model))
    own = model.state_dict()
    unknown = sorted(set(sd) - set(own))
    if unknown:
        raise KeyError(f"{filename}: {len(unknown)} names the model does not have: "
                       f"{unknown[:8]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{filename}: {k} has shape {tuple(v.shape)}, the model "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=False)
    return sorted(sd)
