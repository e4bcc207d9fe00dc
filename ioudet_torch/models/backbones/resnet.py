"""ResNet backbone (counterpart of ``ioudet/models/backbones/resnet.py``).

mmdet module names (``conv1``, ``bn1`` / ``gn1``, ``layer{i}.{j}.conv{k}``,
``layer{i}.{j}.downsample.{0,1}``), FrozenBN or GN (``norm_cfg``), plain or
weight-standardized convs (``conv_cfg``), 'pytorch' style (stride on the
3x3) and 'caffe' style (stride on the first 1x1) bottlenecks, and
``frozen_stages``.  Takes NCHW and returns the NCHW stage outputs selected by
``out_indices``.

Bottleneck options, per stage as in ``ioudet``: grouped 3x3 convs (ResNeXt,
``groups`` / ``base_width``), a deformable 3x3 (``stage_with_dcn``, v2 with
``dcn_modulated``: ``conv2_offset`` then ``conv2`` as ``DeformConv``) and a
global-context block after ``bn3`` (``stage_with_gcb``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ...ops.deform_conv import DeformConv
from ..plugins import ContextBlock
from ..utils.layers import Conv2d, build_norm, compute_dtype, conv_class


FROZEN_BN = dict(type="FrozenBN")


def _conv(cin, cout, k, stride=1, dtype=torch.float32, conv_cfg=None, groups=1):
    return conv_class(conv_cfg)(cin, cout, k, stride, (k - 1) // 2, groups=groups, bias=False,
                                compute_dtype=dtype)


class _Block(nn.Module):
    """A residual block's norms under mmdet's names (``bn<i>`` or
    ``gn<i>``), reached as ``norm<i>``."""

    def add_norm(self, index: int, norm_cfg: dict, features: int, dtype) -> None:
        stem, norm = build_norm(norm_cfg, features, dtype)
        self.norm_stem = stem
        self.add_module(f"{stem}{index}", norm)

    def norm(self, index: int) -> nn.Module:
        return getattr(self, f"{self.norm_stem}{index}")

    def downsample_branch(self, inplanes, out, stride, dtype, conv_cfg, norm_cfg):
        return nn.Sequential(_conv(inplanes, out, 1, stride, dtype, conv_cfg),
                             build_norm(norm_cfg, out, dtype)[1])


class BasicBlock(_Block):
    expansion = 1
    last_norm = 2

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, style: str = "pytorch",
                 dtype: torch.dtype = torch.float32, conv_cfg: Optional[dict] = None,
                 norm_cfg: dict = FROZEN_BN):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dtype, conv_cfg)
        self.add_norm(1, norm_cfg, planes, dtype)
        self.conv2 = _conv(planes, planes, 3, dtype=dtype, conv_cfg=conv_cfg)
        self.add_norm(2, norm_cfg, planes, dtype)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = self.downsample_branch(inplanes, planes, stride, dtype, conv_cfg,
                                                 norm_cfg) if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.norm(1)(self.conv1(x)))
        out = self.norm(2)(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(_Block):
    expansion = 4
    last_norm = 3

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, style: str = "pytorch",
                 dtype: torch.dtype = torch.float32, groups: int = 1,
                 base_width: int = 4, with_dcn: bool = False,
                 dcn_modulated: bool = False, with_gcb: bool = False,
                 conv_cfg: Optional[dict] = None, norm_cfg: dict = FROZEN_BN):
        super().__init__()
        if style not in ("pytorch", "caffe"):
            raise ValueError(f"style must be 'pytorch' or 'caffe', got {style!r}")
        c1_stride, c2_stride = (stride, 1) if style == "caffe" else (1, stride)
        # ResNeXt's width rule as ioudet writes it
        width = planes if groups == 1 else int((planes * (base_width / 64.0)) * groups)
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, width, 1, c1_stride, dtype, conv_cfg)
        self.add_norm(1, norm_cfg, width, dtype)
        self.with_dcn, self.dcn_modulated = with_dcn, dcn_modulated
        if with_dcn:
            # offsets (dy, dx a tap), then 9 mask logits for v2; zero init
            self.conv2_offset = Conv2d(width, 27 if dcn_modulated else 18, 3, c2_stride, 1,
                                       compute_dtype=dtype)
            self.conv2 = DeformConv(width, width, 3, c2_stride, compute_dtype=dtype)
        else:
            self.conv2 = _conv(width, width, 3, c2_stride, dtype, conv_cfg, groups)
        self.add_norm(2, norm_cfg, width, dtype)
        self.conv3 = _conv(width, out, 1, dtype=dtype, conv_cfg=conv_cfg)
        self.add_norm(3, norm_cfg, out, dtype)
        self.context_block = ContextBlock(out, dtype=dtype) if with_gcb else None
        self.relu = nn.ReLU(inplace=True)
        self.downsample = self.downsample_branch(inplanes, out, stride, dtype, conv_cfg,
                                                 norm_cfg) if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.norm(1)(self.conv1(x)))
        if self.with_dcn:
            om = self.conv2_offset(out)
            mask = torch.sigmoid(om[:, 18:]) if self.dcn_modulated else None
            out = self.conv2(out, om[:, :18], mask)
        else:
            out = self.conv2(out)
        out = self.relu(self.norm(2)(out))
        out = self.norm(3)(self.conv3(out))
        if self.context_block is not None:
            out = self.context_block(out)
        return self.relu(out + identity)


ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 frozen_stages: int = -1, style: str = "pytorch",
                 norm_cfg: Optional[dict] = None,
                 conv_cfg: Optional[dict] = None,
                 zero_init_residual: bool = False,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 dcn_modulated: bool = False,
                 stage_with_gcb: Sequence[bool] = (False,) * 4,
                 groups: int = 1, base_width: int = 4,
                 gen_attention: Optional[dict] = None,
                 stage_with_gen_attention: Sequence[Sequence[int]] = ((),) * 4,
                 stem_space_to_depth: bool = False,
                 dtype: Union[None, str, torch.dtype] = None):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"invalid depth {depth} for resnet")
        norm_cfg = dict(norm_cfg or FROZEN_BN)
        not_ported = dict(gen_attention=gen_attention is not None,
                          stem_space_to_depth=stem_space_to_depth,
                          # the trainable BN is the Double-Head's (ConvModule)
                          train_mode_bn=norm_cfg.get("type") in ("BN", "SyncBN"))
        for name, used in not_ported.items():
            if used:
                raise NotImplementedError(f"ResNet option {name} is not ported yet")
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.zero_init_residual = zero_init_residual
        block, stage_blocks = ARCH_SETTINGS[depth]
        dtype = compute_dtype(dtype)
        self.conv1 = _conv(3, 64, 7, 2, dtype, conv_cfg)
        self.norm_stem, norm = build_norm(norm_cfg, 64, dtype)
        self.add_module(f"{self.norm_stem}1", norm)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        self.num_stages = num_stages
        for i, num_blocks in enumerate(stage_blocks[:num_stages]):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(num_blocks):
                stride = strides[i] if j == 0 else 1
                downsample = j == 0 and (stride != 1 or
                                         inplanes != planes * block.expansion)
                extra = {}
                if block is Bottleneck:
                    extra = dict(groups=groups, base_width=base_width,
                                 with_dcn=bool(stage_with_dcn[i]), dcn_modulated=dcn_modulated,
                                 with_gcb=bool(stage_with_gcb[i]))
                blocks.append(block(inplanes, planes, stride, downsample, style,
                                    dtype, conv_cfg=conv_cfg, norm_cfg=norm_cfg, **extra))
                inplanes = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self._freeze_stages()

    def _freeze_stages(self) -> None:
        if self.frozen_stages < 0:
            return
        frozen = [self.conv1, self.norm1] + [getattr(self, f"layer{i}")
                                           for i in range(1, self.frozen_stages + 1)]
        for m in frozen:
            for p in m.parameters():
                p.requires_grad_(False)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random init drawn from ``generator``: He-normal (fan_out) convs,
        deformable ones too, zero conv biases (the context blocks'), zero
        offset convs, identity FrozenBN or GN (zero scale on each block's
        last norm when ``zero_init_residual``)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, DeformConv)):
                    o, _, kh, kw = m.weight.shape
                    m.weight.normal_(0.0, math.sqrt(2.0 / (o * kh * kw)),
                                     generator=generator)
                if isinstance(m, nn.Conv2d) and m.bias is not None:
                    m.bias.zero_()
            for m in self.modules():
                if isinstance(m, Bottleneck) and m.with_dcn:
                    m.conv2_offset.weight.zero_()
                    m.conv2_offset.bias.zero_()
            if self.zero_init_residual:
                for m in self.modules():
                    if isinstance(m, _Block):
                        m.norm(m.last_norm).weight.zero_()

    @property
    def norm1(self) -> nn.Module:
        return getattr(self, f"{self.norm_stem}1")

    def forward(self, x: torch.Tensor):
        x = self.maxpool(self.relu(self.norm1(self.conv1(x))))
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
