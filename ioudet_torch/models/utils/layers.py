"""Shared model building blocks (counterpart of ``ioudet/models/utils/layers.py``).

Modules compute in NCHW; the mmdet state_dict key layout is kept
(``<name>.conv.weight``, BN ``weight/bias/running_mean/running_var``) so
reference checkpoints and the flax bridge load without renaming.

``dtype`` threads ``ioudet``'s compute-dtype policy through every block:
parameters stay f32, so state_dicts and ``.pth`` files do not depend on it;
each convolution casts its input, weight and bias to the compute dtype per
call and returns that dtype; FrozenBN folds its statistics in f32 and casts
the folded scale and shift.  The casts are written out, as in the flax
modules: ``torch.autocast`` picks its own operators and is not this policy.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


def bias_init_with_prob(prior_prob: float) -> float:
    """RetinaNet's focal init: the bias that makes the initial fg prob
    ``prior_prob``."""
    return float(-math.log((1 - prior_prob) / prior_prob))


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype: Union[None, str, torch.dtype]) -> torch.dtype:
    """The compute dtype named by a config's ``dtype`` entry (a string, a
    torch dtype or None for float32); anything but float32 and bfloat16
    raises."""
    if dtype is None:
        return torch.float32
    if dtype in DTYPES.values():
        return dtype
    if dtype not in DTYPES:
        raise NotImplementedError(f"dtype {dtype!r} is not ported; available: "
                                  f"{sorted(DTYPES)}")
    return DTYPES[dtype]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with f32 parameters that computes in ``compute_dtype``:
    input, weight and bias are cast to it per call, and the output has it."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def check_norm_cfg(norm_cfg: Optional[dict]) -> None:
    if norm_cfg is not None and norm_cfg.get("type") != "FrozenBN":
        raise NotImplementedError(
            f"norm {norm_cfg.get('type')!r} is not ported yet; only FrozenBN "
            "(the inference form of the detection backbones' BN) is")


class FrozenBatchNorm(nn.Module):
    """BatchNorm that always uses its stored statistics (the reference's
    ``norm_eval=True`` + frozen BN): ``x * inv + (bias - mean * inv)`` with
    ``inv = weight / sqrt(var + eps)``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = (self.bias - self.running_mean * inv).to(self.dtype)
        inv = inv.to(self.dtype)
        return x * inv[None, :, None, None] + shift[None, :, None, None]


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's 'SAME' padding of one axis: out = ceil(size / stride), the
    odd pixel of padding goes after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvModule(nn.Module):
    """conv (+ FrozenBN) (+ ReLU), in that order (the reference's ConvModule).

    ``padding='SAME'`` follows ``ioudet``'s ConvModule default (XLA 'SAME'),
    which for a stride-2 3x3 conv on an even input pads (0, 1) where mmdet's
    ``padding=1`` pads (1, 1): the FPN's extra convs inherit this from
    ``ioudet`` (ROADMAP.md queue 3).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: Union[str, int] = "SAME",
                 conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None, act: Optional[str] = "relu",
                 dtype: Union[None, str, torch.dtype] = None):
        super().__init__()
        if (conv_cfg or {}).get("type", "Conv") != "Conv":
            raise NotImplementedError(f"conv {conv_cfg['type']!r} is not ported yet")
        if act not in ("relu", None):
            raise NotImplementedError(f"activation {act!r} is not ported yet")
        check_norm_cfg(norm_cfg)
        self.kernel_size, self.stride = kernel_size, stride
        # with stride 1 and an odd kernel 'SAME' is the symmetric (k-1)/2;
        # otherwise it depends on the input size and is padded per call
        self.pad_per_call = padding == "SAME" and (stride > 1 or kernel_size % 2 == 0)
        if padding == "SAME":
            padding = 0 if self.pad_per_call else (kernel_size - 1) // 2
        dtype = compute_dtype(dtype)
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, bias=norm_cfg is None, compute_dtype=dtype)
        if norm_cfg is not None:
            self.bn = FrozenBatchNorm(out_channels, dtype=dtype)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_per_call:
            ph = same_pads(x.shape[2], self.kernel_size, self.stride)
            pw = same_pads(x.shape[3], self.kernel_size, self.stride)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        x = self.conv(x)
        if hasattr(self, "bn"):
            x = self.bn(x)
        return F.relu(x) if self.act == "relu" else x

