"""Shared model building blocks (counterpart of ``ioudet/models/utils/layers.py``).

Modules compute in NCHW; the mmdet state_dict key layout is kept
(``<name>.conv.weight``, BN ``weight/bias/running_mean/running_var``) so
reference checkpoints and the flax bridge load without renaming.

``dtype`` threads ``ioudet``'s compute-dtype policy through every block:
parameters stay f32, so state_dicts and ``.pth`` files do not depend on it;
each convolution and linear layer casts its input, weight and bias to the
compute dtype per call and returns that dtype; FrozenBN folds its statistics
in f32 and casts the folded scale and shift; GN and the trainable BN take
their statistics in f32 and return the compute dtype.  The casts are written out, as in the flax
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


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with f32 parameters that computes in
    ``compute_dtype``, as ``Conv2d``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` with f32 parameters that computes in ``compute_dtype``
    (flax's ``nn.Dense(dtype=...)``): input, weight and bias cast per call."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


NORMS = ("FrozenBN", "GN", "BN")


def check_norm_cfg(norm_cfg: Optional[dict]) -> None:
    if norm_cfg is not None and norm_cfg.get("type") not in NORMS:
        raise NotImplementedError(
            f"norm {norm_cfg.get('type')!r} is not ported yet; available: {sorted(NORMS)}")


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


class GroupNorm(nn.Module):
    """Trainable group norm as flax's ``nn.GroupNorm`` computes it: the
    statistics of each group in f32, the variance as E[x^2] - E[x]^2 floored
    at 0, ``epsilon`` 1e-6 (torch's and mmdet's is 1e-5), then
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in the compute
    dtype.  ``weight`` / ``bias`` are mmdet's names of GN's affine."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels do not split into {num_groups} groups")
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = x.float().reshape(n, self.num_groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = ((g * g).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
        scale = torch.rsqrt(var + self.eps).reshape(n, self.num_groups, 1) * \
            self.weight.reshape(self.num_groups, -1)
        y = (g - mean).reshape(n, self.num_groups, c // self.num_groups, -1) * scale[..., None]
        y = y.reshape(x.shape) + self.bias.reshape(1, c, *([1] * (x.dim() - 2)))
        return y.to(self.dtype)


class BatchNorm(nn.Module):
    """Trainable batch norm as flax's ``nn.BatchNorm`` computes it with the
    numbers ``ioudet``'s ``build_norm`` gives it (momentum 0.9 in flax's
    sense, 0.1 in torch's; epsilon 1e-5): in training the statistics of the
    batch over (N, H, W) in f32, the variance E[x^2] - E[x]^2 floored at 0
    and not Bessel-corrected, and the running statistics moved by ``running
    = 0.9 * running + 0.1 * batch``; in eval the running statistics.  Then
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, returned in the
    compute dtype.  torch's ``BatchNorm2d`` keeps the unbiased variance in its
    running statistics and is not this module.  mmdet's names (``weight``,
    ``bias``, ``running_mean``, ``running_var``).  Under DDP each rank keeps
    its own batch statistics and running buffers (mmdet v1's plain BN)."""

    momentum = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            axes = [d for d in range(x.dim()) if d != 1]
            mean = xf.mean(axes)
            var = ((xf * xf).mean(axes) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype)


def build_norm(norm_cfg: dict, num_features: int, dtype: torch.dtype = torch.float32):
    """(mmdet's name stem, module) of a norm config: ("bn", FrozenBN),
    ("bn", the trainable ``BatchNorm`` of type "BN") or ("gn", GroupNorm of
    ``num_groups``, 32 by default)."""
    check_norm_cfg(norm_cfg)
    if norm_cfg["type"] == "GN":
        return "gn", GroupNorm(norm_cfg.get("num_groups", 32), num_features, dtype=dtype)
    if norm_cfg["type"] == "BN":
        return "bn", BatchNorm(num_features, dtype=dtype)
    return "bn", FrozenBatchNorm(num_features, dtype=dtype)


class ConvWS2d(Conv2d):
    """Weight-standardized convolution (``ioudet``'s ``ConvWS``, mmdet's
    ``ConvWS2d``): each output channel's kernel, over (I, kh, kw), minus its
    mean and divided by its population standard deviation plus ``eps``
    (1e-5 added to the std, not to the variance), then the plain conv.  The
    parameters are ``nn.Conv2d``'s."""

    eps = 1e-5

    def standardized(self) -> torch.Tensor:
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        std = (w - mean).square().mean(dim=(1, 2, 3), keepdim=True).sqrt()
        return (w - mean) / (std + self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.standardized().to(dt), bias)


CONVS = {"Conv": Conv2d, "ConvWS": ConvWS2d}


def conv_class(conv_cfg: Optional[dict]):
    """The conv class of a config's ``conv_cfg`` (None or "Conv": ``Conv2d``,
    "ConvWS": ``ConvWS2d``)."""
    name = (conv_cfg or {}).get("type", "Conv")
    if name not in CONVS:
        raise NotImplementedError(f"conv {name!r} is not ported yet; available: {sorted(CONVS)}")
    return CONVS[name]


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize of an NCHW map to ``size``: source index floor(dst *
    in / out) in f32, clamped, the rule of ``ioudet``'s ``resize_nearest``
    (an exact x2 is its repeat).  The FPN's top-down path and the semantic
    head's fusion share it."""
    return F.interpolate(x, size=tuple(size), mode="nearest")


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's 'SAME' padding of one axis: out = ceil(size / stride), the
    odd pixel of padding goes after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvModule(nn.Module):
    """conv (+ norm) (+ ReLU), in that order (the reference's ConvModule).
    The conv is ``conv_class(conv_cfg)``'s, with a bias only where there is
    no norm; the norm is ``build_norm``'s under mmdet's name, ``bn`` or
    ``gn``.

    ``bias`` overrides that rule (``ioudet``'s FCOS towers put a bias before
    their GN).

    ``padding='SAME'`` follows ``ioudet``'s ConvModule default (XLA 'SAME'),
    which for a stride-2 3x3 conv on an even input pads (0, 1) where mmdet's
    ``padding=1`` pads (1, 1): the FPN's extra convs inherit this from
    ``ioudet`` (ROADMAP.md queue 3).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: Union[str, int] = "SAME",
                 conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None, act: Optional[str] = "relu",
                 dtype: Union[None, str, torch.dtype] = None, bias: Optional[bool] = None):
        super().__init__()
        if act not in ("relu", None):
            raise NotImplementedError(f"activation {act!r} is not ported yet")
        self.kernel_size, self.stride = kernel_size, stride
        # with stride 1 and an odd kernel 'SAME' is the symmetric (k-1)/2;
        # otherwise it depends on the input size and is padded per call
        self.pad_per_call = padding == "SAME" and (stride > 1 or kernel_size % 2 == 0)
        if padding == "SAME":
            padding = 0 if self.pad_per_call else (kernel_size - 1) // 2
        dtype = compute_dtype(dtype)
        self.conv = conv_class(conv_cfg)(in_channels, out_channels, kernel_size, stride,
                                         padding, bias=norm_cfg is None if bias is None else bias,
                                         compute_dtype=dtype)
        self.norm_name = None
        if norm_cfg is not None:
            self.norm_name, norm = build_norm(norm_cfg, out_channels, dtype)
            self.add_module(self.norm_name, norm)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_per_call:
            ph = same_pads(x.shape[2], self.kernel_size, self.stride)
            pw = same_pads(x.shape[3], self.kernel_size, self.stride)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        x = self.conv(x)
        if self.norm_name is not None:
            x = getattr(self, self.norm_name)(x)
        return F.relu(x) if self.act == "relu" else x


class Scale(nn.Module):
    """A learnable scalar multiplier (mmdet's ``Scale``, ``ioudet``'s
    ``layers.Scale``): the parameter ``scale``, 0-d, ``init_value`` at
    construction."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale
