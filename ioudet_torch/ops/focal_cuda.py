"""Fused sigmoid focal loss over one FPN level: wrappers, plain versions and
the autograd function.

The two CUDA kernels of ``ioudet_torch/csrc/focal_kernel.cu`` take the place
of the TPU kernels of ``ioudet/ops/focal_pallas.py``:

  * ``focal_level_sum`` (``focal_sum_kernel``, K3a): the weighted focal sum
    of one level's (B, H, W, A*C) logits, the one-hot target rebuilt from
    integer labels;
  * ``focal_level_dx``  (``focal_dx_kernel``, K3b): that sum's gradient for
    the logits times an upstream scalar, in the logits' type and strides.

Each wrapper launches its kernel for CUDA tensors and runs its plain torch
version (``*_plain``) only for CPU tensors; any other device raises.  The
kernels read the logits through their strides, so the permuted NCHW view the
heads return is consumed where the convolution wrote it.
``FusedLevelFocalSum`` ties the pair into autograd: its forward is
``focal_level_sum`` and its backward ``focal_level_dx``; labels and weights
get no gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ._build import F32, I32, I64, PTR

TILE = 128                 # positions per block (kTile in the source)
MAX_SMEM = 48 * 1024       # dynamic shared memory a launch gets without opting in
TARGET_BLOCKS = 8 * 132    # blocks that keep an H100's 132 SMs busy
MIN_CHUNK = 8              # fewest channels a block is given

_LEVEL = [I32] * 6 + [I64] * 6 + [F32] * 2   # B H W A C split, strides, gamma alpha
LIBRARY = _build.KernelLibrary(
    "focal_kernel.cu", (),
    {"ioudet_focal_sum": [PTR, I32, PTR, PTR, PTR, PTR, PTR] + _LEVEL,
     "ioudet_focal_dx": [PTR, PTR, I32, PTR, PTR, PTR] + _LEVEL},
    kernels=("focal_sum_kernel", "focal_dx_kernel"))


# ---------------------------------------------------------------- plain forms

def _focal_terms(x: torch.Tensor, t: torch.Tensor, gamma: float, alpha: float):
    """The f32 focal chain, elementwise: (loss, d loss / d x).  One exp and
    one log1p, as in the kernels."""
    e = torch.exp(-x.abs())
    p = torch.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
    pt = t + p * (1.0 - 2.0 * t)
    wa = alpha * t + (1.0 - alpha) * (1.0 - t)
    bce = x.clamp(min=0.0) - x * t + torch.log1p(e)
    fw = wa * pt ** gamma
    dfw = wa * gamma * pt ** (gamma - 1.0) * (1.0 - 2.0 * t) * p * (1.0 - p)
    return fw * bce, fw * (p - t) + bce * dfw


def _level_views(logits, labels, lw, num_anchors):
    """x (B, H, W, A, C) f32, one-hot t of that shape, lw (B, H, W, A)."""
    b, h, w, ac = logits.shape
    c = ac // num_anchors
    x = logits.float().reshape(b, h, w, num_anchors, c)
    lab = labels.reshape(b, h, w, num_anchors, 1)
    t = (lab - 1 == torch.arange(c, device=lab.device, dtype=lab.dtype)).float()
    return x, t, lw.reshape(b, h, w, num_anchors)


def focal_level_sum_plain(logits: torch.Tensor, labels: torch.Tensor,
                          lw: torch.Tensor, gamma: float, alpha: float,
                          num_anchors: int) -> torch.Tensor:
    x, t, lwr = _level_views(logits, labels, lw, num_anchors)
    loss, _ = _focal_terms(x, t, gamma, alpha)
    return (loss.sum(dim=-1) * lwr).sum()


def focal_level_dx_plain(g, logits: torch.Tensor, labels: torch.Tensor,
                         lw: torch.Tensor, gamma: float, alpha: float,
                         num_anchors: int) -> torch.Tensor:
    x, t, lwr = _level_views(logits, labels, lw, num_anchors)
    _, dx = _focal_terms(x, t, gamma, alpha)
    g = torch.as_tensor(g, dtype=torch.float32, device=logits.device)
    out = torch.empty_strided(logits.shape, logits.stride(), dtype=logits.dtype,
                              device=logits.device)
    return out.copy_((g * dx * lwr[..., None]).reshape(logits.shape))


# ------------------------------------------------------------------- wrappers

def _check_level(logits, labels, lw, num_anchors) -> Tuple[int, int, int, int, int]:
    _build.check_tensor(logits, "logits", (torch.float32, torch.bfloat16), 4)
    _build.check_tensor(labels, "labels", torch.int32, 2)
    _build.check_tensor(lw, "lw", torch.float32, 2)
    b, h, w, ac = logits.shape
    if ac % num_anchors:
        raise ValueError(f"logits: {ac} channels do not divide into {num_anchors} anchors")
    n = h * w * num_anchors
    if tuple(labels.shape) != (b, n) or tuple(lw.shape) != (b, n):
        raise ValueError(f"labels {tuple(labels.shape)} and lw {tuple(lw.shape)} "
                         f"must be {(b, n)}")
    if not (logits.device == labels.device == lw.device):
        raise ValueError("logits, labels and lw must be on one device")
    return b, h, w, num_anchors, ac // num_anchors


def channel_split(dims, channel_stride: int) -> int:
    """Into how many chunks the kernels split a level's A*C channels, each
    chunk with its own blocks: as many as bring the launch to TARGET_BLOCKS
    blocks, so that a small level is not a few blocks that each walk every
    channel.  1 for a unit channel stride, where threads run along the
    channels."""
    b, h, w, a, c = dims
    if channel_stride == 1:
        return 1
    tiles = b * ((h * w + TILE - 1) // TILE)
    return max(1, min(-(-TARGET_BLOCKS // max(tiles, 1)), a * c // MIN_CHUNK))


def _level_args(logits, labels, lw, dims, gamma, alpha) -> tuple:
    """The kernels' shape, split, stride and constant arguments; raises on
    what they do not take."""
    b, h, w, a, c = dims
    if labels.shape[1] > 1 and (labels.stride(1) != 1 or lw.stride(1) != 1):
        raise ValueError("labels and lw must have unit inner stride")
    smem = TILE * 8 + TILE * a * 8 + a * c * 2
    if smem > MAX_SMEM or a * c >= 1 << 16:
        raise ValueError(f"A={a}, C={c}: the tile needs {smem} B of shared memory "
                         f"(limit {MAX_SMEM})")
    return (b, h, w, a, c, channel_split(dims, logits.stride(3)), *logits.stride(),
            labels.stride(0), lw.stride(0), float(gamma), float(alpha))


def focal_level_sum(logits: torch.Tensor, labels: torch.Tensor, lw: torch.Tensor,
                    gamma: float, alpha: float, num_anchors: int) -> torch.Tensor:
    """Weighted focal sum over one level.

    logits (B, H, W, A*C) f32 or bf16, any strides; labels (B, H*W*A) int32,
    0 = background / 1..C foreground; lw (B, H*W*A) f32 -> scalar f32.
    """
    dims = _check_level(logits, labels, lw, num_anchors)
    if logits.device.type == "cpu":
        return focal_level_sum_plain(logits, labels, lw, gamma, alpha, num_anchors)
    args = _level_args(logits, labels, lw, dims, gamma, alpha)
    b, h, w = dims[:3]
    blocks = b * ((h * w + TILE - 1) // TILE) * args[5]   # tiles x channel split
    dev = logits.device
    if logits.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    partials = torch.empty(blocks, dtype=torch.float64, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    _build.launch(LIBRARY.build().ioudet_focal_sum, "focal_sum_kernel",
                  logits.data_ptr(), int(logits.dtype == torch.bfloat16),
                  labels.data_ptr(), lw.data_ptr(), partials.data_ptr(),
                  counter.data_ptr(), out.data_ptr(), *args)
    return out


def focal_level_dx(g, logits: torch.Tensor, labels: torch.Tensor, lw: torch.Tensor,
                   gamma: float, alpha: float, num_anchors: int) -> torch.Tensor:
    """g * d focal_level_sum / d logits, in the logits' type and strides.
    ``g`` is the upstream scalar: a 0-d tensor on the logits' device (no host
    copy) or a Python number."""
    dims = _check_level(logits, labels, lw, num_anchors)
    if logits.device.type == "cpu":
        return focal_level_dx_plain(g, logits, labels, lw, gamma, alpha, num_anchors)
    args = _level_args(logits, labels, lw, dims, gamma, alpha)
    g = torch.as_tensor(g, dtype=torch.float32, device=logits.device).reshape(())
    dx = torch.empty_strided(logits.shape, logits.stride(), dtype=logits.dtype,
                             device=logits.device)
    if logits.numel():
        _build.launch(LIBRARY.build().ioudet_focal_dx, "focal_dx_kernel",
                      g.data_ptr(), logits.data_ptr(),
                      int(logits.dtype == torch.bfloat16), labels.data_ptr(),
                      lw.data_ptr(), dx.data_ptr(), *args)
    return dx


class FusedLevelFocalSum(torch.autograd.Function):
    """``focal_level_sum`` with ``focal_level_dx`` as its backward: the chain
    is recomputed from the saved inputs, so nothing of the logits' size is
    kept between the passes but the logits themselves."""

    @staticmethod
    def forward(ctx, logits, labels, lw, gamma, alpha, num_anchors):
        ctx.save_for_backward(logits, labels, lw)
        ctx.consts = (gamma, alpha, num_anchors)
        return focal_level_sum(logits, labels, lw, gamma, alpha, num_anchors)

    @staticmethod
    def backward(ctx, grad_out):
        logits, labels, lw = ctx.saved_tensors
        dx = focal_level_dx(grad_out, logits, labels, lw, *ctx.consts)
        return dx, None, None, None, None, None
