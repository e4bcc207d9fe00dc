"""Fused sigmoid focal loss over one FPN level: wrappers, plain versions and
the autograd function.

The two CUDA kernels of ``ioudet_torch/csrc/focal_kernel.cu`` take the place
of the TPU kernels of ``ioudet/ops/focal_pallas.py``:

  * ``focal_level_sum`` (``focal_sum_kernel``, K3a): the weighted focal sum
    of one level's (B, H, W, A*C) logits, the one-hot target rebuilt from
    integer labels.  ``sum_vector`` and ``sum_plan`` (pure functions of the
    shapes, strides and the card's counts) choose its route and grid;
  * ``focal_level_dx``  (``focal_dx_kernel``, K3b): that sum's gradient for
    the logits times an upstream scalar, in the logits' type and strides, on
    the sum's units and wave (``dx_vector`` asks the logits' and dx's base
    addresses for the run's grid).

Each wrapper launches its kernel for CUDA tensors and runs its plain torch
version (``*_plain``) only for CPU tensors; any other device raises.  The
kernels read the logits through their strides, so the permuted NCHW view the
heads return is consumed where the convolution wrote it.
``FusedLevelFocalSum`` ties the pair into autograd: its forward is
``focal_level_sum`` and its backward ``focal_level_dx``; labels and weights
get no gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from ._build import F32, I32, I64, PTR

MIN_CHUNK = 8              # fewest classes a unit is given (or all C)
SUM_THREADS = 256          # threads a block of either kernel (kThreads in the source)
RUN_BYTES = 16             # the widest load of a run of positions
UNIT_COST = 2              # a unit's own work (indices, labels, weights), in classes:
                           # fitted to the sum kernel's times over chunks of 8-80 on an H100;
                           # the dx kernel's chunk sweeps at P3-P7 agree

_LEVEL = [I32] * 8 + [I64] * 6 + [F32] * 2   # B H W A C vec chunk blocks, strides, gamma alpha
LIBRARY = _build.KernelLibrary(
    "focal_kernel.cu", (),
    {"ioudet_focal_sum": [PTR, I32, PTR, PTR, PTR, PTR, PTR] + _LEVEL,
     "ioudet_focal_sum_fit": [I32, I32, I32, PTR],
     "ioudet_focal_dx": [PTR, PTR, I32, PTR, PTR, PTR] + _LEVEL,
     "ioudet_focal_dx_fit": [I32, I32, I32, PTR]},
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


def sum_vector(dims, strides, itemsize: int, address: int) -> int:
    """Positions a thread of the sum kernel loads at once: the most, up to
    RUN_BYTES of logits (4 f32, 8 bf16), that keep every run's load on its
    own grid.  That needs the positions to be a channel plane's unit-stride
    axis (the permuted NCHW view: sw = 1, sh = W) and H*W, the channel and
    image strides and the base address to be multiples of the run; else 1
    (an odd H*W, a contiguous NHWC tensor, any other strides)."""
    b, h, w, a, c = dims
    sb, sh, sw, sc = strides
    if not ((w == 1 or sw == 1) and (h == 1 or sh == w)):
        return 1
    v = RUN_BYTES // itemsize
    while v > 1 and ((h * w) % v or (a * c > 1 and sc % v) or (b > 1 and sb % v)
                     or address % (v * itemsize)):
        v //= 2
    return v


def dx_vector(dims, strides, itemsize: int, address: int, dx_address: int) -> int:
    """Positions a thread of the dx kernel loads and stores at once:
    ``sum_vector``'s run, on the grid of both base addresses (dx shares the
    logits' strides, not their allocation)."""
    return sum_vector(dims, strides, itemsize, address | dx_address)


@functools.lru_cache(maxsize=256)
def sum_plan(dims, vec: int, sms: int, resident: int) -> Tuple[int, int]:
    """(classes a unit, blocks) of the sum kernel, and of the dx kernel on
    its own ``vec`` and ``resident``.  The grid is at most one
    wave, ``sms`` x ``resident`` blocks.  A unit is a run of ``vec``
    positions of one image and anchor and a chunk of its classes; the chunk
    is the one of at least MIN_CHUNK classes (or all C) that gives the
    busiest thread the least work, chunk + UNIT_COST a unit, when the units
    are dealt out over the wave in turn (ties to the longer chunk), so that a
    small level fills the card and a large one ends with no thread left a
    whole unit behind."""
    b, h, w, a, c = dims
    runs = b * a * (h * w // vec)
    wave = sms * resident * SUM_THREADS
    best = None
    for chunk in range(c, min(c, MIN_CHUNK) - 1, -1):
        units = runs * -(-c // chunk)
        busiest = -(-units // wave) * (chunk + UNIT_COST)
        if best is None or busiest < best[0]:
            best = (busiest, chunk, units)
    _, chunk, units = best
    return chunk, max(1, min(sms * resident, -(-units // SUM_THREADS)))


_RESIDENT: dict = {}


def resident_blocks(kernel: str, device, dtype: torch.dtype, vec: int, gamma2: bool) -> int:
    """Blocks of the ``kernel`` ("sum" or "dx") instance for (type, vec,
    gamma == 2) that an SM holds at once, asked of the runtime once per
    device and instance."""
    device = torch.device(device)
    key = (kernel, device.index if device.index is not None else torch.cuda.current_device(),
           dtype, vec, gamma2)
    if key not in _RESIDENT:
        count = ctypes.c_int(0)
        err = getattr(LIBRARY.build(), f"ioudet_focal_{kernel}_fit")(
            int(dtype == torch.bfloat16), vec, int(gamma2), ctypes.addressof(count), None)
        if err != 0 or count.value < 1:
            raise RuntimeError(f"focal_{kernel}_kernel: occupancy query failed "
                               f"({err}, {count.value})")
        _RESIDENT[key] = count.value
    return _RESIDENT[key]


def launch_plan(kernel: str, logits: torch.Tensor, num_anchors: int, gamma: float,
                vec: int) -> dict:
    """The ``kernel``'s ("sum" or "dx") plan for these CUDA logits on runs of
    ``vec``: vec, classes a unit (chunk), blocks, the blocks an SM holds
    (resident) and SMs."""
    b, h, w, ac = logits.shape
    dims = (b, h, w, num_anchors, ac // num_anchors)
    sms = torch.cuda.get_device_properties(logits.device).multi_processor_count
    resident = resident_blocks(kernel, logits.device, logits.dtype, vec, float(gamma) == 2.0)
    chunk, blocks = sum_plan(dims, vec, sms, resident)
    return dict(vec=vec, chunk=chunk, blocks=blocks, resident=resident, sms=sms)


def sum_launch_plan(logits: torch.Tensor, num_anchors: int, gamma: float) -> dict:
    """What ``focal_level_sum`` launches for these CUDA logits."""
    b, h, w, ac = logits.shape
    vec = sum_vector((b, h, w, num_anchors, ac // num_anchors), logits.stride(),
                     logits.element_size(), logits.data_ptr())
    return launch_plan("sum", logits, num_anchors, gamma, vec)


def dx_launch_plan(logits: torch.Tensor, dx: torch.Tensor, num_anchors: int,
                   gamma: float) -> dict:
    """What ``focal_level_dx`` launches for these CUDA logits and the dx it
    writes."""
    b, h, w, ac = logits.shape
    vec = dx_vector((b, h, w, num_anchors, ac // num_anchors), logits.stride(),
                    logits.element_size(), logits.data_ptr(), dx.data_ptr())
    return launch_plan("dx", logits, num_anchors, gamma, vec)


def _check_rows(labels, lw) -> None:
    if labels.shape[1] > 1 and (labels.stride(1) != 1 or lw.stride(1) != 1):
        raise ValueError("labels and lw must have unit inner stride")


def focal_level_sum(logits: torch.Tensor, labels: torch.Tensor, lw: torch.Tensor,
                    gamma: float, alpha: float, num_anchors: int) -> torch.Tensor:
    """Weighted focal sum over one level.

    logits (B, H, W, A*C) f32 or bf16, any strides; labels (B, H*W*A) int32,
    0 = background / 1..C foreground; lw (B, H*W*A) f32 -> scalar f32.
    """
    dims = _check_level(logits, labels, lw, num_anchors)
    if logits.device.type == "cpu":
        return focal_level_sum_plain(logits, labels, lw, gamma, alpha, num_anchors)
    _check_rows(labels, lw)
    dev = logits.device
    if logits.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    plan = sum_launch_plan(logits, num_anchors, gamma)
    partials = torch.empty(plan["blocks"], dtype=torch.float64, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    _build.launch(LIBRARY.build().ioudet_focal_sum, "focal_sum_kernel",
                  logits.data_ptr(), int(logits.dtype == torch.bfloat16),
                  labels.data_ptr(), lw.data_ptr(), partials.data_ptr(),
                  counter.data_ptr(), out.data_ptr(), *dims, plan["vec"], plan["chunk"],
                  plan["blocks"], *logits.stride(), labels.stride(0), lw.stride(0),
                  float(gamma), float(alpha))
    return out


def focal_level_dx(g, logits: torch.Tensor, labels: torch.Tensor, lw: torch.Tensor,
                   gamma: float, alpha: float, num_anchors: int) -> torch.Tensor:
    """g * d focal_level_sum / d logits, in the logits' type and strides.
    ``g`` is the upstream scalar: a 0-d tensor on the logits' device (no host
    copy) or a Python number."""
    dims = _check_level(logits, labels, lw, num_anchors)
    if logits.device.type == "cpu":
        return focal_level_dx_plain(g, logits, labels, lw, gamma, alpha, num_anchors)
    _check_rows(labels, lw)
    g = torch.as_tensor(g, dtype=torch.float32, device=logits.device).reshape(())
    dx = torch.empty_strided(logits.shape, logits.stride(), dtype=logits.dtype,
                             device=logits.device)
    if logits.numel():
        plan = dx_launch_plan(logits, dx, num_anchors, gamma)
        _build.launch(LIBRARY.build().ioudet_focal_dx, "focal_dx_kernel",
                      g.data_ptr(), logits.data_ptr(),
                      int(logits.dtype == torch.bfloat16), labels.data_ptr(),
                      lw.data_ptr(), dx.data_ptr(), *dims, plan["vec"], plan["chunk"],
                      plan["blocks"], *logits.stride(), labels.stride(0), lw.stride(0),
                      float(gamma), float(alpha))
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
