"""Greedy NMS kernels: wrappers, plain versions, build and launch counts.

The two CUDA kernels of ``ioudet_torch/csrc/nms_kernel.cu`` take the place of
the TPU kernels of ``ioudet/ops/nms_pallas.py``:

  * ``nms_mask``   (``nms_mask_kernel``, K1a ``suppression_matrix``): boxes
    (B, N, 4) in score order -> (B, N, ceil(N/64)) int64 words, bit j of word
    (i, c) set iff IoU(i, 64c + j) > thr and 64c + j > i;
  * ``nms_reduce`` (``nms_reduce_kernel``, K1b ``greedy_keep_pallas``): the
    words and a valid (B, N) mask -> the exact greedy keep mask (B, N).

Each wrapper launches its kernel for CUDA tensors and runs its plain torch
version (``*_plain``) only for CPU tensors; any other device raises.  The
kernels are compiled with nvcc from the repository's source at first use
(``ioudet_torch/ops/_build.py``); ``launches`` there counts the launches of
each kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.bbox.geometry import bbox_overlaps
from . import _build
from ._build import F32, I32, PTR, launches  # noqa: F401  (tests read nms_cuda.launches)

# --fmad=false: the IoU must round as bbox_overlaps does (see the source)
LIBRARY = _build.KernelLibrary(
    "nms_kernel.cu", ("--fmad=false",),
    {"ioudet_nms_mask": [PTR, PTR, I32, I32, F32],
     "ioudet_nms_reduce": [PTR, PTR, PTR, I32, I32]},
    kernels=("nms_mask_kernel", "nms_reduce_kernel"))
# the largest N the wrappers take: the reduce keeps ceil(N/64) words of
# removed rows and two slab windows of 64 x 64 words in dynamic shared memory
# (113 KB at this N, of the 227 KB a block may opt into)
MAX_N = 64 * (48 * 1024 // 8 - 64)


def num_words(n: int) -> int:
    return (n + 63) // 64


# ---------------------------------------------------------------- plain forms

def _bit_weights(device) -> torch.Tensor:
    """1 << j for j < 64 as int64 (bit 63 is the sign bit)."""
    return torch.tensor([1 << j for j in range(63)] + [-(1 << 63)],
                        dtype=torch.int64).to(device)


def nms_mask_plain(boxes: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """The mask pass in plain torch: bbox_overlaps, threshold, strict upper
    triangle, packed 64 columns to a word."""
    b, n, _ = boxes.shape
    idx = torch.arange(n, device=boxes.device)
    supp = (bbox_overlaps(boxes, boxes) > iou_thr) & (idx[None, :] > idx[:, None])
    w = num_words(n)
    bits = F.pad(supp, (0, 64 * w - n)).reshape(b, n, w, 64).long()
    return (bits * _bit_weights(boxes.device)).sum(-1)


def nms_reduce_plain(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The greedy walk in plain torch: for i in score order, keep i if it is
    valid and not yet removed, then OR its row into the removed words."""
    b, n, w = mask.shape
    removed = torch.zeros(b, w, dtype=torch.int64, device=mask.device)
    keep = torch.zeros(b, n, dtype=torch.bool, device=mask.device)
    for i in range(n):
        free = ((removed[:, i // 64] >> (i % 64)) & 1) == 0
        k = valid[:, i] & free
        keep[:, i] = k
        removed |= torch.where(k[:, None], mask[:, i], 0)
    return keep


# ------------------------------------------------------------------- wrappers

def nms_mask(boxes: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """boxes (B, N, 4) f32 in score order -> (B, N, ceil(N/64)) int64 words."""
    _build.check_tensor(boxes, "boxes", torch.float32, 3)
    if boxes.shape[-1] != 4:
        raise ValueError(f"boxes: expected (B, N, 4), got {tuple(boxes.shape)}")
    if boxes.device.type == "cpu":
        return nms_mask_plain(boxes, iou_thr)
    bsz, n, _ = boxes.shape
    if n > MAX_N:
        raise ValueError(f"N={n} exceeds the kernels' limit {MAX_N}")
    if not boxes.is_contiguous():
        raise ValueError("boxes must be contiguous")
    mask = torch.empty(bsz, n, num_words(n), dtype=torch.int64,
                       device=boxes.device)
    if bsz and n:
        _build.launch(LIBRARY.build().ioudet_nms_mask, "nms_mask_kernel",
                      boxes.data_ptr(), mask.data_ptr(), bsz, n, iou_thr)
    return mask


def nms_reduce(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """mask (B, N, W) from ``nms_mask``, valid (B, N) bool -> keep (B, N)."""
    _build.check_tensor(mask, "mask", torch.int64, 3)
    _build.check_tensor(valid, "valid", torch.bool, 2)
    bsz, n, w = mask.shape
    if tuple(valid.shape) != (bsz, n) or w != num_words(n):
        raise ValueError(f"shape mismatch: mask {tuple(mask.shape)}, "
                         f"valid {tuple(valid.shape)}")
    if mask.device != valid.device:
        raise ValueError(f"mask on {mask.device}, valid on {valid.device}")
    if mask.device.type == "cpu":
        return nms_reduce_plain(mask, valid)
    if not (mask.is_contiguous() and valid.is_contiguous()):
        raise ValueError("mask and valid must be contiguous")
    keep = torch.empty(bsz, n, dtype=torch.bool, device=mask.device)
    if bsz and n:
        _build.launch(LIBRARY.build().ioudet_nms_reduce, "nms_reduce_kernel",
                      mask.data_ptr(), valid.data_ptr(), keep.data_ptr(), bsz, n)
    return keep


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                iou_thr: float) -> torch.Tensor:
    """Exact greedy NMS keep mask, batched: boxes (B, N, 4) in score order,
    valid (B, N) bool -> keep (B, N) bool."""
    return nms_reduce(nms_mask(boxes, iou_thr), valid)


def suppression_matrix(boxes: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """K1a's contract: boxes (N, 4) in score order -> (N, N) float {0, 1},
    [i, j] = 1 iff i < j and IoU(i, j) > thr."""
    words = nms_mask(boxes[None], iou_thr)[0]
    n = boxes.shape[0]
    shifts = torch.arange(64, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(n, -1)[:, :n].float()
