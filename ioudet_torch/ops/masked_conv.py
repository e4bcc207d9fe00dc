"""Masked conv2d (counterpart of ``ioudet/ops/masked_conv.py``; mmdet's
``MaskedConv2d``).

mmdet's CUDA op gathers the masked-in output positions into an im2col
buffer and convolves only those; ``ioudet`` computes the dense convolution
plus bias and multiplies it by the mask, which gives the same outputs.  The
port does what ``ioudet`` does, in plain torch: no config calls it (the
guided-anchoring heads multiply their scores by the loc mask instead), and
``ioudet`` runs no Pallas kernel here.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """XLA's 'SAME' padding of one axis: (low, high), the larger half high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def masked_conv2d(x: torch.Tensor, kernel: torch.Tensor, mask: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: Union[str, int] = "SAME") -> torch.Tensor:
    """x (B, H, W, Cin) NHWC; kernel (kh, kw, Cin, Cout) HWIO; mask (B, H',
    W') bool or float over the output positions; ``padding`` 'SAME' or an
    int for every side.  Returns (B, H', W', Cout): conv + bias, times the
    mask."""
    kh, kw = kernel.shape[:2]
    xc = x.permute(0, 3, 1, 2)
    if isinstance(padding, int):
        xc = F.pad(xc, (padding, padding, padding, padding))
    elif padding == "SAME":
        xc = F.pad(xc, same_padding(x.shape[2], kw, stride) + same_padding(x.shape[1], kh, stride))
    else:
        raise ValueError(f"padding must be 'SAME' or an int, got {padding!r}")
    out = F.conv2d(xc, kernel.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias
    return out * mask[..., None].to(out.dtype)
