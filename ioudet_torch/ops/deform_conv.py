"""Deformable convolution v1 / v2 (counterpart of ``ioudet/ops/deform_conv.py``;
mmdet's ``DeformConv`` / ``ModulatedDeformConv``).

The taps are sampled bilinearly at p0 + p_k + offset_k (zero outside the
image), multiplied by the modulation mask for v2, and the convolution is one
``torch.matmul`` of the (Cout, Cin*K) kernel with the (Cin*K, Ho*Wo) taps.
Autograd gives the backward, as JAX's autodiff does in ``ioudet``; the
gradients of x go through a scatter-add, so on the card they are not
bit-reproducible.

Layout is NCHW: x (B, Cin, H, W), offsets (B, 2K, Ho, Wo) interleaved
(dy, dx) a tap (the reference's channel layout), mask (B, K, Ho, Wo), kernel
(Cout, Cin, kh, kw).  The sample coordinates are formed as ``ioudet`` forms
them, integer base and tap first, then the f32 offset, so that ``floor`` sees
the same values and integer offsets sample exact pixels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


def sample_taps(x: torch.Tensor, offsets: torch.Tensor,
                kernel_size: Tuple[int, int] = (3, 3), stride: int = 1,
                dilation: int = 1, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, C, K, Ho, Wo) bilinear taps of x (B, C, H, W) at the offsets
    (B, 2K, Ho, Wo), times ``mask`` (B, K, Ho, Wo) when given.  The four
    corners are gathered and accumulated one at a time."""
    b, c, h, w = x.shape
    kh, kw = kernel_size
    k = kh * kw
    ho, wo = offsets.shape[2:]
    pad = (dilation * (kh - 1)) // 2
    dev = x.device
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev), torch.arange(kw, device=dev),
                            indexing="ij")
    ky = ky.reshape(k, 1, 1) * dilation - pad
    kx = kx.reshape(k, 1, 1) * dilation - pad
    off = offsets.view(b, k, 2, ho, wo)
    yy = (torch.arange(ho, device=dev).view(1, ho, 1) * stride + ky) + off[:, :, 0]
    xx = (torch.arange(wo, device=dev).view(1, 1, wo) * stride + kx) + off[:, :, 1]
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy, wx = yy - y0, xx - x0
    y0, x0 = y0.long(), x0.long()
    flat = x.reshape(b, c, h * w)
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            wgt = (wy if dy else 1 - wy) * (wx if dx else 1 - wx)
            wgt = torch.where(inb, wgt, 0.0)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).view(b, 1, -1)
            tap = torch.gather(flat, 2, idx.expand(b, c, -1)).view(b, c, k, ho, wo)
            tap = tap * wgt[:, None]
            out = tap if out is None else out + tap
    if mask is not None:
        out = out * mask[:, None]
    return out


def tap_product(taps: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """taps (B, C, K, Ho, Wo) x kernel (Cout, C, kh, kw) -> (B, Cout, Ho, Wo)
    in at least f32 (``ioudet``'s ``preferred_element_type``)."""
    b, c, k, ho, wo = taps.shape
    dt = torch.promote_types(taps.dtype, torch.float32)
    wmat = weight.reshape(weight.shape[0], c * k).to(dt)
    return torch.matmul(wmat, taps.reshape(b, c * k, ho * wo).to(dt)).view(b, -1, ho, wo)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None, stride: int = 1,
                  dilation: int = 1) -> torch.Tensor:
    """Deformable conv: v1 without ``mask``, v2 (modulated) with it.  Output
    (B, Cout, Ho, Wo) in at least f32, (Ho, Wo) taken from the offsets."""
    taps = sample_taps(x, offsets, tuple(weight.shape[2:]), stride, dilation, mask)
    out = tap_product(taps, weight)
    if bias is not None:
        out = out + bias.to(out.dtype)[:, None, None]
    return out


class DeformConv(nn.Module):
    """mmdet's ``DeformConv`` without bias: ``weight`` (out, in, k, k) f32,
    cast to ``compute_dtype`` per call with x, offsets and mask (as
    ``ioudet``'s bottleneck casts its ``conv2_kernel``).  It is no
    ``nn.Conv2d``, so ``quantize_calls`` leaves it alone, as ``ioudet``'s
    interceptor sees no ``nn.Conv`` here."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))

    def forward(self, x: torch.Tensor, offsets: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.compute_dtype
        return deform_conv2d(x.to(dt), offsets.to(dt), self.weight.to(dt),
                             mask=None if mask is None else mask.to(dt), stride=self.stride)
