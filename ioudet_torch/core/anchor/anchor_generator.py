"""Anchor generation (counterpart of ``ioudet/core/anchor/anchor_generator.py``).

Parity-critical details kept from the reference:
  * base anchors centred at ``0.5 * (base_size - 1)`` and rounded to
    integers (the v1 ``.round()``), computed once in numpy on the host;
  * ``h_ratios = sqrt(ratios)``, ``w_ratios = 1 / h_ratios``; scale-major
    ordering (scales vary fastest within a cell);
  * grid anchors in (H, W, A) order: row-major over (y, x), base anchor
    fastest, matching the heads' NHWC ``reshape(-1, A*C)`` layout.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


class AnchorGenerator:
    def __init__(self, base_size: float, scales: Sequence[float],
                 ratios: Sequence[float], scale_major: bool = True,
                 ctr: Tuple[float, float] | None = None):
        self.base_size = base_size
        self.scales = np.asarray(scales, dtype=np.float32)
        self.ratios = np.asarray(ratios, dtype=np.float32)
        self.scale_major = scale_major
        self.ctr = ctr
        self.base_anchors = self.gen_base_anchors()  # np (A, 4)

    @property
    def num_base_anchors(self) -> int:
        return self.base_anchors.shape[0]

    def gen_base_anchors(self) -> np.ndarray:
        w = h = float(self.base_size)
        if self.ctr is None:
            x_ctr, y_ctr = 0.5 * (w - 1), 0.5 * (h - 1)
        else:
            x_ctr, y_ctr = self.ctr
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        else:
            ws = (w * self.scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * self.scales[:, None] * h_ratios[None, :]).reshape(-1)
        base = np.stack(
            [x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
             x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)], axis=-1)
        return np.round(base).astype(np.float32)

    def grid_anchors(self, featmap_size: Tuple[int, int], stride: int,
                     device="cpu") -> torch.Tensor:
        """All anchors on a (feat_h, feat_w) grid, (feat_h*feat_w*A, 4) f32."""
        feat_h, feat_w = featmap_size
        shift_x = np.arange(0, feat_w, dtype=np.float32) * stride
        shift_y = np.arange(0, feat_h, dtype=np.float32) * stride
        xx = np.tile(shift_x, feat_h)
        yy = np.repeat(shift_y, feat_w)
        shifts = np.stack([xx, yy, xx, yy], axis=-1)  # (H*W, 4)
        all_anchors = self.base_anchors[None, :, :] + shifts[:, None, :]
        return torch.from_numpy(all_anchors.reshape(-1, 4)).to(device)

    def valid_flags(self, featmap_size: Tuple[int, int],
                    valid_size: Tuple[torch.Tensor, torch.Tensor]
                    ) -> torch.Tensor:
        """(B, feat_h*feat_w*A) bool: True where the cell lies inside each
        image's valid extent.  ``valid_size`` holds (B,) tensors (valid_h,
        valid_w), so one call serves a batch of differently sized images."""
        feat_h, feat_w = featmap_size
        valid_h, valid_w = valid_size
        dev = valid_h.device
        row = torch.arange(feat_h, device=dev)[None, :, None]
        col = torch.arange(feat_w, device=dev)[None, None, :]
        valid = (row < valid_h[:, None, None]) & (col < valid_w[:, None, None])
        return valid.reshape(valid.shape[0], -1, 1).expand(
            -1, -1, self.num_base_anchors).reshape(valid.shape[0], -1)
