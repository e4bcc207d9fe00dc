"""FCN mask head (counterpart of ``ioudet/models/mask_heads/fcn_mask_head.py``,
mmdet's ``FCNMaskHead``): ``num_convs`` 3x3 convs + ReLU on the 14x14 RoI
features, a 2x2 stride-2 transposed conv + ReLU, and a 1x1 ``conv_logits``
to ``num_classes - 1`` class masks at 28x28 (no background channel, as
``ioudet`` has it); the convs take ``conv_cfg`` / ``norm_cfg`` (GN, weight
standardization) and compute in the head's ``dtype``.  NCHW; parameters under mmdet's names (``convs.{i}.conv``,
``convs.{i}.gn``, ``upsample``, ``conv_logits``).

``HTCMaskHead`` is HTC's: the previous stage's pre-upsample feature enters
through a 1x1 ``conv_res`` added to the input (mask information flow), and
the head returns its own pre-upsample feature beside the logits.

The loss is the head's own: per-pixel BCE with logits of each roi's own
class channel against its target, the mean over the 28x28 pixels, summed
over the positive rois and divided by their count (at least 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import global_count
from ..losses.cross_entropy_loss import binary_cross_entropy_with_logits
from ..utils.layers import Conv2d, ConvModule, ConvTranspose2d, compute_dtype


class FCNMaskHead(nn.Module):
    def __init__(self, num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 81,
                 conv_cfg: Optional[dict] = None, norm_cfg: Optional[dict] = None,
                 dtype=None):
        super().__init__()
        self.num_convs = num_convs
        self.num_classes = num_classes
        chans = [in_channels] + [conv_out_channels] * num_convs
        self.convs = nn.ModuleList([ConvModule(chans[i], chans[i + 1], 3, padding=1,
                                               conv_cfg=conv_cfg, norm_cfg=norm_cfg, dtype=dtype)
                                    for i in range(num_convs)])
        dt = compute_dtype(dtype)
        self.upsample = ConvTranspose2d(chans[-1], conv_out_channels, 2, stride=2,
                                        compute_dtype=dt)
        self.conv_logits = Conv2d(conv_out_channels, num_classes - 1, 1, compute_dtype=dt)

    def init_weights(self, generator: torch.Generator) -> None:
        """``ioudet``'s initializers: N(0, 0.01) for the convs and
        ``conv_logits``, LeCun normal for ``upsample``; zero biases."""
        with torch.no_grad():
            for conv in [c.conv for c in self.convs] + [self.conv_logits]:
                conv.weight.normal_(0.0, 0.01, generator=generator)
                if conv.bias is not None:
                    conv.bias.zero_()
            fan_in = self.upsample.weight.shape[0] * 4
            self.upsample.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            self.upsample.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """RoI features (R, C, 14, 14) -> mask logits (R, num_classes - 1, 28, 28)."""
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(F.relu(self.upsample(x)))

    @staticmethod
    def own_class(mask_pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """(R, C - 1, S, S) -> (R, S, S): each roi's channel of its 1-based
        label (clamped into range)."""
        safe = (labels.long() - 1).clamp(0, mask_pred.shape[1] - 1)
        idx = safe[:, None, None, None].expand(-1, 1, *mask_pred.shape[2:])
        return torch.gather(mask_pred, 1, idx)[:, 0]

    def loss(self, mask_pred: torch.Tensor, mask_targets: torch.Tensor,
             labels: torch.Tensor, pos_mask: torch.Tensor) -> torch.Tensor:
        """mask_pred (R, C - 1, 28, 28), targets (R, 28, 28), labels (R,)
        1-based, pos_mask (R,).  In a process group of more than one rank
        the positive count is the global batch's."""
        bce = binary_cross_entropy_with_logits(self.own_class(mask_pred, labels), mask_targets)
        pos = pos_mask.float()
        count = global_count(pos.sum()).clamp(min=1.0)
        return (bce.mean(dim=(1, 2)) * pos).sum() / count


class HTCMaskHead(FCNMaskHead):
    """``FCNMaskHead`` with HTC's mask information flow: ``res_feat``, the
    previous stage's pre-upsample feature, goes through the 1x1 ``conv_res``
    and is added to the RoI features; the head returns its logits and its
    own pre-upsample feature.  ``with_conv_res`` False (the first stage, or
    a cascade without information flow) builds no ``conv_res``, as
    ``ioudet`` creates none there."""

    def __init__(self, with_conv_res: bool = True, **kwargs):
        super().__init__(**kwargs)
        chans = self.conv_logits.in_channels
        self.conv_res = nn.Conv2d(chans, chans, 1) if with_conv_res else None

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        if self.conv_res is not None:
            with torch.no_grad():
                self.conv_res.weight.normal_(0.0, 0.01, generator=generator)
                self.conv_res.bias.zero_()

    def forward(self, x: torch.Tensor, res_feat: Optional[torch.Tensor] = None):
        """(logits (R, num_classes - 1, 28, 28), feature (R, C, 14, 14))."""
        if res_feat is not None:
            x = x + self.conv_res(res_feat)
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(F.relu(self.upsample(x))), x
