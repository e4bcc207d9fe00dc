"""Gradient-harmonizing losses (counterpart of
``ioudet/models/losses/ghm_loss.py``): ``GHMC`` over sigmoid logits,
``GHMR`` (the authentic smooth L1) over box deltas, and the adapters that
take the anchor head's loss contract.

Each valid entry falls into one of ``bins`` bins of its gradient norm
``g`` (GHMC: |sigmoid(x) - t|; GHMR: |d| / sqrt(d^2 + mu^2)), bin ``floor(g
* bins)`` clipped, and is weighted by ``tot / count(its bin)`` divided by
the number of non-empty bins.  With ``momentum`` > 0 the count is an EMA
carried from step to step: per non-empty bin only, ``acc = momentum * acc +
(1 - momentum) * count`` (an empty bin keeps its sum), and the weight takes
``acc`` in place of the count.  As in ``ioudet``, the loss takes the
carried ``acc_sum`` and returns ``(loss, new_acc_sum)``; the anchor head
keeps the sums as buffers and writes them back in a training step
(``AnchorHead.call_loss``).

``ioudet`` counts the bins with a one-hot of the bin index over every
entry, (N, C, bins): on the flat (B * A, 80) logits of a batch of 8 at
832x1344 with 30 bins that would be 16 GB.  Here the counts are a histogram
of the integer bin ids (the invalid entries sent to an extra bin that is
dropped) and the weights a gather of the per-bin density, the same numbers
without the one-hot.  The counts are f32, as ``ioudet``'s: exact while a
bin holds fewer than 2^24 entries.  With GHM's anchor subsampling the valid
set of GHMC is 256 anchors x 80 classes an image (163,840 at batch 8), of
GHMR at most 4 coordinates of 128 positives an image, far below that; the
extra bin of the invalid entries may saturate and is not used.

In a process group of more than one rank (data-parallel training) the
counts and the normalizer are summed over the ranks before the EMA, as
``ioudet``'s step counts over the global batch: every rank then carries the
same sums.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...parallel.mesh import global_count
from .cross_entropy_loss import binary_cross_entropy_with_logits


def _bin_weights(g: torch.Tensor, valid: torch.Tensor, bins: int, momentum: float,
                 acc_sum: Optional[torch.Tensor], norm: torch.Tensor, per: float = 1.0):
    """GHM's density weights.  g: the gradient norm in [0, 1], valid: bool
    like g; ``norm / per`` floored at 1 is the normalizer ``tot`` (GHMC: the
    valid count, per 1; GHMR: the weights' sum, per 4: a box, not a
    coordinate).  Returns (weights like g, tot, new acc_sum); nothing here
    carries a gradient."""
    with torch.no_grad():
        idx = (g.detach().float() * bins).to(torch.int32).clamp(0, bins - 1)
        ids = torch.where(valid, idx, bins)   # the invalid entries into an extra bin
        counts = torch.histc(ids.float(), bins=bins + 1, min=0, max=bins + 1)[:bins]
        both = global_count(torch.cat([counts, norm.float().reshape(1)]))
        counts, tot = both[:bins], (both[bins] / per).clamp(min=1.0)
        nonempty = counts > 0
        n = nonempty.sum().float().clamp(min=1.0)
        if momentum > 0:
            if acc_sum is None:
                raise ValueError("GHM with momentum > 0 needs the carried acc_sum")
            new_acc = torch.where(nonempty, momentum * acc_sum + (1 - momentum) * counts,
                                  acc_sum)
            gd = torch.where(nonempty, tot / new_acc.clamp(min=1e-12), 0.0)
        else:
            new_acc = acc_sum
            gd = torch.where(nonempty, tot / counts.clamp(min=1.0), 0.0)
        weights = torch.cat([gd, gd.new_zeros(1)])[ids.long()] / n
    return weights, tot, new_acc


class GHMC(nn.Module):
    """GHM classification loss over logits (N, C) with one-hot targets."""

    INT8 = False   # w8a8 serving of a GHM model is not ported

    def __init__(self, bins: int = 10, momentum: float = 0.0, use_sigmoid: bool = True,
                 loss_weight: float = 1.0):
        super().__init__()
        if not use_sigmoid:
            raise NotImplementedError("GHMC takes sigmoid logits only, as ioudet's")
        self.bins = bins
        self.momentum = momentum
        self.loss_weight = loss_weight

    @property
    def stateful(self) -> bool:
        return self.momentum > 0

    def forward(self, pred, target, label_weight, avg_factor=None, reduction_override=None,
                acc_sum=None):
        pred = pred.float()
        target = target.float()
        valid = label_weight > 0
        g = (torch.sigmoid(pred.detach()) - target).abs()
        weights, tot, new_acc = _bin_weights(g, valid, self.bins, self.momentum, acc_sum,
                                             valid.sum())
        loss = (binary_cross_entropy_with_logits(pred, target) * weights).sum()
        out = self.loss_weight * loss / tot
        return (out, new_acc) if self.stateful else out


class GHMR(nn.Module):
    """GHM regression loss (ASL1) over (N, 4) deltas."""

    INT8 = False

    def __init__(self, mu: float = 0.02, bins: int = 10, momentum: float = 0.0,
                 loss_weight: float = 1.0):
        super().__init__()
        self.mu = mu
        self.bins = bins
        self.momentum = momentum
        self.loss_weight = loss_weight

    @property
    def stateful(self) -> bool:
        return self.momentum > 0

    def forward(self, pred, target, label_weight, avg_factor=None, reduction_override=None,
                acc_sum=None):
        mu = self.mu
        diff = pred.float() - target.float()
        loss = torch.sqrt(diff * diff + mu * mu) - mu
        with torch.no_grad():
            g = (diff / torch.sqrt(mu * mu + diff * diff)).abs()
        weights, tot, new_acc = _bin_weights(g, label_weight > 0, self.bins, self.momentum,
                                             acc_sum, label_weight.float().sum(), per=4.0)
        out = self.loss_weight * (loss * weights).sum() / tot
        return (out, new_acc) if self.stateful else out


class GHMCAdapter(nn.Module):
    """GHMC under the anchor head's contract: int labels (N,) (0 for the
    background), a weight a row, ``avg_factor`` ignored (GHM normalizes by
    the valid count)."""

    INT8 = False

    def __init__(self, bins: int = 10, momentum: float = 0.0, loss_weight: float = 1.0):
        super().__init__()
        self.ghmc = GHMC(bins=bins, momentum=momentum, loss_weight=loss_weight)
        self.bins = bins

    @property
    def stateful(self) -> bool:
        return self.ghmc.stateful

    def forward(self, pred, labels, weight=None, avg_factor=None, reduction_override=None,
                acc_sum=None):
        classes = torch.arange(1, pred.shape[-1] + 1, device=labels.device)
        onehot = labels[..., None] == classes
        lw = (torch.ones((), device=pred.device) if weight is None else
              weight[..., None]).expand(pred.shape)
        return self.ghmc(pred, onehot, lw, acc_sum=acc_sum)


class GHMRAdapter(nn.Module):
    """GHMR under the anchor head's contract (``avg_factor`` ignored)."""

    INT8 = False

    def __init__(self, mu: float = 0.02, bins: int = 10, momentum: float = 0.0,
                 loss_weight: float = 1.0):
        super().__init__()
        self.ghmr = GHMR(mu=mu, bins=bins, momentum=momentum, loss_weight=loss_weight)
        self.bins = bins

    @property
    def stateful(self) -> bool:
        return self.ghmr.stateful

    def forward(self, pred, target, weight=None, avg_factor=None, reduction_override=None,
                acc_sum=None):
        lw = torch.ones_like(pred) if weight is None else weight
        return self.ghmr(pred, target, lw, acc_sum=acc_sum)


GHM_LOSSES = (GHMC, GHMR, GHMCAdapter, GHMRAdapter)
