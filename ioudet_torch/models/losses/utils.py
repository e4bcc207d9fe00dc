"""Loss weighting and reduction helpers (counterpart of
``ioudet/models/losses/utils.py``).

The ``avg_factor`` rule matters for parity: detection losses are normalised
by the number of positive samples, not of elements.  With ``avg_factor``
given and reduction 'mean' the loss is ``sum(loss * weight) / avg_factor``.
``avg_factor`` may be a device tensor: nothing here copies to the host.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"invalid reduction {reduction}")


def weight_reduce_loss(loss: torch.Tensor, weight: Optional[torch.Tensor] = None,
                       reduction: str = "mean",
                       avg_factor: Union[torch.Tensor, float, None] = None
                       ) -> torch.Tensor:
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == "mean":
        if isinstance(avg_factor, torch.Tensor):
            return loss.sum() / avg_factor.clamp(min=1e-12)
        return loss.sum() / max(avg_factor, 1e-12)
    if reduction == "none":
        return loss
    raise ValueError("avg_factor is not compatible with reduction='sum'")


def weighted_loss(loss_fn):
    """Decorator turning an elementwise ``f(pred, target, **kw)`` into
    ``f(pred, target, weight, reduction, avg_factor, **kw)``."""

    @functools.wraps(loss_fn)
    def wrapper(pred, target, weight=None, reduction="mean", avg_factor=None,
                **kwargs):
        loss = loss_fn(pred, target, **kwargs)
        return weight_reduce_loss(loss, weight, reduction, avg_factor)

    return wrapper
