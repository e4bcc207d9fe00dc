"""Top-k accuracy (counterpart of ``ioudet/models/losses/accuracy.py``)."""

from __future__ import annotations

import torch


def accuracy(pred: torch.Tensor, target: torch.Tensor, topk=1):
    """Percentage of rows of ``pred`` (N, C) whose ``target`` (N,) is among
    the top k scores; a list for a tuple of k.  The ranking is ``ioudet``'s:
    an ascending stable sort reversed, so a tie goes to the higher index."""
    ks = (topk,) if isinstance(topk, int) else tuple(topk)
    order = torch.argsort(pred, dim=-1, stable=True).flip(-1)[..., :max(ks)]
    correct = order == target[..., None]
    res = [correct[..., :k].any(dim=-1).sum() / pred.shape[0] * 100.0 for k in ks]
    return res[0] if isinstance(topk, int) else res
