"""Plain greedy NMS (counterpart of ``ioudet/ops/nms.py``).

These are the readable references of the exact greedy semantics the CUDA
kernels in ``ops/nms_cuda.py`` implement.  They loop on the host (the fixed
point checks for convergence after every sweep), so the serving path never
calls them: ``multiclass_nms`` goes through ``ops.nms_cuda.greedy_keep``.
``soft_nms`` and ``matrix_nms`` are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.bbox.geometry import bbox_overlaps

NEG_INF = -1e10


def _suppression(iou: torch.Tensor, iou_thr: float) -> torch.Tensor:
    n = iou.shape[-1]
    idx = torch.arange(n, device=iou.device)
    return (iou > iou_thr) & (idx[None, :] > idx[:, None])


def greedy_suppress(iou: torch.Tensor, valid: torch.Tensor,
                    iou_thr: float) -> torch.Tensor:
    """Exact greedy NMS over a score-descending (N, N) IoU matrix, as the
    fixed point of
        kept[j] = valid[j] and not any_i (i < j and kept[i] and iou[i,j] > thr),
    iterated until it stops changing (at most N sweeps).  Returns keep (N,)."""
    supp = _suppression(iou, iou_thr)
    suppressed = (supp & valid[:, None]).any(dim=0)
    for _ in range(iou.shape[0]):
        kept = valid & ~suppressed
        new = (supp & kept[:, None]).any(dim=0)
        if torch.equal(new, suppressed):
            break
        suppressed = new
    return ~suppressed & valid


def greedy_suppress_sequential(iou: torch.Tensor, valid: torch.Tensor,
                               iou_thr: float) -> torch.Tensor:
    """The N-step sequential oracle the fixed point is tested against."""
    supp = _suppression(iou, iou_thr)
    suppressed = torch.zeros_like(valid)
    for i in range(iou.shape[0]):
        if valid[i] and not suppressed[i]:
            suppressed = suppressed | supp[i]
    return ~suppressed & valid


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
        valid: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact greedy NMS.

    boxes (N, 4), scores (N,), optional valid (N,) bool.  Returns
    (dets (N, 5) score-sorted, keep (N,) bool, order (N,) int64).
    """
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    s = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    s, order = torch.sort(s, descending=True, stable=True)
    b = boxes[order]
    keep = greedy_suppress(bbox_overlaps(b, b), s > NEG_INF / 2, iou_thr)
    return torch.cat([b, s[:, None]], dim=-1), keep, order
