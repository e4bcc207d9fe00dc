"""Fused anchor-target assignment: wrappers, plain versions and the batched
entry point ``fused_anchor_assign``.

The two CUDA kernels of ``ioudet_torch/csrc/assign_kernel.cu`` take the place
of the TPU kernels of ``ioudet/ops/assign_pallas.py``:

  * ``assign_gtmax``   (``assign_gtmax_kernel``, K2a ``_gtmax_kernel``): the
    per-(image, gt) maximum over all anchors of the masked IoU;
  * ``assign_targets`` (``assign_targets_kernel``, K2b ``_assign_kernel``):
    per anchor the MaxIoU assignment (first argmax, last forced positive),
    then labels, label weights, the positive mask, ``bbox2delta`` targets
    and the matched gt box.

Both kernels compute an IoU only for the gts that meet the hull of a warp's
valid anchors (the rest are +0, exactly); ``pair_counts`` counts the pairs
they compute beside the pairs that intersect.

Each wrapper launches its kernel for CUDA tensors and runs its plain torch
version (``*_plain``) only for CPU tensors; any other device raises.  The
plain versions walk the anchors in chunks, so that no (B, G, A) tensor larger
than a few hundred MB is made.  ``fused_anchor_assign`` has the arguments,
outputs and defaults of ``ioudet``'s function of that name.  It covers the
default configuration only (no sampler, no ignore regions, no border rule,
``gt_max_assign_all``); ``ioudet_torch.core.anchor.anchor_target`` routes
everything else to the general path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.bbox.geometry import bbox_overlaps
from ..core.bbox.transforms import bbox2delta
from . import _build
from ._build import F32, I32, PTR

MAX_GTS = 128          # the kernels' shared-memory gt table
PLAIN_CHUNK = 32768    # anchors per step of the plain versions
HULL_ANCHORS = (64, 32)   # anchors under one hull test: a warp of pass 1, of pass 2
_NEG = -2.0            # below the masked value (-1)

# --fmad=false: the IoU of the two passes and of bbox_overlaps must be the
# same bits (see the source)
LIBRARY = _build.KernelLibrary(
    "assign_kernel.cu", ("--fmad=false",),
    {"ioudet_assign_gtmax": [PTR, PTR, PTR, PTR, I32, I32, I32],
     "ioudet_assign_targets": [PTR] * 9 + [I32] * 3 + [F32] * 12},
    kernels=("assign_gtmax_kernel", "assign_targets_kernel"))


def gt_table(gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
             gt_valid: torch.Tensor) -> torch.Tensor:
    """(B, G, 6) f32 rows [x1 y1 x2 y2 label valid]."""
    return torch.cat([gt_bboxes.float(), gt_labels.float()[..., None],
                      gt_valid.float()[..., None]], dim=-1).contiguous()


def _masked_iou(anchors: torch.Tensor, valid: torch.Tensor,
                table: torch.Tensor) -> torch.Tensor:
    """(B, G, a) IoU of every gt with a chunk of anchors, -1 where the gt is
    padding or the anchor is left out."""
    iou = bbox_overlaps(table[..., :4], anchors)
    return torch.where((table[..., 5] > 0)[:, :, None] & valid[:, None, :], iou, -1.0)


def _check_inputs(anchors, valid, table) -> Tuple[int, int, int]:
    _build.check_tensor(anchors, "anchors", torch.float32, 2)
    _build.check_tensor(valid, "valid", torch.bool, 2)
    _build.check_tensor(table, "gt_table", torch.float32, 3)
    (a, four), (b, a2), (b2, g, six) = anchors.shape, valid.shape, table.shape
    if four != 4 or six != 6 or a2 != a or b2 != b:
        raise ValueError(f"shape mismatch: anchors {tuple(anchors.shape)}, valid "
                         f"{tuple(valid.shape)}, gt_table {tuple(table.shape)}")
    if not (anchors.device == valid.device == table.device):
        raise ValueError("anchors, valid and gt_table must be on one device")
    if not 1 <= g <= MAX_GTS:
        raise ValueError(f"G={g} must be in 1..{MAX_GTS}")
    if anchors.is_cuda:
        if not (anchors.is_contiguous() and valid.is_contiguous()
                and table.is_contiguous()):
            raise ValueError("anchors, valid and gt_table must be contiguous")
        if anchors.data_ptr() % 16:
            raise ValueError("anchors must be 16-byte aligned")
    return b, a, g


# ---------------------------------------------------------------- plain forms

def assign_gtmax_plain(anchors: torch.Tensor, valid: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Pass 1 in plain torch: gtmax (B, G)."""
    b, a, g = table.shape[0], anchors.shape[0], table.shape[1]
    gtmax = torch.full((b, g), _NEG, dtype=torch.float32, device=table.device)
    for s in range(0, a, PLAIN_CHUNK):
        iou = _masked_iou(anchors[s:s + PLAIN_CHUNK], valid[:, s:s + PLAIN_CHUNK], table)
        gtmax = torch.maximum(gtmax, iou.amax(dim=2))
    return gtmax


def assign_targets_plain(anchors: torch.Tensor, valid: torch.Tensor,
                         table: torch.Tensor, gtmax: torch.Tensor,
                         pos_iou_thr: float, neg_iou_thr: float,
                         min_pos_iou: float, pos_weight: float,
                         means: Sequence[float], stds: Sequence[float]):
    """Pass 2 in plain torch; outputs as ``assign_targets``."""
    b, g = table.shape[:2]
    dev = table.device
    gt_ok = (table[..., 5] > 0) & (gtmax >= min_pos_iou)
    ids = torch.arange(1, g + 1, dtype=torch.int32, device=dev)[None, :, None]
    # tensors, not Python scalars: on a CUDA device torch divides by a Python
    # scalar through its reciprocal, which rounds differently from a division
    means_t, stds_t = anchors.new_tensor(means), anchors.new_tensor(stds)
    outs = []
    for s in range(0, anchors.shape[0], PLAIN_CHUNK):
        anc, av = anchors[s:s + PLAIN_CHUNK], valid[:, s:s + PLAIN_CHUNK]
        iou = _masked_iou(anc, av, table)
        max_ov, best = iou.max(dim=1)                 # the first maximum on ties
        assigned = torch.full_like(max_ov, -1, dtype=torch.int32)
        assigned = torch.where((max_ov >= 0) & (max_ov < neg_iou_thr), 0, assigned)
        assigned = torch.where(max_ov >= pos_iou_thr, best.int() + 1, assigned)
        hit = (iou == gtmax[:, :, None]) & gt_ok[:, :, None] & av[:, None, :]
        forced = torch.where(hit, ids, 0).amax(dim=1)  # the last gt wins
        assigned = torch.where(forced > 0, forced, assigned)

        pos = assigned > 0
        rows = torch.gather(table, 1, (assigned - 1).clamp(min=0).long()[..., None]
                            .expand(-1, -1, 6))
        rows = torch.where(pos[..., None], rows, 0.0)
        matched = rows[..., :4]
        deltas = (bbox2delta(anc, matched) - means_t) / stds_t
        outs.append((rows[..., 4].int(),
                     torch.where(pos, pos_weight, (assigned == 0).float()),
                     pos.float(),
                     torch.where(pos[..., None], deltas, 0.0),
                     matched))
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


# ----------------------------------------------------- the pairs they compute

def hull_candidates(anchors: torch.Tensor, valid: torch.Tensor, table: torch.Tensor,
                    group: int) -> tuple:
    """The kernels' hull test: (candidates (B, groups, G) bool: valid gt g
    meets the hull of the group's valid anchors; valid anchors a group
    (B, groups) int64), for groups of ``group`` consecutive anchors."""
    b, n = valid.shape
    groups = -(-n // group)
    pad = groups * group - n
    a = F.pad(anchors, (0, 0, 0, pad)).view(1, groups, group, 4)
    v = F.pad(valid, (0, pad)).view(b, groups, group)
    lo = torch.where(v[..., None], a[..., :2], float("inf")).amin(dim=2)    # (B, groups, 2)
    hi = torch.where(v[..., None], a[..., 2:], float("-inf")).amax(dim=2)
    box = table[:, None, :, :4]                                     # (B, 1, G, 4)
    span = torch.minimum(hi[:, :, None], box[..., 2:]) - torch.maximum(lo[:, :, None], box[..., :2])
    meets = ((span + 1.0) > 0).all(dim=-1)
    return meets & (table[:, None, :, 5] > 0), v.sum(dim=2)


def pair_counts(anchors: torch.Tensor, valid: torch.Tensor, table: torch.Tensor,
                gtmax: torch.Tensor, groups: tuple = HULL_ANCHORS, chunk: int = 16384) -> dict:
    """(anchor, gt) pairs: every slot (B * G * A), the valid pairs whose boxes
    intersect (the IoUs an exact walk has to compute), and the pairs each
    pass computes, with hulls over ``groups`` anchors: pass 1 a candidate for
    every anchor of its group, pass 2 for every valid anchor of an image
    with a valid gt, with the valid gts of gtmax 0 among the candidates."""
    n = anchors.shape[0]
    gvalid = table[..., 5] > 0
    cand, per_group = hull_candidates(anchors, valid, table, groups[0])
    lanes = torch.full((cand.shape[1],), groups[0], device=anchors.device)
    lanes[-1] = n - groups[0] * (cand.shape[1] - 1)
    pass1 = (cand.sum(dim=2) * lanes).sum()
    cand, per_group = hull_candidates(anchors, valid, table, groups[1])
    zero = gvalid & (gtmax == 0)
    live = gvalid.any(dim=1)[:, None] & (per_group > 0)
    pass2 = ((cand | zero[:, None]).sum(dim=2) * per_group * live).sum()
    meet = 0
    for s in range(0, n, chunk):
        a = anchors[s:s + chunk]
        box = table[..., None, :4]
        span = torch.minimum(a[:, 2:], box[..., 2:]) - torch.maximum(a[:, :2], box[..., :2])
        hit = ((span + 1.0) > 0).all(dim=-1) & gvalid[..., None] & valid[:, None, s:s + chunk]
        meet += int(hit.sum())
    return {"slots": valid.shape[0] * table.shape[1] * n, "intersecting": meet,
            "pass1": int(pass1), "pass2": int(pass2)}


# ------------------------------------------------------------------- wrappers

def assign_gtmax(anchors: torch.Tensor, valid: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
    """anchors (A, 4) f32, valid (B, A) bool, gt table (B, G, 6) f32 ->
    gtmax (B, G) f32."""
    b, a, g = _check_inputs(anchors, valid, table)
    if anchors.device.type == "cpu":
        return assign_gtmax_plain(anchors, valid, table)
    gtmax = torch.full((b, g), _NEG, dtype=torch.float32, device=table.device)
    if b and a:
        _build.launch(LIBRARY.build().ioudet_assign_gtmax, "assign_gtmax_kernel",
                      anchors.data_ptr(), valid.data_ptr(), table.data_ptr(),
                      gtmax.data_ptr(), b, a, g)
    return gtmax


def assign_targets(anchors: torch.Tensor, valid: torch.Tensor,
                   table: torch.Tensor, gtmax: torch.Tensor,
                   pos_iou_thr: float, neg_iou_thr: float,
                   min_pos_iou: float, pos_weight: float,
                   means: Sequence[float], stds: Sequence[float]):
    """Inputs as ``assign_gtmax`` plus its result -> (labels (B, A) i32,
    label_weights (B, A) f32, pos_mask (B, A) f32, bbox_targets (B, A, 4)
    f32, pos_gt_boxes (B, A, 4) f32)."""
    b, a, g = _check_inputs(anchors, valid, table)
    _build.check_tensor(gtmax, "gtmax", torch.float32, 2)
    if tuple(gtmax.shape) != (b, g) or gtmax.device != table.device:
        raise ValueError(f"gtmax: expected {(b, g)} on {table.device}, got "
                         f"{tuple(gtmax.shape)} on {gtmax.device}")
    if anchors.device.type == "cpu":
        return assign_targets_plain(anchors, valid, table, gtmax, pos_iou_thr,
                                    neg_iou_thr, min_pos_iou, pos_weight, means, stds)
    if not gtmax.is_contiguous():
        raise ValueError("gtmax must be contiguous")
    dev = table.device
    labels = torch.empty(b, a, dtype=torch.int32, device=dev)
    lw = torch.empty(b, a, dtype=torch.float32, device=dev)
    posf = torch.empty(b, a, dtype=torch.float32, device=dev)
    targets = torch.empty(b, a, 4, dtype=torch.float32, device=dev)
    matched = torch.empty(b, a, 4, dtype=torch.float32, device=dev)
    if b and a:
        _build.launch(LIBRARY.build().ioudet_assign_targets, "assign_targets_kernel",
                      anchors.data_ptr(), valid.data_ptr(), table.data_ptr(),
                      gtmax.data_ptr(), labels.data_ptr(), lw.data_ptr(),
                      posf.data_ptr(), targets.data_ptr(), matched.data_ptr(),
                      b, a, g, pos_iou_thr, neg_iou_thr, min_pos_iou, pos_weight,
                      *means, *stds)
    return labels, lw, posf, targets, matched


def fused_anchor_assign(flat_anchors: torch.Tensor, valid: torch.Tensor,
                        gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                        gt_labels: torch.Tensor, pos_iou_thr: float,
                        neg_iou_thr: float, min_pos_iou: float = 0.0,
                        pos_weight: float = 1.0,
                        target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                        target_stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0)):
    """Batched fused anchor-target assignment.

    flat_anchors (A, 4) f32; valid (B, A) bool; gt_bboxes (B, G, 4);
    gt_valid (B, G) bool; gt_labels (B, G) int (1-based).  Returns (labels
    (B, A) i32, label_weights (B, A) f32, pos mask (B, A) f32, bbox_targets
    (B, A, 4) f32, pos_gt_boxes (B, A, 4) f32).
    """
    # the reference's pos_weight rule: <= 0 means "weight positives 1.0"
    pos_weight = 1.0 if pos_weight <= 0 else float(pos_weight)
    table = gt_table(gt_bboxes, gt_labels, gt_valid)
    anchors = flat_anchors.float().contiguous()
    valid = valid.contiguous()
    args = (float(pos_iou_thr), float(neg_iou_thr), float(min_pos_iou), pos_weight,
            tuple(float(m) for m in target_means),
            tuple(float(s) for s in target_stds))
    gtmax = assign_gtmax(anchors, valid, table)
    return assign_targets(anchors, valid, table, gtmax, *args)
