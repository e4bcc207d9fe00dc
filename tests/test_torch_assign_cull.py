"""The culled walk of the anchor-assignment kernels
(``ioudet_torch/csrc/assign_kernel.cu``), replayed in torch on the CPU and
held bit for bit against the plain versions ``assign_gtmax_plain`` and
``assign_targets_plain``.  The kernels cannot run here; the replay is their
algorithm step for step, kept here and not in the package:

  * the hull test: each group of consecutive anchors (a warp: 64 anchors in
    the kernels' pass 1, 32 in pass 2; 128 as well here) tests every valid
    gt against the hull of its valid anchors with the IoU's own rounded
    steps; a gt that fails is culled, and every culled pair's IoU must be
    exactly +0;
  * pass 1: the floor of each image (0 for a valid gt where the image has a
    valid anchor, -1 otherwise) and the groups' IoUs above +0 with their
    candidates, merged by max;
  * pass 2: rule (a), a valid anchor of an image with a valid gt starting at
    max_ov +0 and best = the first valid gt, else at -1 and 0; rule (b), the
    valid gts whose gtmax is exactly 0 among every group's candidates; the
    candidates walked in increasing g with a strict > and the last forced gt
    winning.

Also the kernels' pair counts (``assign_cuda.hull_candidates``,
``pair_counts``) against the replay, ``chip_smoke.flagship_anchors`` against
the head's ``get_anchors``, and the lines the parts probe replaces.
Imports no JAX.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from ioudet_torch.core.bbox.geometry import bbox_overlaps
from ioudet_torch.core.bbox.transforms import bbox2delta
from ioudet_torch.ops import assign_cuda as A
from ioudet_torch.tools import probe_assign_parts as P
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

# (pos_iou_thr, neg_iou_thr, min_pos_iou, pos_weight, means, stds), as
# chip_smoke.phase_assign_kernels
SETTINGS = ((0.5, 0.4, 0.0, 1.0, (0.0,) * 4, (1.0,) * 4),
            (0.5, 0.4, 0.3, 2.0, (0.0,) * 4, (0.1, 0.1, 0.2, 0.2)))
# a pos_iou_thr of 0 makes an anchor that meets no gt positive for the first
# valid gt (rule a's best)
ZERO_THR = ((0.0, 0.0, 0.0, 1.0, (0.0,) * 4, (1.0,) * 4),)


def groups_of(anchors, valid, group):
    """anchors (1, n_groups, group, 4) and valid (B, n_groups, group), the
    ragged edge padded with left-out anchors."""
    pad = -anchors.shape[0] % group
    a = F.pad(anchors, (0, 0, 0, pad)).view(1, -1, group, 4)
    return a, F.pad(valid, (0, pad)).view(valid.shape[0], -1, group)


def replay_candidates(anchors, valid, table, group):
    """(B, n_groups, G): valid gt g meets the hull of the group's valid
    anchors, in the kernels' rounded steps."""
    a, v = groups_of(anchors, valid, group)
    big = torch.tensor(np.float32(np.inf))
    x1 = torch.where(v, a[..., 0], big).amin(-1)[..., None]
    y1 = torch.where(v, a[..., 1], big).amin(-1)[..., None]
    x2 = torch.where(v, a[..., 2], -big).amax(-1)[..., None]
    y2 = torch.where(v, a[..., 3], -big).amax(-1)[..., None]
    g = table[:, None]
    w = (torch.minimum(x2, g[..., 2]) - torch.maximum(x1, g[..., 0])) + 1.0
    h = (torch.minimum(y2, g[..., 3]) - torch.maximum(y1, g[..., 1])) + 1.0
    return (w > 0) & (h > 0) & (g[..., 5] > 0)


def per_anchor(mask, n, group):
    """(B, n_groups, G) -> (B, G, n): each anchor takes its group's row."""
    return mask.transpose(1, 2).repeat_interleave(group, dim=2)[..., :n]


def replay_gtmax(anchors, valid, table, group):
    b, n, g = valid.shape[0], anchors.shape[0], table.shape[1]
    if n == 0:
        return torch.full((b, g), -2.0)
    gvalid = table[..., 5] > 0
    floor = torch.where(gvalid & valid.any(1)[:, None], 0.0, -1.0)
    cand = replay_candidates(anchors, valid, table, group)
    iou = bbox_overlaps(table[..., :4], anchors)                   # (B, G, n)
    both = gvalid[..., None] & valid[:, None]
    culled = both & ~per_anchor(cand, n, group)
    # every culled pair: exactly +0, sign bit clear
    assert bool((iou.view(torch.int32)[culled] == 0).all())
    pad = -n % group
    top = F.pad(torch.where(both, iou, 0.0), (0, pad)).view(b, g, -1, group).amax(-1)
    top = torch.where(cand.transpose(1, 2), top, 0.0).amax(-1)    # (B, G)
    return torch.where(top > 0, torch.maximum(floor, top), floor)


def replay_targets(anchors, valid, table, gtmax, pos_iou_thr, neg_iou_thr, min_pos_iou,
                   pos_weight, means, stds, group):
    b, n, g = valid.shape[0], anchors.shape[0], table.shape[1]
    gvalid = table[..., 5] > 0
    ok = gvalid & (gtmax >= min_pos_iou)
    zero = gvalid & (gtmax == 0)                                    # rule (b)
    cand = per_anchor(replay_candidates(anchors, valid, table, group) | zero[:, None], n,
                      group)
    iou = bbox_overlaps(table[..., :4], anchors)
    live = valid & gvalid.any(1)[:, None]                           # rule (a)
    first = torch.argmax(gvalid.int(), dim=1)[:, None].expand(b, n)
    max_ov = torch.where(live, 0.0, -1.0)
    best = torch.where(live, first, 0)
    forced = torch.zeros(b, n, dtype=torch.long)
    for k in range(g):
        c = cand[:, k] & live
        v = iou[:, k]
        better = c & (v > max_ov)
        max_ov = torch.where(better, v, max_ov)
        best = torch.where(better, k, best)
        forced = torch.where(c & (v == gtmax[:, k:k + 1]) & ok[:, k:k + 1], k + 1, forced)
    assigned = torch.full((b, n), -1, dtype=torch.long)
    assigned = torch.where((max_ov >= 0) & (max_ov < neg_iou_thr), 0, assigned)
    assigned = torch.where(max_ov >= pos_iou_thr, best + 1, assigned)
    assigned = torch.where(forced > 0, forced, assigned)
    pos = assigned > 0
    rows = torch.gather(table, 1, (assigned - 1).clamp(min=0)[..., None].expand(-1, -1, 6))
    rows = torch.where(pos[..., None], rows, 0.0)
    deltas = (bbox2delta(anchors, rows[..., :4]) - torch.tensor(means)) / torch.tensor(stds)
    return (rows[..., 4].int(), torch.where(pos, pos_weight, (assigned == 0).float()),
            pos.float(), torch.where(pos[..., None], deltas, 0.0), rows[..., :4])


def check_replay(anchors, valid, table, settings=SETTINGS, groups=(32, 64, 128)):
    """The replay at each group size against the plain versions, bit for bit;
    returns the plain gtmax."""
    want_max = A.assign_gtmax_plain(anchors, valid, table)
    for group in groups:
        got_max = replay_gtmax(anchors, valid, table, group)
        assert torch.equal(got_max, want_max), group
        for args in settings:
            want = A.assign_targets_plain(anchors, valid, table, want_max, *args)
            got = replay_targets(anchors, valid, table, want_max, *args, group)
            for o, q in zip(got, want):
                assert o.dtype == q.dtype and torch.equal(o, q), (group, args)
    return want_max


def tensors(anchors, valid, gt, gtv, gtl):
    return (torch.from_numpy(anchors), torch.from_numpy(valid),
            A.gt_table(torch.from_numpy(gt), torch.from_numpy(gtl), torch.from_numpy(gtv)))


@pytest.mark.parametrize("gts_valid", [True, False])
@pytest.mark.parametrize("shape", chip_smoke.ASSIGN_SHAPES[:5])
def test_replay_on_the_adversarial_cases(shape, gts_valid):
    """chip_smoke's random cases (duplicated gts, anchors equal to gts,
    invalid anchors and gts) up to (2, 9000, 128); with gts_valid False every
    gt is padding."""
    b, n, g = shape
    anchors, valid, table = tensors(*chip_smoke.assign_case(b, n, g, seed=n + g,
                                                            gts_valid=gts_valid))
    check_replay(anchors, valid, table)


@pytest.mark.parametrize("case", chip_smoke.GRID_CASES)
def test_replay_on_grid_anchors(case):
    """chip_smoke's grid cases on the flagship's P6-P7 anchors: a gt off every
    anchor (rule b, min_pos_iou 0 and 0.3), an image with no valid anchor,
    gts covering the canvas."""
    anchors, valid, table = tensors(*chip_smoke.grid_assign_case(case, levels=slice(3, None)))
    gtmax = check_replay(anchors, valid, table)
    if case == "off_canvas":
        assert bool((gtmax[:, 0] == 0).all())
    if case == "no_valid_anchor":
        assert bool((gtmax[1] == -1).all()) and bool((gtmax[0] >= 0).any())


def test_replay_on_big_hulls_and_empty_groups():
    """The flagship's P6/P7 anchors (a group's hull spans hundreds of pixels)
    on a training batch's gts, with whole groups of anchors left out."""
    anchors = chip_smoke.flagship_anchors(levels=slice(3, None))
    boxes, gv, labels = chip_smoke.gt_boxes(2, 40, dense=False, seed=1)
    valid = np.ones((2, anchors.shape[0]), bool)
    valid[0, 128:384] = False           # two groups of 128, four of 64, eight of 32
    valid[1, ::3] = False
    table = A.gt_table(torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(gv))
    check_replay(anchors, torch.from_numpy(valid), table, SETTINGS + ZERO_THR)
    # three small gts in a corner: most groups have no candidate at all
    few = A.gt_table(torch.tensor([[[90.0, 80.0, 110.0, 95.0], [0.0, 0.0, 30.0, 30.0],
                                    [100.0, 70.0, 140.0, 120.0]]] * 2),
                     torch.tensor([[3, 7, 9]] * 2), torch.tensor([[False, True, True]] * 2))
    check_replay(anchors, torch.from_numpy(valid), few, SETTINGS + ZERO_THR)


def test_culling_leaves_few_pairs_on_a_training_batch():
    """On the flagship's P4 anchors and a training batch's gts the hull test
    of a warp keeps a small share of the slots, and never fewer pairs than
    intersect; the probe's counts equal the replay's."""
    anchors = chip_smoke.flagship_anchors(levels=slice(1, 2))
    boxes, gv, labels = chip_smoke.gt_boxes(2, 50, dense=False)
    table = A.gt_table(torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(gv))
    valid = torch.ones(2, anchors.shape[0], dtype=torch.bool)
    gtmax = A.assign_gtmax_plain(anchors, valid, table)
    counts = A.pair_counts(anchors, valid, table, gtmax, chunk=8192)
    for group in (32, 64):
        cand, per_group = A.hull_candidates(anchors, valid, table, group)
        assert torch.equal(cand, replay_candidates(anchors, valid, table, group))
        assert int(per_group.sum()) == int(valid.sum())
    iou = bbox_overlaps(table[..., :4], anchors)
    assert counts["intersecting"] == int(((iou > 0) & (table[..., 5:6] > 0)).sum())
    assert counts["slots"] == 2 * 50 * anchors.shape[0]
    assert counts["intersecting"] <= counts["pass2"] <= counts["pass1"] < 0.3 * counts["slots"]
    assert counts["pass2"] == A.pair_counts(anchors, valid, table, gtmax, (32, 32))["pass1"]
    dense = chip_smoke.gt_boxes(2, 50, dense=True)
    table = A.gt_table(*(torch.from_numpy(x) for x in (dense[0], dense[2], dense[1])))
    counts = A.pair_counts(anchors, valid, table, A.assign_gtmax_plain(anchors, valid, table))
    nothing_culled = int(dense[1].sum()) * anchors.shape[0]
    assert counts["intersecting"] <= counts["pass1"] == counts["pass2"] == nothing_culled


def test_flagship_anchors_are_the_heads():
    from ioudet_torch.models.heads.retina_head import RetinaHead
    strides, canvas = (8, 16, 32, 64, 128), (832, 1344)
    head = RetinaHead(num_classes=81, in_channels=8, feat_channels=8, stacked_convs=1,
                      anchor_strides=strides)
    sizes = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in strides]
    anchors, valid = head.get_anchors(sizes, torch.tensor([list(canvas)]))
    assert torch.equal(anchors, chip_smoke.flagship_anchors()) and bool(valid.all())
    assert anchors.shape[0] == chip_smoke.ASSIGN_SHAPES[-1][1]


@pytest.mark.parametrize("name", sorted(P.CUTS))
def test_parts_probe_finds_its_lines_in_the_kernel_source(name):
    """The probe of the kernels' parts replaces whole lines of the source:
    each must be there exactly once."""
    source = A.LIBRARY.source.read_text()
    pairs = P.CUTS[name]
    assert pairs
    for old, new in pairs:
        assert source.count(old) == 1 and old != new


def test_parts_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert P.main() == 1
