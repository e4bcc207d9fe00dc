"""Port parity of the anchor-target assignment: the plain versions of the
fused kernels (ioudet_torch/ops/assign_cuda.py, what the wrappers run on CPU
tensors) and the port's anchor_target against ioudet's fused_anchor_assign
(Pallas, interpret mode on the CPU) and anchor_target_single, on seeded
adversarial cases: duplicated gts (ties that force the later-gt-wins rule),
anchors equal to gts, invalid gts and anchors, min_pos_iou > 0, pos_weight,
anchor counts that no block size divides.

Tolerances: labels, weights and the positive mask exact; targets and matched
boxes rtol = atol = 1e-6 (log of the width ratio in two libraries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import assign_case
from ioudet.core.anchor.anchor_target import anchor_target as jax_anchor_target
from ioudet.core.anchor.anchor_target import anchor_target_single as jax_single
from ioudet.core.bbox import MaxIoUAssigner as JaxAssigner
from ioudet.ops.assign_pallas import fused_anchor_assign as jax_fused
from ioudet_torch.core.anchor import anchor_target, anchor_target_single
from ioudet_torch.core.bbox import MaxIoUAssigner
from ioudet_torch.ops import assign_cuda
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

MEANS = (0.0, 0.0, 0.0, 0.0)
STDS = (0.1, 0.1, 0.2, 0.2)


def t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def assert_outputs(ours, ref):
    """(labels, lw, posf, targets, matched) of the port against ioudet's."""
    for o, r in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    for o, r in zip(ours[3:], ref[3:]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("A", [500, 4096, 9000])
@pytest.mark.parametrize("min_pos,pw", [(0.0, -1.0), (0.3, 2.0)])
def test_fused_matches_pallas(A, min_pos, pw):
    case = assign_case(3, A, 17, seed=42 + A)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=min_pos,
              pos_weight=pw, target_means=MEANS, target_stds=STDS)
    ours = assign_cuda.fused_anchor_assign(*t(*case), **kw)
    ref = jax_fused(*j(*case), **dict(kw, pos_weight=1.0 if pw <= 0 else pw))
    assert_outputs(ours, ref)
    assert ours[0].dtype == torch.int32 and ours[3].shape == (3, A, 4)
    assert float(ours[2].sum()) > 0  # the planted exact matches are positive


def test_gtmax_plain_matches_pallas_pass_one():
    """Pass 1 alone: the per-gt maxima equal the masked IoU matrix's row
    maxima, which ioudet's assign_max_iou computes (-1 for padded gts)."""
    from ioudet.core.bbox.geometry import bbox_overlaps as jax_overlaps
    anchors, valid, gt, gtv, gtl = assign_case(2, 700, 9, seed=3)
    table = assign_cuda.gt_table(*t(gt, gtl, gtv))
    ours = assign_cuda.assign_gtmax(*t(anchors, valid), table)
    for b in range(2):
        iou = np.asarray(jax_overlaps(jnp.asarray(gt[b]), jnp.asarray(anchors)))
        masked = np.where(gtv[b][:, None] & valid[b][None, :], iou, -1.0)
        np.testing.assert_array_equal(ours[b].numpy(), masked.max(axis=1))


def test_all_gts_invalid():
    case = assign_case(2, 700, 5, seed=0, gts_valid=False)
    labels, lw, posf, bt, pgb = assign_cuda.fused_anchor_assign(
        *t(*case), pos_iou_thr=0.5, neg_iou_thr=0.4)
    assert float(posf.sum()) == 0 and int(labels.sum()) == 0
    assert bool((bt == 0).all()) and bool((pgb == 0).all())
    assert float(lw.sum()) == 0  # every overlap is masked: nothing is negative either


def test_chunked_plain_equals_one_chunk(monkeypatch):
    case = t(*assign_case(2, 1500, 9, seed=5))
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, target_stds=STDS)
    whole = assign_cuda.fused_anchor_assign(*case, **kw)
    monkeypatch.setattr(assign_cuda, "PLAIN_CHUNK", 256)
    for a, b in zip(whole, assign_cuda.fused_anchor_assign(*case, **kw)):
        assert torch.equal(a, b)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    anchors, valid, gt, gtv, gtl = t(*assign_case(1, 10, 129, seed=1))
    with pytest.raises(ValueError, match="G=129"):
        assign_cuda.fused_anchor_assign(anchors, valid, gt, gtv, gtl, 0.5, 0.4)
    with pytest.raises(ValueError):
        assign_cuda.assign_gtmax(anchors.double(), valid, torch.zeros(1, 3, 6))


@pytest.mark.parametrize("pos_weight", [-1.0, 2.0])
def test_anchor_target_default_route(pos_weight):
    """The default configuration goes through the fused path and returns
    ioudet's AnchorTargets, counts included."""
    case = assign_case(2, 1500, 9, seed=7)
    shapes = np.array([[1000, 1000]] * 2, np.int32)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
    ours = anchor_target(*t(*case, shapes), MaxIoUAssigner(**kw), MEANS, STDS,
                         pos_weight=pos_weight)
    ref = jax_anchor_target(*j(*case, shapes), JaxAssigner(**kw), MEANS, STDS,
                            pos_weight=pos_weight)
    assert_outputs((ours.labels, ours.label_weights, ours.bbox_weights[..., 0],
                    ours.bbox_targets, ours.pos_gt_boxes),
                   (ref.labels, ref.label_weights, ref.bbox_weights[..., 0],
                    ref.bbox_targets, ref.pos_gt_boxes))
    assert ours.bbox_weights.shape == (2, 1500, 4)
    assert int(ours.num_total_pos) == int(ref.num_total_pos) > 0
    assert int(ours.num_total_neg) == int(ref.num_total_neg) > 0


@pytest.mark.parametrize("route", ["border", "ignore", "single_best"])
def test_general_route_matches_anchor_target_single(route):
    """What the fused path does not cover runs the general path in plain
    torch: a border rule, ignore regions, gt_max_assign_all=False."""
    case = assign_case(2, 1200, 9, seed=11)
    anchors, valid, gt, gtv, gtl = case
    shapes = np.array([[600, 640], [500, 600]], np.int32)
    akw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.1)
    kw, extra = dict(pos_weight=2.0), ()
    if route == "border":
        kw["allowed_border"] = 0
    elif route == "single_best":
        akw["gt_max_assign_all"] = False
    else:
        akw["ignore_iof_thr"] = 0.5
        rng = np.random.default_rng(1)
        xy = rng.uniform(0, 400, (2, 3, 2)).astype(np.float32)
        extra = (np.concatenate([xy, xy + 200], -1), np.array([[1, 1, 0], [1, 0, 1]], bool))
    ours = anchor_target(
        *t(*case, shapes), MaxIoUAssigner(**akw), MEANS, STDS, **kw,
        **dict(zip(("gt_bboxes_ignore", "gt_ignore_valid"), t(*extra))))
    assigner = JaxAssigner(**akw)

    def single(vf, gb, gv, gl, shape, *ign):
        return jax_single(jnp.asarray(anchors), vf, gb, gv, gl, shape, assigner,
                          MEANS, STDS, kw.get("allowed_border", -1), 2.0, *ign)

    ref = jax.vmap(single)(*j(valid, gt, gtv, gtl, shapes, *extra))
    assert_outputs((ours.labels, ours.label_weights, ours.bbox_weights[..., 0],
                    ours.bbox_targets, ours.pos_gt_boxes),
                   (ref[0], ref[1], ref[3][..., 0], ref[2], ref[4]))
    assert int(ours.num_total_pos) == int(ref[5].sum()) > 0
    assert int(ours.num_total_neg) == int(ref[6].sum()) > 0
    if route == "ignore":  # the regions took anchors out of the loss
        plain = anchor_target(*t(*case, shapes), MaxIoUAssigner(**dict(akw, ignore_iof_thr=-1)),
                              MEANS, STDS, **kw)
        assert float(plain.label_weights.sum()) > float(ours.label_weights.sum())


def test_general_route_equals_fused_route():
    """The two routes of the port agree where both apply."""
    case = t(*assign_case(2, 1500, 9, seed=7), np.array([[1000, 1000]] * 2, np.int32))
    assigner = MaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.2)
    fused = anchor_target(*case, assigner, MEANS, STDS)
    general = anchor_target_single(*case, assigner, MEANS, STDS)
    assert torch.equal(fused.labels, general[0])
    assert torch.equal(fused.label_weights, general[1])
    torch.testing.assert_close(fused.bbox_targets, general[2], rtol=1e-6, atol=1e-6)
    assert torch.equal(fused.pos_gt_boxes, general[4])


def test_sampler_is_not_ported():
    """Anchor subsampling (the RPN's sampling=True path, ported since the
    two-stage detectors): a sampler takes the general path, and one whose
    ``num`` exceeds the anchors samples every assigned anchor, as ioudet's
    does whatever its draw; a small one caps the sampled set."""
    from ioudet.core.bbox.samplers import RandomSampler as JaxRandomSampler
    from ioudet_torch.core.bbox.samplers import RandomSampler

    case = assign_case(2, 1500, 9, seed=7)
    shapes = np.array([[1000, 1000]] * 2, np.int32)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
    ours = anchor_target(*t(*case, shapes), MaxIoUAssigner(**kw), MEANS, STDS,
                         sampler=RandomSampler(4000, 0.5),
                         generator=torch.Generator().manual_seed(0))
    ref = jax.jit(lambda *a: jax_anchor_target(
        *a, JaxAssigner(**kw), MEANS, STDS, sampler=JaxRandomSampler(4000, 0.5),
        rng=jax.random.PRNGKey(0)))(*j(*case, shapes))
    assert_outputs((ours.labels, ours.label_weights, ours.bbox_weights[..., 0],
                    ours.bbox_targets, ours.pos_gt_boxes),
                   (ref.labels, ref.label_weights, ref.bbox_weights[..., 0],
                    ref.bbox_targets, ref.pos_gt_boxes))
    assert int(ours.num_total_pos) == int(ref.num_total_pos) > 0
    assert int(ours.num_total_neg) == int(ref.num_total_neg) > 0
    small = anchor_target(*t(*case, shapes), MaxIoUAssigner(**kw), MEANS, STDS,
                          sampler=RandomSampler(64, 0.25),
                          generator=torch.Generator().manual_seed(0))
    per_image = small.label_weights.gt(0).sum(-1)
    assert per_image.tolist() == [64, 64]
    assert int(small.num_total_pos) <= 32 and int(small.num_total_pos + small.num_total_neg) == 128
