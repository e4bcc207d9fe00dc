"""Port parity of FreeAnchor RetinaNet on the CPU: the scatter-amax
P{matched} against ``ioudet``'s max over the (G, A, C) product, values and
gradients, with tied maxima; the head's loss and its gradients w.r.t. the
head outputs against ``ioudet``'s ``FreeAnchorRetinaHead.loss``; padded gt
slots and a gt whose best decoded IoU is under ``bbox_thr`` (where
``ioudet``'s box gradient is NaN); bags cut through anchor-IoU ties; a tiny
FreeAnchor RetinaNet (R-18, FPN and head 32 wide, 5 classes) on bridged
weights: ``simple_test``, ``forward_train``'s losses and every gradient;
the single-stage TTA against ``ioudet``'s ``aug_test``; the named errors of
bf16 and int8.

Where ``ioudet``'s gradients are finite the port's equal them: every valid
gt of those cases has a decoded box above ``bbox_thr`` (the twin's box
deltas are drawn small and its gts are anchors of the grid).  Where a gt's
best IoU is at most ``bbox_thr`` (a padded slot, a zero box, practically
always), ``ioudet``'s box gradient is NaN (0 / 0 in ``(iou - t1) / (t2 -
t1)``); the port's is finite and the padded slots change neither its loss
nor its gradients.

Tolerances.  P{matched} bit for bit, its gradient to 1e-6.  Head losses
rtol 1e-5, their gradients within 1e-5 of each tensor's largest |value|.
The detector: ``simple_test`` labels exact, dets rtol 1e-4 / atol 1e-3;
losses rtol 1e-4; gradients within 1e-3 of each tensor's largest |value|
(sums over some 30 layers in another order).  TTA: labels exact, dets rtol
1e-4 / atol 1e-3 (tests/test_torch_tta.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.apis.test import aug_test as jax_aug_test
from ioudet.core.bbox import bbox_overlaps as jax_bbox_overlaps
from ioudet.data import build_dataset as jax_build_dataset
from ioudet.models import build_detector as jax_build_detector
from ioudet.models.heads import FreeAnchorRetinaHead as JaxFreeAnchorRetinaHead
from ioudet_torch.apis.checkpoint import module_types, state_dict_from_flax
from ioudet_torch.apis.test import aug_test
from ioudet_torch.core.bbox import bbox_overlaps
from ioudet_torch.core.post_processing.bbox_nms import topk_stable
from ioudet_torch.data import build_dataset
from ioudet_torch.models import build_detector
from ioudet_torch.models.heads.free_anchor_retina_head import FreeAnchorRetinaHead
from tests.test_torch_data_pipeline import plant_coco
from tests.test_torch_tta import TTA_PIPELINE
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

HEAD = dict(num_classes=4, in_channels=8, feat_channels=8, stacked_convs=1,
            anchor_strides=(8, 16), pre_anchor_topk=6)
SIZES = [(4, 6), (2, 3)]
C = 3
MODEL = dict(
    type="RetinaNet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1, norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32, start_level=1,
              add_extra_convs=True, num_outs=5),
    bbox_head=dict(type="FreeAnchorRetinaHead", num_classes=5, in_channels=32,
                   feat_channels=32, stacked_convs=1, anchor_strides=(8, 16, 32, 64, 128),
                   pre_anchor_topk=16, bbox_thr=0.6, gamma=2.0, alpha=0.5))
TEST_CFG = dict(nms_pre=60, score_thr=0.05, nms=dict(iou_thr=0.5), max_per_img=20)
CANVAS = (96, 128)
SHAPES = np.array([[96, 128], [96, 128]], np.int32)
FACTORS = np.array([1.0, 0.625], np.float32)
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")


def t(a):
    return torch.from_numpy(np.array(a))


def assert_scaled(got, want, tol: float, what: str = "") -> None:
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


# ------------------------------------------------------------------ P{matched}

def jax_box_prob(obj_iou, labels, valid, t1=0.6):
    """ioudet's P{matched} (free_anchor_retina_head.py, ``single``), batched
    by vmap: obj_iou (B, G, A) -> (B, A, C)."""
    def single(iou, gl, gv):
        t2 = jnp.clip(jnp.max(iou, axis=-1, keepdims=True), t1 + 1e-12, None)
        obj_prob = jnp.clip((iou - t1) / (t2 - t1), 0.0, 1.0) * gv[:, None]
        onehot = jax.nn.one_hot(gl - 1, C) * gv[:, None]
        return jnp.max(obj_prob[:, :, None] * onehot[:, None, :], axis=0)
    return jax.vmap(single)(obj_iou, labels, valid)


def test_box_prob_scatter_amax_matches_the_gac_max():
    """Five gt slots over 12 anchors: gt 0's best IoU at two anchors (both
    obj_prob 1), gt 1 its duplicate of the same class (a tie across gts),
    gt 2 of another class, gt 3 with its best IoU under bbox_thr, gt 4
    padded (over IoUs above it).  Values bit for bit; the gradient of a
    weighted sum: equal where ioudet's is finite (0 in the padded row), NaN
    in ioudet's row of gt 3 and 0 in the port's."""
    rng = np.random.default_rng(0)
    iou = rng.uniform(0.0, 0.95, (1, 5, 12)).astype(np.float32)
    iou[0, 0, [2, 7]] = 0.9
    iou[0, 0, 2:] = np.minimum(iou[0, 0, 2:], 0.9)
    iou[0, 1] = iou[0, 0]
    iou[0, 3] = rng.uniform(0.0, 0.55, 12)
    labels = np.array([[1, 1, 2, 3, 0]], np.int32)
    valid = np.array([[True, True, True, True, False]])
    w = rng.normal(0, 1, (1, 12, C)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x: jax_box_prob(x, jnp.asarray(labels), jnp.asarray(valid)),
                       jnp.asarray(iou))
    (ref_grad,) = vjp(jnp.asarray(w))
    head = FreeAnchorRetinaHead(**dict(HEAD))
    x = t(iou).requires_grad_()
    out = head.box_prob(x, t(labels), t(valid).float())
    (out * t(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    assert (np.asarray(ref)[0, [2, 7], 0] == 1.0).all()
    ref_grad = np.asarray(ref_grad)
    rows = [0, 1, 2, 4]
    np.testing.assert_allclose(x.grad.numpy()[0, rows], ref_grad[0, rows], rtol=0, atol=1e-6)
    # the tie of gts 0 and 1 at anchors 2 and 7 splits the gradient between them
    assert (x.grad.numpy()[0, 0, [2, 7]] != 0).all()
    assert (ref_grad[0, 4] == 0).all()
    assert np.isnan(ref_grad[0, 3]).all()
    assert (x.grad.numpy()[0, 3] == 0).all()


# ------------------------------------------------------------------ the head's loss

def anchors_of(head) -> np.ndarray:
    return head.level_anchors(SIZES, "cpu")


def head_case(seed: int, gts: np.ndarray, labels: np.ndarray, valid: np.ndarray) -> tuple:
    """Head outputs at SIZES: logits around -2, box deltas small (decoded
    boxes near their anchors)."""
    rng = np.random.default_rng(seed)
    A9 = 9
    cls = [rng.normal(-2, 1, (2, h, w, A9 * C)).astype(np.float32) for h, w in SIZES]
    box = [rng.normal(0, 0.05, (2, h, w, A9 * 4)).astype(np.float32) for h, w in SIZES]
    return cls, box, gts.astype(np.float32), labels.astype(np.int32), valid


def grid_gts(head, picks) -> np.ndarray:
    """gts that are anchors of the grid (their decoded twins sit near IoU
    1), ``picks`` (B, G) anchor indices."""
    anchors = torch.cat(anchors_of(head)).numpy()
    return np.stack([anchors[p] for p in picks])


def run_both(case) -> tuple:
    """(port losses, port gradients w.r.t. cls / box maps), and ioudet's."""
    cls, box, gts, labels, valid = case
    jhead = JaxFreeAnchorRetinaHead(**HEAD)
    shapes = jnp.asarray([[32, 48], [32, 48]], jnp.int32)

    def f(c, b):
        out = jhead.loss(c, b, jnp.asarray(gts), jnp.asarray(labels), jnp.asarray(valid),
                         shapes, shapes, dict())
        return out["loss_cls"] + out["loss_bbox"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        [jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in box])
    head = FreeAnchorRetinaHead(**dict(HEAD))
    tc = [t(c).requires_grad_() for c in cls]
    tb = [t(b).requires_grad_() for b in box]
    out = head.loss(tc, tb, t(gts), t(labels), t(valid), t([[32, 48], [32, 48]]),
                    t([[32, 48], [32, 48]]), dict())
    (out["loss_cls"] + out["loss_bbox"]).backward()
    return ({k: float(v.detach()) for k, v in out.items()}, ([c.grad for c in tc],
                                                              [b.grad for b in tb]),
            {k: float(v) for k, v in jout.items()}, jax.device_get(jgrads))


def test_head_loss_and_gradients_match_ioudet():
    head = FreeAnchorRetinaHead(**dict(HEAD))
    gts = grid_gts(head, [[30, 100, 200], [5, 150, 230]])
    case = head_case(1, gts, np.array([[1, 2, 3], [3, 1, 1]]), np.ones((2, 3), bool))
    out, grads, jout, jgrads = run_both(case)
    assert sorted(out) == sorted(jout) == ["loss_bbox", "loss_cls"]
    for k in out:
        np.testing.assert_allclose(out[k], jout[k], rtol=1e-5, err_msg=k)
    for which, ours, theirs in zip(("cls", "box"), grads, jgrads):
        for lvl, (o, r) in enumerate(zip(ours, theirs)):
            assert np.isfinite(r).all()
            assert_scaled(o, r, 1e-5, f"{which} level {lvl}")


def test_padded_and_low_iou_gts():
    """Padded slots (their boxes over a valid gt, any label) change neither
    the port's loss nor its gradients; a valid gt with no decoded box above
    bbox_thr (a thin box) gives ioudet a NaN box gradient and the port a
    finite one, its loss and cls gradient ioudet's."""
    head = FreeAnchorRetinaHead(**dict(HEAD))
    gts = grid_gts(head, [[30, 100, 200], [5, 150, 230]])
    gts[1, 2] = [4.0, 10.0, 40.0, 12.0]                     # thin: IoU < 0.6 everywhere
    labels = np.array([[1, 2, 3], [3, 1, 2]])
    base = head_case(2, gts, labels, np.ones((2, 3), bool))
    out, grads, jout, jgrads = run_both(base)
    for k in out:
        np.testing.assert_allclose(out[k], jout[k], rtol=1e-5, err_msg=k)
    for lvl, (o, r) in enumerate(zip(grads[0], jgrads[0])):
        assert_scaled(o, r, 1e-5, f"cls level {lvl}")
    assert any(np.isnan(r).any() for r in jgrads[1])
    assert all(torch.isfinite(o).all() for o in grads[1])

    padded_gts = np.concatenate([gts, gts[:, :2]], 1)        # two slots over valid gts
    padded = head_case(2, padded_gts, np.concatenate([labels, [[2, 1], [3, 3]]], 1),
                       np.concatenate([np.ones((2, 3), bool), np.zeros((2, 2), bool)], 1))
    pout, pgrads, pjout, _ = run_both(padded)
    for k in out:
        np.testing.assert_allclose(pout[k], out[k], rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(pjout[k], jout[k], rtol=1e-6, err_msg=k)
    for ours, base_grads in zip(pgrads, grads):
        for o, b in zip(ours, base_grads):
            torch.testing.assert_close(o, b, rtol=1e-6, atol=1e-9)


def test_bags_cut_through_anchor_iou_ties():
    """gts fully inside several anchors of one shape: the anchors' IoUs tie
    (area(gt) / area(anchor) at every offset that contains the gt) and the
    top-6 cut passes through a run of them.  The port's bags are lax.top_k's
    (the lower anchor index first), and so are its losses."""
    head = FreeAnchorRetinaHead(**dict(HEAD))
    anchors = torch.cat(anchors_of(head))
    gts = np.array([[[20.0, 12.0, 27.0, 19.0], [30.0, 6.0, 33.0, 9.0]],
                    [[12.0, 12.0, 19.0, 19.0], [4.0, 4.0, 7.0, 7.0]]], np.float32)
    iou = bbox_overlaps(t(gts), anchors.expand(2, -1, 4))
    _, bag = topk_stable(iou, 6)
    ref = np.stack([np.asarray(jax.lax.top_k(jax_bbox_overlaps(jnp.asarray(g),
                                                               jnp.asarray(anchors.numpy())), 6)[1])
                    for g in gts])
    np.testing.assert_array_equal(bag.numpy(), ref)
    cut = iou.gather(-1, bag[..., -1:])
    ties = ((iou == cut).sum(-1) > 1) & ((iou > cut).sum(-1) < 6)
    assert ties.sum() >= 2, "the planted gts cut the bags through ties"
    case = head_case(3, gts, np.array([[1, 2], [3, 3]]), np.ones((2, 2), bool))
    out, _, jout, _ = run_both(case)
    for k in out:
        np.testing.assert_allclose(out[k], jout[k], rtol=1e-5, err_msg=k)


# ------------------------------------------------------------------ the detector

def images(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 1, (2,) + CANVAS + (3,)).astype(np.float32)


@pytest.fixture(scope="module")
def twin():
    """The tiny FreeAnchor RetinaNet on ioudet's seeded tree (retina_reg
    drawn at 0.01 of its He scale, so that decoded boxes sit near their
    anchors and every gt below, an anchor of the grid, has one above
    bbox_thr); ioudet's simple_test, losses and gradients, one program."""
    det = jax_build_detector(MODEL, dict(), TEST_CFG)
    params = random_params(param_shapes(det, jnp.zeros((1,) + CANVAS + (3,))), seed=0)
    reg = params["bbox_head"]["retina_reg"]
    reg["kernel"] = (reg["kernel"] * 0.01).astype(np.float32)
    model = build_detector(MODEL, dict(), TEST_CFG)
    model.load_state_dict(state_dict_from_flax(params, module_types(model)), strict=True)
    anchors = torch.cat(model.bbox_head.level_anchors(
        [(12, 16), (6, 8), (3, 4), (2, 2), (1, 1)], "cpu")).numpy()
    gts = np.stack([anchors[[200, 900, 1500]], anchors[[60, 1200, 1650]]])
    labels = np.array([[1, 2, 3], [4, 1, 2]], np.int32)
    valid = np.ones((2, 3), bool)
    img = images()

    def losses(p, *a):
        out = det.apply({"params": p}, *a, method=det.forward_train)
        return sum(out.values()), out

    @jax.jit
    def run(p, img, shapes, factors, gb, gl, gv):
        dets = det.apply({"params": p}, img, shapes, factors, shapes, method=det.simple_test)
        (_, out), grads = jax.value_and_grad(losses, has_aux=True)(
            p, img, gb, gl, gv, shapes, shapes)
        return dets, out, grads

    ref = jax.device_get(run(params, *(jnp.asarray(a) for a in (img, SHAPES, FACTORS, gts,
                                                                 labels, valid))))
    return det, params, model, img, (gts, labels, valid), ref


def test_simple_test_matches_ioudet(twin):
    _, _, model, img, _, ((ref_dets, ref_labels), _, _) = twin
    with torch.no_grad():
        dets, labels = model.eval().simple_test(t(img), t(SHAPES), t(FACTORS), t(SHAPES))
    assert (ref_labels >= 0).sum() > 10
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_allclose(dets.numpy(), ref_dets, rtol=1e-4, atol=1e-3)


def test_forward_train_losses_and_gradients_match_ioudet(twin):
    _, _, model, img, gts, (_, ref_out, grads) = twin
    model.train().zero_grad()
    out = model.forward_train(t(img), *(t(a) for a in gts), t(SHAPES), t(SHAPES))
    assert sorted(out) == sorted(ref_out) == ["loss_bbox", "loss_cls"]
    for k in out:
        assert float(ref_out[k]) > 0
        np.testing.assert_allclose(float(out[k].detach()), float(ref_out[k]), rtol=1e-4,
                                   err_msg=k)
    sum(out.values()).backward()
    ref_grads = state_dict_from_flax(grads, module_types(model))
    for k, p in model.named_parameters():
        if k.startswith(FROZEN):
            assert p.grad is None, k
        else:
            assert np.isfinite(ref_grads[k].numpy()).all(), k
            assert_scaled(p.grad, ref_grads[k].numpy(), 1e-3, k)


def test_aug_test_matches_ioudet(twin, tmp_path):
    """The mstest pipeline's four views (two scales, flip) of planted
    images: FreeAnchor's decode is RetinaHead's, and the port's ``aug_test``
    takes it."""
    det, params, model, _, _, _ = twin
    ann_file, img_dir = plant_coco(str(tmp_path), [(48, 80), (64, 96), (80, 56)], seed=7)
    cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
               pipeline=TTA_PIPELINE, test_mode=True)
    ds, jds = build_dataset(cfg), jax_build_dataset(cfg)
    model.eval()
    for idx in range(len(ds)):
        dets, labels = aug_test(model, ds[idx], TEST_CFG)
        jd, jl = jax_aug_test(det, params, jds[idx], TEST_CFG)
        np.testing.assert_array_equal(labels.numpy(), jl)
        np.testing.assert_allclose(dets.numpy(), jd, rtol=1e-4, atol=1e-3)
        assert int((labels >= 0).sum()) >= 3


def test_bf16_and_int8_raise_named_errors(twin):
    from ioudet_torch.ops import quant

    with pytest.raises(NotImplementedError, match="FreeAnchorRetinaHead in torch.bfloat16"):
        build_detector(dict(MODEL, dtype="bfloat16"), dict(), TEST_CFG)
    with pytest.raises(NotImplementedError, match="int8 serving of FreeAnchorRetinaHead"):
        with quant.quantize_calls(twin[2]):
            pass
