"""The two-stage multi-scale / flip TTA in the port against ``ioudet``'s: the
three merges (``merge_aug_proposals`` with padding rows, flips, scales and
ties among zero scores; ``merge_aug_bboxes_mean``; ``merge_aug_masks``
with flips and weights), ``aug_test_two_stage`` of the tiny Mask R-CNN of
``mask_rcnn_cfgs`` (its Faster R-CNN too: the same weights without the mask
branch give ``ioudet``'s Mask R-CNN boxes) and Cascade R-CNN of
``cascade_rcnn_cfgs`` on a planted dataset whose test pipeline takes two
scales with flip, all views on one 96x128 canvas (so that ``ioudet``
compiles each primitive once); identity views against ``simple_test``;
HTC's TTA (the cascade's primitives, boxes only); the named error of a
detector without an RPN; and ``tools.test``'s TTA route with a two-stage
config.  Two ``ioudet`` detectors are compiled.

Tolerances: the proposal merge bit for bit (a division, a sort, the plain
greedy NMS and a selection: exact in both); the box mean and the masks
1e-6 abs (a mean of four in another order); TTA detections labels exact,
dets rtol 1e-4 and 1e-3 abs and masks 5e-5 abs (tests/test_torch_htc.py's:
each view's decode and mask of features that differ by f32 roundoff, on
twin weights); identity views and HTC's boxes bit-equal (the same
arithmetic in the port)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.apis.test import aug_test_two_stage as jax_aug_test_two_stage
from ioudet.core.post_processing.merge_augs import (
    merge_aug_bboxes_mean as jax_merge_aug_bboxes_mean, merge_aug_masks as jax_merge_aug_masks,
    merge_aug_proposals as jax_merge_aug_proposals)
from ioudet.data import build_dataset as jax_build_dataset
from ioudet.models import build_detector as jax_build_detector
from ioudet_torch.apis.checkpoint import save_checkpoint, state_dict_from_flax
from ioudet_torch.apis.test import aug_test_two_stage, tta_test
from ioudet_torch.core.post_processing import (merge_aug_bboxes_mean, merge_aug_masks,
                                               merge_aug_proposals)
from ioudet_torch.data import build_dataset
from ioudet_torch.models import build_detector
from ioudet_torch.tools import test as test_tool
from tests._torch_mp_worker import cascade_rcnn_cfgs, htc_cfgs, mask_rcnn_cfgs
from tests.test_torch_data_pipeline import plant_coco
from tests.test_torch_tta import TTA_PIPELINE
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

SIZES = [(48, 80), (64, 96)]   # landscape: one canvas
CANVAS = (96, 128)   # TTA_PIPELINE's Pad size: every view's


# ------------------------------------------------------------------ merges

def jax_meta(shape, scale, flip):
    return dict(img_shape=jnp.asarray(shape, jnp.int32), scale_factor=float(scale), flip=flip)


def torch_meta(shape, scale, flip):
    return dict(img_shape=torch.tensor(shape, dtype=torch.int32),
                scale_factor=torch.tensor(scale, dtype=torch.float32), flip=flip)


VIEWS = (((64, 96), 1.0, False), ((64, 96), 1.0, True), ((48, 72), 0.75, False),
         ((48, 72), 0.75, True))


def view_proposals(seed: int, num: int = 40, valid: int = 28) -> list:
    """Each view's (num, 5) proposals: boxes in the view, scores with ties
    (rounded to eighths), ``valid`` of them positive and the rest padding
    rows of score 0 that keep nonzero boxes (as the RPN's do not, but the
    merge must carry them in order all the same)."""
    rng = np.random.default_rng(seed)
    out = []
    for (h, w), _, _ in VIEWS:
        xy = rng.uniform(0, 1, (num, 2)) * (w - 10, h - 10)
        wh = rng.uniform(4, 30, (num, 2))
        score = np.floor(rng.uniform(0.05, 1.0, (num, 1)) * 8) / 8
        score[valid:] = 0.0
        out.append(np.concatenate([xy, xy + wh, score], 1).astype(np.float32))
    return out


@pytest.mark.parametrize("max_num", [30, 200])
def test_merge_aug_proposals_matches_ioudet(max_num):
    """Four views (two scales, flip) through one NMS: the kept proposals, the
    order of tied scores and the padding rows' boxes (the suppressed and the
    invalid candidates, in sorted order) bit for bit; with max_num past the
    candidates every one of them comes back."""
    props = view_proposals(1)
    cfg = dict(nms_thr=0.5, max_num=max_num)
    got = merge_aug_proposals([torch.from_numpy(p) for p in props],
                              [torch_meta(*v) for v in VIEWS], cfg)
    want = np.asarray(jax_merge_aug_proposals([jnp.asarray(p) for p in props],
                                              [jax_meta(*v) for v in VIEWS], cfg))
    assert tuple(got.shape) == (min(max_num, 160), 5)
    np.testing.assert_array_equal(got.numpy(), want)
    kept = int((got[:, 4] > 0).sum())
    assert 0 < kept < 4 * 28 and (got[kept:, 4] == 0).all()
    if max_num > 160:
        assert got[kept:, :4].abs().sum() > 0   # the padding rows keep their boxes


def test_merge_aug_proposals_maps_back_then_suppresses():
    """ioudet's hand case: a flipped view's box maps back onto the identity
    view's, with a higher score, and suppresses it; a 2x view's lands at
    half its coordinates; the last slot is padding."""
    props = [torch.tensor([[0.0, 0.0, 10.0, 10.0, 0.9], [20.0, 20.0, 30.0, 30.0, 0.8]]),
             torch.tensor([[29.0, 0.0, 39.0, 10.0, 0.95]]),
             torch.tensor([[24.0, 24.0, 32.0, 32.0, 0.7]])]
    metas = [torch_meta((50, 40), 1.0, False), torch_meta((50, 40), 1.0, True),
             torch_meta((100, 80), 2.0, False)]
    merged = merge_aug_proposals(props, metas, dict(nms_thr=0.5, max_num=4))
    assert merged.tolist() == [[0.0, 0.0, 10.0, 10.0, 0.949999988079071],
                               [20.0, 20.0, 30.0, 30.0, 0.800000011920929],
                               [12.0, 12.0, 16.0, 16.0, 0.699999988079071],
                               [0.0, 0.0, 10.0, 10.0, 0.0]]


def test_merge_aug_bboxes_mean_and_masks_match_ioudet():
    rng = np.random.default_rng(2)
    boxes = [rng.uniform(0, 90, (30, 4, 4)).astype(np.float32) for _ in VIEWS]
    scores = [rng.uniform(0, 1, (30, 4)).astype(np.float32) for _ in VIEWS]
    got = merge_aug_bboxes_mean([torch.from_numpy(b) for b in boxes],
                                [torch.from_numpy(s) for s in scores],
                                [torch_meta(*v) for v in VIEWS])
    want = jax_merge_aug_bboxes_mean([jnp.asarray(b) for b in boxes],
                                     [jnp.asarray(s) for s in scores],
                                     [jax_meta(*v) for v in VIEWS])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6 * 90)
    masks = [rng.uniform(0, 1, (12, 28, 28)).astype(np.float32) for _ in VIEWS]
    for weights in (None, (3.0, 1.0, 2.0, 0.5)):
        got = merge_aug_masks([torch.from_numpy(m) for m in masks],
                              [torch_meta(*v) for v in VIEWS], weights)
        want = jax_merge_aug_masks([jnp.asarray(m) for m in masks],
                                   [jax_meta(*v) for v in VIEWS], weights)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # a flipped view's crop is mirrored back: the mirror image of a view is that view
    base = torch.from_numpy(masks[0])
    merged = merge_aug_masks([base, base.flip(-1)], [dict(flip=False), dict(flip=True)])
    assert torch.equal(merged, base)


# -------------------------------------------------------------- detectors

def twin(cfgs) -> tuple:
    """(port model, ioudet detector, ioudet's parameters) of a tiny
    two-stage config on seeded values of ``ioudet``'s tree."""
    model_cfg, train_cfg, test_cfg = cfgs
    det = jax_build_detector(dict(model_cfg), train_cfg, test_cfg)
    img = jnp.zeros((1,) + CANVAS + (3,), jnp.float32)
    shape = jnp.asarray([CANVAS], jnp.int32)
    params = random_params(param_shapes(det, img, shape, jnp.ones((1,)), shape,
                                        method=det.simple_test), seed=0)
    model = build_detector(model_cfg, train_cfg, test_cfg)
    model.load_state_dict(state_dict_from_flax(params))
    return model.eval(), det, params


@pytest.fixture(scope="module")
def mask_twin():
    return twin(mask_rcnn_cfgs())


@pytest.fixture(scope="module")
def cascade_twin():
    return twin(cascade_rcnn_cfgs())


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """A planted COCO set of 2 images with 4 categories, a rectangle polygon
    a box, through TTA_PIPELINE in both packages."""
    import json

    root = str(tmp_path_factory.mktemp("tta2"))
    ann_file, img_dir = plant_coco(root, SIZES, seed=9, num_cats=4, crowd=False)
    with open(ann_file) as f:
        coco = json.load(f)
    for a in coco["annotations"]:
        x, y, w, h = a["bbox"]
        a["segmentation"] = [[x, y, x + w, y, x + w, y + h, x, y + h]]
    with open(ann_file, "w") as f:
        json.dump(coco, f)
    cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
               pipeline=TTA_PIPELINE, test_mode=True)
    return cfg, build_dataset(cfg), jax_build_dataset(cfg)


def ioudet_tta(det, params, jds, test_cfg) -> list:
    """``ioudet``'s ``aug_test_two_stage`` of every planted image."""
    return [jax_aug_test_two_stage(det, params, jds[idx], test_cfg) for idx in range(len(SIZES))]


def check_against_ioudet(model, refs, ds, test_cfg, masks: bool) -> None:
    for idx, ref in enumerate(refs):
        views = ds[idx]
        assert len(views) == 4 and {v["img"].shape[:2] for v in views} == {CANVAS}
        out = aug_test_two_stage(model, views, test_cfg)
        assert len(out) == len(ref) == (3 if masks else 2)
        np.testing.assert_array_equal(out[1].numpy(), ref[1])
        assert int((out[1] >= 0).sum()) >= 5
        np.testing.assert_allclose(out[0].numpy(), ref[0], rtol=1e-4, atol=1e-3)
        if masks:
            np.testing.assert_allclose(out[2].numpy(), ref[2], rtol=0, atol=5e-5)


@pytest.fixture(scope="module")
def mask_refs(mask_twin, planted):
    _, det, params = mask_twin
    return ioudet_tta(det, params, planted[2], mask_rcnn_cfgs()[2])


def test_mask_rcnn_tta_matches_ioudet(mask_twin, mask_refs, planted):
    check_against_ioudet(mask_twin[0], mask_refs, planted[1], mask_rcnn_cfgs()[2], masks=True)


def faster_of(model):
    model_cfg, train_cfg, test_cfg = mask_rcnn_cfgs()
    faster = build_detector(dict(model_cfg, type="FasterRCNN", mask_roi_extractor=None,
                                 mask_head=None), train_cfg, test_cfg).eval()
    faster.load_state_dict({k: v for k, v in model.state_dict().items()
                            if not k.startswith("mask_")})
    return faster


def test_faster_rcnn_tta_gives_the_mask_rcnn_boxes(mask_twin, mask_refs, planted):
    """Faster R-CNN on the Mask R-CNN's box weights: its TTA is ioudet's
    Mask R-CNN TTA without the masks (the mask pass comes after the NMS)."""
    model = mask_twin[0]
    ds = planted[1]
    faster = faster_of(model)
    test_cfg = mask_rcnn_cfgs()[2]
    for idx, ref in enumerate(mask_refs[:1]):
        dets, labels = aug_test_two_stage(faster, ds[idx], test_cfg)
        np.testing.assert_array_equal(labels.numpy(), ref[1])
        np.testing.assert_allclose(dets.numpy(), ref[0], rtol=1e-4, atol=1e-3)
        mine = aug_test_two_stage(model, ds[idx], test_cfg)
        assert torch.equal(dets, mine[0]) and torch.equal(labels, mine[1])


def test_cascade_rcnn_tta_matches_ioudet(cascade_twin, planted):
    model, det, params = cascade_twin
    refs = ioudet_tta(det, params, planted[2], cascade_rcnn_cfgs()[2])
    check_against_ioudet(model, refs, planted[1], cascade_rcnn_cfgs()[2], masks=False)


def identity_view(seed: int) -> tuple:
    """(one view at scale 1 without flip on the 64x96 canvas, the same image
    as simple_test's inputs)."""
    img = np.random.default_rng(seed).normal(0, 1, (64, 96, 3)).astype(np.float32)
    shape = np.array([64, 96], np.int32)
    view = dict(img=img, img_shape=shape, pad_shape=shape, scale_factor=np.float32(1.0),
                flip=False)
    inputs = (torch.from_numpy(img)[None], torch.from_numpy(shape)[None], torch.ones(1),
              torch.from_numpy(shape)[None])
    return view, inputs


@pytest.mark.parametrize("name", ["faster", "mask", "cascade"])
def test_identity_view_equals_simple_test(name, mask_twin, cascade_twin):
    """One view at scale 1 without flip: the merge keeps the RPN's proposals
    as they are (already suppressed at the same IoU, sorted, padded last),
    the mean of one view is that view, so the TTA gives ``simple_test``'s
    outputs bit for bit."""
    model = dict(faster=lambda: faster_of(mask_twin[0]), mask=lambda: mask_twin[0],
                 cascade=lambda: cascade_twin[0])[name]()
    view, inputs = identity_view(4)
    with torch.no_grad():
        want = model.simple_test(*inputs)
    got = aug_test_two_stage(model, [view])
    assert len(got) == len(want)
    assert all(torch.equal(g, w[0]) for g, w in zip(got, want))
    assert int((got[1] >= 0).sum()) >= 5


def test_htc_tta_is_the_cascades_boxes(cascade_twin):
    """HTC's TTA takes the cascade's primitives, as ``ioudet``'s does: no
    semantic feature and no masks.  On the cascade's box weights it gives
    Cascade R-CNN's TTA bit for bit."""
    cascade = cascade_twin[0]
    model_cfg, train_cfg, test_cfg = htc_cfgs()
    htc = build_detector(model_cfg, train_cfg, test_cfg).eval()
    htc.init_weights(torch.Generator().manual_seed(0))
    htc.load_state_dict(cascade.state_dict(), strict=False)
    view, _ = identity_view(5)
    flipped = dict(view, img=view["img"][:, ::-1].copy(), flip=True)
    got = aug_test_two_stage(htc, [view, flipped])
    want = aug_test_two_stage(cascade, [view, flipped])
    assert len(got) == 2 and all(torch.equal(g, w) for g, w in zip(got, want))
    assert int((got[1] >= 0).sum()) >= 5


def test_detector_without_rpn_raises():
    model_cfg, train_cfg, test_cfg = mask_rcnn_cfgs()
    fast = build_detector({k: v for k, v in dict(model_cfg, type="FastRCNN").items()
                           if k not in ("rpn_head", "mask_roi_extractor", "mask_head")},
                          train_cfg, test_cfg).eval()
    view, _ = identity_view(6)
    with pytest.raises(NotImplementedError, match="FastRCNN reads its proposals"):
        aug_test_two_stage(fast, [view])


def test_tta_test_and_the_test_tool(mask_twin, planted, tmp_path):
    """``tta_test`` of the Mask R-CNN gives (bbox, segm) pairs, and
    ``python -m ioudet_torch.tools.test`` on a config whose test pipeline
    holds ``MultiScaleFlipAug`` takes that route: its metrics are those of
    ``tta_test``'s results."""
    model = mask_twin[0]
    ds_cfg, ds, _ = planted
    model_cfg, _, test_cfg = mask_rcnn_cfgs()
    results = tta_test(model, ds, test_cfg)
    assert len(results) == len(SIZES)
    assert all(isinstance(r, tuple) and len(r[0]) == len(r[1]) == 4 for r in results)
    assert all(len(b) == len(s) for r in results for b, s in zip(*r))
    ckpt = save_checkpoint(str(tmp_path), "weights", model)
    config = tmp_path / "cfg.py"
    config.write_text(f"model = {model_cfg!r}\ntest_cfg = {test_cfg!r}\n"
                      f"data = {dict(test=ds_cfg)!r}\n")
    metrics = test_tool.main([str(config), ckpt, "--eval", "bbox", "segm", "--device", "cpu"])
    assert metrics == {"bbox": ds.evaluate(results, metric="bbox"),
                       "segm": ds.evaluate(results, metric="segm")}
    assert all(np.isfinite(v) for m in metrics.values() for v in m.values())
