"""Multi-scale / flip test-time augmentation in the port against ``ioudet``:
the box mappings and merges, ``MultiScaleFlipAug``'s views (the inner
``Resize`` / ``RandomFlip`` overrides draw nothing from the sample stream),
``aug_test`` on the tiny detector of tests/test_tta.py (weights bridged),
``tta_test`` on a planted dataset, and the port's tools/test.py taking the
TTA route for a config whose test pipeline holds ``MultiScaleFlipAug``.

Tolerances: the mappings bit for bit; views bit-equal; detections labels
exact and dets rtol 1e-4 / atol 1e-3 (tests/test_torch_detector.py's: the
decode of head outputs that differ by f32 roundoff)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.apis.test import aug_test as jax_aug_test, tta_test as jax_tta_test
from ioudet.core.bbox.transforms import (bbox_flip as jax_bbox_flip,
                                         bbox_mapping as jax_bbox_mapping,
                                         bbox_mapping_back as jax_bbox_mapping_back)
from ioudet.core.post_processing.merge_augs import (merge_aug_bboxes as jax_merge_aug_bboxes,
                                                    merge_aug_scores as jax_merge_aug_scores)
from ioudet.data import build_dataset as jax_build_dataset
from ioudet.data.pipelines.test_aug import MultiScaleFlipAug as JaxMultiScaleFlipAug
from ioudet.data.rng import set_sample_rng as jax_set_rng, make_sample_rng as jax_make_rng
from ioudet.models import build_detector as jax_build_detector
from ioudet_torch.apis.checkpoint import save_checkpoint
from ioudet_torch.apis.test import aug_test, tta_test
from ioudet_torch.core.bbox import bbox_flip, bbox_mapping, bbox_mapping_back
from ioudet_torch.core.post_processing import merge_aug_bboxes, merge_aug_scores
from ioudet_torch.data import build_dataset
from ioudet_torch.data.pipelines import Compose, MultiScaleFlipAug
from ioudet_torch.data.rng import make_sample_rng, sample_rng, set_sample_rng
from ioudet_torch.tools import test as test_tool
from tests.test_torch_data_pipeline import plant_coco
from tests.test_torch_eval_loop import bridged
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

# the detector of tests/test_tta.py's aug_test case
MODEL = dict(
    type="IoUAwareRetinaNet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=-1, norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32, start_level=1,
              add_extra_convs=True, num_outs=5),
    bbox_head=dict(type="IoUAwareRetinaHead", num_classes=3, in_channels=32, feat_channels=32,
                   stacked_convs=1, anchor_strides=(8, 16, 32, 64, 128)))
# class_topk and pre_nms_total are ignored by the merge, in both packages
TEST_CFG = dict(nms_pre=50, score_thr=0.01, nms=dict(iou_thr=0.5), max_per_img=10,
                rescoring_alpha=0.5, class_topk=1, pre_nms_total=30)
NORM = dict(type="Normalize", mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375),
            to_rgb=True)
# the mstest config's test pipeline at a small scale: two views a scale
TTA_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="MultiScaleFlipAug", img_scale=[(96, 64), (128, 80)], flip=True,
         transforms=[dict(type="Resize", keep_ratio=True),
                     dict(type="RandomFlip", flip_ratio=0.0),
                     NORM,
                     dict(type="Pad", size_divisor=32, size=(96, 128)),
                     dict(type="Collect", keys=["img"])]),
]
SIZES = [(48, 80), (64, 96), (80, 56), (60, 100), (72, 48)]


@pytest.fixture(scope="module")
def twins():
    model, params = bridged(MODEL, seed=5, test_cfg=TEST_CFG)
    return model, jax_build_detector(dict(MODEL), None, TEST_CFG), params


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tta"))
    ann_file, img_dir = plant_coco(root, SIZES, seed=7)
    cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
               pipeline=TTA_PIPELINE, test_mode=True)
    return root, cfg, build_dataset(cfg), jax_build_dataset(cfg)


@pytest.mark.parametrize("flip", [False, True])
def test_box_mappings_match_ioudet(flip):
    rng = np.random.default_rng(int(flip))
    boxes = rng.uniform(0, 300, (20, 5)).astype(np.float32)   # a score column rides along
    shape = np.array([200, 301], np.int32)
    factor = np.float32(1.3)
    t, s, f = torch.from_numpy(boxes), torch.from_numpy(shape), torch.tensor(factor)
    np.testing.assert_array_equal(bbox_flip(t, s).numpy(),
                                  np.asarray(jax_bbox_flip(jnp.asarray(boxes), jnp.asarray(shape))))
    np.testing.assert_array_equal(
        bbox_mapping(t[:, :4], s, f, flip).numpy(),
        np.asarray(jax_bbox_mapping(jnp.asarray(boxes[:, :4]), jnp.asarray(shape), factor, flip)))
    back = bbox_mapping_back(t[:, :4], s, f, flip)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_bbox_mapping_back(
        jnp.asarray(boxes[:, :4]), jnp.asarray(shape), jnp.asarray(factor), flip)))
    # the round trip, in the +1 flip convention
    np.testing.assert_allclose(bbox_mapping(back, s, f, flip).numpy(), boxes[:, :4], atol=1e-4)


def test_merges_match_ioudet():
    rng = np.random.default_rng(3)
    boxes = [rng.uniform(0, 90, (n, 4)).astype(np.float32) for n in (7, 5, 9)]
    scores = [rng.uniform(0, 1, (n, 4)).astype(np.float32) for n in (7, 5, 9)]
    metas = [dict(img_shape=np.array(s, np.int32), scale_factor=np.float32(f), flip=fl)
             for s, f, fl in (((60, 90), 1.0, False), ((60, 90), 1.0, True),
                              ((90, 135), 1.5, True))]
    ours = merge_aug_bboxes([torch.from_numpy(b) for b in boxes],
                            [torch.from_numpy(s) for s in scores],
                            [dict(img_shape=torch.from_numpy(m["img_shape"]),
                                  scale_factor=torch.tensor(m["scale_factor"]), flip=m["flip"])
                             for m in metas])
    ref = jax_merge_aug_bboxes([jnp.asarray(b) for b in boxes], [jnp.asarray(s) for s in scores],
                               [dict(m, scale_factor=jnp.asarray(m["scale_factor"]))
                                for m in metas])
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    same = [s[:5] for s in scores]
    np.testing.assert_allclose(merge_aug_scores([torch.from_numpy(s) for s in same]).numpy(),
                               np.asarray(jax_merge_aug_scores([jnp.asarray(s) for s in same])),
                               rtol=1e-6)   # the mean's division, written another way


def test_views_match_ioudet_and_draw_nothing():
    """Scale-major, then flip False / True; every array and meta of each
    view ioudet's; the sample stream is where it was before the views."""
    inner = TTA_PIPELINE[1]["transforms"]
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 72, 3), dtype=np.uint8)
    sample = dict(img=img, img_shape=(48, 72), ori_shape=(48, 72), channel_order="bgr")
    set_sample_rng(make_sample_rng(0, 0, 0))
    jax_set_rng(jax_make_rng(0, 0, 0))
    try:
        ours = MultiScaleFlipAug(inner, [(96, 64), (128, 80)], flip=True)(dict(sample))
        ref = JaxMultiScaleFlipAug(inner, [(96, 64), (128, 80)], flip=True)(dict(sample))
        untouched = sample_rng().random() == make_sample_rng(0, 0, 0).random()
    finally:
        set_sample_rng(None)
        jax_set_rng(None)
    assert untouched
    assert [bool(v["flip"]) for v in ours] == [False, True, False, True]
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        assert sorted(o) == sorted(k for k in r if k != "idx")
        for k in o:
            np.testing.assert_array_equal(np.asarray(o[k]), np.asarray(r[k]), err_msg=k)
    # a Resize without img_scale, as the mstest config writes it, takes the view's
    assert Compose([dict(type="Resize", keep_ratio=True)])(
        dict(img=img, scale_override=(128, 80)))["img_shape"] == (80, 120)


def test_aug_test_matches_ioudet(planted, twins):
    _, _, ds, jds = planted
    model, det, params = twins
    for idx in range(len(SIZES)):
        views, jviews = ds[idx], jds[idx]
        dets, labels = aug_test(model, views, TEST_CFG)
        jd, jl = jax_aug_test(det, params, jviews, TEST_CFG)
        assert dets.shape == (10, 5) and labels.shape == (10,)
        np.testing.assert_array_equal(labels.numpy(), jl)
        np.testing.assert_allclose(dets.numpy(), jd, rtol=1e-4, atol=1e-3)
        assert int((labels >= 0).sum()) >= 3   # not trivially empty


def test_tta_test_and_the_test_tool(planted, twins, tmp_path):
    root, ds_cfg, ds, jds = planted
    model, det, params = twins
    ours = tta_test(model, ds, TEST_CFG)
    ref = jax_tta_test(det, params, jds, TEST_CFG)
    assert len(ours) == len(ref) == len(SIZES)
    for per_img, ref_img in zip(ours, ref):
        assert len(per_img) == len(ref_img) == 2
        for o, r in zip(per_img, ref_img):
            assert o.dtype == np.float32 and o.shape == r.shape
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-3)
    assert ds.evaluate(ref) == jds.evaluate(ref)

    ckpt = save_checkpoint(str(tmp_path), "weights", model)
    config = tmp_path / "cfg.py"
    config.write_text(f"model = {MODEL!r}\ntest_cfg = {TEST_CFG!r}\n"
                      f"data = {dict(test=ds_cfg)!r}\n")
    metrics = test_tool.main([str(config), ckpt, "--eval", "bbox", "--device", "cpu"])
    assert metrics == {"bbox": ds.evaluate(ours)}
    with pytest.raises(TypeError, match="MultiScaleFlipAug"):
        tta_test(model, build_dataset(dict(ds_cfg, pipeline=[
            TTA_PIPELINE[0], dict(type="Resize", img_scale=(96, 64)), NORM,
            dict(type="Pad", size_divisor=32, size=(64, 96)), dict(type="Collect", keys=["img"])])))
