"""Multi-scale / flip TTA of guided anchoring on the CPU: ``ioudet``'s
``tta_test`` runs a tiny GA-RetinaNet (its ``aug_test`` hands the head's
four output lists to ``decode_candidates``), so the port's ``tta_test`` runs
it too and is held against it, on tests/test_torch_tta.py's planted
dataset and views (two scales, flipped and not, on one 96x128 canvas) and
``ioudet``'s weights bridged by ``state_dict_from_flax``.  Then the port's
tools/test.py takes the TTA route for such a config.

Tolerances: labels exact, dets rtol 1e-4 / atol 1e-3 (tests/test_torch_tta.py's:
the decode of head outputs that differ by f32 roundoff, mapped back to the
image's scale)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ioudet.apis.test import tta_test as jax_tta_test
from ioudet.data import build_dataset as jax_build_dataset
from ioudet.models import build_detector as jax_build_detector
from ioudet_torch.apis.checkpoint import module_types, save_checkpoint, state_dict_from_flax
from ioudet_torch.apis.test import tta_test
from ioudet_torch.data import build_dataset
from ioudet_torch.models import build_detector
from ioudet_torch.tools import test as test_tool
from tests.test_torch_data_pipeline import plant_coco
from tests.test_torch_tta import SIZES, TTA_PIPELINE
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

MODEL = dict(
    type="RetinaNet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=-1, norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32, start_level=1,
              add_extra_convs=True, num_outs=5),
    bbox_head=dict(type="GARetinaHead", num_classes=3, in_channels=32, feat_channels=32,
                   stacked_convs=1, octave_base_scale=8, anchor_ratios=(0.5, 1.0, 2.0),
                   anchor_strides=(8, 16, 32, 64, 128)))
TEST_CFG = dict(nms_pre=50, score_thr=0.01, nms=dict(iou_thr=0.5), max_per_img=10)


@pytest.fixture(scope="module")
def twins():
    """The port's GA-RetinaNet on ioudet's seeded weights (``conv_loc``
    drawn at std 1 around the 0.01 prior: no loc score near the
    threshold), ioudet's detector and parameters."""
    det = jax_build_detector(dict(MODEL), None, TEST_CFG)
    params = random_params(param_shapes(det, jnp.zeros((1, 96, 128, 3))), 5)
    loc = params["bbox_head"]["conv_loc"]
    loc["kernel"] = np.random.default_rng(6).normal(0, 1.0, loc["kernel"].shape).astype(
        np.float32)
    loc["bias"] = np.full((1,), np.log(0.01 / 0.99), np.float32)
    model = build_detector(MODEL, None, TEST_CFG).eval()
    model.load_state_dict(state_dict_from_flax(params, module_types(model)), strict=True)
    return model, det, params


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ga_tta"))
    ann_file, img_dir = plant_coco(root, SIZES, seed=7)
    cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
               pipeline=TTA_PIPELINE, test_mode=True)
    return cfg, build_dataset(cfg), jax_build_dataset(cfg)


def test_ga_retinanet_tta_matches_ioudet(planted, twins, tmp_path):
    cfg, ds, jds = planted
    model, det, params = twins
    ref = jax_tta_test(det, params, jds, TEST_CFG)
    ours = tta_test(model, ds, TEST_CFG)
    assert len(ours) == len(ref) == len(SIZES)
    kept = 0
    for per_img, ref_img in zip(ours, ref):
        assert len(per_img) == len(ref_img) == 2
        for o, r in zip(per_img, ref_img):
            assert o.dtype == np.float32 and o.shape == r.shape
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-3)
            kept += len(o)
    assert kept >= 10   # not trivially empty

    ckpt = save_checkpoint(str(tmp_path), "weights", model)
    config = tmp_path / "cfg.py"
    config.write_text(f"model = {MODEL!r}\ntest_cfg = {TEST_CFG!r}\n"
                      f"data = {dict(test=cfg)!r}\n")
    metrics = test_tool.main([str(config), ckpt, "--eval", "bbox", "--device", "cpu"])
    assert metrics == {"bbox": ds.evaluate(ours)}
