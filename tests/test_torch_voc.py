"""The port's XML datasets (``ioudet_torch/data/datasets/xml_style.py``)
against ``ioudet``'s on a planted VOC tree (``chip_smoke.plant_voc``: .jpg
files that hold binary netpbm bytes, which cv2 decodes in ``ioudet`` and the
port's own decoder here; difficult objects, objects without the tag and of a
class VOC does not have): image infos, annotations and samples through the
VOC config's pipelines (small scale) equal, every array bit-equal; and
``evaluate`` equal on the same results, in '11points' mode (VOC2007) and
'area' mode (VOC2012), mAP within 1e-6; the port's tools/test.py with
``--eval mAP``."""

import os

import numpy as np
import pytest

from chip_smoke import plant_voc, voc_gt_as_results
from ioudet.data import build_dataset as jax_build_dataset
from ioudet.data.rng import make_sample_rng as jax_make_rng, set_sample_rng as jax_set_rng
from ioudet_torch.apis.inference import init_detector
from ioudet_torch.apis.test import single_device_test
from ioudet_torch.data import build_dataset
from ioudet_torch.data.rng import make_sample_rng, set_sample_rng
from ioudet_torch.tools import test as test_tool
from ioudet_torch.utils.config import Config
from tests.test_torch_data_pipeline import assert_samples_equal
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_CFG = Config.fromfile(os.path.join(ROOT, "configs", "iou_aware_retinanet_r50_fpn_voc.py"))
SIZES = [(75, 100), (100, 75), (66, 100), (100, 66), (56, 100), (80, 90)]


def small(pipeline):
    steps = []
    for s in pipeline:
        s = dict(s)
        if s["type"] == "Resize":
            s["img_scale"] = (100, 60)
        elif s["type"] == "Pad":
            s["size"] = (64, 128)
        elif s["type"] == "DefaultFormatBundle":
            s["max_gt"] = 8
        steps.append(s)
    return steps


@pytest.fixture(scope="module", params=["VOC2007", "VOC2012"])
def tree(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    ann_file, prefix = plant_voc(root, SIZES, seed=4, year=request.param)
    return request.param, ann_file, prefix


def pair(tree, pipeline, test_mode, kind="VOCDataset"):
    _, ann_file, prefix = tree
    cfg = dict(type=kind, ann_file=ann_file, img_prefix=prefix, pipeline=small(pipeline),
               test_mode=test_mode)
    return build_dataset(cfg), jax_build_dataset(cfg)


def test_annotations_and_test_samples_equal_ioudet(tree):
    ours, ref = pair(tree, VOC_CFG.test_pipeline, True)
    assert ours.year == ref.year == int(tree[0][3:])
    assert ours.img_infos == ref.img_infos and len(ours) == len(SIZES)
    assert ours.img_infos[0]["filename"] == os.path.join("JPEGImages", "000000.jpg")
    ignored = 0
    for idx in range(len(ours)):
        a, b = ours.get_ann_info(idx), ref.get_ann_info(idx)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["labels"].min() >= 1 and a["labels"].max() <= 20
        ignored += len(a["bboxes_ignore"])
        assert_samples_equal(ours[idx], ref[idx])
    assert ignored > 0   # difficult objects went to bboxes_ignore


def test_train_samples_equal_ioudet(tree):
    ours, ref = pair(tree, VOC_CFG.train_pipeline, False)
    np.testing.assert_array_equal(ours.flag, ref.flag)
    for idx in range(len(ours)):
        set_sample_rng(make_sample_rng(3, 0, idx))
        jax_set_rng(jax_make_rng(3, 0, idx))
        try:
            a, b = ours[idx], ref[idx]
        finally:
            set_sample_rng(None)
            jax_set_rng(None)
        assert_samples_equal(a, b)


def test_evaluate_matches_ioudet(tree):
    """Jittered ground truth, false positives and missing boxes: the mAP and
    each class's AP of ioudet within 1e-6; the ground truth itself at 1 (the
    eleven 1/11 steps of '11points' sum to 1 + 2**-52 in both packages)."""
    ours, ref = pair(tree, VOC_CFG.test_pipeline, True)
    rng = np.random.default_rng(5)
    results = []
    for per_cls in voc_gt_as_results(ours):
        img = []
        for dets in per_cls:
            dets = dets[rng.uniform(size=len(dets)) < 0.8].copy()
            dets[:, :4] += rng.normal(0, 3, dets[:, :4].shape)
            dets[:, 4] = rng.uniform(0.1, 1, len(dets))
            extra = np.concatenate([rng.uniform(0, 60, (2, 2)), rng.uniform(60, 100, (2, 2)),
                                    rng.uniform(0, 1, (2, 1))], axis=1)
            img.append(np.concatenate([dets, extra]).astype(np.float32))
        results.append(img)
    a, b = ours.evaluate(results), ref.evaluate(results)
    assert abs(a["mAP"] - b["mAP"]) <= 1e-6 and 0.1 < a["mAP"] < 0.99
    assert [r["ap"] for r in a["per_class"]] == pytest.approx(
        [r["ap"] for r in b["per_class"]], abs=1e-6)
    perfect = ours.evaluate(voc_gt_as_results(ours))["mAP"]
    assert perfect == ref.evaluate(voc_gt_as_results(ours))["mAP"]
    assert perfect == (1.0 if tree[0] == "VOC2012" else 1.0 + 2.0 ** -52)
    with pytest.raises(ValueError):
        ours.evaluate(results[:-1])


def test_wider_face_reads_the_folder(tree):
    ours, ref = pair(tree, VOC_CFG.test_pipeline, True, kind="WIDERFaceDataset")
    assert ours.img_infos == ref.img_infos
    assert ours.img_infos[0]["filename"] == os.path.join(tree[0], "000000.jpg")
    for idx in range(len(ours)):
        for k, v in ours.get_ann_info(idx).items():
            np.testing.assert_array_equal(v, ref.get_ann_info(idx)[k])


def test_test_tool_evaluates_voc(tmp_path):
    """tools/test.py on the VOC config with --eval mAP: the metrics of
    single_device_test's results through the dataset's evaluate."""
    ann_file, prefix = plant_voc(str(tmp_path), SIZES[:4], seed=6)
    model = dict(VOC_CFG.model, backbone=dict(type="ResNet", depth=18, frozen_stages=1),
                 neck=dict(VOC_CFG.model["neck"], in_channels=[64, 128, 256, 512],
                           out_channels=32),
                 bbox_head=dict(VOC_CFG.model["bbox_head"], in_channels=32, feat_channels=32,
                                stacked_convs=1))
    data = dict(test=dict(type="VOCDataset", ann_file=ann_file, img_prefix=prefix,
                          pipeline=small(VOC_CFG.test_pipeline), test_mode=True))
    config = tmp_path / "voc.py"
    config.write_text(f"model = {model!r}\ntest_cfg = {VOC_CFG.test_cfg!r}\ndata = {data!r}\n")
    metrics = test_tool.main([str(config), "--eval", "mAP", "--batch", "4", "--device", "cpu"])
    ds = build_dataset(data["test"])
    results = single_device_test(init_detector(str(config), device="cpu"), ds, 4, progress=False)
    assert metrics["mAP"]["mAP"] == ds.evaluate(results)["mAP"]
