"""SSD's host side and SSD512 on the CPU, against ``ioudet`` and OpenCV:

  * ``bgr_to_hsv`` / ``hsv_to_bgr`` against ``cv2.cvtColor`` on float32
    images in both channel orders, with the edges planted (V = 0, max = min,
    negative pixels, each sector's edge, hues at 0 and 360 and past them):
    S, V and the inverse bit for bit; H bit for bit but at the last (width
    mod 8) pixels of each row, where OpenCV's scalar loop rounds once more,
    and there within one f32 step;
  * ``imresize_float`` against ``cv2.resize`` (INTER_LINEAR) bit for bit;
  * ``PhotoMetricDistortion``, ``Expand`` (BGR and RGB) and
    ``MinIoURandomCrop`` (with its "return unchanged" draw and its retries)
    against ``ioudet``'s on seeded samples: the same draws, boxes and labels
    exactly, pixels within 1e-3 on the 0-255 scale (the hue's last bit);
  * ``Pad(orient_aware=False)``, and the whole ssd300_coco train pipeline
    through the datasets;
  * SSD512 (configs/ssd512_coco.py, full width): feature maps 64 / 32 / 16
    / 8 / 4 / 2 / 1, its anchors bit for bit and one forward pass (head
    outputs within 1e-5 of each map's largest |value|);
  * one ``train_detector`` step of ssd300_voc from a planted VOC tree
    through the config's own train pipeline: the step's losses equal
    ``ioudet``'s ``forward_train`` on the batch of ``ioudet``'s loader
    (rtol 1e-4)."""

import json
import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import plant_voc
from ioudet.data import build_dataloader as jax_build_dataloader
from ioudet.data import build_dataset as jax_build_dataset
from ioudet.data.pipelines import transforms as jt
from ioudet.data.rng import make_sample_rng as jax_make_rng, set_sample_rng as jax_set_rng
from ioudet_torch.apis.train import train_detector
from ioudet_torch.data import build_dataset
from ioudet_torch.data.pipelines import transforms as tt
from ioudet_torch.data.rng import make_sample_rng, set_sample_rng
from tests.test_torch_data_pipeline import plant_coco
from tests.test_torch_ssd import KEYS, assert_close_scaled, configs, images, ssd_twin
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

f32 = np.float32
MEAN = (123.675, 116.28, 103.53)


def edge_image(seed: int, shape=(37, 53)) -> np.ndarray:
    """Float pixels in [-40, 300] with the conversions' edges planted."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-40, 300, shape + (3,)).astype(f32)
    img[0, :6] = [[0, 0, 0], [7, 7, 7], [-3, -3, -3], [255, 255, 0], [0, 255, 255], [255, 0, 255]]
    img[1, :6] = [[5, 5, 9], [9, 5, 5], [5, 9, 5], [9, 9, 5], [5, 9, 9], [9, 5, 9]]
    img[2, :4] = [[200, 100, 100.00001], [100, 200, 200], [0, 0, 1e-6], [300, 299.99997, 0]]
    return img


ORDERS = {"bgr": (cv2.COLOR_BGR2HSV, cv2.COLOR_HSV2BGR),
          "rgb": (cv2.COLOR_RGB2HSV, cv2.COLOR_HSV2RGB)}


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (3, 5), (300, 301)])
def test_hsv_is_opencvs_float_conversion(order, shape):
    to_code, from_code = ORDERS[order]
    for seed in range(2):
        img = edge_image(seed, shape) if shape[0] >= 3 and shape[1] >= 6 else \
            np.random.default_rng(seed).uniform(-40, 300, shape + (3,)).astype(f32)
        ref, ours = cv2.cvtColor(img, to_code), tt.bgr_to_hsv(img, order)
        assert ours.dtype == f32 and ours.shape == ref.shape
        np.testing.assert_array_equal(ours[..., 1:], ref[..., 1:])
        tail = shape[1] - shape[1] % 8   # OpenCV's vector loop ends here in a row
        np.testing.assert_array_equal(ours[:, :tail, 0], ref[:, :tail, 0])
        np.testing.assert_allclose(ours[..., 0], ref[..., 0], rtol=0, atol=3.1e-5)
        hsv = ref.copy()
        hsv[..., 1] *= f32(1.3)
        hsv[..., 0] += f32(17.5)
        hsv[..., 0][hsv[..., 0] > 360] -= 360
        edges = np.array([0, 360, 359.99997, 60, 120, 300], f32)[:shape[1]]
        hsv[0, :len(edges), 0] = edges
        np.testing.assert_array_equal(tt.hsv_to_bgr(hsv, order), cv2.cvtColor(hsv, from_code))


@pytest.mark.parametrize("src,dst", [((37, 53), (300, 300)), ((900, 600), (300, 300)),
                                     ((300, 300), (300, 300)), ((600, 600), (300, 300)),
                                     ((128, 90), (512, 512))])
def test_imresize_float_is_cv2_bit_for_bit(src, dst):
    img = np.random.default_rng(sum(src)).uniform(-40, 300, src + (3,)).astype(f32)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(tt.imresize_float(img, dst), ref)


def sample(seed: int, h: int = 120, w: int = 160, order: str = "bgr", uint8: bool = False):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w, 3))
    xy = rng.uniform(0, [w - 40, h - 40], (4, 2))
    wh = rng.uniform(10, 40, (4, 2))
    return dict(img=img.astype(np.uint8) if uint8 else img.astype(f32),
                img_shape=(h, w), channel_order=order,
                gt_bboxes=np.concatenate([xy, xy + wh], -1).astype(f32),
                gt_labels=np.arange(1, 5, dtype=np.int64))


def both(step_ours, step_ref, results: dict, seed: int) -> tuple:
    """One step of each package on copies of ``results``, from the same
    seeded stream; also the state each stream is left in."""
    ours_rng, ref_rng = random.Random(seed), random.Random(seed)
    set_sample_rng(ours_rng)
    jax_set_rng(ref_rng)
    try:
        a = step_ours({k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in results.items()})
        b = step_ref({k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in results.items()})
    finally:
        set_sample_rng(None)
        jax_set_rng(None)
    assert ours_rng.getstate() == ref_rng.getstate()   # the same draws, in the same order
    return a, b


def assert_same(a: dict, b: dict, pixel_tol: float = 0.0) -> None:
    assert sorted(a) == sorted(b)
    for k in b:
        if k == "img":
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=pixel_tol)
        elif isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("order", ["bgr", "rgb"])
def test_photometric_distortion_matches_ioudet(order):
    changed = set()
    for seed in range(12):
        results = sample(seed, order=order, uint8=seed % 2 == 0)
        a, b = both(tt.PhotoMetricDistortion(), jt.PhotoMetricDistortion(), results, seed)
        assert_same(a, b, pixel_tol=1e-3)
        changed.add(not np.array_equal(a["img"], results["img"].astype(f32)))
    assert changed == {True}


@pytest.mark.parametrize("order", ["bgr", "rgb"])
def test_expand_matches_ioudet(order):
    fired = 0
    for seed in range(8):
        results = sample(seed, order=order, uint8=seed % 3 == 0)
        a, b = both(tt.Expand(mean=MEAN, to_rgb=True, ratio_range=(1, 4)),
                    jt.Expand(mean=MEAN, to_rgb=True, ratio_range=(1, 4)), results, seed)
        assert_same(a, b)
        if a["img"].shape != results["img"].shape:
            fired += 1   # the border holds the mean in the image's channel order
            fill = np.asarray(MEAN[::-1] if order == "bgr" else MEAN).astype(a["img"].dtype)
            assert (a["img"] == fill).all(-1).any()
    assert 0 < fired < 8


def test_min_iou_random_crop_matches_ioudet():
    unchanged = cropped = 0
    for seed in range(24):
        results = sample(seed)
        a, b = both(tt.MinIoURandomCrop(), jt.MinIoURandomCrop(), results, seed)
        assert_same(a, b)
        if a["img"].shape == results["img"].shape:
            unchanged += 1
        else:
            cropped += 1
            assert len(a["gt_bboxes"]) == len(a["gt_labels"]) >= 1
    assert unchanged and cropped   # the draw of 1 returned samples as they were


def test_min_iou_random_crop_retries_and_keeps_centres():
    """One small gt in a corner and a high minimum IoU: many tries fail
    (bad aspect, low IoU, no centre inside) before one stands."""
    results = sample(0, 200, 200)
    results["gt_bboxes"] = np.array([[0, 0, 30, 30], [150, 150, 199, 199]], f32)
    results["gt_labels"] = np.array([3, 7])
    for seed in range(6):
        crop = dict(min_ious=(0.7, 0.9), min_crop_size=0.3)
        a, b = both(tt.MinIoURandomCrop(**crop), jt.MinIoURandomCrop(**crop), results, seed)
        assert_same(a, b)


def test_pad_without_orientation():
    results = dict(img=np.ones((300, 200, 3), f32))
    for pad in (dict(size=(300, 300), orient_aware=False), dict(size=(200, 300))):
        a, b = tt.Pad(**pad)(dict(results)), jt.Pad(**pad)(dict(results))
        assert_same(a, b)
    assert tt.Pad(size=(300, 300), orient_aware=False)(dict(results))["img"].shape == (300, 300, 3)


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    return plant_voc(root, [(75, 100), (100, 75), (66, 100), (100, 66)], seed=4)


def test_ssd300_train_pipeline_samples_equal_ioudet(tmp_path):
    """ssd300_coco's train pipeline (the three augmentations, Resize to
    300x300 of the float image, the square Pad) through both packages'
    datasets: every sample's boxes, labels and shapes exactly, pixels within
    1e-3."""
    cfg, _ = configs("ssd300_coco.py")
    ann_file, img_dir = plant_coco(str(tmp_path), [(60, 100), (100, 60), (80, 96), (120, 200)],
                                   seed=5, crowd=False)
    ds = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
              pipeline=cfg["train_pipeline"])
    ours, ref = build_dataset(ds), jax_build_dataset(ds)
    for epoch in range(3):
        for idx in range(len(ours)):
            set_sample_rng(make_sample_rng(5, epoch, idx))
            jax_set_rng(jax_make_rng(5, epoch, idx))
            try:
                a, b = ours[idx], ref[idx]
            finally:
                set_sample_rng(None)
                jax_set_rng(None)
            assert_same(a, b, pixel_tol=1e-3)
            assert a["img"].shape == (300, 300, 3)


def test_ssd512_shapes_anchors_and_forward_match_ioudet():
    det, params, model = ssd_twin("ssd512_coco.py", seed=1)
    img = images(1, 512, seed=2)
    fn = jax.jit(lambda p, x: det.apply({"params": p}, x))
    cls, reg = jax.device_get(fn(params, jnp.asarray(img)))
    with torch.no_grad():
        ours_cls, ours_reg = model.eval()(torch.from_numpy(img))
    sizes = [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    assert [tuple(c.shape[1:3]) for c in ours_cls] == sizes
    for i, (o, r) in enumerate(zip(ours_cls + ours_reg, list(cls) + list(reg))):
        assert tuple(o.shape) == r.shape
        assert_close_scaled(o.numpy(), r, 1e-5, f"output {i}")
    pads = np.array([[512, 512]], np.int32)
    ref_anchors, _ = det.apply({}, sizes, jnp.asarray(pads),
                               method=lambda m, s, p: m.bbox_head.get_anchors(s, p))
    anchors, _ = model.bbox_head.get_anchors(sizes, torch.from_numpy(pads))
    assert model.bbox_head.level_num_anchors == [4, 6, 6, 6, 6, 4, 4]
    assert anchors.shape == (24564, 4)
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(ref_anchors))


def test_train_detector_step_from_a_voc_tree_matches_ioudet(voc_tree, tmp_path):
    ann_file, prefix = voc_tree
    cfg, _ = configs("ssd300_voc.py")
    ds = dict(type="VOCDataset", ann_file=ann_file, img_prefix=prefix,
              pipeline=cfg["train_pipeline"])
    det, params, model = ssd_twin("ssd300_voc.py", seed=3)
    run_cfg = dict(cfg, data=dict(imgs_per_gpu=2, workers_per_gpu=2, train=ds), total_epochs=1,
                   log_config=dict(interval=1), checkpoint_config=dict(interval=1))
    seen = []
    runner = train_detector(model, build_dataset(ds), run_cfg, str(tmp_path / "work"),
                            device="cpu", step_hook=lambda step, lv: seen.append(lv))
    assert runner.step == 2 and len(seen) == 2
    with open(tmp_path / "work" / "log.json") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    batch = next(iter(jax_build_dataloader(jax_build_dataset(ds), 2, 2, shuffle=True, seed=0,
                                           num_shards=1, shard_index=0)))
    forward = jax.jit(lambda p, *a: det.apply({"params": p}, *a, method=det.forward_train))
    ref = forward(params, *(jnp.asarray(batch[k]) for k in KEYS))
    assert sorted(ref) == ["loss_bbox", "loss_cls"]
    for k, v in ref.items():
        np.testing.assert_allclose(float(seen[0][k]), float(v), rtol=1e-4, err_msg=k)
    assert float(ref["loss_bbox"]) > 0 and np.isfinite(float(seen[1]["loss_cls"]))
