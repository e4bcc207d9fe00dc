"""The port's data pipeline (ioudet_torch/data) on the CPU: its imresize
against cv2.resize(INTER_LINEAR), its netpbm decoder against cv2.imread, and
CocoDataset samples against ioudet's with the flagship's train and test
pipelines (small img_scale) on .ppm files and on .jpg files (the port's
lazy cv2 route), under the same (seed, epoch, index) streams: every array
bit-equal, every meta field equal.  ``plant_coco`` is the planted COCO-style
dataset the port's loader and eval-loop tests use too."""

import json
import os
import runpy
import sys

import cv2
import numpy as np
import pytest

from ioudet.data import build_dataset as jax_build_dataset
from ioudet.data.rng import make_sample_rng as jax_make_rng, set_sample_rng as jax_set_rng
from ioudet_torch.data import build_dataset
from ioudet_torch.data.pipelines import Compose, imresize
from ioudet_torch.data.pipelines.loading import (decode_netpbm, encode_netpbm, imread,
                                                 imwrite_netpbm)
from ioudet_torch.data.rng import make_sample_rng, set_sample_rng
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = runpy.run_path(os.path.join(ROOT, "configs", "iou_aware_retinanet_r50_fpn_1x.py"))
COLORS = ((40, 40, 250), (40, 250, 40), (250, 60, 60))   # BGR


def plant_coco(root, sizes, ext=".ppm", seed=0, num_cats=3, crowd=True):
    """Images of the given (h, w) sizes with 2-6 coloured boxes each on dark
    noise, class = colour (category ids 1..num_cats); one box in five is
    crowd when ``crowd``.  Returns (ann_file, img_dir)."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        for _ in range(int(rng.integers(2, 7))):
            bw = int(rng.integers(max(2, w // 8), max(3, w // 3)))
            bh = int(rng.integers(max(2, h // 8), max(3, h // 3)))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            cat = int(rng.integers(1, num_cats + 1))
            img[y:y + bh, x:x + bw] = COLORS[(cat - 1) % len(COLORS)]
            anns.append(dict(id=len(anns), image_id=i, category_id=cat, bbox=[x, y, bw, bh],
                             area=bw * bh, iscrowd=int(crowd and rng.uniform() < 0.2)))
        name = f"{i}{ext}"
        if ext == ".ppm":
            imwrite_netpbm(os.path.join(img_dir, name), img)
        else:
            assert cv2.imwrite(os.path.join(img_dir, name), img)
        images.append(dict(id=i, file_name=name, width=w, height=h))
    ann_file = os.path.join(root, "annotations.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=c, name=f"c{c}") for c in range(1, num_cats + 1)]), f)
    return ann_file, img_dir


def small_pipeline(name, scale=(160, 96), canvas=(96, 160)):
    """The flagship's train or test pipeline at a small scale and canvas."""
    steps = []
    for s in FLAGSHIP[name]:
        s = dict(s)
        if s["type"] == "Resize":
            s["img_scale"] = scale
        elif s["type"] == "Pad":
            s["size"] = canvas
        elif s["type"] == "DefaultFormatBundle":
            s["max_gt"] = 8
        steps.append(s)
    return steps


def assert_samples_equal(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        o, r = ours[k], ref[k]
        assert isinstance(o, np.ndarray) and o.dtype == r.dtype and o.shape == r.shape, k
        np.testing.assert_array_equal(o, r, err_msg=k)


# ------------------------------------------------------------------ imresize

RESIZE_CASES = [((480, 640), (800, 1067)), ((1333, 800), (800, 480)), ((800, 1333), (800, 1333)),
                ((50, 70), (64, 90)), ((100, 200), (50, 100)), ((101, 203), (37, 77)),
                ((7, 5), (13, 29)), ((33, 31), (16, 15)), ((3, 3), (1, 1)), ((1, 1), (5, 7)),
                ((100, 200), (50, 200)), ((5, 1), (9, 3)), ((427, 640), (800, 1199))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES, ids=lambda s: "x".join(map(str, s)))
def test_imresize_is_cv2_inter_linear_bit_for_bit(src, dst):
    """Bit-exact on every case: colour and grey, noise and a smooth ramp."""
    rng = np.random.default_rng(sum(src) + sum(dst))
    h, w = src
    ramp = (np.add.outer(np.arange(h), np.arange(w))[..., None] * np.array([1, 3, 7])) % 256
    for img in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), ramp.astype(np.uint8),
                rng.integers(0, 256, (h, w), dtype=np.uint8)):
        ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
        ours = imresize(img, dst)
        assert ours.dtype == np.uint8 and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)


# ------------------------------------------------------------------- netpbm

def test_netpbm_decoder_equals_cv2_imread(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    grey = rng.integers(0, 256, (29, 41), dtype=np.uint8)
    cases = {"cv2.ppm": img, "cv2.pgm": grey}
    for name, arr in cases.items():
        assert cv2.imwrite(str(tmp_path / name), arr)
    imwrite_netpbm(str(tmp_path / "ours.ppm"), img)
    imwrite_netpbm(str(tmp_path / "ours.pgm"), grey)
    # a header with comments and line breaks where the format allows them
    body = np.ascontiguousarray(img[..., ::-1]).tobytes()
    (tmp_path / "comments.ppm").write_bytes(b"P6\n# made by hand\n53 # width\n37\n255\n" + body)
    for name in ("cv2.ppm", "cv2.pgm", "ours.ppm", "ours.pgm", "comments.ppm"):
        path = str(tmp_path / name)
        ref = cv2.imread(path, cv2.IMREAD_COLOR)
        ours = imread(path)
        assert ours.dtype == np.uint8 and ours.shape == ref.shape, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)
    np.testing.assert_array_equal(decode_netpbm(encode_netpbm(img)), img)


def test_netpbm_refusals(tmp_path):
    with pytest.raises(ValueError, match="maxval"):
        decode_netpbm(b"P5 2 2 65535\n" + bytes(8))
    with pytest.raises(ValueError, match="netpbm"):
        decode_netpbm(b"P3\n1 1\n255\n0 0 0\n")
    with pytest.raises(FileNotFoundError):
        imread(str(tmp_path / "missing.ppm"))


def test_other_formats_need_cv2(tmp_path, monkeypatch):
    img = np.random.default_rng(1).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(imread(path), img)
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 now raises
    with pytest.raises(ImportError, match="a.png"):
        imread(path)


# ---------------------------------------------------------------- datasets

SIZES = [(60, 100), (100, 60), (80, 96), (120, 200), (45, 90), (90, 45), (150, 96)]


@pytest.fixture(scope="module", params=[".ppm", ".jpg"])
def planted(request, tmp_path_factory):
    return plant_coco(str(tmp_path_factory.mktemp("coco")), SIZES, request.param)


def dataset_pair(planted, name, test_mode):
    ann_file, img_dir = planted
    cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
               pipeline=small_pipeline(name), test_mode=test_mode)
    return build_dataset(cfg), jax_build_dataset(cfg)


@pytest.mark.parametrize("epoch", [0, 3])
def test_train_samples_equal_ioudet(planted, epoch):
    ours, ref = dataset_pair(planted, "train_pipeline", False)
    assert len(ours) == len(ref) == len(SIZES)
    np.testing.assert_array_equal(ours.flag, ref.flag)
    flips = set()
    for idx in range(len(ours)):
        set_sample_rng(make_sample_rng(7, epoch, idx))
        jax_set_rng(jax_make_rng(7, epoch, idx))
        try:
            a, b = ours[idx], ref[idx]
        finally:
            set_sample_rng(None)
            jax_set_rng(None)
        assert_samples_equal(a, b)
        flips.add(bool(a["flip"]))
    assert flips == {False, True}   # both branches of RandomFlip ran


def test_test_samples_equal_ioudet(planted):
    ours, ref = dataset_pair(planted, "test_pipeline", True)
    for idx in range(len(ours)):
        assert_samples_equal(ours[idx], ref[idx])
    for idx in range(len(ours)):
        assert ours.get_ann_info(idx).keys() <= ref.get_ann_info(idx).keys()
        assert ours.gt_for_eval(idx) == ref.gt_for_eval(idx)


def test_dataset_wrappers_and_build_dataset(planted):
    ann_file, img_dir = planted
    base = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
                pipeline=small_pipeline("test_pipeline"), test_mode=True)
    for cfg in (dict(type="RepeatDataset", times=2, dataset=base),
                dict(type="ConcatDataset", datasets=[base, base]),
                dict(base, ann_file=[ann_file, ann_file], img_prefix=img_dir)):
        ours, ref = build_dataset(cfg), jax_build_dataset(cfg)
        assert len(ours) == len(ref) == 2 * len(SIZES)
        np.testing.assert_array_equal(ours.flag, ref.flag)
        assert_samples_equal(ours[len(SIZES) + 3], ref[len(SIZES) + 3])
    with pytest.raises(KeyError, match="not ported"):
        build_dataset(dict(base, type="CityscapesDataset"))


def test_unported_steps_raise():
    # SSD's augmentations are ported (tests/test_torch_ssd_pipeline.py); RandomCrop is not
    with pytest.raises(KeyError, match="not ported"):
        Compose([dict(type="RandomCrop", crop_size=(32, 32))])
    # precomputed proposals are ported (tests/test_torch_fast_rcnn.py); the
    # Cityscapes dataset is not
    with pytest.raises(KeyError, match="not ported"):
        build_dataset(dict(type="CityscapesDataset", ann_file="unread.json", pipeline=[]))
