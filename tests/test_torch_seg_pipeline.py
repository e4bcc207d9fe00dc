"""Semantic label maps through the port's data pipeline, on the CPU, held
against Pillow and ``ioudet``:

  * the port's PNG reader (``data/pipelines/png.py``, numpy and ``zlib``)
    against ``np.asarray(PIL.Image.open(...))`` on 8-bit L, P and RGB maps
    written by this file's own encoder with each of the five row filters
    on every row and with all five mixed, and on Pillow's own files; a
    format it does not read raises, naming the file;
  * ``imresize_nearest`` against ``cv2.resize(..., INTER_NEAREST)`` (which
    ``ioudet`` calls) at ratios that are not integers, and the feature
    maps' ``resize_nearest`` (the FPN's and the semantic head's) against
    ``ioudet``'s;
  * ``CocoDataset`` with ``seg_prefix`` and HTC's train pipeline
    (``LoadAnnotations(with_seg)``, ``Resize``, ``RandomFlip``, ``Pad``,
    ``SegRescale``, ``DefaultFormatBundle``) at a small scale, each sample
    against ``ioudet``'s on the same draws, both flips, one image without a
    map (all 255 in both).

Every comparison is exact."""

import json
import os
import runpy
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ioudet.data import build_dataset as jax_build_dataset
from ioudet.data.rng import make_sample_rng as jax_make_rng, set_sample_rng as jax_set_rng
from ioudet.models.utils.layers import resize_nearest as jax_resize_nearest
from ioudet_torch.data import build_dataset
from ioudet_torch.data.pipelines.png import decode_png, read_png
from ioudet_torch.data.pipelines.transforms import imresize_nearest
from ioudet_torch.data.rng import make_sample_rng, set_sample_rng
from ioudet_torch.models.utils.layers import resize_nearest
from tests.test_torch_data_pipeline import plant_coco
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HTC = runpy.run_path(os.path.join(ROOT, "configs", "htc_r50_fpn_1x.py"))
FILTERS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4],
           "mixed": [4, 0, 3, 1, 2]}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_png(img: np.ndarray, ctype: int, filters, depth: int = 8, interlace: int = 0,
               palette: bytes = b"") -> bytes:
    """A PNG of ``img`` (8-bit samples) with row y filtered by
    ``filters[y % len(filters)]``, written from the specification."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        kind = filters[y % len(filters)]
        cur, prior = rows[y], rows[y - 1] if y else np.zeros_like(rows[y])
        raw.append(kind)
        for i in range(len(cur)):
            a = int(cur[i - bpp]) if i >= bpp else 0
            b, c = int(prior[i]), int(prior[i - bpp]) if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            raw.append((int(cur[i]) - pred) & 255)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette:
        body += _chunk(b"PLTE", palette)
    return (b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IDAT", zlib.compress(bytes(raw)))
            + _chunk(b"IEND", b""))


def label_map(h: int, w: int, seed: int, classes: int = 183) -> np.ndarray:
    """Bands and blocks of classes with an ignored (255) corner."""
    rng = np.random.default_rng(seed)
    seg = np.repeat(rng.integers(0, classes, (h // 4 + 1, 1)), 4, axis=0)[:h]
    seg = np.broadcast_to(seg, (h, w)).astype(np.uint8).copy()
    y, x = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
    seg[y:y + h // 3, x:x + w // 3] = rng.integers(0, classes)
    seg[: h // 6, : w // 5] = 255
    return seg


@pytest.mark.parametrize("filters", list(FILTERS))
@pytest.mark.parametrize("mode", ["L", "P", "RGB"])
def test_png_reader_equals_pillow(tmp_path, mode, filters):
    rng = np.random.default_rng(len(filters) + len(mode))
    if mode == "RGB":
        img = rng.integers(0, 256, (23, 31, 3)).astype(np.uint8)
        buf = encode_png(img, 2, FILTERS[filters])
    else:
        img = rng.integers(0, 256, (23, 31)).astype(np.uint8)
        palette = bytes(rng.integers(0, 256, 768).astype(np.uint8)) if mode == "P" else b""
        buf = encode_png(img, 3 if mode == "P" else 0, FILTERS[filters], palette=palette)
    path = tmp_path / f"{mode}_{filters}.png"
    path.write_bytes(buf)
    with Image.open(path) as im:
        assert im.mode == mode
        want = np.asarray(im)
    got = read_png(str(path))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode", ["L", "P", "RGB"])
def test_png_reader_equals_pillow_on_its_own_files(tmp_path, mode):
    """Pillow's encoder picks its own filters (adaptive for L and RGB)."""
    rng = np.random.default_rng(3)
    arr = label_map(57, 83, 4) if mode != "RGB" else rng.integers(0, 256, (57, 83, 3), np.uint8)
    im = Image.fromarray(arr)
    if mode == "P":
        im = im.convert("P")
    path = tmp_path / f"pil_{mode}.png"
    im.save(path)
    with Image.open(path) as back:
        np.testing.assert_array_equal(read_png(str(path)), np.asarray(back))


@pytest.mark.parametrize("case", ["16-bit", "interlaced", "grey+alpha", "bad crc", "not png"])
def test_png_reader_refuses_what_it_does_not_read(tmp_path, case):
    img = np.zeros((4, 5), np.uint8)
    buf = {"16-bit": lambda: encode_png(img, 0, [0], depth=16),
           "interlaced": lambda: encode_png(img, 0, [0], interlace=1),
           "grey+alpha": lambda: encode_png(np.zeros((4, 5, 2), np.uint8), 4, [0]),
           "bad crc": lambda: encode_png(img, 0, [0])[:-5] + b"\x00" + encode_png(img, 0, [0])[-4:],
           "not png": lambda: b"P5\n5 4\n255\n" + bytes(20)}[case]()
    path = tmp_path / "refused.png"
    path.write_bytes(buf)
    with pytest.raises(ValueError, match="refused.png"):
        read_png(str(path))
    with pytest.raises(ValueError):
        decode_png(buf)


@pytest.mark.parametrize("src,dst", [((800, 1333), (1000, 1666)), ((427, 640), (800, 1199)),
                                     ((832, 1344), (104, 168)), ((45, 90), (61, 122)),
                                     ((7, 5), (3, 11))])
def test_nearest_resize_equals_cv2(src, dst):
    img = label_map(*src, seed=5)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(imresize_nearest(img, dst), want)


@pytest.mark.parametrize("src,dst", [((8, 12), (16, 24)), ((3, 5), (8, 12)), ((13, 21), (8, 12)),
                                     ((5, 7), (13, 21)), ((1, 2), (8, 12))])
def test_resize_nearest_matches_ioudet(src, dst):
    """The port's ``resize_nearest`` of feature maps (the FPN's and the
    semantic head's) is ioudet's, at x2 and at ratios that are not
    integers, up and down."""
    x = np.random.default_rng(1).normal(0, 1, (2,) + src + (3,)).astype(np.float32)
    want = np.asarray(jax_resize_nearest(jnp.asarray(x), dst))
    got = resize_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


SIZES = [(60, 100), (100, 60), (80, 96), (45, 90), (90, 45)]


def htc_pipeline():
    """HTC's train pipeline at scale (160, 96) onto a 96x160 canvas."""
    steps = []
    for s in HTC["train_pipeline"]:
        s = dict(s)
        if s["type"] == "Resize":
            s["img_scale"] = (160, 96)
        elif s["type"] == "Pad":
            s["size"] = (96, 160)
        elif s["type"] == "DefaultFormatBundle":
            s["max_gt"] = 8
        steps.append(s)
    assert [s["type"] for s in steps][-3:] == ["SegRescale", "DefaultFormatBundle", "Collect"]
    return steps


@pytest.fixture(scope="module")
def seg_datasets(tmp_path_factory):
    """The port's and ioudet's COCO datasets of planted images, each with a
    Pillow-written L map of the image's size except the last image."""
    root = tmp_path_factory.mktemp("stuff")
    ann_file, img_dir = plant_coco(str(root), SIZES, ".ppm", seed=2, crowd=False)
    seg_dir = root / "stuffthingmaps"
    seg_dir.mkdir()
    with open(ann_file) as f:
        images = json.load(f)["images"]
    for info in images[:-1]:
        stem = os.path.splitext(info["file_name"])[0]
        Image.fromarray(label_map(info["height"], info["width"], info["id"])).save(
            seg_dir / f"{stem}.png")
    cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
               seg_prefix=str(seg_dir), pipeline=htc_pipeline())
    return build_dataset(cfg), jax_build_dataset(cfg)


@pytest.mark.parametrize("epoch", [0, 1])
def test_htc_train_samples_equal_ioudet(seg_datasets, epoch):
    ours, ref = seg_datasets
    assert len(ours) == len(ref) == len(SIZES)
    flips = set()
    for idx in range(len(ours)):
        set_sample_rng(make_sample_rng(7, epoch, idx))
        jax_set_rng(jax_make_rng(7, epoch, idx))
        try:
            a, b = ours[idx], ref[idx]
        finally:
            set_sample_rng(None)
            jax_set_rng(None)
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        seg = a["gt_semantic_seg"]
        assert seg.shape == tuple(n // 8 for n in a["img"].shape[:2]) and seg.dtype == np.int32
        if idx == len(ours) - 1:
            assert (seg == 255).all()        # no map on disk: all ignored
        else:
            assert ((seg != 255) & (seg < 183)).any()
        flips.add(bool(a["flip"]))
    assert flips == {False, True}


def test_htc_cli_trains_on_png_maps_and_evaluates_segm(tmp_path):
    """``tools/train.py`` on a tiny HTC (``htc_cfgs``) whose train set is two
    planted images with polygons and PNG maps through HTC's pipeline (one
    step), then ``tools/test.py --eval bbox segm`` on its checkpoint: finite
    losses with ``loss_semantic_seg`` in the log, both metrics in range."""
    from ioudet_torch.tools import test as test_tool
    from ioudet_torch.tools import train as train_tool
    from tests._torch_mp_worker import htc_cfgs

    ann_file, img_dir = plant_coco(str(tmp_path), [SIZES[0], SIZES[2]], ".ppm", seed=3,
                                   num_cats=4, crowd=False)
    with open(ann_file) as f:
        coco = json.load(f)
    for ann in coco["annotations"]:
        x, y, w, h = ann["bbox"]
        ann["segmentation"] = [[x, y, x + w - 1, y, x + w - 1, y + h - 1, x, y + h - 1]]
    with open(ann_file, "w") as f:
        json.dump(coco, f)
    seg_dir = tmp_path / "maps"
    seg_dir.mkdir()
    for info in coco["images"]:
        Image.fromarray(label_map(info["height"], info["width"], info["id"], classes=7)).save(
            seg_dir / f"{info['id']}.png")
    model, train_cfg, test_cfg = htc_cfgs()
    test_cfg["rcnn"]["score_thr"] = 0.0
    test_pipeline = [dict(type="LoadImageFromFile"),
                     dict(type="Resize", img_scale=(160, 96), keep_ratio=True),
                     dict(type="Normalize", **HTC["img_norm_cfg"]),
                     dict(type="Pad", size_divisor=32, size=(96, 160)),
                     dict(type="Collect", keys=["img"])]
    data = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir)
    cfg = dict(model=model, train_cfg=train_cfg, test_cfg=test_cfg,
               data=dict(imgs_per_gpu=2, workers_per_gpu=1,
                         train=dict(data, pipeline=htc_pipeline(), seg_prefix=str(seg_dir)),
                         test=dict(data, pipeline=test_pipeline, test_mode=True)),
               optimizer=dict(type="SGD", lr=0.002, momentum=0.9, weight_decay=0.0001),
               optimizer_config=dict(grad_clip=dict(max_norm=35)),
               lr_config=dict(policy="step", step=[8]), total_epochs=1,
               log_config=dict(interval=1), checkpoint_config=dict(interval=1))
    path = tmp_path / "htc_tiny.py"
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    work = tmp_path / "work"
    train_tool.main([str(path), "--work_dir", str(work), "--device", "cpu"])
    with open(work / "log.json") as f:
        records = [json.loads(line) for line in f if line.strip()]
    logged = [r for r in records if "loss_semantic_seg" in r]
    assert logged and all(np.isfinite(r["loss"]) and r["loss_semantic_seg"] > 0 for r in logged)
    metrics = test_tool.main([str(path), str(work / "epoch_1.pth"), "--eval", "bbox", "segm",
                              "--device", "cpu", "--batch", "2"])
    assert sorted(metrics) == ["bbox", "segm"]
    assert all(-1 <= v <= 1 for m in metrics.values() for v in m.values())
