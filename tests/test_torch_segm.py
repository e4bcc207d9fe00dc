"""Masks on the host and the segm evaluation of the port on the CPU, held
against ioudet on the same seeded inputs: the RLE codec and mask IoU, the
polygon fill against ioudet's Pillow path and the paste against its cv2
path (both pixel-exact), a planted COCO set with polygons through the
train pipeline (LoadAnnotations with masks, both flips,
DefaultFormatBundle, the loader), ``evaluate(["bbox", "segm"])`` and
``results2json``, the tiny Mask R-CNN through ``single_device_test``,
``multi_host_test``'s mask route with two ranks in one process,
``tools/test.py --eval bbox segm``, and a ``train_detector`` step fed from
the dataset through the mask train pipeline.

Tolerances: the codec, fill, paste, pipeline samples, metrics and JSON
records exact; single_device_test's raw outputs as
tests/test_torch_mask_rcnn.py's simple_test (labels exact, dets rtol 1e-5
and 1e-4 abs, mask probabilities 1e-5 abs), and its segm rows exactly
ioudet's conversion of the same raw outputs; the train step's logged
losses rtol 1e-5 of forward_train on its batch."""

import copy
import json
import threading

import cv2
import numpy as np
import pytest
import torch

from ioudet.apis import single_device_test as jax_single_device_test
from ioudet.apis.test import masks_to_segm_result as jax_masks_to_segm_result
from ioudet.core.mask import rasterize_polygons as jax_rasterize_polygons
from ioudet.core.mask import rle as jrle
from ioudet.data import build_dataset as jax_build_dataset
from ioudet.models import build_detector as jax_build_detector
from ioudet_torch.apis import test as ttest
from ioudet_torch.apis.checkpoint import save_checkpoint
from ioudet_torch.apis.train import step_generator, train_detector
from ioudet_torch.core.mask import rasterize_polygons, rle
from ioudet_torch.data import build_dataloader, build_dataset
from ioudet_torch.tools import test as test_tool
from tests._torch_mp_worker import mask_rcnn_cfgs
from tests.test_torch_data_pipeline import plant_coco
from tests.test_torch_mask_rcnn import bridge, new_model
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

MODEL, TRAIN_CFG, TEST_CFG = mask_rcnn_cfgs()
NORM = dict(type="Normalize", mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375),
            to_rgb=True)
TEST_PIPELINE = [dict(type="LoadImageFromFile"),
                 dict(type="Resize", img_scale=(96, 64), keep_ratio=True), NORM,
                 dict(type="Pad", size_divisor=32, size=(64, 96)),
                 dict(type="Collect", keys=["img"])]
# 4 landscape and 2 portrait images: ragged batches of 4
SIZES = [(48, 80), (64, 96), (80, 56), (56, 90), (96, 64), (60, 100)]


def polygon(rng, box, n):
    """A star-shaped polygon of n vertices around the box's centre, radii up
    to 0.6 of the box (some vertices past it), sub-pixel coordinates."""
    x, y, w, h = box
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(0.15, 0.6, n)
    pts = np.stack([x + w / 2 + r * w * np.cos(ang), y + h / 2 + r * h * np.sin(ang)], 1)
    return [float(v) for v in pts.reshape(-1)]


def plant_masks(root, sizes, seed):
    """plant_coco's set with a segmentation for every annotation: one or
    two polygons in its box, a crowd one an uncompressed RLE of its box."""
    ann_file, img_dir = plant_coco(root, sizes, seed=seed, num_cats=4)
    with open(ann_file) as f:
        coco = json.load(f)
    rng = np.random.default_rng(seed + 100)
    size = {im["id"]: (im["height"], im["width"]) for im in coco["images"]}
    for ann in coco["annotations"]:
        if ann["iscrowd"]:
            h, w = size[ann["image_id"]]
            m = np.zeros((h, w), np.uint8)
            x, y, bw, bh = ann["bbox"]
            m[y:y + bh, x:x + bw] = 1
            ann["segmentation"] = dict(size=[h, w], counts=jrle.mask_to_counts(m).tolist())
        else:
            ann["segmentation"] = [polygon(rng, ann["bbox"], int(rng.integers(3, 12)))
                                   for _ in range(int(rng.integers(1, 3)))]
    with open(ann_file, "w") as f:
        json.dump(coco, f)
    return ann_file, img_dir


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("segm"))
    ann_file, img_dir = plant_masks(root, SIZES, seed=4)
    cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
               pipeline=TEST_PIPELINE, test_mode=True)
    return cfg, build_dataset(cfg), jax_build_dataset(cfg)


# --------------------------------------------------------------- the host

def test_rle_codec_and_iou_match_ioudet():
    rng = np.random.default_rng(0)
    masks = [(rng.uniform(size=(int(rng.integers(1, 40)), int(rng.integers(1, 40))))
              < rng.uniform()).astype(np.uint8) for _ in range(60)]
    for m in masks:
        ours = rle.encode(m)
        assert ours == jrle.encode(m)
        assert np.array_equal(rle.decode(ours), m) and rle.area(ours) == jrle.area(ours)
        assert rle.string_to_counts(ours["counts"]) == jrle.string_to_counts(ours["counts"])
    same = [(rng.uniform(size=(30, 40)) < p).astype(np.uint8) for p in (0.0, 0.3, 0.6, 1.0)]
    same += [np.pad(np.ones((10, 12), np.uint8), ((3, 17), (20, 8)))]
    dt, gt = [rle.encode(m) for m in same[:3]], [rle.encode(m) for m in same[2:]]
    for crowd in ([0, 0, 0], [1, 0, 1]):
        assert np.array_equal(rle.iou(dt, gt, crowd), jrle.iou(dt, gt, crowd))
    assert rle.merge(dt) == jrle.merge(dt)


def random_polygon(rng, h, w, convex: bool):
    n = int(rng.integers(3, 30))
    if convex:
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        c = rng.uniform(-0.2, 1.2, 2) * (w, h)
        r = rng.uniform(1, max(h, w))
        return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)
    pts = rng.uniform(-0.2, 1.2, (n, 2)) * (w, h)
    return np.round(pts) if rng.uniform() < 0.2 else pts   # integer: flat edges, corners


@pytest.mark.parametrize("h, w, count", [(112, 112, 300), (427, 640, 40)])
def test_polygon_fill_is_pillows(h, w, count):
    """ann_to_rle's fill against ioudet's PIL path pixel for pixel, on
    seeded convex and self-intersecting polygons with sub-pixel, integer
    and out-of-frame vertices; at 112 also through rasterize_polygons'
    box-frame transform."""
    rng = np.random.default_rng(h)
    for i in range(count):
        polys = [random_polygon(rng, h, w, convex=bool(k % 2 == i % 2))
                 for k in range(1 + i % 2)]
        segm = [[float(v) for v in p.reshape(-1)] for p in polys]
        assert rle.ann_to_rle(segm, h, w) == jrle.ann_to_rle(segm, h, w), i
        if h == 112:
            box = np.sort(rng.uniform(-10, 130, 4).reshape(2, 2), axis=0).reshape(-1)
            box = box[[0, 2, 1, 3]].astype(np.float32)
            assert np.array_equal(rasterize_polygons(segm, box),
                                  jax_rasterize_polygons(segm, box)), i


def test_paste_mask_is_cv2s():
    """paste_mask and encode_pasted against ioudet's cv2 path: boxes that
    grow, shrink, halve exactly (28 -> 14) and leave the image; the resize
    itself against cv2.resize bit for bit."""
    rng = np.random.default_rng(8)
    h, w = 90, 120
    boxes = [[10.2, 20.7, 22.8, 32.8],        # 14 x 14: exactly half
             [3.5, 4.5, 30.0, 10.0], [0.0, 0.0, 119.0, 89.0], [-30.0, -20.0, 200.0, 70.0],
             [100.0, 80.0, 160.0, 140.0], [50.0, 50.0, 50.0, 50.0], [130.0, 5.0, 150.0, 9.0]]
    for _ in range(40):
        (x1, x2), (y1, y2) = np.sort(rng.uniform(-20, 140, 2)), np.sort(rng.uniform(-20, 110, 2))
        boxes.append([x1, y1, x2, y2])
    for b in boxes:
        box = np.asarray(b, np.float32)
        prob = (rng.uniform(0, 1, (28, 28)) ** rng.uniform(0.3, 3)).astype(np.float32)
        want = jrle.paste_mask(box, prob, h, w)
        assert np.array_equal(rle.paste_mask(box, prob, h, w), want)
        assert rle.encode_pasted(box, prob, h, w) == jrle.encode(want)
    for dh, dw in ((14, 14), (7, 9), (28, 28), (29, 200), (300, 31), (1, 1)):
        prob = rng.uniform(0, 1, (28, 28)).astype(np.float32)
        assert np.array_equal(rle.resize_bilinear(prob, (dh, dw)),
                              cv2.resize(prob, (dw, dh), interpolation=cv2.INTER_LINEAR))


# ------------------------------------------------------------ the dataset

def train_pipeline(flip: float) -> list:
    return [dict(type="LoadImageFromFile"),
            dict(type="LoadAnnotations", with_bbox=True, with_mask=True),
            dict(type="Resize", img_scale=(96, 64), keep_ratio=True),
            dict(type="RandomFlip", flip_ratio=flip), NORM,
            dict(type="Pad", size_divisor=32, size=(64, 96)),
            dict(type="DefaultFormatBundle", max_gt=8),
            dict(type="Collect", keys=["img", "gt_bboxes", "gt_labels", "gt_valid", "gt_masks"])]


@pytest.mark.parametrize("flip", [0.0, 1.0])
def test_train_pipeline_with_masks_matches_ioudet(planted, flip):
    cfg = dict(planted[0], test_mode=False, pipeline=train_pipeline(flip))
    ours, ref = build_dataset(cfg), jax_build_dataset(cfg)
    assert len(ours) == len(ref) == len(SIZES)
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert a["gt_masks"].shape == (8, 112, 112) and a["gt_masks"].dtype == np.uint8
        for k in ("gt_masks", "gt_bboxes", "gt_labels", "gt_valid", "img"):
            assert np.array_equal(a[k], b[k]), (i, k)
        assert a["gt_masks"][a["gt_valid"]].any(axis=(1, 2)).all()
    batch = next(iter(build_dataloader(ours, 2, 1, shuffle=False)))
    assert batch["gt_masks"].shape == (2, 8, 112, 112)


def perturbed_results(dataset, seed) -> list:
    """(bbox, segm) results from the gts: each gt's box and polygon mask
    (crowds: their RLE) moved a little, scored at random, and a random
    false positive a class."""
    rng = np.random.default_rng(seed)
    out = []
    for idx in range(len(dataset)):
        info = dataset.img_infos[idx]
        h, w = info["height"], info["width"]
        boxes = [[] for _ in dataset.cat_ids]
        segms = [[] for _ in dataset.cat_ids]
        for ann in dataset.gt_for_eval(idx, with_segm=True):
            ci = dataset.cat_ids.index(ann["category_id"])
            x, y, bw, bh = np.asarray(ann["bbox"]) + rng.uniform(-2, 2, 4)
            boxes[ci].append([x, y, x + bw - 1, y + bh - 1, rng.uniform()])
            m = jrle.decode(jrle.ann_to_rle(ann["segmentation"], h, w))
            segms[ci].append(jrle.encode(np.roll(m, tuple(rng.integers(-2, 3, 2)), (0, 1))))
        for ci in range(len(dataset.cat_ids)):
            x, y = rng.uniform(0, w - 10), rng.uniform(0, h - 10)
            boxes[ci].append([x, y, x + 9, y + 9, rng.uniform()])
            m = np.zeros((h, w), np.uint8)
            m[int(y):int(y) + 9, int(x):int(x) + 9] = 1
            segms[ci].append(jrle.encode(m))
        out.append(([np.asarray(b, np.float32).reshape(-1, 5) for b in boxes], segms))
    return out


def test_evaluate_bbox_and_segm_matches_ioudet(planted):
    _, ds, jds = planted
    results = perturbed_results(ds, seed=2)
    for metric in ("segm", ["bbox", "segm"]):
        ours = ds.evaluate(results, metric=metric)
        assert ours == jds.evaluate(results, metric=metric)
    assert 0.05 < ours["segm_AP"] < 0.9 and ours["bbox_AP"] != ours["segm_AP"]
    assert ds.results2json(results) == jds.results2json(results)
    # each gt's own segmentation at score 1: AP exactly 1
    oracle = [([np.asarray(b, np.float32) for b in r[0]], r[1]) for r in results]
    for idx, (boxes, segms) in enumerate(oracle):
        info = ds.img_infos[idx]
        for ci in range(len(boxes)):
            boxes[ci], segms[ci] = boxes[ci][:0], []
        for ann in ds.gt_for_eval(idx, with_segm=True):
            ci = ds.cat_ids.index(ann["category_id"])
            x, y, bw, bh = ann["bbox"]
            boxes[ci] = np.concatenate([boxes[ci], [[x, y, x + bw - 1, y + bh - 1, 1.0]]])
            segms[ci].append(rle.ann_to_rle(ann["segmentation"], info["height"],
                                            info["width"]))
    assert ds.evaluate(oracle, metric="segm")["AP"] == 1.0


# ----------------------------------------------------------- the detector

@pytest.fixture(scope="module")
def mask_model():
    model = new_model().eval()
    return model, bridge(model)


def test_single_device_test_of_the_mask_detector(planted, mask_model):
    _, ds, jds = planted
    model, params = mask_model
    jdet = jax_build_detector(dict(MODEL), TRAIN_CFG, TEST_CFG)
    ours = ttest.single_device_test(model, ds, imgs_per_batch=4, workers=2, progress=False,
                                    return_raw=True)
    ref = jax_single_device_test(jdet, params, jds, imgs_per_batch=4, workers=2,
                                 progress=False, return_raw=True)
    assert sorted(ours) == sorted(ref) == list(range(len(SIZES)))
    for i in ours:
        (d, l, m, ori), (jd, jl, jm, jori) = ours[i], ref[i]
        np.testing.assert_array_equal(l, jl)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(m, jm, rtol=0, atol=1e-5)
        assert list(ori) == list(jori) == list(SIZES[i])
        assert ttest.to_results(ref[i], 5)[1] == jax_masks_to_segm_result(jd, jl, jm, 5, *jori)
    results = ttest.single_device_test(model, ds, imgs_per_batch=4, workers=2,
                                       progress=False)
    n = 0
    for i, (bbox_res, segm_res) in enumerate(results):
        want = ttest.to_results(ours[i], 5)
        assert [len(s) for s in segm_res] == [len(b) for b in bbox_res]
        assert all(np.array_equal(a, b) for a, b in zip(bbox_res, want[0]))
        assert segm_res == want[1]
        n += sum(map(len, segm_res))
    assert n > 2 * len(SIZES)
    metrics = ds.evaluate(results, metric=["bbox", "segm"])
    assert all(np.isfinite(v) for v in metrics.values()) and "segm_AP" in metrics


def test_multi_host_test_mask_route_in_one_process(planted, mask_model, monkeypatch):
    """Two ranks as two threads of one process: each runs its shard, the
    fixed-shape outputs (with the mask probabilities and original shapes)
    meet in a stand-in allgather, and both get single_device_test's
    results."""
    _, ds, _ = planted
    model, _ = mask_model
    local = threading.local()
    barrier = threading.Barrier(2)
    trees = [None, None]

    def allgather(tree):
        trees[local.rank] = tree
        barrier.wait()
        return list(trees)

    monkeypatch.setattr(ttest, "world_size", lambda: 2)
    monkeypatch.setattr(ttest, "rank", lambda: local.rank)
    monkeypatch.setattr(ttest, "allgather_pytrees", allgather)
    got = [None, None]

    def run(r):
        local.rank = r
        torch.set_num_threads(1)
        got[r] = ttest.multi_host_test(model, ds, imgs_per_batch=2, workers=1, progress=False)

    threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(t is not None for t in trees) and len(trees[0]) == 5
    assert trees[0][3].shape[1:] == (20, 28, 28) and trees[0][4].shape[1:] == (2,)
    monkeypatch.undo()
    want = ttest.single_device_test(model, ds, imgs_per_batch=2, workers=1, progress=False)
    for res in got:
        assert len(res) == len(want)
        for (b, s), (wb, ws) in zip(res, want):
            assert s == ws and all(np.array_equal(x, y) for x, y in zip(b, wb))


def test_test_tool_evaluates_segm(planted, mask_model, tmp_path):
    """``tools/test.py --eval bbox segm`` on a checkpoint of the mask
    detector: single_device_test's results, each metric's evaluate, and
    JSON records that carry the RLEs."""
    cfg, ds, _ = planted
    model, _ = mask_model
    ckpt = save_checkpoint(str(tmp_path), "weights", model)
    config = tmp_path / "cfg.py"
    config.write_text(f"model = {MODEL!r}\ntest_cfg = {TEST_CFG!r}\n"
                      f"data = {dict(test=cfg)!r}\n")
    js = tmp_path / "res.json"
    metrics = test_tool.main([str(config), ckpt, "--eval", "bbox", "segm", "--json_out",
                              str(js), "--batch", "4", "--device", "cpu"])
    results = ttest.single_device_test(model, ds, imgs_per_batch=4, progress=False)
    assert metrics == {m: ds.evaluate(results, metric=m) for m in ("bbox", "segm")}
    with open(js) as f:
        records = json.load(f)
    assert records == json.loads(json.dumps(ds.results2json(results)))
    assert records and all("counts" in r["segmentation"] for r in records)


def test_train_detector_on_a_mask_dataset(planted, tmp_path):
    """One train_detector step fed from the COCO set through the mask train
    pipeline: the logged losses, loss_mask among them, are forward_train's
    on the loader's first batch with the step's draws."""
    ds_cfg = dict(planted[0], test_mode=False, pipeline=train_pipeline(0.5))
    cfg = dict(model=MODEL, train_cfg=TRAIN_CFG,
               data=dict(imgs_per_gpu=2, workers_per_gpu=1, train=ds_cfg),
               optimizer=dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=0.0001),
               lr_config=dict(policy="step", step=[8]), total_epochs=1,
               log_config=dict(interval=1), checkpoint_config=dict(interval=1))
    model = new_model().train()
    initial = copy.deepcopy(model)
    dataset = build_dataset(ds_cfg)
    seen = []
    train_detector(model, dataset, dict(cfg, total_epochs=1), str(tmp_path / "work"),
                   device="cpu", step_hook=lambda step, lv: seen.append(lv))
    assert len(seen) == len(dataset) // 2 and "loss_mask" in seen[0]
    batch = next(iter(build_dataloader(dataset, 2, 1, shuffle=True, seed=0)))
    tb = {k: torch.from_numpy(batch[k]) for k in ("img", "gt_bboxes", "gt_labels",
                                                   "gt_valid", "img_shape", "pad_shape",
                                                   "gt_masks")}
    with torch.no_grad():
        want = initial.forward_train(tb["img"], tb["gt_bboxes"], tb["gt_labels"],
                                     tb["gt_valid"], tb["img_shape"], tb["pad_shape"],
                                     gt_masks=tb["gt_masks"],
                                     generator=step_generator("cpu", 0, 0))
    for k, v in want.items():
        np.testing.assert_allclose(float(seen[0][k]), float(v), rtol=1e-5, err_msg=k)
    assert 0.1 < float(want["loss_mask"]) < 10
