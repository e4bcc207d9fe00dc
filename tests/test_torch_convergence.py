"""Closed loop with the port alone, on the CPU: train the tiny IoU-aware
RetinaNet on planted boxes and measure it, through the port's own entry
points: CocoDataset -> train_detector(dataset) -> single_device_test ->
evaluate.  The recipe is that of tests/test_convergence_map.py (16 images of
64x96 with one bright 28x24 box on dark noise, batch 8, flips, SGD lr 0.005
with warm-up), cut from its 90 epochs (step at 70) to 24 (step at 19) to keep
the test short; the images are .ppm files.  Held: the top detection of every
image against its planted box, and the COCO AP50 of the results.  Measured
at 24 epochs with 1, 2, 3 and 8 threads (through the dataset pipeline): 16
of 16 hits at IoU 0.56 or more, mean IoU 0.76-0.91, lowest top score
0.47-0.64, AP50 0.863 / 0.974 / 1.0 / 1.0 at 8 / 2 / 3 / 1 threads (false
positives above a true one cost the 8-thread run), AP 0.46-0.84; the AP50
bar is 0.75, ~0.11 under the lowest."""

import json

import numpy as np
import pytest
import torch

from ioudet_torch.apis.inference import init_detector
from ioudet_torch.apis.test import single_device_test
from ioudet_torch.apis.train import train_detector
from ioudet_torch.core.bbox import bbox_overlaps
from ioudet_torch.data import build_dataset
from ioudet_torch.data.pipelines.loading import imwrite_netpbm
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

H, W, N, BATCH = 64, 96, 16, 8
MODEL = dict(
    type="IoUAwareRetinaNet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=-1,
                  norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
              start_level=1, add_extra_convs=True, num_outs=5),
    bbox_head=dict(type="IoUAwareRetinaHead", num_classes=2, in_channels=32,
                   feat_channels=32, stacked_convs=1,
                   anchor_strides=(8, 16, 32, 64, 128),
                   loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0,
                                 alpha=0.25, loss_weight=1.0),
                   loss_bbox=dict(type="SmoothL1Loss", beta=0.11, loss_weight=1.0)))
NORM = dict(type="Normalize", mean=(30.0, 30.0, 30.0), std=(60.0, 60.0, 60.0), to_rgb=False)
TRAIN_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True),
    dict(type="Resize", img_scale=(96, 64), keep_ratio=True),
    dict(type="RandomFlip", flip_ratio=0.5),
    NORM,
    dict(type="Pad", size_divisor=32, size=(64, 96)),
    dict(type="DefaultFormatBundle", max_gt=3),
    dict(type="Collect", keys=["img", "gt_bboxes", "gt_labels", "gt_valid"]),
]
TEST_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="Resize", img_scale=(96, 64), keep_ratio=True),
    NORM,
    dict(type="Pad", size_divisor=32, size=(64, 96)),
    dict(type="Collect", keys=["img"]),
]


def planted_coco(root, seed=42):
    """The 16 planted images as .ppm files and their annotation file;
    returns (ann_file, boxes (N, 4) xyxy)."""
    rng = np.random.default_rng(seed)
    images, anns = [], []
    boxes = np.zeros((N, 4), np.float32)
    bw, bh = 28, 24
    for i in range(N):
        img = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)   # dark noise
        x = int(rng.integers(4, W - bw - 4))
        y = int(rng.integers(4, H - bh - 4))
        img[y:y + bh, x:x + bw] = [250, 40, 40]
        boxes[i] = [x, y, x + bw - 1, y + bh - 1]
        imwrite_netpbm(f"{root}/{i}.ppm", img)
        images.append(dict(id=i, file_name=f"{i}.ppm", width=W, height=H))
        anns.append(dict(id=i, image_id=i, category_id=1, bbox=[x, y, bw, bh],
                         area=bw * bh, iscrowd=0))
    ann_file = f"{root}/annotations.json"
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name="thing")]), f)
    return ann_file, boxes


def config(ann_file, root) -> dict:
    data = dict(type="CocoDataset", ann_file=ann_file, img_prefix=root)
    return dict(
        model=MODEL,
        train_cfg=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                                     neg_iou_thr=0.4, min_pos_iou=0, ignore_iof_thr=-1),
                       allowed_border=-1, pos_weight=-1),
        test_cfg=dict(nms_pre=100, score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                      max_per_img=5, rescoring_alpha=0.5),
        data=dict(imgs_per_gpu=BATCH, workers_per_gpu=2,
                  train=dict(data, pipeline=TRAIN_PIPELINE),
                  val=dict(data, pipeline=TEST_PIPELINE, test_mode=True)),
        optimizer=dict(type="SGD", lr=0.005, momentum=0.9, weight_decay=0.0001),
        optimizer_config=dict(grad_clip=dict(max_norm=35)),
        lr_config=dict(policy="step", warmup="linear", warmup_iters=20,
                       warmup_ratio=0.1, step=[19]),
        checkpoint_config=dict(interval=1000), log_config=dict(interval=20),
        total_epochs=24)


def train_and_measure(root):
    """Returns (the top detection of each image (N, 5), the planted boxes,
    the COCO metrics)."""
    ann_file, boxes = planted_coco(root)
    cfg = config(ann_file, root)
    handle = init_detector(cfg, device="cpu", seed=0)
    runner = train_detector(handle, build_dataset(cfg["data"]["train"]), cfg,
                            f"{root}/work", device="cpu")
    assert runner.step == cfg["total_epochs"] * (N // BATCH)
    val = build_dataset(cfg["data"]["val"])
    results = single_device_test(handle, val, imgs_per_batch=BATCH, progress=False)
    top = np.zeros((N, 5), np.float32)
    for i, (dets,) in enumerate(results):   # one class
        if len(dets):
            top[i] = dets[np.argmax(dets[:, 4])]
    return top, boxes, val.evaluate(results)


@pytest.fixture
def two_threads():
    """Two intra-op threads: the test runs beside other test processes, and a
    pool as wide as the machine then spends most of its time waiting (the
    same bars were also measured at 1, 3 and 8 threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_train_then_predict_finds_the_planted_boxes(tmp_path, two_threads):
    top, boxes, metrics = train_and_measure(str(tmp_path))
    iou = bbox_overlaps(torch.from_numpy(top[:, :4]), torch.from_numpy(boxes),
                        is_aligned=True)
    # the JAX recipe's bars: AP50 > 0.8 and AP > 0.5 there
    assert float((iou >= 0.5).float().mean()) > 0.8, iou
    assert float(iou.mean()) > 0.5, iou
    assert float(top[:, 4].min()) > 0.3, top[:, 4]
    assert metrics["AP50"] > 0.75, metrics
