"""Closed loop with the port alone, on the CPU: train the tiny IoU-aware
RetinaNet on planted boxes through ``train_detector``, then ``predict`` and
hold the top detection of every image against its planted box.  The recipe
is that of tests/test_convergence_map.py (16 images of 64x96 with one bright
28x24 box on dark noise, batch 8, flips, SGD lr 0.005 with warm-up), cut
from its 90 epochs (step at 70) to 24 (step at 19) to keep the test short;
the images are made with numpy and fed as ready batches, since the port has
no dataset pipeline yet, and the measure is the IoU of the top detection,
since it has no COCOeval yet.  Measured at 24 epochs with 1, 3 and 8
threads: 16 of 16 hits at IoU 0.69 or more, mean IoU 0.76-0.85, lowest top
score 0.41-0.66 (at 90 epochs, when the test was written: IoU 0.75 or more,
mean 0.95-0.98)."""

import numpy as np
import pytest
import torch

from ioudet_torch.apis.inference import init_detector, predict
from ioudet_torch.apis.train import train_detector
from ioudet_torch.core.bbox import bbox_overlaps

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
CFG = dict(
    model=MODEL,
    train_cfg=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                                 neg_iou_thr=0.4, min_pos_iou=0, ignore_iof_thr=-1),
                   allowed_border=-1, pos_weight=-1),
    test_cfg=dict(nms_pre=100, score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                  max_per_img=5, rescoring_alpha=0.5),
    optimizer=dict(type="SGD", lr=0.005, momentum=0.9, weight_decay=0.0001),
    optimizer_config=dict(grad_clip=dict(max_norm=35)),
    lr_config=dict(policy="step", warmup="linear", warmup_iters=20,
                   warmup_ratio=0.1, step=[19]),
    checkpoint_config=dict(interval=1000), log_config=dict(interval=20),
    total_epochs=24)


def planted(seed=42):
    """Normalised images (N, H, W, 3) f32 and their boxes (N, 1, 4)."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 60, (N, H, W, 3)).astype(np.float32)  # dark noise
    boxes = np.zeros((N, 1, 4), np.float32)
    bw, bh = 28, 24
    for i in range(N):
        x = int(rng.integers(4, W - bw - 4))
        y = int(rng.integers(4, H - bh - 4))
        imgs[i, y:y + bh, x:x + bw] = [250, 40, 40]
        boxes[i, 0] = [x, y, x + bw - 1, y + bh - 1]
    return (imgs - 30.0) / 60.0, boxes


class PlantedLoader:
    """Two batches an epoch: a permutation and horizontal flips drawn from
    (seed, epoch), so that a run does not depend on what ran before it."""

    def __init__(self, imgs, boxes):
        self.imgs, self.boxes, self.epoch = imgs, boxes, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return N // BATCH

    def __iter__(self):
        rng = np.random.default_rng(1000 + self.epoch)
        order = rng.permutation(N)
        shapes = np.tile(np.array([[H, W]], np.int32), (BATCH, 1))
        for idx in order.reshape(-1, BATCH):
            img, box = self.imgs[idx].copy(), self.boxes[idx].copy()
            flip = rng.uniform(size=BATCH) < 0.5
            img[flip] = img[flip, :, ::-1]
            x1, x2 = W - 1 - box[flip, :, 2], W - 1 - box[flip, :, 0]
            box[flip, :, 0], box[flip, :, 2] = x1, x2
            yield dict(img=img, gt_bboxes=box,
                       gt_labels=np.ones((BATCH, 1), np.int32),
                       gt_valid=np.ones((BATCH, 1), bool),
                       img_shape=shapes, pad_shape=shapes.copy())


@pytest.fixture
def two_threads():
    """Two intra-op threads: the test runs beside other test processes, and a
    pool as wide as the machine then spends most of its time waiting (16 of
    16 hits were also measured at 1, 3 and 8 threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_train_then_predict_finds_the_planted_boxes(tmp_path, two_threads):
    imgs, boxes = planted()
    handle = init_detector(CFG, device="cpu", seed=0)
    runner = train_detector(handle, PlantedLoader(imgs, boxes), CFG, str(tmp_path),
                            device="cpu")
    assert runner.step == CFG["total_epochs"] * (N // BATCH)

    handle.model.eval()
    shapes = torch.tensor([[H, W]] * N, dtype=torch.int32)
    dets, labels = predict(handle, torch.from_numpy(imgs), shapes, torch.ones(N), shapes)
    assert bool((labels[:, 0] == 0).all()), labels[:, 0]   # class 1 of 1, 0-based
    iou = bbox_overlaps(dets[:, 0, :4], torch.from_numpy(boxes[:, 0]), is_aligned=True)
    # the JAX recipe's bars: AP50 > 0.8 and AP > 0.5 there
    assert float((iou >= 0.5).float().mean()) > 0.8, iou
    assert float(iou.mean()) > 0.5, iou
    assert float(dets[:, 0, 4].min()) > 0.3, dets[:, 0, 4]
