"""The two-stage TTA on the card: ``merge_aug_proposals`` of four views of
1000 proposals (two scales, flip, padding rows, tied scores) launches K1a and
K1b once and is bit-equal to a replay with the plain NMS in K1's place on
the same tensors; then ``aug_test_two_stage`` of the tiny Mask R-CNN of
tests/test_torch_tta_two_stage.py on four views launches K1 views + 2 times
(each view's proposals, the merge, the final NMS) and gives a replay's
bits.  TF32 off.  Skips without a GPU.  This file imports no JAX, so a GPU
host without it runs it as

    python -m pytest --noconftest -m cuda tests/test_torch_tta_two_stage_cuda.py
"""

import numpy as np
import pytest
import torch

from ioudet_torch.apis.inference import init_detector
from ioudet_torch.apis.test import aug_test_two_stage
from ioudet_torch.core.post_processing import merge_aug_proposals
from ioudet_torch.ops import _build
from ioudet_torch.ops import nms_cuda
# by its file name, not as tests._torch_mp_worker: pytest puts this directory on
# sys.path, and a GPU host may have another package named "tests" installed
from _torch_mp_worker import mask_rcnn_cfgs

VIEWS = (((800, 1333), 1.0, False), ((800, 1333), 1.0, True), ((1000, 1666), 1.25, False),
         ((1000, 1666), 1.25, True))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kept = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = kept


def plain_keep(boxes, valid, thr):
    return nms_cuda.nms_reduce_plain(nms_cuda.nms_mask_plain(boxes, thr), valid)


def launches() -> tuple:
    return (nms_cuda.launches["nms_mask_kernel"], nms_cuda.launches["nms_reduce_kernel"])


@pytest.mark.cuda
def test_merge_aug_proposals_launches_k1_once_and_matches_plain(card, monkeypatch):
    rng = np.random.default_rng(0)
    props, metas = [], []
    for (h, w), scale, flip in VIEWS:
        xy = rng.uniform(0, 1, (1000, 2)) * (w - 100, h - 100)
        score = np.floor(rng.uniform(0.01, 1.0, (1000, 1)) * 64) / 64
        score[900:] = 0.0
        p = np.concatenate([xy, xy + rng.uniform(8, 300, (1000, 2)), score], 1)
        props.append(torch.from_numpy(p.astype(np.float32)).cuda())
        metas.append(dict(img_shape=torch.tensor([h, w], dtype=torch.int32, device="cuda"),
                          scale_factor=torch.tensor(scale, device="cuda"), flip=flip))
    cfg = dict(nms_thr=0.7, max_num=1000)
    torch.cuda.synchronize()
    _build.reset_launches()
    got = merge_aug_proposals(props, metas, cfg)
    torch.cuda.synchronize()
    assert launches() == (1, 1)
    monkeypatch.setattr(nms_cuda, "greedy_keep", plain_keep)
    want = merge_aug_proposals(props, metas, cfg)
    assert got.is_cuda and tuple(got.shape) == (1000, 5) and torch.equal(got, want)
    assert 100 < int((got[:, 4] > 0).sum()) < 3600


@pytest.mark.cuda
def test_aug_test_two_stage_launches_views_plus_two(card, monkeypatch):
    model, train_cfg, test_cfg = mask_rcnn_cfgs()
    test_cfg["rcnn"]["score_thr"] = 0.0   # random weights: scores near 1/5
    handle = init_detector(dict(model=model, test_cfg=test_cfg), device="cuda", seed=0)
    rng = np.random.default_rng(1)
    views = []
    for scale, flip in ((1.0, False), (1.0, True), (0.75, False), (0.75, True)):
        h, w = int(64 * scale), int(96 * scale)
        img = np.zeros((64, 96, 3), np.float32)
        img[:h, :w] = rng.normal(0, 1, (h, w, 3))
        views.append(dict(img=img, img_shape=np.array([h, w], np.int32),
                          pad_shape=np.array([64, 96], np.int32),
                          scale_factor=np.float32(scale), flip=flip))
    aug_test_two_stage(handle, views)   # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    got = aug_test_two_stage(handle, views)
    torch.cuda.synchronize()
    assert launches() == (len(views) + 2, len(views) + 2)
    monkeypatch.setattr(nms_cuda, "greedy_keep", plain_keep)
    want = aug_test_two_stage(handle, views)
    assert len(got) == 3 and all(torch.equal(g, w) for g, w in zip(got, want))
    assert int((got[1] >= 0).sum()) >= 5
