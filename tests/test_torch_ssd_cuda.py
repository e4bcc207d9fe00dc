"""SSD300 (configs/ssd300_coco.py, full width, seeded random weights) on the
card: ``predict`` at batch 2 launches K1a and K1b once, on 2000 (box,
class) candidates an image, and its (dets, labels) are bit-equal to a replay
with the plain NMS in K1's place; K1 alone on those candidates equals the
plain mask and walk bit for bit.  TF32 off.  Skips without a GPU.  This file
imports no JAX, so a GPU host without it runs it as

    python -m pytest --noconftest -m cuda tests/test_torch_ssd_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from ioudet_torch.apis.inference import init_detector, predict
from ioudet_torch.ops import _build
from ioudet_torch.ops import nms_cuda
from ioudet_torch.ops.preprocess import preprocess_batch
from ioudet_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kept = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = kept


def plain_greedy(boxes, valid, thr):
    return nms_cuda.nms_reduce_plain(nms_cuda.nms_mask_plain(boxes, thr), valid)


@pytest.mark.cuda
def test_ssd_predict_through_k1_equals_its_plain_replay(card, monkeypatch):
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "ssd300_coco.py")).todict()
    handle = init_detector(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)).cuda()
    shapes = torch.tensor([[480, 640], [480, 640]], dtype=torch.int32, device="cuda")
    img, img_shapes, factors = preprocess_batch(
        raw, shapes, canvas=(300, 300), max_scale=(300, 300), mean=(123.675, 116.28, 103.53),
        std=(1.0, 1.0, 1.0), flip_channels=True, keep_ratio=False)
    inputs = (img, img_shapes, factors, torch.full((2, 2), 300, dtype=torch.int32, device="cuda"))
    predict(handle, *inputs)
    torch.cuda.synchronize()
    seen = []
    greedy = nms_cuda.greedy_keep

    def capture(boxes, valid, thr):
        seen.append((boxes.clone(), valid.clone(), thr))
        return greedy(boxes, valid, thr)

    monkeypatch.setattr(nms_cuda, "greedy_keep", capture)
    _build.reset_launches()
    dets, labels = predict(handle, *inputs)
    torch.cuda.synchronize()
    assert _build.launches["nms_mask_kernel"] == 1 and _build.launches["nms_reduce_kernel"] == 1
    assert tuple(dets.shape) == (2, 200, 5) and int((labels >= 0).sum()) > 0
    (boxes, valid, thr), = seen
    assert boxes.shape[1] == 2000 and thr == 0.45 and int(valid.sum()) > 0
    np.testing.assert_array_equal(greedy(boxes, valid, thr).cpu().numpy(),
                                  plain_greedy(boxes, valid, thr).cpu().numpy())
    monkeypatch.setattr(nms_cuda, "greedy_keep", plain_greedy)
    plain = predict(handle, *inputs)
    assert torch.equal(plain[0], dets) and torch.equal(plain[1], labels)
