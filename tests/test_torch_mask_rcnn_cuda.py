"""Mask R-CNN's ``predict`` on the card: the tiny model of
tests/test_torch_mask_rcnn.py on 64x96 canvases at batch 2, its (dets,
labels, masks) bit-equal to a replay with the plain NMS at both stages in
K1's place, K1a and K1b launched twice, masks in [0, 1], TF32 off.  Skips
without a GPU.  This file imports no JAX, so a GPU host without it runs it
as

    python -m pytest --noconftest -m cuda tests/test_torch_mask_rcnn_cuda.py
"""

import numpy as np
import pytest
import torch

from ioudet_torch.apis.inference import init_detector, predict
from ioudet_torch.ops import _build
from ioudet_torch.ops import nms_cuda
# by its file name, not as tests._torch_mp_worker: pytest puts this directory on
# sys.path, and a GPU host may have another package named "tests" installed
from _torch_mp_worker import mask_rcnn_cfgs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kept = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = kept


@pytest.mark.cuda
def test_mask_predict_through_k1_equals_its_plain_replay(card, monkeypatch):
    model, train_cfg, test_cfg = mask_rcnn_cfgs()
    test_cfg["rcnn"]["score_thr"] = 0.0   # random weights: scores near 1/5
    handle = init_detector(dict(model=model, train_cfg=train_cfg, test_cfg=test_cfg),
                           device="cuda", seed=0)
    rng = np.random.default_rng(0)
    inputs = (torch.from_numpy(rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32)).cuda(),
              torch.tensor([[64, 96], [50, 80]], dtype=torch.int32, device="cuda"),
              torch.tensor([1.0, 0.625], device="cuda"),
              torch.tensor([[64, 96], [64, 96]], dtype=torch.int32, device="cuda"))
    predict(handle, *inputs)
    torch.cuda.synchronize()
    _build.reset_launches()
    dets, labels, masks = predict(handle, *inputs)
    torch.cuda.synchronize()
    assert _build.launches["nms_mask_kernel"] == 2 and _build.launches["nms_reduce_kernel"] == 2
    assert tuple(masks.shape) == (2, 20, 28, 28) and int((labels >= 0).sum()) > 0
    assert bool(((masks >= 0) & (masks <= 1)).all())
    monkeypatch.setattr(nms_cuda, "greedy_keep", lambda b, v, t: nms_cuda.nms_reduce_plain(
        nms_cuda.nms_mask_plain(b, t), v))
    plain = predict(handle, *inputs)
    for a, b in zip(plain, (dets, labels, masks)):
        assert torch.equal(a, b)
