"""HTC's ``predict`` and train step on the card: the tiny model of
tests/test_torch_htc.py (``htc_cfgs``: interleaving, information flow and
the semantic branch on) on 64x96 canvases at batch 2, TF32 off.  Its
(dets, labels, masks) are bit-equal to a replay with the plain NMS at both
stages in K1's place, K1a and K1b launched twice, masks in [0, 1]; one
step on a seeded label map launches K1 once and gives finite losses, the
semantic one among them.  Skips without a GPU.  This file imports no JAX,
so a GPU host without it runs it as

    python -m pytest --noconftest -m cuda tests/test_torch_htc_cuda.py
"""

import numpy as np
import pytest
import torch

from ioudet_torch.apis import train as ttrain
from ioudet_torch.apis.inference import init_detector, predict
from ioudet_torch.ops import _build
from ioudet_torch.ops import nms_cuda
# by its file name, not as tests._torch_mp_worker: pytest puts this directory on
# sys.path, and a GPU host may have another package named "tests" installed
from _torch_mp_worker import htc_cfgs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kept = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = kept


def handle_and_inputs():
    model, train_cfg, test_cfg = htc_cfgs()
    test_cfg["rcnn"]["score_thr"] = 0.0   # random weights: scores near 1/5
    handle = init_detector(dict(model=model, train_cfg=train_cfg, test_cfg=test_cfg),
                           device="cuda", seed=0)
    rng = np.random.default_rng(0)
    inputs = (torch.from_numpy(rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32)).cuda(),
              torch.tensor([[64, 96], [50, 80]], dtype=torch.int32, device="cuda"),
              torch.tensor([1.0, 0.625], device="cuda"),
              torch.tensor([[64, 96], [64, 96]], dtype=torch.int32, device="cuda"))
    return handle, inputs


@pytest.mark.cuda
def test_htc_predict_through_k1_equals_its_plain_replay(card, monkeypatch):
    handle, inputs = handle_and_inputs()
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


@pytest.mark.cuda
def test_htc_train_step_on_the_card(card):
    handle, inputs = handle_and_inputs()
    model = handle.model.train()
    ttrain.make_trainable_mask(model)
    step = ttrain.make_train_step(model, ttrain.build_optimizer(model, dict(type="SGD", lr=0.01)),
                                  lambda s: 0.01)
    rng = np.random.default_rng(1)
    seg = rng.integers(0, 7, (2, 8, 12)).astype(np.int32)
    seg[:, :2] = 255
    gts = torch.tensor([[[10., 8., 40., 50.], [50., 5., 90., 30.]]] * 2, device="cuda")
    batch = dict(img=inputs[0], gt_bboxes=gts,
                 gt_labels=torch.tensor([[3, 4]] * 2, dtype=torch.int32, device="cuda"),
                 gt_valid=torch.ones(2, 2, dtype=torch.bool, device="cuda"),
                 img_shape=inputs[1], pad_shape=inputs[3],
                 gt_masks=torch.ones(2, 2, 112, 112, dtype=torch.uint8, device="cuda"),
                 gt_semantic_seg=torch.from_numpy(seg).cuda())
    _build.reset_launches()
    logs = step(batch, 0)
    torch.cuda.synchronize()
    assert _build.launches["nms_mask_kernel"] == 1 and _build.launches["nms_reduce_kernel"] == 1
    assert float(logs["loss_semantic_seg"]) > 0 and "s2_loss_mask" in logs
    assert all(bool(torch.isfinite(v)) for v in logs.values())
