"""Fast R-CNN on the card: the tiny model of tests/test_torch_fast_rcnn.py
(as Fast R-CNN, no mask branch) on 64x96 canvases at batch 2 with seeded
proposals and padding rows, ``predict`` with proposals: K1a and K1b
launched once (the final NMS; there is no RPN), (dets, labels) bit-equal
to a replay with the plain NMS in K1's place, and a train step's losses
finite with no K1 launch.  TF32 off.  Skips without a GPU.  This file
imports no JAX, so a GPU host without it runs it as

    python -m pytest --noconftest -m cuda tests/test_torch_fast_rcnn_cuda.py
"""

import numpy as np
import pytest
import torch

from ioudet_torch.apis.inference import init_detector, predict
from ioudet_torch.ops import _build
from ioudet_torch.ops import nms_cuda
# by its file name, not as tests._torch_mp_worker: pytest puts this directory on
# sys.path, and a GPU host may have another package named "tests" installed
from _torch_mp_worker import faster_rcnn_cfgs, two_stage_batches


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kept = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = kept


def proposals(rng, batch: int = 2, num: int = 32, valid_rows=(32, 20)):
    xy = rng.uniform(0, 70, (batch, num, 2)) * np.array([1.0, 0.6])
    boxes = np.concatenate([xy, xy + rng.uniform(8, 40, (batch, num, 2))], -1)
    valid = np.arange(num)[None] < np.asarray(valid_rows)[:, None]
    return (torch.from_numpy((boxes * valid[..., None]).astype(np.float32)).cuda(),
            torch.from_numpy(valid).cuda())


@pytest.mark.cuda
def test_fast_rcnn_predict_and_step_on_the_card(card, monkeypatch):
    model, train_cfg, test_cfg = faster_rcnn_cfgs(max_num=32)
    model = {k: v for k, v in dict(model, type="FastRCNN", rpn_head=None).items()
             if v is not None}
    test_cfg["rcnn"]["score_thr"] = 0.0   # random weights: scores near 1/5
    handle = init_detector(dict(model=model, train_cfg=dict(rcnn=train_cfg["rcnn"]),
                                test_cfg=dict(rcnn=test_cfg["rcnn"])), device="cuda", seed=0)
    rng = np.random.default_rng(0)
    inputs = (torch.from_numpy(rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32)).cuda(),
              torch.tensor([[64, 96], [50, 80]], dtype=torch.int32, device="cuda"),
              torch.tensor([1.0, 0.625], device="cuda"),
              torch.tensor([[64, 96], [64, 96]], dtype=torch.int32, device="cuda"))
    props = proposals(rng)
    predict(handle, *inputs, *props)
    torch.cuda.synchronize()
    _build.reset_launches()
    dets, labels = predict(handle, *inputs, *props)
    torch.cuda.synchronize()
    assert _build.launches["nms_mask_kernel"] == 1 and _build.launches["nms_reduce_kernel"] == 1
    assert tuple(dets.shape) == (2, 20, 5) and int((labels >= 0).sum()) > 0

    batch = {k: torch.from_numpy(v[:2]).cuda() for k, v in two_stage_batches(1)[0].items()}
    batch["proposals"], batch["prop_valid"] = proposals(rng)
    net = handle.model.train()
    _build.reset_launches()
    losses = net.forward_train(batch["img"], batch["gt_bboxes"], batch["gt_labels"],
                               batch["gt_valid"], batch["img_shape"], batch["pad_shape"],
                               proposals=batch["proposals"], prop_valid=batch["prop_valid"],
                               generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    assert sorted(losses) == ["loss_bbox", "loss_cls"]
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    assert _build.launches["nms_mask_kernel"] == 0
    net.eval()

    monkeypatch.setattr(nms_cuda, "greedy_keep", lambda b, v, t: nms_cuda.nms_reduce_plain(
        nms_cuda.nms_mask_plain(b, t), v))
    plain = predict(handle, *inputs, *props)
    assert torch.equal(plain[0], dets) and torch.equal(plain[1], labels)
