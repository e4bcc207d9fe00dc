"""Guided anchoring (configs/ga_retinanet_r50_fpn_1x.py and
configs/ga_faster_rcnn_r50_fpn_1x.py, full width, seeded random weights at
``ioudet``'s init, GA-RetinaNet's ``conv_cls.bias`` zeroed) on the card:
``predict`` at batch 2 launches K1a and K1b once a NMS stage (once for
GA-RetinaNet, on 2000 (box, class) candidates an image; twice for
GA-Faster R-CNN), and its outputs are bit-equal to a replay with the plain
NMS; a GA-RetinaNet train step's forward and backward launch K3a and K3b 5
times each at A = 1, with losses within rtol 1e-5 of the same step through
K3's plain versions.  TF32 off, cuDNN deterministic for the replay.  Skips
without a GPU.  This file imports no JAX, so a GPU host without it runs it
as

    python -m pytest --noconftest -m cuda tests/test_torch_ga_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ioudet_torch.apis.inference import predict
from ioudet_torch.ops import _build, assign_cuda, focal_cuda, nms_cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kept = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = kept


@pytest.mark.cuda
@pytest.mark.parametrize("name,stages", [(chip_smoke.GA_RETINA, 1), (chip_smoke.GA_FASTER, 2)])
def test_predict_through_k1_equals_its_plain_replay(card, name, stages):
    _, handle = chip_smoke.ga_handle(name, two_stage=stages == 2)
    inputs = chip_smoke.canvases(2, np.random.default_rng(0))
    predict(handle, *inputs)
    torch.cuda.synchronize()
    seen = []
    _build.reset_launches()
    with chip_smoke.nms_calls(nms_cuda, seen):
        dets, labels = predict(handle, *inputs)
    torch.cuda.synchronize()
    assert (_build.launches["nms_mask_kernel"] == stages and
            _build.launches["nms_reduce_kernel"] == stages)
    assert tuple(dets.shape) == (2, 100, 5) and int((labels >= 0).sum()) > 0
    assert len(seen) == stages and all(s[0].shape[1] == 2000 for s in seen)
    with chip_smoke.plain_nms(nms_cuda):
        plain = predict(handle, *inputs)
    assert torch.equal(plain[0], dets) and torch.equal(plain[1], labels)


@pytest.mark.cuda
def test_ga_retinanet_step_launches_k3_at_a_equal_1(card):
    _, handle = chip_smoke.ga_handle(chip_smoke.GA_RETINA)
    model = handle.model.train()
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in chip_smoke.train_batch(2, 30, canvas=(416, 672)).items()}
    names = chip_smoke.AF_NAMES["GARetinaHead"]
    torch.backends.cudnn.deterministic = True
    try:
        _build.reset_launches()
        losses, _ = chip_smoke.loss_and_grads(model, batch, names)
        torch.cuda.synchronize()
        launched = dict(_build.launches)
        with chip_smoke.plain_kernels(assign_cuda, focal_cuda):
            plain, _ = chip_smoke.loss_and_grads(model, batch, names)
    finally:
        torch.backends.cudnn.deterministic = False
    assert launched["focal_sum_kernel"] == 5 and launched["focal_dx_kernel"] == 5
    assert launched["nms_mask_kernel"] == 0 and launched["assign_gtmax_kernel"] == 0
    levels = chip_smoke.focal_level_inputs(focal_cuda, model, batch, names)
    assert [lv[6] for lv in levels] == [1] * 5
    assert sorted(losses) == ["loss_bbox", "loss_cls", "loss_loc", "loss_shape"]
    for k, v in losses.items():
        assert bool(torch.isfinite(v)) and float(v) > 0, k
        torch.testing.assert_close(v, plain[k], rtol=1e-5, atol=0.0)
