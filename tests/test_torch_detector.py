"""Port parity: the detector of ioudet_torch against ioudet on the same
weights (bridged through convert_torch_retinanet / state_dict_from_flax) and
the same seeded inputs.

Tolerances: forward outputs rtol = atol = 2e-3 (f32 sums over 20+ conv
layers in another order; the same bound as test_full_detector_parity);
simple_test labels exact and dets rtol 1e-4 / atol 1e-3 (decode of those
outputs, then exact selection on scores that the fixture keeps apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.apis.checkpoint import convert_torch_retinanet
from ioudet.models import build_detector as jax_build_detector
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.models import build_detector
from ioudet_torch.models.utils.layers import FrozenBatchNorm
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

TINY = dict(
    type="IoUAwareRetinaNet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1,
                  norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
              start_level=1, add_extra_convs=True, num_outs=5),
    bbox_head=dict(type="IoUAwareRetinaHead", num_classes=5, in_channels=32,
                   feat_channels=32, stacked_convs=2, octave_base_scale=4,
                   scales_per_octave=3, anchor_ratios=(0.5, 1.0, 2.0),
                   anchor_strides=(8, 16, 32, 64, 128)))
TEST_CFG = dict(nms_pre=60, score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                max_per_img=12, rescoring_alpha=0.5, class_topk=2)


def randomize(model, seed):
    """Seeded weights that keep activations O(1) through the network
    (random FrozenBN statistics, halved backbone convs) and spread the
    head's logits, so score ranks sit far apart compared with the two
    libraries' f32 roundoff.  retina_cls.bias is zero (not the -4.6 prior),
    so that detections clear score_thr."""
    g = torch.Generator().manual_seed(seed)
    model.init_weights(g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.5, 0.5, generator=g)
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
        backbone = getattr(model, "backbone", model)
        for p in backbone.parameters():
            if p.dim() == 4:
                p.mul_(0.5)
        head = getattr(model, "bbox_head", None)
        if head is not None:
            for conv in (head.retina_cls, head.retina_reg, head.retina_iou):
                conv.weight.normal_(0.0, 0.15, generator=g)
            head.retina_cls.bias.zero_()
    return model.eval()


def bridge(model, depth, stacked_convs):
    return convert_torch_retinanet(model.state_dict(), depth=depth,
                                   num_laterals=3, stacked_convs=stacked_convs)


@pytest.fixture(scope="module")
def tiny():
    model = randomize(build_detector(TINY, None, TEST_CFG), seed=0)
    det = jax_build_detector(dict(TINY), None, TEST_CFG)
    return model, det, bridge(model, 18, 2)


@pytest.mark.parametrize("depth", [18, 50])
def test_bridge_round_trip_is_identity(depth):
    cfg = dict(TINY, backbone=dict(TINY["backbone"], depth=depth))
    if depth == 50:
        cfg["neck"] = dict(TINY["neck"], in_channels=[256, 512, 1024, 2048])
    model = randomize(build_detector(cfg), seed=depth)
    sd = model.state_dict()
    back = state_dict_from_flax(bridge(model, depth, 2))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    model.load_state_dict(back)  # strict: same keys and shapes


def test_forward_parity_all_branches(tiny):
    model, det, params = tiny
    x = np.random.default_rng(0).normal(0, 1, (2, 64, 96, 3)).astype(np.float32)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    ref = det.apply({"params": params}, jnp.asarray(x))
    for branch_ours, branch_ref in zip(ours, ref):
        assert len(branch_ours) == len(branch_ref) == 5
        for o, r in zip(branch_ours, branch_ref):
            assert tuple(o.shape) == r.shape
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("style", ["pytorch", "caffe"])
def test_resnet50_bottleneck_parity(style):
    from ioudet.apis.checkpoint import convert_torch_resnet
    from ioudet.models.backbones.resnet import ResNet as JaxResNet
    from ioudet_torch.models.backbones.resnet import ResNet

    net = randomize(ResNet(depth=50, style=style, frozen_stages=1), seed=3)
    x = np.random.default_rng(1).normal(0, 1, (1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ours = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    params = convert_torch_resnet(net.state_dict(), depth=50)
    ref = JaxResNet(depth=50, style=style, frozen_stages=1).apply(
        {"params": params}, jnp.asarray(x))
    for o, r in zip(ours, ref):
        o = o.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(o, np.asarray(r), rtol=2e-3,
                                   atol=2e-3 * float(np.abs(r).max()))


@pytest.mark.parametrize("rescore_before_topk", [False, True])
def test_simple_test_matches_ioudet(tiny, rescore_before_topk, monkeypatch):
    model, det, params = tiny
    test_cfg = dict(TEST_CFG, rescore_before_topk=rescore_before_topk)
    monkeypatch.setattr(model, "test_cfg", test_cfg)
    det = det.clone(test_cfg=test_cfg)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32)
    img_shapes = np.array([[64, 96], [50, 70]], np.int32)
    factors = np.array([1.0, 0.75], np.float32)
    pads = np.array([[64, 96], [64, 96]], np.int32)
    with torch.no_grad():
        dets, labels = model.simple_test(
            torch.from_numpy(x), torch.from_numpy(img_shapes),
            torch.from_numpy(factors), torch.from_numpy(pads))
    fn = jax.jit(lambda p, *a: det.apply({"params": p}, *a, method=det.simple_test))
    jd, jl = fn(params, jnp.asarray(x), jnp.asarray(img_shapes),
                jnp.asarray(factors), jnp.asarray(pads))
    assert tuple(dets.shape) == (2, 12, 5)
    assert int((labels >= 0).sum()) >= 12  # not trivially empty
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_allclose(dets.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-3)


def test_config_file_builds_the_flagship():
    """configs/iou_aware_retinanet_r50_fpn_1x.py builds the same detector as
    __graft_entry__.FLAGSHIP (the model chip_smoke.py drives)."""
    from __graft_entry__ import FLAGSHIP
    from ioudet.utils.config import Config

    a = build_detector(Config.fromfile(
        "configs/iou_aware_retinanet_r50_fpn_1x.py").todict()["model"])
    b = build_detector(FLAGSHIP)
    sa, sb = a.state_dict(), b.state_dict()
    assert {k: v.shape for k, v in sa.items()} == {k: v.shape for k, v in sb.items()}
    for attr in ("anchor_scales", "anchor_ratios", "anchor_strides",
                 "num_classes", "target_means", "target_stds"):
        assert getattr(a.bbox_head, attr) == getattr(b.bbox_head, attr)
    assert a.bbox_head.num_anchors == 9 and a.bbox_head.cls_out_channels == 80


@pytest.mark.parametrize("change", [
    dict(backbone=dict(type="ResNet", depth=50, stem_space_to_depth=True)),
    dict(backbone=dict(type="ResNet", depth=50, gen_attention=dict(
        type="GeneralizedAttention", attention_type="0010"),
        stage_with_gen_attention=((), (), (0, 1), ()))),
    # GN and weight standardization are ported (tests/test_torch_gn_ws.py);
    # train-mode BN is not
    dict(backbone=dict(type="ResNet", depth=50, norm_cfg=dict(type="SyncBN"))),
    dict(backbone=dict(type="ResNet", depth=50, norm_cfg=dict(type="BN"))),
    dict(dtype="float16"),   # bfloat16 is ported (tests/test_torch_dtype.py)
])
def test_unported_options_raise(change):
    with pytest.raises(NotImplementedError):
        build_detector(dict(TINY, **change))


def test_retina_head_anchor_scales_follow_ioudet():
    """ioudet's RetinaHead fixes its anchor scales at octave_scales() and
    ignores octave_base_scale / scales_per_octave (mmdet derives the scales
    from them); the port follows ioudet: the same anchors and detections at
    octave_base_scale=8, scales_per_octave=2."""
    cfg = dict(TINY, bbox_head=dict(TINY["bbox_head"], octave_base_scale=8,
                                    scales_per_octave=2))
    model = randomize(build_detector(cfg, None, TEST_CFG), seed=4)
    det = jax_build_detector(dict(cfg), None, TEST_CFG)
    params = bridge(model, 18, 2)   # the same nine anchors a location, or this fails
    head_scales = det.apply({"params": params}, method=lambda m: m.bbox_head.anchor_scales)
    assert model.bbox_head.anchor_scales == tuple(head_scales) == (4, 4 * 2 ** (1 / 3),
                                                                   4 * 2 ** (2 / 3))
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    pads = np.array([[64, 96], [50, 70]], np.int32)
    anchors, valid = model.bbox_head.get_anchors(sizes, torch.from_numpy(pads))
    ref_anchors, ref_valid = det.apply(
        {"params": params}, method=lambda m: m.bbox_head.get_anchors(sizes, jnp.asarray(pads)))
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(ref_anchors))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    x = np.random.default_rng(6).normal(0, 1, (2, 64, 96, 3)).astype(np.float32)
    shapes, factors = np.array([[64, 96], [50, 70]], np.int32), np.array([1.0, 0.75], np.float32)
    with torch.no_grad():
        dets, labels = model.simple_test(torch.from_numpy(x), torch.from_numpy(shapes),
                                         torch.from_numpy(factors), torch.from_numpy(pads))
    jd, jl = jax.jit(lambda p, *a: det.apply({"params": p}, *a, method=det.simple_test))(
        params, jnp.asarray(x), jnp.asarray(shapes), jnp.asarray(factors), jnp.asarray(pads))
    assert int((labels >= 0).sum()) >= 12
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_allclose(dets.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-3)
