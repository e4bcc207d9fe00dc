"""Port parity of FoveaBox on the CPU: the tiny models of tests/test_fovea.py
(R-18, FPN and towers 32 wide, 4 classes): the plain head with two tower
convs and no norm, and the align variant (``with_deform=True``, GN:
``FeatureAdaption``'s deformable conv from the detached exp(reg) field,
the widened cls tower), each built from ``ioudet``'s parameter tree filled
with seeded values and bridged by ``state_dict_from_flax``, on the same
seeded inputs at batch 2 on 96x128 canvases.  One jitted ``ioudet``
program a twin serves every case: the head's outputs, ``decode_candidates``
(on the outputs and on planted outputs whose scores tie across the top-k
cut), ``simple_test``, every level's fovea targets of a gt set with
equal-area gts and padded slots, and ``forward_train``'s losses with every
parameter's gradient.  A gt whose fovea edges land on whole numbers in f32
is held against ``ioudet``'s eager targets.

Tolerances: head outputs within 1e-4 of each output's largest |value|;
labels exact; the log-space targets within one f32 rounding of the log
(atol 2.5e-7); candidates rtol 1e-5; ``simple_test`` labels exact, dets
rtol 1e-4; losses rtol 1e-4 and each gradient within 1e-3 of its tensor's
largest |value|.  The focal term (gamma 1.5, alpha 0.4) is the sum of five
per-level sums in the port (K3's plain version at A = 1) and one flat sum
in ``ioudet``: they differ only in summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.models import build_detector as jax_build_detector
from ioudet_torch.apis.checkpoint import module_types, state_dict_from_flax
from ioudet_torch.models import build_detector
from ioudet_torch.ops import quant
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

HEAD = dict(type="FoveaHead", num_classes=4, in_channels=32, feat_channels=32,
            stacked_convs=2, strides=(8, 16, 32, 64, 128),
            base_edge_list=(16, 32, 64, 128, 256),
            scale_ranges=((1, 64), (32, 128), (64, 256), (128, 512), (256, 2048)),
            loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=1.5, alpha=0.4,
                          loss_weight=1.0),
            loss_bbox=dict(type="SmoothL1Loss", beta=0.11, loss_weight=0.75))
MODEL = dict(
    type="FOVEA",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1, norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32, start_level=1,
              add_extra_convs=True, num_outs=5),
    bbox_head=HEAD)
VARIANTS = {"plain": dict(with_deform=False, norm=None),
            "align": dict(with_deform=True, norm="GN")}
TEST_CFG = dict(nms_pre=50, score_thr=0.05, nms=dict(iou_thr=0.5), max_per_img=20)
CANVAS = (96, 128)
SIZES = [(12, 16), (6, 8), (3, 4), (2, 2), (1, 1)]
SHAPES = np.array([[96, 128], [80, 112]], np.int32)
FACTORS = np.array([1.0, 0.625], np.float32)
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")   # frozen_stages=1
G = 8


def model_cfg(variant: str) -> dict:
    return dict(MODEL, bbox_head=dict(HEAD, **VARIANTS[variant]))


def images(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 1, (2,) + CANVAS + (3,)).astype(np.float32)


def gts() -> tuple:
    """Two images' gts, G slots: edges of 16-90 px (scale ranges of levels
    0-2, 32-64 px in two), two equal-area gts overlapping (the first index
    wins a shared cell), padded slots over valid boxes."""
    b = np.zeros((2, G, 4), np.float32)
    b[0, :6] = [[4, 6, 40, 38], [10, 12, 46, 44], [50, 20, 110, 90], [8, 8, 100, 90],
                [60, 40, 90, 70], [56, 44, 86, 74]]
    b[1, :5] = [[20, 20, 52, 52], [8, 30, 100, 78], [30, 10, 70, 50], [70, 5, 106, 41],
                [12, 12, 28, 28]]
    b[1, 5:7] = [[20, 20, 52, 52], [8, 30, 100, 78]]    # padding over valid boxes
    valid = np.zeros((2, G), bool)
    valid[0, :6] = True
    valid[1, :5] = True
    labels = np.array([[1, 2, 3, 4, 2, 3, 0, 0], [4, 1, 2, 3, 1, 2, 3, 0]], np.int32)
    return b, labels, valid


def planted_outputs(seed: int = 4) -> tuple:
    """Head outputs of three logit values: level 0's top-50 cut (192
    cells) runs through a tie."""
    rng = np.random.default_rng(seed)
    cls = [rng.choice([-1.0, 0.5, 2.0], (2, h, w, 3)).astype(np.float32) for h, w in SIZES]
    reg = [rng.uniform(-1, 1, (2, h, w, 4)).astype(np.float32) for h, w in SIZES]
    return cls, reg


def t(a):
    return torch.from_numpy(np.array(a))


def assert_close_scaled(got, want, tol, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * scale, err_msg=what)


@pytest.fixture(scope="module", params=list(VARIANTS))
def twin(request):
    """(variant, ioudet's outputs, the port's model on the bridged weights,
    ioudet's parameters), ioudet's side in one compiled program."""
    cfg = model_cfg(request.param)
    det = jax_build_detector(cfg, dict(), TEST_CFG)
    params = random_params(param_shapes(det, jnp.zeros((1,) + CANVAS + (3,))), 0)
    model = build_detector(cfg, dict(), TEST_CFG)
    model.load_state_dict(state_dict_from_flax(params, module_types(model)), strict=True)
    test_cfg = dict(TEST_CFG)

    def forward_side(m, img, shapes, factors, gb, gl, gv, pc, pr):
        head = m.bbox_head
        cls, reg = m(img)
        targets = [jax.vmap(lambda b, v, lab: head._targets_level(fs, s, bl, sr, b, v, lab))(
            gb, gv, gl) for fs, s, bl, sr in zip(SIZES, head.strides, head.base_edge_list,
                                                 head.scale_ranges)]
        return ((cls, reg), head.decode_candidates(cls, reg, shapes, test_cfg),
                head.get_bboxes(cls, reg, shapes, factors, shapes, test_cfg, rescale=True),
                head.decode_candidates(pc, pr, shapes, test_cfg), targets)

    def losses(p, *a):
        out = det.apply({"params": p}, *a, method=det.forward_train)
        return sum(out.values()), out

    def run(p, img, shapes, factors, gb, gl, gv, pc, pr):
        fwd = det.apply({"params": p}, img, shapes, factors, gb, gl, gv, pc, pr,
                        method=forward_side)
        (_, out), grads = jax.value_and_grad(losses, has_aux=True)(
            p, img, gb, gl, gv, shapes, shapes)
        return fwd, out, grads

    pc, pr = planted_outputs()
    args = [images(), SHAPES, FACTORS, *gts()]
    out = jax.device_get(jax.jit(run)(params, *(jnp.asarray(a) for a in args),
                                      [jnp.asarray(c) for c in pc],
                                      [jnp.asarray(r) for r in pr]))
    return request.param, out, model, params


def test_head_outputs_match_ioudet(twin):
    variant, ((outs, *_), _, _), model, _ = twin
    with torch.no_grad():
        ours = model.eval()(t(images()))
    for i, (o_lvls, r_lvls) in enumerate(zip(ours, outs)):
        for lvl, (o, r) in enumerate(zip(o_lvls, r_lvls)):
            assert tuple(o.shape) == r.shape
            assert_close_scaled(o.numpy(), r, 1e-4, f"{variant} output {i} level {lvl}")
    assert ours[0][0].shape[-1] == 3 and ours[1][0].shape[-1] == 4


def test_targets_match_ioudet(twin):
    """Every level's labels exactly, the log-space targets within one
    rounding of the log; the smallest gt wins, the first of two equal
    areas, padded slots change nothing."""
    _, ((*_, targets), _, _), model, _ = twin
    head = model.bbox_head
    gb, gl, gv = (t(a) for a in gts())
    positives = []
    for lvl, ((fs, s, bl, sr), (ref_lab, ref_t)) in enumerate(zip(
            zip(SIZES, head.strides, head.base_edge_list, head.scale_ranges), targets)):
        lab, tgt = head.targets_level(fs, s, bl, sr, gb, gv, gl)
        assert lab.dtype == torch.int32
        np.testing.assert_array_equal(lab.numpy(), ref_lab, err_msg=f"level {lvl}")
        np.testing.assert_allclose(tgt.numpy(), ref_t, rtol=0, atol=2.5e-7,
                                   err_msg=f"level {lvl}")
        positives.append(int((lab > 0).sum()))
        unpadded = head.targets_level(fs, s, bl, sr, gb[1:, :5], gv[1:, :5], gl[1:, :5])
        np.testing.assert_array_equal(unpadded[0].numpy(), lab[1:].numpy())
    assert all(positives[:3]), positives
    # the two equal-area gts 4 and 5 of image 0 share P3 cells: gt 4 (label 2) wins
    lab0, _ = head.targets_level(SIZES[0], 8, 16, (1, 64), gb, gv, gl)
    only5 = head.targets_level(SIZES[0], 8, 16, (1, 64), gb[:, 5:6], gv[:, 5:6], gl[:, 5:6])[0]
    only4 = head.targets_level(SIZES[0], 8, 16, (1, 64), gb[:, 4:5], gv[:, 4:5], gl[:, 4:5])[0]
    shared = (only4[0] > 0) & (only5[0] > 0)
    assert shared.any() and (lab0[0][shared] == 2).all()


def test_targets_on_a_region_edge():
    """A gt whose fovea edges land on whole numbers in f32: x1 = 24, x2 = 64
    at stride 8 (g 3 to 8, half 2.5) gives ceil(3 + 0.6 * 2.5 - 0.5) =
    ceil(4.0) = 4 and floor(3 + 1.4 * 2.5 - 0.5) = floor(6.0) = 6, where
    exact arithmetic on f32(0.6) and f32(1.4) gives 4.00000006 and
    5.99999994: cells 4-6 are in, as in ioudet (its sum one FMA)."""
    from ioudet.models.heads.fovea_head import FoveaHead as JaxHead
    from ioudet_torch.models.heads.fovea_head import FoveaHead

    args = (np.array([[[24, 24, 64, 64]]], np.float32), np.ones((1, 1), bool),
            np.array([[3]], np.int32))
    head = FoveaHead(num_classes=4, in_channels=8, feat_channels=8, stacked_convs=0)
    lab, _ = head.targets_level((10, 10), 8, 16, (1, 64), *(t(a) for a in args))
    ref = JaxHead(num_classes=4)._targets_level((10, 10), 8, 16, (1, 64),
                                               *(jnp.asarray(a[0]) for a in args))[0]
    np.testing.assert_array_equal(lab[0].numpy(), np.asarray(ref))
    grid = lab[0].numpy().reshape(10, 10) > 0
    assert list(np.nonzero(grid.any(0))[0]) == [4, 5, 6]
    assert list(np.nonzero(grid.any(1))[0]) == [4, 5, 6]


def test_decode_with_tied_scores_keeps_ioudets_order(twin):
    _, ((_, _, _, (boxes, scores), _), _, _), model, _ = twin
    pc, pr = planted_outputs()
    with torch.no_grad():
        b, s = model.bbox_head.decode_candidates([t(c) for c in pc], [t(r) for r in pr],
                                                 t(SHAPES), TEST_CFG)
    top = torch.sigmoid(t(pc[0])).amax(-1).reshape(2, -1)
    cut = top.sort(dim=1, descending=True).values[:, 49]
    assert ((top == cut[:, None]).sum(1) > 5).all()
    np.testing.assert_array_equal(s.numpy(), scores)
    np.testing.assert_allclose(b.numpy(), boxes, rtol=1e-6, atol=1e-5)


def test_decode_and_simple_test_match_ioudet(twin):
    _, ((outs, (boxes, scores), (ref_dets, ref_labels), *_), _, _), model, _ = twin
    with torch.no_grad():
        b, s = model.bbox_head.decode_candidates([t(o) for o in outs[0]],
                                                 [t(o) for o in outs[1]], t(SHAPES), TEST_CFG)
        dets, labels = model.eval().simple_test(t(images()), t(SHAPES), t(FACTORS), t(SHAPES))
    assert s.shape == (2, 50 + 48 + 12 + 4 + 1, 3)
    np.testing.assert_allclose(s.numpy(), scores, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b.numpy(), boxes, rtol=1e-5, atol=1e-4)
    assert (ref_labels >= 0).sum() > 10
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_allclose(dets.numpy(), ref_dets, rtol=1e-4, atol=1e-4)


def test_losses_and_gradients_match_ioudet(twin):
    variant, (_, ref_out, grads), model, _ = twin
    model.train().zero_grad()
    gb, gl, gv = (t(a) for a in gts())
    out = model.forward_train(t(images()), gb, gl, gv, t(SHAPES), t(SHAPES))
    assert sorted(out) == sorted(ref_out) == ["loss_bbox", "loss_cls"]
    for k in out:
        assert float(ref_out[k]) > 0
        np.testing.assert_allclose(float(out[k].detach()), float(ref_out[k]), rtol=1e-4,
                                   err_msg=f"{variant} {k}")
    sum(out.values()).backward()
    ref_grads = state_dict_from_flax(grads, module_types(model))
    zero = []
    for k, p in model.named_parameters():
        if k.startswith(FROZEN):
            assert p.grad is None, k
        elif not ref_grads[k].any():
            assert not p.grad.any(), k
            zero.append(k)
        else:
            assert_close_scaled(p.grad.numpy(), ref_grads[k].numpy(), 1e-3, f"{variant} {k}")
    assert zero == []
    if variant == "align":
        # the offsets learn through the deformable sampling; the reg tower
        # gets nothing from the cls branch (the shape field is detached)
        assert model.bbox_head.feature_adaption.conv_offset.weight.grad.abs().max() > 0


def test_the_bridge_takes_fovea_only_when_named(twin):
    variant, _, model, params = twin
    assert module_types(model)["bbox_head"] == "FoveaHead"
    with pytest.raises(KeyError, match="unknown head param"):
        state_dict_from_flax(params)
    names = set(state_dict_from_flax(params, module_types(model)))
    if variant == "align":
        assert {"bbox_head.feature_adaption.conv_offset.weight",
                "bbox_head.feature_adaption.conv_adaption.weight",
                "bbox_head.cls_convs.1.gn.weight", "bbox_head.cls_convs.0.conv.weight"} <= names
        assert "bbox_head.cls_convs.0.conv.bias" not in names
    else:
        assert {"bbox_head.reg_convs.1.conv.bias", "bbox_head.fovea_cls.bias"} <= names


def test_bf16_and_int8_raise_named_errors(twin):
    variant, _, model, _ = twin
    with pytest.raises(NotImplementedError, match="FoveaHead in torch.bfloat16"):
        build_detector(dict(model_cfg(variant), dtype="bfloat16"), dict(), TEST_CFG)
    with pytest.raises(NotImplementedError, match="int8 serving of FoveaHead"):
        quant.calibrate(model, lambda b: None, [])
