"""Port parity of the guided-anchoring detectors on the CPU: a tiny
GA-RetinaNet (R-18, FPN and one tower conv 32 wide, 4 classes, 96x128
canvases) and the tiny GA-Faster R-CNN of tests/test_ga_faster.py (R-18,
FPN 64 wide, GA-RPN, the shared-fc box head; 64x96 canvases), each built
from ``ioudet``'s parameter tree filled with seeded values and bridged by
``state_dict_from_flax``, at batch 2.  One jitted ``ioudet`` program a
detector serves every case: ``simple_test``, the RPN's proposals (the
GA-RPN detector of the same weights), and ``forward_train``'s losses with
every parameter's gradient.  ``conv_shape`` is drawn at std 0.1 and
``conv_loc`` at std 1 around the 0.01 prior, so that no cell's loc score
is near ``loc_filter_thr`` (tests/test_torch_guided_anchor.py holds the
init's knife-edge).  The R-CNN's sampler takes every candidate (the
proposals and the gts, no cap on positives), so that the port's draws and
``ioudet``'s select the same rois and the sums differ only in order.

Tolerances: losses rtol 1e-5; gradients 1e-4 of each tensor's largest
|value|, except GA-Faster R-CNN's outside its GA-RPN head (backbone, FPN,
box head), held at 1e-3 as tests/test_torch_two_stage_train.py holds
Faster R-CNN's: they go through RoIAlign at rois that carry the RPN
decode's f32 drift (one FrozenBN scale's element sits at 1.2e-4); and
GA-RPN's own, which are ill-conditioned at these weights: the FPN
features of one intra-op thread and of four differ by 3e-7 of their
largest value, and that moves the port's own ``conv_offset`` and
``conv_adaption`` gradients by 2e-3 of theirs (the backward on the same
features moves them by 2e-7).  So an f64 run of the RPN head on the
port's f32 features holds every GA-RPN gradient: the port's f32 one
within 1e-4 of its largest value, ``ioudet``'s within 5e-3 (2.0e-3 at
most); labels
and the proposals' order exact; scores rtol 1e-5; boxes rtol 1e-5 / atol
1e-4 (a forward output: the backbone's f32 drift, about 1e-5 of each
output's largest value, reaches them), 1e-3 after the R-CNN.  Everything
is f32."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.models import build_detector as jax_build_detector
from ioudet_torch.apis.checkpoint import module_types, state_dict_from_flax
from ioudet_torch.apis.inference import inference_detector, init_detector, predict
from ioudet_torch.models import build_detector
from ioudet_torch.ops import quant
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

RETINA = dict(
    type="RetinaNet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1, norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32, start_level=1,
              add_extra_convs=True, num_outs=5),
    bbox_head=dict(type="GARetinaHead", num_classes=4, in_channels=32, feat_channels=32,
                   stacked_convs=1, octave_base_scale=8, anchor_ratios=(0.5, 1.0, 2.0),
                   anchor_strides=(8, 16, 32, 64, 128)))
RETINA_TRAIN = dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5, neg_iou_thr=0.4,
                                  min_pos_iou=0), allowed_border=-1)
RETINA_TEST = dict(nms_pre=50, score_thr=0.05, nms=dict(iou_thr=0.5), max_per_img=20)
NUM_PROPS = 32
FASTER = dict(
    type="FasterRCNN",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1, norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=64, num_outs=5),
    rpn_head=dict(type="GARPNHead", num_classes=2, in_channels=64, feat_channels=64,
                  octave_base_scale=8, scales_per_octave=3, anchor_ratios=(0.5, 1.0, 2.0),
                  anchor_strides=(4, 8, 16, 32, 64), anchoring_stds=(0.07, 0.07, 0.14, 0.14),
                  target_stds=(0.07, 0.07, 0.11, 0.11),
                  loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=True, loss_weight=1.0),
                  loss_bbox=dict(type="SmoothL1Loss", beta=1.0, loss_weight=1.0)),
    bbox_roi_extractor=dict(type="SingleRoIExtractor", out_channels=64,
                            featmap_strides=(4, 8, 16, 32),
                            roi_layer=dict(out_size=7, sample_num=2)),
    bbox_head=dict(type="SharedFCBBoxHead", num_classes=5, in_channels=64, fc_out_channels=64,
                   target_stds=(0.1, 0.1, 0.2, 0.2)))
G = 3
FASTER_TRAIN = dict(
    rpn=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.7, neg_iou_thr=0.3,
                           min_pos_iou=0.3),
             ga_assigner=dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3),
             allowed_border=-1),
    rpn_proposal=dict(nms_pre=100, max_num=NUM_PROPS, nms_thr=0.7),
    rcnn=dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5),
              sampler=dict(type="RandomSampler", num=NUM_PROPS + G, pos_fraction=1.0,
                           add_gt_as_proposals=True)))
FASTER_TEST = dict(rpn=dict(nms_pre=100, max_num=NUM_PROPS, nms_thr=0.7),
                   rcnn=dict(score_thr=0.05, nms=dict(iou_thr=0.5), max_per_img=8))
RPN_TEST = dict(nms_pre=100, max_num=NUM_PROPS, nms_thr=0.7)
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")   # frozen_stages=1
CANVAS = {"retina": (96, 128), "faster": (64, 96)}
SHAPES = {"retina": np.array([[96, 128], [80, 112]], np.int32),
          "faster": np.array([[64, 96], [56, 80]], np.int32)}
FACTORS = np.array([1.0, 0.625], np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def assert_close_scaled(got, want, tol, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale, err_msg=what)


def images(which: str) -> np.ndarray:
    return np.random.default_rng(0).normal(0, 1, (2,) + CANVAS[which] + (3,)).astype(np.float32)


def gts(which: str) -> tuple:
    rng = np.random.default_rng(1)
    h, w = CANVAS[which]
    xy = rng.uniform(0, min(h, w) * 0.5, (2, G, 2)).astype(np.float32)
    wh = rng.uniform(16, min(h, w) * 0.5, (2, G, 2)).astype(np.float32)
    labels = rng.integers(1, 4, (2, G)).astype(np.int32)
    valid = np.ones((2, G), bool)
    valid[1, -1] = False
    return np.concatenate([xy, xy + wh], -1), labels, valid


def ga_params(params: dict, head: str) -> dict:
    """``conv_shape`` at std 0.1, ``conv_loc`` at std 1 around the prior
    (no loc score near the threshold)."""
    rng = np.random.default_rng(5)
    tree = params[head]
    tree["conv_shape"]["kernel"] = rng.normal(
        0, 0.1, tree["conv_shape"]["kernel"].shape).astype(np.float32)
    tree["conv_loc"]["kernel"] = rng.normal(
        0, 1.0, tree["conv_loc"]["kernel"].shape).astype(np.float32)
    tree["conv_loc"]["bias"] = np.full((1,), np.log(0.01 / 0.99), np.float32)
    return params


def grads_and_losses(det, params, which: str):
    img, (gb, gl, gv), shapes = images(which), gts(which), SHAPES[which]

    def total(p):
        out = det.apply({"params": p}, img, gb, gl, gv, shapes, shapes,
                        method=det.forward_train, rngs={"sampler": jax.random.PRNGKey(2)})
        return sum(out.values()), out

    (_, losses), grads = jax.value_and_grad(total, has_aux=True)(params)
    return losses, grads


@pytest.fixture(scope="module")
def retina():
    det = jax_build_detector(RETINA, RETINA_TRAIN, RETINA_TEST)
    params = ga_params(random_params(param_shapes(
        det, jnp.zeros((1,) + CANVAS["retina"] + (3,))), 0), "bbox_head")
    model = build_detector(RETINA, RETINA_TRAIN, RETINA_TEST)
    model.load_state_dict(state_dict_from_flax(params, module_types(model)), strict=True)

    def run(p):
        img, shapes = images("retina"), SHAPES["retina"]
        dets = det.apply({"params": p}, img, shapes, FACTORS, shapes, method=det.simple_test)
        return dets, grads_and_losses(det, p, "retina")

    return jax.device_get(jax.jit(run)(params)), model


@pytest.fixture(scope="module")
def faster():
    det = jax_build_detector(FASTER, FASTER_TRAIN, FASTER_TEST)
    shapes = SHAPES["faster"]
    params = ga_params(random_params(param_shapes(
        det, jnp.zeros((1,) + CANVAS["faster"] + (3,)), shapes[:1], FACTORS[:1], shapes[:1],
        method=det.simple_test), 0), "rpn_head")
    model = build_detector(FASTER, FASTER_TRAIN, FASTER_TEST)
    model.load_state_dict(state_dict_from_flax(params, module_types(model)), strict=True)
    rpn_cfg = dict(type="RPN", backbone=FASTER["backbone"], neck=FASTER["neck"],
                   rpn_head=FASTER["rpn_head"])
    rpn = build_detector(rpn_cfg, FASTER_TRAIN["rpn"], RPN_TEST)
    rpn.load_state_dict(state_dict_from_flax(
        {k: params[k] for k in ("backbone", "neck", "rpn_head")}, module_types(rpn)), strict=True)
    jrpn = jax_build_detector(rpn_cfg, FASTER_TRAIN["rpn"], RPN_TEST)

    def run(p):
        img = images("faster")
        dets = det.apply({"params": p}, img, shapes, FACTORS, shapes, method=det.simple_test)
        sub = {k: p[k] for k in ("backbone", "neck", "rpn_head")}
        props = jrpn.apply({"params": sub}, img, shapes, FACTORS, shapes,
                           method=jrpn.simple_test)
        return dets, props, grads_and_losses(det, p, "faster")

    return jax.device_get(jax.jit(run)(params)), model, rpn


def check_losses_and_grads(model, ref_losses, grads, which: str, names,
                           rcnn_tol: float = 1e-4, by_f64: str = "-") -> None:
    model.train().zero_grad()
    gb, gl, gv = (t(a) for a in gts(which))
    out = model.forward_train(t(images(which)), gb, gl, gv, t(SHAPES[which]), t(SHAPES[which]))
    assert sorted(out) == sorted(ref_losses) == sorted(names)
    for k in out:
        assert float(ref_losses[k]) > 0, k
        np.testing.assert_allclose(float(out[k].detach()), float(ref_losses[k]), rtol=1e-5,
                                   err_msg=k)
    sum(out.values()).backward()
    ref_grads = state_dict_from_flax(grads, module_types(model))
    for k, p in model.named_parameters():
        if k.startswith(FROZEN):
            assert p.grad is None, k
            continue
        assert float(ref_grads[k].abs().max()) > 0, k
        if k.startswith(by_f64):
            continue
        tol = 1e-4 if k.startswith(("rpn_head.", "bbox_head.conv", "bbox_head.feature",
                                    "bbox_head.cls_convs", "bbox_head.reg_convs")) else rcnn_tol
        assert_close_scaled(p.grad.numpy(), ref_grads[k].numpy(), tol, k)
    model.eval()


def test_ga_retinanet_simple_test_matches_ioudet(retina):
    ((ref_dets, ref_labels), _), model = retina
    shapes = t(SHAPES["retina"])
    with torch.no_grad():
        dets, labels = model.eval().simple_test(t(images("retina")), shapes, t(FACTORS), shapes)
    assert dets.shape == (2, 20, 5) and (ref_labels >= 0).sum() > 10
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_allclose(dets.numpy()[..., 4], ref_dets[..., 4], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dets.numpy()[..., :4], ref_dets[..., :4], rtol=1e-5, atol=1e-4)


def test_ga_retinanet_losses_and_gradients_match_ioudet(retina):
    (_, (losses, grads)), model = retina
    check_losses_and_grads(model, losses, grads, "retina",
                           ["loss_bbox", "loss_cls", "loss_loc", "loss_shape"])


def test_ga_retinanet_entry_points(retina):
    """``init_detector`` / ``predict`` / ``inference_detector`` on the CPU:
    the handle's model on the twin's weights gives ``simple_test``'s
    detections; an image of another size goes through the config's
    pipeline to 3 per-class lists."""
    ((ref_dets, ref_labels), _), model = retina
    handle = init_detector(dict(model=RETINA, test_cfg=RETINA_TEST), device="cpu")
    handle.model.load_state_dict(model.state_dict())
    shapes = t(SHAPES["retina"])
    dets, labels = predict(handle, t(images("retina")), shapes, t(FACTORS), shapes)
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    img = np.random.default_rng(3).integers(0, 256, (90, 120, 3), dtype=np.uint8)
    result = inference_detector(handle, img)
    assert len(result) == 3 and all(r.ndim == 2 and r.shape[1] == 5 for r in result)


def test_ga_faster_simple_test_matches_ioudet(faster):
    ((ref_dets, ref_labels), _, _), model, _ = faster
    shapes = t(SHAPES["faster"])
    with torch.no_grad():
        dets, labels = model.eval().simple_test(t(images("faster")), shapes, t(FACTORS), shapes)
    assert dets.shape == (2, 8, 5) and (ref_labels >= 0).sum() > 4
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_allclose(dets.numpy()[..., 4], ref_dets[..., 4], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dets.numpy()[..., :4], ref_dets[..., :4], rtol=0, atol=1e-3)


def test_ga_rpn_proposals_match_ioudet(faster):
    """GA-RPN as a detector of its own: its (B, max_num, 5) proposals, in
    ``ioudet``'s order."""
    (_, (ref_props, ref_labels), _), _, rpn = faster
    shapes = t(SHAPES["faster"])
    with torch.no_grad():
        props, labels = rpn.eval().simple_test(t(images("faster")), shapes, t(FACTORS), shapes)
    assert props.shape == (2, NUM_PROPS, 5) and (ref_labels >= 0).sum() > NUM_PROPS
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_allclose(props.numpy()[..., 4], ref_props[..., 4], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(props.numpy()[..., :4], ref_props[..., :4], rtol=1e-5,
                               atol=1e-4)


def test_ga_faster_losses_and_gradients_match_ioudet(faster):
    (_, _, (losses, grads)), model, _ = faster
    check_losses_and_grads(model, losses, grads, "faster",
                           ["loss_bbox", "loss_cls", "rpn_loss_bbox", "rpn_loss_cls",
                            "rpn_loss_loc", "rpn_loss_shape"], rcnn_tol=1e-3,
                           by_f64="rpn_head.")


def test_ga_rpn_gradients_against_f64(faster):
    """GA-RPN's gradients (the RPN losses alone reach its head) against an
    f64 run of the port's RPN head on the port's f32 features: the port's
    f32 gradients within 1e-4 of each tensor's largest value, ``ioudet``'s
    within 5e-3."""
    (_, _, (_, grads)), model, _ = faster
    ref = state_dict_from_flax(grads, module_types(model))
    gb, gl, gv = (t(a) for a in gts("faster"))
    shapes, cfg = t(SHAPES["faster"]), FASTER_TRAIN["rpn"]
    with torch.no_grad():
        feats = model.extract_feat(t(images("faster")))
    got = {}
    for dtype in (torch.float32, torch.float64):
        head = copy.deepcopy(model.rpn_head).to(dtype).train()
        losses = head.loss(*head([f.to(dtype) for f in feats]), gb.to(dtype),
                           torch.ones_like(gl), gv, shapes, shapes, cfg)
        sum(losses.values()).backward()
        got[dtype] = {k: p.grad.double() for k, p in head.named_parameters()}
    worst = {}
    for k, exact in got[torch.float64].items():
        scale = float(exact.abs().max())
        assert scale > 0, k
        mine = float((got[torch.float32][k] - exact).abs().max()) / scale
        theirs = float((ref[f"rpn_head.{k}"].double() - exact).abs().max()) / scale
        assert mine <= 1e-4 and theirs <= 5e-3, (k, mine, theirs)
        worst[k] = theirs
    assert len(worst) == 12


@pytest.mark.parametrize("which", ["retina", "faster"])
def test_bf16_and_int8_raise_named_errors(retina, faster, which):
    cfg, head, train, test = ((RETINA, "GARetinaHead", RETINA_TRAIN, RETINA_TEST)
                              if which == "retina" else
                              (FASTER, "GARPNHead", FASTER_TRAIN, FASTER_TEST))
    with pytest.raises(NotImplementedError, match=f"{head} in torch.bfloat16"):
        build_detector(dict(cfg, dtype="bfloat16"), train, test)
    model = retina[1] if which == "retina" else faster[1]
    with pytest.raises(NotImplementedError, match=f"int8 serving of {head}"):
        quant.calibrate(model, lambda b: None, [])
    with pytest.raises(NotImplementedError, match=f"int8 serving of {head}"):
        with quant.quantize_calls(model):
            pass


@pytest.mark.parametrize("which", ["retina", "faster"])
def test_mmdet_pth_of_a_ga_head_raises(retina, faster, tmp_path, which):
    """An mmdet checkpoint of the head: GARetinaHead's two adaptions, and
    mmdet's 4 deformable groups (a 72-channel conv_offset), raise a named
    error; the port's own .pth loads."""
    from ioudet_torch.apis.checkpoint import load_checkpoint

    model = retina[1] if which == "retina" else faster[1]
    part = "bbox_head" if which == "retina" else "rpn_head"
    own = tmp_path / "own.pth"
    torch.save(model.state_dict(), own)
    load_checkpoint(model, str(own))
    sd = dict(model.state_dict())
    sd[f"{part}.feature_adaption.conv_offset.weight"] = torch.zeros(72, 2, 1, 1)
    if which == "retina":
        for k in [k for k in sd if k.startswith(f"{part}.feature_adaption.")]:
            sd[k.replace("feature_adaption", "feature_adaption_cls")] = sd[k]
            sd[k.replace("feature_adaption", "feature_adaption_reg")] = sd.pop(k)
    mmdet = tmp_path / "mmdet.pth"
    torch.save(dict(state_dict=sd), mmdet)
    with pytest.raises(NotImplementedError, match="mmdet's GA.*two feature adaptions"):
        load_checkpoint(model, str(mmdet))
