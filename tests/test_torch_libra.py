"""Port parity of Libra R-CNN's parts on the CPU: ``NonLocal2D``,
``F.adaptive_max_pool2d`` (against ``ioudet``'s ``adaptive_max_pool``) and
``resize_nearest`` at the canvas's uneven sizes, ``BFP`` with each
``refine_type``, the FPN -> BFP ``NeckSequence``,
``BalancedL1Loss``, a tiny Libra RetinaNet and a tiny Libra Faster R-CNN
(R-18, FPN and heads 32 / 64 wide, FPN -> non-local BFP, Balanced L1; the
R-CNN's ``IoUBalancedNegSampler`` and the RPN's sampler take every
candidate, so that both packages select alike), and the bridge of the
chained neck under flax's names (``necks_<i>``) and mmdet's (``neck.<i>``).
The twins are ``ioudet``'s parameter trees filled by
``tests/torch_twins.random_params`` (``conv_out`` of the non-local block is
drawn too, so that its attention takes part) and bridged by
``state_dict_from_flax``.

Tolerances.  The adaptive max pool and ``resize_nearest``: values bit for
bit, the pooled gradient (continuous inputs, so no ties) to 1e-6.  Modules:
outputs and gradients within 1e-5 of each tensor's largest |value| (sums
in another order).  Balanced L1: values rtol 1e-6, gradients rtol 1e-5.
Detectors: ``simple_test`` labels exact, dets rtol 1e-4 / atol 1e-3 (the
port's usual: a decode of outputs that differ by f32 roundoff); losses rtol
1e-4; each gradient within 1e-3 of its tensor's largest |value|."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ioudet.models import build_detector as jax_build_detector
from ioudet.models.losses.balanced_l1_loss import BalancedL1Loss as JaxBalancedL1Loss
from ioudet.models.losses.balanced_l1_loss import balanced_l1_loss as jax_balanced_l1_loss
from ioudet.models.necks.bfp import BFP as JaxBFP
from ioudet.models.necks.fpn import FPN as JaxFPN
from ioudet.models.necks.neck_sequence import NeckSequence as JaxNeckSequence
from ioudet.models.plugins import NonLocal2D as JaxNonLocal2D
from ioudet.models.utils import layers as jlayers
from ioudet_torch.apis.checkpoint import load_checkpoint, module_types, state_dict_from_flax
from ioudet_torch.models import build_detector
from ioudet_torch.models.losses.balanced_l1_loss import BalancedL1Loss, balanced_l1_loss
from ioudet_torch.models.necks import BFP, FPN, NeckSequence
from ioudet_torch.models.plugins import NonLocal2D
from ioudet_torch.models.utils.layers import resize_nearest
from tests._torch_mp_worker import faster_rcnn_cfgs
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

# RetinaNet's P3-P7 of a 208x336 canvas: P5 is the refine level, the finer
# levels pool to it unevenly, the coarser ones resize unevenly
LEVELS = ((26, 42), (13, 21), (7, 11), (4, 6), (2, 3))
CH = 16
FPN_R = dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32, start_level=1,
             add_extra_convs=True, num_outs=5)
BFP_R = dict(type="BFP", in_channels=32, num_levels=5, refine_level=2, refine_type="non_local")
RETINA = dict(
    type="RetinaNet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1, norm_cfg=dict(type="FrozenBN")),
    neck=[FPN_R, BFP_R],
    bbox_head=dict(type="RetinaHead", num_classes=5, in_channels=32, feat_channels=32,
                   stacked_convs=1, anchor_strides=(8, 16, 32, 64, 128),
                   loss_bbox=dict(type="BalancedL1Loss", alpha=0.5, gamma=1.5, beta=0.11,
                                  loss_weight=1.0)))
RETINA_TRAIN = dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5, neg_iou_thr=0.4,
                                  min_pos_iou=0, ignore_iof_thr=-1),
                    allowed_border=-1, pos_weight=-1)
RETINA_TEST = dict(nms_pre=60, score_thr=0.05, nms=dict(iou_thr=0.5), max_per_img=20)
CANVAS = (96, 128)
SHAPES = np.array([[96, 128], [80, 112]], np.int32)
FACTORS = np.array([1.0, 0.625], np.float32)
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")


def libra_faster_cfgs(num_gts: int = 4, max_num: int = 64) -> tuple:
    """``faster_rcnn_cfgs`` as Libra Faster R-CNN: FPN -> non-local BFP at
    P4, Balanced L1 in the box head, the R-CNN's ``IoUBalancedNegSampler``
    (3 IoU bins) taking every candidate."""
    model, train, test = faster_rcnn_cfgs(num_gts, max_num)
    model = dict(model, neck=[dict(model["neck"]),
                              dict(type="BFP", in_channels=64, num_levels=5, refine_level=2,
                                   refine_type="non_local")],
                 bbox_head=dict(model["bbox_head"], loss_bbox=dict(
                     type="BalancedL1Loss", alpha=0.5, gamma=1.5, beta=1.0, loss_weight=1.0)))
    rcnn = dict(train["rcnn"], sampler=dict(type="IoUBalancedNegSampler", num=max_num + num_gts,
                                            pos_fraction=1.0, floor_thr=-1, floor_fraction=0,
                                            num_bins=3))
    return model, dict(train, rcnn=rcnn), test


def t(a):
    return torch.from_numpy(np.array(a))


# phi's bias adds q . b to every key of a query: the softmax cancels it, and
# its gradient is f32 noise in both packages
PHI_BIAS = re.compile(r"(.*refine\.)?phi\.conv\.bias")


def assert_noise(got: torch.Tensor, want, weight_grad: torch.Tensor, what: str) -> None:
    """Both gradients below 1e-5 of the matching weight's largest |gradient|."""
    limit = 1e-5 * float(weight_grad.abs().max())
    assert float(got.abs().max()) < limit and float(np.abs(np.asarray(want)).max()) < limit, what


def assert_scaled(got, want, tol: float, what: str = "") -> None:
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def levels(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (2, h, w, CH)).astype(np.float32) for h, w in LEVELS]


def conv_sd(tree: dict, prefix: str) -> dict:
    """A flax {kernel, bias} conv -> the port's ``<prefix>.weight`` / ``.bias``."""
    return {f"{prefix}.weight": t(tree["kernel"]).permute(3, 2, 0, 1).contiguous(),
            f"{prefix}.bias": t(tree["bias"])}


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("src,dst", [((26, 42), (7, 11)), ((26, 42), (13, 21)),
                                     ((104, 168), (26, 42)), ((13, 21), (7, 11)),
                                     ((7, 11), (4, 6))])
def test_adaptive_max_pool_matches_ioudet_and_torch(src, dst):
    """``F.adaptive_max_pool2d``, which the port's BFP calls, against
    ``ioudet``'s ``adaptive_max_pool`` on continuous random maps: values
    bit for bit, the gradient of sum(out * w) to 1e-6 (an input in two
    overlapping bins sums two weights, in either order)."""
    rng = np.random.default_rng(src[0] + dst[1])
    x = rng.normal(0, 1, (2,) + src + (3,)).astype(np.float32)
    w = rng.normal(0, 1, (2,) + dst + (3,)).astype(np.float32)
    ref_grad = jax.jit(jax.grad(
        lambda b: (jlayers.adaptive_max_pool(b, dst) * w).sum()))(jnp.asarray(x))
    ref = jax.jit(lambda a: jlayers.adaptive_max_pool(a, dst))(jnp.asarray(x))
    xt = nchw(x).requires_grad_()
    out = F.adaptive_max_pool2d(xt, dst)
    (out * nchw(w)).sum().backward()
    np.testing.assert_array_equal(nhwc(out), np.asarray(ref))
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(ref_grad), rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((7, 11), (26, 42)), ((4, 6), (7, 11)), ((2, 3), (7, 11)),
                                     ((13, 21), (26, 42)), ((26, 42), (104, 168)),
                                     ((26, 42), (52, 84))])
def test_resize_nearest_matches_ioudet(src, dst):
    x = np.random.default_rng(1).normal(0, 1, (1,) + src + (2,)).astype(np.float32)
    np.testing.assert_array_equal(nhwc(resize_nearest(nchw(x), dst)),
                                  np.asarray(jlayers.resize_nearest(jnp.asarray(x), dst)))


# ------------------------------------------------------------------ modules

def module_grads(apply, params, xs, weights):
    """ioudet's outputs and the gradients of sum(out * w) w.r.t. the params
    and the inputs."""
    def f(p, xs):
        outs = apply(p, xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights)), outs

    (_, outs), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(params, xs)
    return outs, grads


def test_non_local_matches_ioudet():
    """The block as BFP builds it: reduction 1, no scaling."""
    x = levels(2)[1]
    jmod = JaxNonLocal2D(reduction=1, use_scale=False)
    params = random_params(param_shapes(jmod, jnp.asarray(x)), seed=3)
    w = np.random.default_rng(4).normal(0, 1, x.shape).astype(np.float32)
    (ref,), (pgrad, xgrad) = module_grads(lambda p, a: jmod.apply({"params": p}, a), params,
                                          jnp.asarray(x), [jnp.asarray(w)])
    mod = NonLocal2D(CH)
    sd = {}
    for name in ("theta", "phi", "g", "conv_out"):
        sd.update(conv_sd(params[name], f"{name}.conv"))
    mod.load_state_dict(sd)
    xt = nchw(x).requires_grad_()
    out = mod(xt)
    (out * nchw(w)).sum().backward()
    assert_scaled(nhwc(out), ref, 1e-5, "output")
    assert_scaled(nhwc(xt.grad), xgrad, 1e-5, "input gradient")
    for name in ("theta", "phi", "g", "conv_out"):
        conv = getattr(mod, name).conv
        assert_scaled(conv.weight.grad.permute(2, 3, 1, 0), pgrad[name]["kernel"], 1e-5, name)
        if name == "phi":
            assert_noise(conv.bias.grad, pgrad[name]["bias"], conv.weight.grad, name)
        else:
            assert_scaled(conv.bias.grad, pgrad[name]["bias"], 1e-5, name)


@pytest.mark.parametrize("refine", ["conv", "non_local", None])
def test_bfp_matches_ioudet(refine):
    xs = levels(5)
    jmod = JaxBFP(in_channels=CH, num_levels=5, refine_level=2, refine_type=refine)
    xj = tuple(jnp.asarray(x) for x in xs)
    ws = [np.random.default_rng(6 + i).normal(0, 1, x.shape).astype(np.float32)
          for i, x in enumerate(xs)]
    if refine is None:
        params = {}
    else:
        params = random_params(param_shapes(jmod, xj), seed=7)
    ref, (pgrad, xgrad) = module_grads(lambda p, a: jmod.apply({"params": p}, a), params, xj,
                                       [jnp.asarray(w) for w in ws])
    mod = BFP(in_channels=CH, num_levels=5, refine_level=2, refine_type=refine)
    sd = state_dict_from_flax({"neck": params}) if params else {}
    mod.load_state_dict({k[len("neck."):]: v for k, v in sd.items()})
    xt = [nchw(x).requires_grad_() for x in xs]
    outs = mod(xt)
    sum((o * nchw(w)).sum() for o, w in zip(outs, ws)).backward()
    for i, (o, r) in enumerate(zip(outs, ref)):
        assert_scaled(nhwc(o), r, 1e-5, f"level {i}")
        assert_scaled(nhwc(xt[i].grad), xgrad[i], 1e-5, f"input gradient {i}")
    ref_grads = state_dict_from_flax({"neck": pgrad})
    named = dict(mod.named_parameters())
    for name, p in named.items():
        if PHI_BIAS.fullmatch(name):
            assert_noise(p.grad, ref_grads[f"neck.{name}"], named[name[:-4] + "weight"].grad, name)
        else:
            assert_scaled(p.grad, ref_grads[f"neck.{name}"].numpy(), 1e-5, name)


def test_neck_sequence_matches_ioudet():
    rng = np.random.default_rng(8)
    feats = [rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
             for (h, w), c in zip(((52, 84), (26, 42), (13, 21), (7, 11)), (64, 128, 256, 512))]
    fpn = {k: v for k, v in FPN_R.items() if k != "type"}
    bfp = {k: v for k, v in BFP_R.items() if k != "type"}
    jmod = JaxNeckSequence((JaxFPN(**{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in fpn.items()}), JaxBFP(**bfp)))
    params = random_params(param_shapes(jmod, [jnp.asarray(f) for f in feats]), seed=9)
    assert sorted(params) == ["necks_0", "necks_1"]
    ref = jax.jit(lambda p, xs: jmod.apply({"params": p}, xs))(params,
                                                               [jnp.asarray(f) for f in feats])
    mod = NeckSequence(FPN(**fpn), BFP(**bfp))
    sd = state_dict_from_flax({"neck": params})
    mod.load_state_dict({k[len("neck."):]: v for k, v in sd.items()})
    with torch.no_grad():
        outs = mod([nchw(f) for f in feats])
    assert [tuple(o.shape[2:]) for o in outs] == list(LEVELS)
    for i, (o, r) in enumerate(zip(outs, ref)):
        assert_scaled(nhwc(o), r, 1e-5, f"level {i}")


@pytest.mark.parametrize("beta", [1.0, 0.11])
def test_balanced_l1_matches_ioudet(beta):
    rng = np.random.default_rng(10)
    pred = rng.normal(0, 1.5, (40, 4)).astype(np.float32)
    target = rng.normal(0, 1.5, (40, 4)).astype(np.float32)
    weight = (rng.uniform(size=(40, 4)) < 0.7).astype(np.float32)
    kw = dict(alpha=0.5, gamma=1.5, beta=beta)
    none = balanced_l1_loss(t(pred), t(target), reduction="none", **kw)
    ref_none = jax_balanced_l1_loss(jnp.asarray(pred), jnp.asarray(target), reduction="none",
                                     **kw)
    np.testing.assert_allclose(none.numpy(), np.asarray(ref_none), rtol=1e-6, atol=1e-7)
    assert (np.abs(pred - target) < beta).any() and (np.abs(pred - target) >= beta).any()
    jmod = JaxBalancedL1Loss(loss_weight=2.0, **kw)
    ref, ref_grad = jax.value_and_grad(lambda p: jmod(p, jnp.asarray(target),
                                                      jnp.asarray(weight), avg_factor=7.0))(
        jnp.asarray(pred))
    x = t(pred).requires_grad_()
    out = BalancedL1Loss(loss_weight=2.0, **kw)(x, t(target), t(weight),
                                                avg_factor=torch.tensor(7.0))
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------ detectors

def retina_gts():
    b = np.zeros((2, 6, 4), np.float32)
    b[0, :4] = [[4, 6, 40, 38], [50, 20, 110, 90], [60, 40, 90, 70], [2, 2, 125, 93]]
    b[1, :3] = [[20, 20, 52, 52], [8, 30, 100, 78], [70, 5, 106, 41]]
    valid = np.zeros((2, 6), bool)
    valid[0, :4] = True
    valid[1, :3] = True
    labels = np.array([[1, 2, 3, 4, 0, 0], [4, 1, 2, 0, 0, 0]], np.int32)
    return b, labels, valid


@pytest.fixture(scope="module")
def retina():
    """The tiny Libra RetinaNet in both packages and ioudet's simple_test,
    losses and gradients on the same inputs (one compiled program)."""
    det = jax_build_detector(RETINA, RETINA_TRAIN, RETINA_TEST)
    params = random_params(param_shapes(det, jnp.zeros((1,) + CANVAS + (3,))), seed=0)
    model = build_detector(RETINA, RETINA_TRAIN, RETINA_TEST)
    model.load_state_dict(state_dict_from_flax(params, module_types(model)), strict=True)
    img = np.random.default_rng(0).normal(0, 1, (2,) + CANVAS + (3,)).astype(np.float32)
    gb, gl, gv = retina_gts()

    def losses(p, *a):
        out = det.apply({"params": p}, *a, method=det.forward_train)
        return sum(out.values()), out

    @jax.jit
    def run(p, img, shapes, factors, gb, gl, gv):
        dets = det.apply({"params": p}, img, shapes, factors, shapes, method=det.simple_test)
        (_, out), grads = jax.value_and_grad(losses, has_aux=True)(
            p, img, gb, gl, gv, shapes, shapes)
        return dets, out, grads

    ref = jax.device_get(run(params, *(jnp.asarray(a) for a in (img, SHAPES, FACTORS, gb,
                                                                 gl, gv))))
    return model, params, img, ref


def check_losses_and_grads(model, out, ref_out, grads):
    assert sorted(out) == sorted(ref_out)
    for k in out:
        assert float(ref_out[k]) > 0, k
        np.testing.assert_allclose(float(out[k].detach()), float(ref_out[k]), rtol=1e-4,
                                   err_msg=k)
    ref_grads = state_dict_from_flax(grads, module_types(model))
    named = dict(model.named_parameters())
    for k, p in named.items():
        if k.startswith(FROZEN):
            assert p.grad is None, k
        elif PHI_BIAS.fullmatch(k):
            assert_noise(p.grad, ref_grads[k], named[k[:-4] + "weight"].grad, k)
        else:
            assert_scaled(p.grad, ref_grads[k].numpy(), 1e-3, k)


def test_libra_retinanet_predict_matches_ioudet(retina):
    model, _, img, ((ref_dets, ref_labels), _, _) = retina
    with torch.no_grad():
        dets, labels = model.eval().simple_test(t(img), t(SHAPES), t(FACTORS), t(SHAPES))
    assert (ref_labels >= 0).sum() > 10
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_allclose(dets.numpy(), ref_dets, rtol=1e-4, atol=1e-3)


def test_libra_retinanet_train_step_matches_ioudet(retina):
    model, _, img, (_, ref_out, grads) = retina
    model.train().zero_grad()
    out = model.forward_train(t(img), *(t(a) for a in retina_gts()), t(SHAPES), t(SHAPES))
    sum(out.values()).backward()
    check_losses_and_grads(model, out, ref_out, grads)
    # the non-local refine takes part: its attention convs get gradient
    assert float(model.neck[1].refine.theta.conv.weight.grad.abs().max()) > 0


@pytest.fixture(scope="module")
def faster():
    """The tiny Libra Faster R-CNN in both packages, ioudet's simple_test,
    losses and gradients on the same inputs (one compiled program)."""
    from tests._torch_mp_worker import two_stage_batches

    model_cfg, train_cfg, test_cfg = libra_faster_cfgs()
    det = jax_build_detector(model_cfg, train_cfg, test_cfg)
    meta = (jnp.zeros((1, 2), jnp.int32), jnp.ones((1,), jnp.float32),
            jnp.zeros((1, 2), jnp.int32))
    params = random_params(param_shapes(det, jnp.zeros((1, 64, 96, 3)), *meta,
                                        method=det.simple_test), seed=1)
    model = build_detector(model_cfg, train_cfg, test_cfg)
    model.load_state_dict(state_dict_from_flax(params, module_types(model)), strict=True)
    batch = {k: v[:2] for k, v in two_stage_batches(1)[0].items()}
    keys = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")
    factors = np.array([1.0, 0.625], np.float32)

    def losses(p, *a):
        out = det.apply({"params": p}, *a, method=det.forward_train,
                        rngs={"sampler": jax.random.PRNGKey(3)})
        return sum(v for k, v in out.items() if "loss" in k), out

    @jax.jit
    def run(p, b):
        dets = det.apply({"params": p}, b["img"], b["img_shape"], jnp.asarray(factors),
                         b["pad_shape"], method=det.simple_test)
        (_, out), grads = jax.value_and_grad(losses, has_aux=True)(p, *(b[k] for k in keys))
        return dets, out, grads

    ref = jax.device_get(run(params, {k: jnp.asarray(batch[k]) for k in keys}))
    return model, batch, factors, keys, ref


def test_libra_faster_rcnn_predict_matches_ioudet(faster):
    model, batch, factors, _, ((ref_dets, ref_labels), _, _) = faster
    with torch.no_grad():
        dets, labels = model.eval().simple_test(t(batch["img"]), t(batch["img_shape"]),
                                                t(factors), t(batch["pad_shape"]))
    assert (ref_labels >= 0).sum() > 5
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_allclose(dets.numpy(), ref_dets, rtol=1e-4, atol=1e-3)


def test_libra_faster_rcnn_train_step_matches_ioudet(faster):
    model, batch, _, keys, (_, ref_out, grads) = faster
    assert type(model.neck).__name__ == "NeckSequence"
    assert model.train_cfg["rcnn"]["sampler"]["type"] == "IoUBalancedNegSampler"
    model.train().zero_grad()
    out = model.forward_train(*(t(batch[k]) for k in keys),
                              generator=torch.Generator().manual_seed(5))
    sum(out.values()).backward()
    assert sorted(out) == ["loss_bbox", "loss_cls", "rpn_loss_bbox", "rpn_loss_cls"]
    check_losses_and_grads(model, out, ref_out, grads)


# ------------------------------------------------------------------ the bridge

def test_chained_neck_bridges_under_both_names(retina, tmp_path):
    """flax's ``necks_0`` / ``necks_1`` cross to mmdet's ``neck.0`` /
    ``neck.1`` (FPN's convs, the non-local block's theta / phi / g /
    conv_out); a ``.pth`` under mmdet's names loads strictly; a refine conv
    crosses as ``refine.conv``."""
    model, params, _, _ = retina
    sd = state_dict_from_flax(params, module_types(model))
    neck = sorted(k for k in sd if k.startswith("neck."))
    assert {k.split(".")[1] for k in neck} == {"0", "1"}
    assert {"neck.0.lateral_convs.0.conv.weight", "neck.0.fpn_convs.4.conv.weight",
            "neck.1.refine.theta.conv.weight", "neck.1.refine.phi.conv.bias",
            "neck.1.refine.g.conv.weight", "neck.1.refine.conv_out.conv.weight"} <= set(neck)
    np.testing.assert_array_equal(
        sd["neck.1.refine.conv_out.conv.weight"].numpy(),
        np.asarray(params["neck"]["necks_1"]["refine"]["conv_out"]["kernel"]).transpose(
            3, 2, 0, 1))
    path = os.path.join(tmp_path, "libra.pth")
    torch.save(dict(state_dict=model.state_dict(), meta={}), path)
    twin = build_detector(RETINA, RETINA_TRAIN, RETINA_TEST)
    load_checkpoint(twin, path)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in twin.state_dict().items())
    conv = {"necks_1": {"refine": {"conv": {"kernel": np.ones((3, 3, 4, 4), np.float32),
                                            "bias": np.zeros(4, np.float32)}}}}
    assert sorted(state_dict_from_flax({"neck": conv})) == ["neck.1.refine.conv.bias",
                                                            "neck.1.refine.conv.weight"]


def test_bf16_int8_raise_named_errors(retina):
    from ioudet_torch.ops import quant
    with pytest.raises(NotImplementedError, match="BFP in torch.bfloat16"):
        build_detector(dict(RETINA, dtype="bfloat16"), RETINA_TRAIN, RETINA_TEST)
    with pytest.raises(NotImplementedError, match="int8 serving of BFP"):
        with quant.quantize_calls(retina[0]):
            pass
