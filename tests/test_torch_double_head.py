"""Double-Head R-CNN of the port on the CPU, against ``ioudet`` and flax:

  * the port's trainable BN (``models/utils/layers.BatchNorm``) against
    flax's ``nn.BatchNorm`` with ``ioudet``'s numbers (momentum 0.9, eps
    1e-5), in training (batch statistics, and the running statistics
    after the step) and in eval (the running statistics), f32 and bf16;
  * ``ioudet``'s own ConvModule with BN raising at its first call (it
    passes the mode to flax's BN twice): the departure the port makes;
  * ``DoubleConvFCBBoxHead`` with GN, as ``ioudet``'s own test builds it
    (64 channels in, conv branch 128 wide, two fcs of 64, 5 classes), on
    ``ioudet``'s parameter tree filled with seeded values and bridged:
    (cls, reg) and the gradient of every parameter and of the input;
  * ``DoubleHeadRCNN`` with that head on the tiny Faster R-CNN of
    ``faster_rcnn_cfgs`` (every candidate sampled): ``simple_test`` and the
    losses against one compiled ``ioudet`` program.

Tolerances: BN outputs 1e-5 of their largest |value| (bf16: one bf16 step),
running statistics 1e-6; head outputs and gradients 1e-4 of each tensor's
largest |value| (f32 sums of ~20 layers in another order);
``simple_test`` labels exact, dets rtol 1e-4 and 1e-3 abs (PERF.md section
2: the conv branch puts ten more convs in front of the regression than
Faster R-CNN's head); losses rtol 1e-5."""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.models import build_detector as jax_build_detector
from ioudet.models.bbox_heads.double_bbox_head import DoubleConvFCBBoxHead as JaxHead
from ioudet.models.utils.layers import ConvModule as JaxConvModule
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.models import build_detector
from ioudet_torch.models.bbox_heads.double_bbox_head import DoubleConvFCBBoxHead
from ioudet_torch.models.utils.layers import BatchNorm
from tests._torch_mp_worker import faster_rcnn_cfgs, two_stage_batches
from tests.test_torch_two_stage import FACTORS, PAD, SHAPES, images
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

HEAD = dict(num_convs=2, num_fcs=2, num_classes=5, in_channels=64, conv_out_channels=128,
            fc_out_channels=64, cls_loss_weight=2.0, bbox_loss_weight=2.0,
            norm_cfg=dict(type="GN"))
KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")


def scaled_close(got: torch.Tensor, want, rel: float) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


# ------------------------------------------------------------------- BN

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_flax_in_both_modes(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(0.5, 2.0, (6, 16, 5, 7))).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    bn = nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jdt)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt)
    variables = bn.init(jax.random.PRNGKey(0), xj, use_running_average=False)
    scale, bias = rng.uniform(0.5, 1.5, 16), rng.uniform(-0.5, 0.5, 16)
    mean, var = rng.uniform(-0.5, 0.5, 16), rng.uniform(0.5, 2.0, 16)
    variables = dict(params=dict(scale=jnp.asarray(scale, jnp.float32),
                                 bias=jnp.asarray(bias, jnp.float32)),
                     batch_stats=dict(mean=jnp.asarray(mean, jnp.float32),
                                      var=jnp.asarray(var, jnp.float32)))
    ours = BatchNorm(16, dtype=tdt)
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean),
                        ("running_var", var)):
            getattr(ours, name).copy_(torch.from_numpy(v.astype(np.float32)))
    xt = torch.from_numpy(x).to(tdt)
    rel = 1e-5 if dtype == "float32" else 2 ** -7

    want, updated = jax.jit(lambda v, a: bn.apply(v, a, use_running_average=False,
                                                  mutable=["batch_stats"]))(variables, xj)
    got = ours.train()(xt)
    assert got.dtype == tdt
    scaled_close(got, np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2), rel)
    np.testing.assert_allclose(ours.running_mean.numpy(), updated["batch_stats"]["mean"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(), updated["batch_stats"]["var"],
                               rtol=0, atol=1e-6)
    assert not np.allclose(ours.running_var.numpy(), var)   # the step moved them

    stepped = dict(variables, batch_stats=updated["batch_stats"])
    want = jax.jit(lambda v, a: bn.apply(v, a, use_running_average=True))(stepped, xj)
    before = ours.running_mean.clone()
    with torch.no_grad():
        got = ours.eval()(xt)
    scaled_close(got, np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2), rel)
    assert torch.equal(before, ours.running_mean)   # eval leaves them


def test_ioudet_bn_conv_module_raises():
    """``ioudet``'s ConvModule builds flax's BN with ``use_running_average``
    and passes it again at call time: flax refuses at the first call, so
    ``ioudet`` cannot run the Double-Head config's BN head.  The port's BN
    does what that call site states instead."""
    mod = JaxConvModule(8, (3, 3), norm_cfg=dict(type="BN"))
    with pytest.raises(ValueError, match="use_running_average"):
        mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 6, 4)))


# ------------------------------------------------------------------ head

@pytest.fixture(scope="module")
def head_twins():
    """(port head, ioudet's head, its parameters, a jitted (outputs,
    gradients) program of ioudet's head)."""
    jhead = JaxHead(**HEAD)
    x = jnp.zeros((12, 7, 7, 64), jnp.float32)
    params = random_params(param_shapes(jhead, x), seed=1)
    head = DoubleConvFCBBoxHead(**HEAD)
    sd = state_dict_from_flax({"bbox_head": params})
    head.load_state_dict({k[len("bbox_head."):]: v for k, v in sd.items()})

    def loss(p, a, wc, wr):
        cls, reg = jhead.apply({"params": p}, a)
        return (cls * wc).sum() + (reg * wr).sum(), (cls, reg)

    @jax.jit
    def ref(p, a, wc, wr):
        (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, a, wc, wr)
        return outs, grads

    return head, params, ref


def test_head_with_gn_matches_ioudet_forward_and_gradient(head_twins):
    head, params, ref = head_twins
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (12, 64, 7, 7)).astype(np.float32)
    wc = rng.normal(0, 1, (12, 5)).astype(np.float32)
    wr = rng.normal(0, 1, (12, 20)).astype(np.float32)
    (jcls, jreg), (gp, gx) = ref(params, jnp.asarray(x.transpose(0, 2, 3, 1)), wc, wr)
    xt = torch.from_numpy(x).requires_grad_(True)
    cls, reg = head.train()(xt)
    scaled_close(cls, jcls, 1e-4)
    scaled_close(reg, jreg, 1e-4)
    ((cls * torch.from_numpy(wc)).sum() + (reg * torch.from_numpy(wr)).sum()).backward()
    scaled_close(xt.grad, np.asarray(gx).transpose(0, 3, 1, 2), 1e-4)
    grads = state_dict_from_flax({"bbox_head": gp})
    named = dict(head.named_parameters())
    assert sorted(f"bbox_head.{k}" for k in named) == sorted(grads)
    for k, g in grads.items():
        p = named[k[len("bbox_head."):]]
        scaled_close(p.grad, g.numpy(), 1e-4)
    assert any(k.startswith("bbox_head.res_block.conv_identity.gn") for k in grads)
    assert "bbox_head.conv_branch.1.gn3.weight" in grads


# --------------------------------------------------------------- detector

def double_head_cfgs() -> tuple:
    model, train, test = faster_rcnn_cfgs()
    return dict(model, type="DoubleHeadRCNN",
                bbox_head=dict(HEAD, type="DoubleConvFCBBoxHead")), train, test


@pytest.fixture(scope="module")
def twins():
    model_cfg, train_cfg, test_cfg = double_head_cfgs()
    det = jax_build_detector(dict(model_cfg), train_cfg, test_cfg)
    meta = tuple(map(jnp.asarray, (SHAPES, FACTORS, PAD)))
    params = random_params(param_shapes(det, jnp.asarray(images(2)), *meta,
                                        method=det.simple_test), seed=0)
    model = build_detector(model_cfg, train_cfg, test_cfg)
    model.load_state_dict(state_dict_from_flax(params))
    batch = {k: v[:2] for k, v in two_stage_batches(1)[0].items()}

    @jax.jit
    def ref(p, x):
        dets = det.apply({"params": p}, x, *meta, method=det.simple_test)
        losses = det.apply({"params": p}, *(jnp.asarray(batch[k]) for k in KEYS),
                           method=det.forward_train, rngs={"sampler": jax.random.PRNGKey(3)})
        return dets, losses

    return model, batch, functools.partial(ref, params)


@pytest.mark.parametrize("seed", [2, 3])
def test_double_head_rcnn_simple_test_matches_ioudet(twins, seed):
    model, _, ref = twins
    x = images(seed)
    (want_d, want_l), _ = ref(jnp.asarray(x))
    with torch.no_grad():
        dets, labels = model.eval().simple_test(
            torch.from_numpy(x), *map(torch.from_numpy, (SHAPES, FACTORS, PAD)))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    assert int((labels >= 0).sum()) >= 10
    np.testing.assert_allclose(dets.numpy(), np.asarray(want_d), rtol=1e-4, atol=1e-3)


def test_double_head_rcnn_losses_match_ioudet(twins):
    model, batch, ref = twins
    _, want = ref(jnp.asarray(images(2)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        ours = model.train().forward_train(*(tb[k] for k in KEYS),
                                           generator=torch.Generator().manual_seed(5))
    assert sorted(ours) == sorted(want) == ["loss_bbox", "loss_cls", "rpn_loss_bbox",
                                            "rpn_loss_cls"]
    for k in want:
        np.testing.assert_allclose(float(ours[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert float(ours["loss_bbox"]) > 0
