"""Port parity of group norm and weight standardization on the CPU: the
port's ``GroupNorm`` / ``ConvWS2d`` (``models/utils/layers.py``) and the
modules that take them (``ConvModule``, a GN + WS ResNet-18 and FPN 64
wide, the "4conv1fc" GN box head, the GN mask head), each on ``ioudet``'s
parameter tree filled with seeded values and bridged, held against
``ioudet`` on the same seeded inputs, forward and gradient (of the
outputs' dot product with a seeded tensor, with respect to the input and
every parameter).  Then the two traps: torch's own defaults (GN's eps
1e-5, the Bessel-corrected std) fail the same comparison.

Tolerances: outputs within 1e-5 of their largest |value| (1e-4 through
the backbone and FPN: ~20 normalized layers summed in another order);
gradients within 1e-4 of the largest |gradient| of each tensor (1e-3
through the backbone, as tests/test_torch_two_stage_train.py's)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ioudet.models.bbox_heads.bbox_head import ConvFCBBoxHead as JaxConvFCBBoxHead
from ioudet.models.backbones.resnet import ResNet as JaxResNet
from ioudet.models.mask_heads.fcn_mask_head import FCNMaskHead as JaxFCNMaskHead
from ioudet.models.necks.fpn import FPN as JaxFPN
from ioudet.models.utils.layers import ConvModule as JaxConvModule, ConvWS as JaxConvWS
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.models.backbones.resnet import ResNet
from ioudet_torch.models.bbox_heads.bbox_head import ConvFCBBoxHead
from ioudet_torch.models.mask_heads.fcn_mask_head import FCNMaskHead
from ioudet_torch.models.necks.fpn import FPN
from ioudet_torch.models.utils.layers import ConvModule, ConvWS2d, GroupNorm
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

WS = dict(type="ConvWS")
GN = dict(type="GN", num_groups=4)
GN32 = dict(type="GN", num_groups=32)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got: np.ndarray, want, share: float, what: str = "") -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=share * np.abs(want).max(), err_msg=what)


def load(module: torch.nn.Module, tree: dict, prefix: str) -> None:
    """A parameter tree bridged, the names under ``prefix``, into ``module``
    (strict)."""
    sd = state_dict_from_flax(tree)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})


def twin_grads(jmod, params, jargs, tmod, targs, wrap, prefix: str, seed: int,
               out_share: float, grad_share: float) -> None:
    """Forward of both twins on the same inputs, then the gradients of
    sum(outputs * r) for seeded r of each output's shape, with respect to
    the first input and every parameter, compared; ``wrap`` places the
    module's tree in a detector's, where the bridge finds it under
    ``prefix``."""
    def flat(outs):
        return outs if isinstance(outs, (tuple, list)) else (outs,)

    load(tmod, wrap(params), prefix)
    shapes = flat(jax.eval_shape(lambda *a: jmod.apply({"params": params}, *a), *jargs))
    rng = np.random.default_rng(seed)
    rs = [rng.normal(0, 1, o.shape).astype(np.float32) for o in shapes]

    def dot(p, x):
        outs = flat(jmod.apply({"params": p}, x, *jargs[1:]))
        return sum(jnp.sum(o * r) for o, r in zip(outs, rs)), outs

    (_, outs), (gp, gx) = jax.jit(jax.value_and_grad(dot, argnums=(0, 1), has_aux=True))(
        params, jargs[0])
    x = targs[0].clone().requires_grad_(True)
    touts = flat(tmod(x, *targs[1:]))
    for i, (t, o) in enumerate(zip(touts, outs)):
        close(nhwc(t) if t.dim() == 4 else t.detach().numpy(), o, out_share, f"output {i}")
    sum((t.permute(0, 2, 3, 1) if t.dim() == 4 else t).mul(torch.from_numpy(r)).sum()
        for t, r in zip(touts, rs)).backward()
    close(nhwc(x.grad), gx, grad_share, "input gradient")
    ref = state_dict_from_flax(wrap(jax.device_get(gp)))
    for name, p in tmod.named_parameters():
        close(p.grad.numpy(), ref[prefix + name].numpy(), grad_share, name)


def test_conv_ws_forward_and_gradient():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 10, 10, 6)).astype(np.float32)
    jconv = JaxConvWS(8, (3, 3), padding=1)
    params = random_params(param_shapes(jconv, jnp.asarray(x)), seed=1)
    twin_grads(jconv, params, (jnp.asarray(x),), ConvWS2d(6, 8, 3, 1, 1), (nchw(x),),
               lambda t: {"neck": {"lateral_0": {"conv": t}}}, "neck.lateral_convs.0.conv.",
               2, 1e-5, 1e-4)


@pytest.mark.parametrize("conv_cfg", [None, WS], ids=["conv", "ws"])
def test_gn_conv_module_forward_and_gradient(conv_cfg):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 9, 11, 8)).astype(np.float32)
    jmod = JaxConvModule(16, (3, 3), padding=1, conv_cfg=conv_cfg, norm_cfg=GN)
    params = random_params(param_shapes(jmod, jnp.asarray(x)), seed=4)
    mod = ConvModule(8, 16, 3, padding=1, conv_cfg=conv_cfg, norm_cfg=GN)
    assert isinstance(mod.gn, GroupNorm) and mod.conv.bias is None
    twin_grads(jmod, params, (jnp.asarray(x),), mod, (nchw(x),),
               lambda t: {"neck": {"lateral_0": t}}, "neck.lateral_convs.0.", 5, 1e-5, 1e-4)


class JaxBackboneFPN(nn.Module):
    """ioudet's GN + WS ResNet-18 and FPN in one module (one compile)."""

    @nn.compact
    def __call__(self, x):
        feats = JaxResNet(depth=18, conv_cfg=WS, norm_cfg=GN32, name="backbone")(x)
        return JaxFPN(in_channels=(64, 128, 256, 512), out_channels=64, num_outs=5,
                      conv_cfg=WS, norm_cfg=GN32, name="neck")(feats)


class BackboneFPN(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = ResNet(depth=18, conv_cfg=WS, norm_cfg=GN32)
        self.neck = FPN(in_channels=(64, 128, 256, 512), out_channels=64, num_outs=5,
                        conv_cfg=WS, norm_cfg=GN32)

    def forward(self, x):
        return self.neck(self.backbone(x))


def test_gn_ws_backbone_and_fpn_forward_and_gradient():
    """The five FPN levels of a GN + WS ResNet-18 and FPN (mmdet's names:
    gn1 / gn2, downsample.1, the FPN's ConvModules' gn) and every
    parameter's gradient."""
    x = np.random.default_rng(6).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jmod = JaxBackboneFPN()
    params = random_params(param_shapes(jmod, jnp.asarray(x)), seed=7)
    mod = BackboneFPN()
    sd = state_dict_from_flax(params)
    mod.load_state_dict(sd)
    assert "backbone.gn1.weight" in sd and "backbone.layer2.0.downsample.1.weight" in sd
    assert "neck.fpn_convs.0.gn.weight" in sd and "backbone.layer1.0.gn2.bias" in sd
    shapes = jax.eval_shape(lambda a: jmod.apply({"params": params}, a), jnp.asarray(x))
    rng = np.random.default_rng(8)
    rs = [rng.normal(0, 1, o.shape).astype(np.float32) for o in shapes]

    def dot(p):
        outs = jmod.apply({"params": p}, jnp.asarray(x))
        return sum(jnp.sum(o * r) for o, r in zip(outs, rs)), outs

    (_, outs), grads = jax.jit(jax.value_and_grad(dot, has_aux=True))(params)
    grads = state_dict_from_flax(jax.device_get(grads))
    touts = mod(nchw(x))
    for i, (t, o) in enumerate(zip(touts, outs)):
        close(nhwc(t), o, 1e-4, f"level {i}")
    sum((t.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum() for t, r in zip(touts, rs)).backward()
    for name, p in mod.named_parameters():
        close(p.grad.numpy(), grads[name].numpy(), 1e-3, name)


def test_gn_shared_conv_box_head_forward_and_gradient():
    """The gn+ws configs' "4conv1fc" head (four GN + WS shared convs, one
    fc): the bridge permutes the fc's input from ioudet's (S, S, C) flatten
    to the port's (C, S, S), after the shared convs."""
    x = np.random.default_rng(9).normal(0, 1, (6, 7, 7, 16)).astype(np.float32)
    kw = dict(num_shared_convs=4, num_shared_fcs=1, conv_out_channels=16, fc_out_channels=32,
              num_classes=5, in_channels=16, roi_feat_size=7, conv_cfg=WS, norm_cfg=GN)
    jhead = JaxConvFCBBoxHead(**kw)
    params = random_params(param_shapes(jhead, jnp.asarray(x)), seed=10)
    twin_grads(jhead, params, (jnp.asarray(x),), ConvFCBBoxHead(**kw), (nchw(x),),
               lambda t: {"bbox_head": t}, "bbox_head.", 11, 1e-5, 1e-4)


def test_gn_mask_head_forward_and_gradient():
    x = np.random.default_rng(12).normal(0, 1, (5, 14, 14, 16)).astype(np.float32)
    kw = dict(num_convs=2, in_channels=16, conv_out_channels=16, num_classes=5,
              conv_cfg=WS, norm_cfg=GN)
    jhead = JaxFCNMaskHead(**kw)
    params = random_params(param_shapes(jhead, jnp.asarray(x)), seed=13)
    head = FCNMaskHead(**kw)
    assert isinstance(head.convs[0].gn, GroupNorm)
    twin_grads(jhead, params, (jnp.asarray(x),), head, (nchw(x),),
               lambda t: {"mask_head": t}, "mask_head.", 14, 1e-5, 1e-4)


def test_torch_defaults_fail_where_the_port_matches():
    """GN on groups whose variance is ~1e-6 (where eps 1e-6 against 1e-5
    matters) and WS of a 1x1 conv on 3 inputs (where the Bessel correction
    is sqrt(3 / 2)): torch's ``F.group_norm`` (eps 1e-5) and a kernel
    standardized by ``Tensor.std`` (unbiased) miss ioudet by far more than
    the tolerance; the port's modules do not."""
    rng = np.random.default_rng(15)
    x = rng.normal(0, 1e-3, (2, 5, 5, 8)).astype(np.float32)
    jgn = nn.GroupNorm(num_groups=4)
    params = random_params(param_shapes(jgn, jnp.asarray(x)), seed=16)
    want = np.asarray(jax.jit(jgn.apply)({"params": params}, jnp.asarray(x)))
    gn = GroupNorm(4, 8)
    gn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"])})
    close(nhwc(gn(nchw(x))), want, 1e-5)
    torch_default = F.group_norm(nchw(x), 4, gn.weight, gn.bias)   # eps 1e-5
    assert np.abs(nhwc(torch_default) - want).max() > 100 * 1e-5 * np.abs(want).max()

    xw = rng.normal(0, 1, (2, 4, 4, 3)).astype(np.float32)
    jws = JaxConvWS(6, (1, 1), use_bias=False)
    wparams = random_params(param_shapes(jws, jnp.asarray(xw)), seed=17)
    want = np.asarray(jax.jit(jws.apply)({"params": wparams}, jnp.asarray(xw)))
    ws = ConvWS2d(3, 6, 1, bias=False)
    ws.weight.data = torch.from_numpy(wparams["kernel"]).permute(3, 2, 0, 1).contiguous()
    close(nhwc(ws(nchw(xw))), want, 1e-5)
    w = ws.weight
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    unbiased = (w - mean) / (w.flatten(1).std(dim=1).reshape(-1, 1, 1, 1) + 1e-5)
    bessel = F.conv2d(nchw(xw), unbiased)
    assert np.abs(nhwc(bessel) - want).max() > 100 * 1e-5 * np.abs(want).max()
