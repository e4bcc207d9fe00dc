"""The low-precision serving slice of ioudet_torch against ioudet on the CPU:
the bfloat16 compute policy and the calibrated w8a8 path, on the tiny
IoU-aware R-18 of tests/test_quant.py at 64x96 with bridged weights and the
same numpy-seeded inputs.  This file holds the policy and the per-module
tests and the shared fixture; the whole detector's bf16 tests are in
tests/test_torch_dtype_bf16.py, its int8 tests in tests/test_torch_dtype_int8.py.

Tolerances.
  * f32 + static int8, scales carried across: every int32 accumulator is
    exact on both sides, so head outputs differ by f32 roundoff unless that
    roundoff moves an activation over a .5 boundary, which changes one int8
    step (about 1e-3 at the logits); limit 5e-3, largest seen 6e-9.
  * bf16: XLA and PyTorch round to bf16 at different places (XLA may keep
    ``x * w + b`` in f32 and round once; PyTorch rounds after each op), one
    bf16 step (2^-8 relative) an op.  One ConvModule or Bottleneck: two
    steps, relative plus as much of the output's rms for sums that cancel;
    the FPN, three roundings deep (lateral, top-down sum, output conv), four.
    The whole detector's logits: 0.02 against ioudet's bf16 logits and 0.03
    against f32 (seen 1.5e-3 and 1.2e-3 at logits of order 0.1).
  * dynamic int8: the scale itself carries the f32 roundoff of the absmax, so
    more activations cross a .5 boundary than with a shared static scale;
    limit 0.05 (seen 0.015).
  * ioudet's calibration keeps a shared conv's last call of a batch (the
    head's towers: P7's absmax), which clips the larger levels: the static
    int8 logits sit up to 0.7 from f32 in both packages alike, so the drift
    from f32 is bounded for the dynamic mode only.
  * the eval tail on the same bf16 head outputs: labels exact, dets 1e-4.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.apis.checkpoint import convert_torch_retinanet
from ioudet.models import build_detector as jax_build_detector
from ioudet.models.backbones.resnet import Bottleneck as JaxBottleneck
from ioudet.models.necks.fpn import FPN as JaxFPN
from ioudet.models.utils.layers import ConvModule as JaxConvModule
from ioudet_torch.apis import checkpoint as ckpt
from ioudet_torch.apis.inference import init_detector, predict
from ioudet_torch.apis.train import build_optimizer, make_train_step, make_trainable_mask
from ioudet_torch.models import build_detector
from ioudet_torch.models.backbones.resnet import Bottleneck
from ioudet_torch.models.necks.fpn import FPN
from ioudet_torch.models.utils.layers import Conv2d, ConvModule, FrozenBatchNorm
from ioudet_torch.ops import quant
from tests.test_torch_detector import randomize
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODEL = dict(   # the tiny detector of tests/test_quant.py
    type="IoUAwareRetinaNet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=-1, norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
              start_level=1, add_extra_convs=True, num_outs=5),
    bbox_head=dict(type="IoUAwareRetinaHead", num_classes=5, in_channels=32,
                   feat_channels=32, stacked_convs=1, anchor_strides=(8, 16, 32, 64, 128)))
TEST_CFG = dict(nms_pre=100, score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                max_per_img=10, rescoring_alpha=0.5, class_topk=2)
META = (np.array([[64, 96], [50, 70]], np.int32), np.array([1.0, 0.75], np.float32),
        np.array([[64, 96], [64, 96]], np.int32))


def images(seed=0, batch=2):
    return np.random.default_rng(seed).normal(0, 1, (batch, 64, 96, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(f32 torch model, its bf16 twin on the same parameters, bridged flax
    params, f32 flax detector, bf16 flax detector)."""
    model = randomize(build_detector(MODEL, None, TEST_CFG), seed=0)
    twin = build_detector(dict(MODEL, dtype="bfloat16"), None, TEST_CFG).eval()
    twin.load_state_dict(model.state_dict())
    params = convert_torch_retinanet(model.state_dict(), depth=18, num_laterals=3,
                                     stacked_convs=1)
    params = jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)), params)
    return (model, twin, params, jax_build_detector(dict(MODEL), None, TEST_CFG),
            jax_build_detector(dict(MODEL, dtype="bfloat16"), None, TEST_CFG))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ------------------------------------------------------------ the dtype policy

def test_bf16_model_keeps_f32_parameters_and_the_state_dict(pair):
    model, twin, *_ = pair
    assert all(p.dtype == torch.float32 for p in twin.parameters())
    assert all(b.dtype == torch.float32 for b in twin.buffers())
    assert list(twin.state_dict()) == list(model.state_dict())
    convs = [m for m in twin.modules() if isinstance(m, Conv2d)]
    norms = [m for m in twin.modules() if isinstance(m, FrozenBatchNorm)]
    assert convs and all(m.compute_dtype == torch.bfloat16 for m in convs)
    assert norms and all(m.dtype == torch.bfloat16 for m in norms)
    assert all(m.compute_dtype == torch.float32 for m in model.modules()
               if isinstance(m, Conv2d))
    with torch.no_grad():
        outs = twin(torch.from_numpy(images(batch=1)))
    assert all(o.dtype == torch.bfloat16 for branch in outs for o in branch)


@pytest.mark.parametrize("dtype", ["float16", "int8", "float64"])
def test_other_dtypes_raise(dtype):
    with pytest.raises(NotImplementedError):
        build_detector(dict(MODEL, dtype=dtype))


def test_a_part_can_name_its_own_dtype():
    det = build_detector(dict(MODEL, dtype="bfloat16",
                              neck=dict(MODEL["neck"], dtype="float32")))
    assert det.neck.lateral_convs[0].conv.compute_dtype == torch.float32
    assert det.backbone.conv1.compute_dtype == torch.bfloat16
    assert det.bbox_head.retina_iou.compute_dtype == torch.bfloat16


def test_training_a_bf16_model_raises(pair):
    """A model that computes in bf16 trains (parameters, gradients and the
    optimizer state in f32: tests/test_torch_train_bf16.py holds it against
    ioudet); one whose parameters are bf16 raises."""
    twin = copy.deepcopy(pair[1])
    make_trainable_mask(twin)
    opt = build_optimizer(twin, dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4))
    make_train_step(twin, opt, lambda step: 0.01)
    halved = copy.deepcopy(twin).to(torch.bfloat16)
    opt = build_optimizer(halved, dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4))
    with pytest.raises(TypeError):
        make_train_step(halved, opt, lambda step: 0.01)


def test_init_detector_takes_the_configs_dtype():
    handle = init_detector(dict(model=dict(MODEL, dtype="bfloat16"), test_cfg=TEST_CFG),
                           device="cpu", seed=0)
    ref = init_detector(dict(model=MODEL, test_cfg=TEST_CFG), device="cpu", seed=0)
    assert handle.model.backbone.conv1.compute_dtype == torch.bfloat16
    sd, rd = handle.model.state_dict(), ref.model.state_dict()
    assert all(torch.equal(sd[k], rd[k]) for k in rd)   # same seed, same f32 weights
    x = torch.from_numpy(images())
    dets, labels = predict(handle, x, *(torch.from_numpy(m) for m in META))
    assert tuple(dets.shape) == (2, 10, 5) and dets.dtype == torch.float32
    assert bool(torch.isfinite(dets).all())


# ---------------------------------------------------------- bf16, per module

def close_bf16(got, want, what, steps=2):
    """Within ``steps`` bf16 steps (2^-8 relative each) of ``want``, plus as
    much of its rms for sums that cancel."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, what
    limit = steps * 2.0 ** -8 * (np.abs(want) + np.sqrt(np.mean(want ** 2)))
    worst = float((np.abs(got - want) / limit).max())
    assert worst <= 1.0, f"{what}: {worst:.2f} of the limit"


def random_bn(rng, n):
    return dict(scale=rng.uniform(0.5, 1.5, n), bias=rng.uniform(-0.5, 0.5, n),
                mean=rng.uniform(-0.5, 0.5, n), var=rng.uniform(0.5, 2.0, n))


def seeded_like(tree, rng):
    """The flax param tree with seeded values: kernels N(0, 1/sqrt(fan_in)),
    biases small, FrozenBN statistics as ``random_bn``."""
    out = {}
    for name, node in tree.items():
        if "kernel" in node:
            k = node["kernel"]
            leaf = dict(kernel=rng.normal(0, (k.shape[0] * k.shape[1] * k.shape[2]) ** -0.5, k.shape))
            if "bias" in node:
                leaf["bias"] = rng.normal(0, 0.1, node["bias"].shape)
            out[name] = leaf
        elif "var" in node:
            out[name] = random_bn(rng, node["var"].shape[0])
        else:
            out[name] = seeded_like(node, rng)
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), out)


def test_conv_module_bf16_matches_ioudet():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 12, 14, 8)).astype(np.float32)
    jm = JaxConvModule(16, (3, 3), strides=(2, 2), norm_cfg=dict(type="FrozenBN"),
                       dtype=jnp.bfloat16)
    params = seeded_like(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tm = ConvModule(8, 16, 3, stride=2, norm_cfg=dict(type="FrozenBN"), dtype="bfloat16")
    sd = {}
    ckpt._conv(sd, "conv", params["conv"])
    ckpt._bn(sd, "bn", params["norm"])
    tm.load_state_dict(sd)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close_bf16(got, want, "ConvModule")


@pytest.mark.parametrize("stride,downsample", [(1, False), (2, True)])
def test_bottleneck_bf16_matches_ioudet(stride, downsample):
    rng = np.random.default_rng(2)
    x = np.asarray(jnp.asarray(rng.normal(0, 1, (2, 10, 12, 32)), jnp.bfloat16)
                   .astype(jnp.float32))   # a block's input is bf16 in the network
    jm = JaxBottleneck(planes=8, stride=stride, downsample=downsample, dtype=jnp.bfloat16)
    params = seeded_like(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tm = Bottleneck(32, 8, stride, downsample, dtype=torch.bfloat16)
    sd = {}
    ckpt._backbone(sd, {"layer1_0": params}, prefix="b")
    tm.load_state_dict({k[len("b.layer1.0."):]: v for k, v in sd.items()})
    want = jm.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close_bf16(got, want, "Bottleneck")


def test_fpn_bf16_matches_ioudet():
    rng = np.random.default_rng(3)
    chans, sizes = (8, 16, 32, 64), ((32, 48), (16, 24), (8, 12), (4, 6))
    feats = [rng.normal(0, 1, (1, h, w, c)).astype(np.float32)
             for c, (h, w) in zip(chans, sizes)]
    kw = dict(in_channels=chans, out_channels=16, start_level=1, add_extra_convs=True,
              num_outs=5)
    jm = JaxFPN(dtype=jnp.bfloat16, **kw)
    jfeats = [jnp.asarray(f, jnp.bfloat16) for f in feats]
    params = seeded_like(jm.init(jax.random.PRNGKey(0), jfeats)["params"], rng)
    tm = FPN(dtype="bfloat16", **kw)
    sd = {}
    ckpt._neck(sd, params, prefix="n")
    tm.load_state_dict({k[len("n."):]: v for k, v in sd.items()})
    want = jm.apply({"params": params}, jfeats)
    with torch.no_grad():
        got = tm([torch.from_numpy(f).bfloat16().permute(0, 3, 1, 2) for f in feats])
    assert len(got) == len(want) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        close_bf16(g.permute(0, 2, 3, 1), w, f"FPN level {lvl}", steps=4)


# ------------------------------------------------- int8 scales across the bridge

def test_scale_bridge_round_trip_on_the_flagship_names():
    from __graft_entry__ import FLAGSHIP
    det = build_detector(FLAGSHIP)
    paths = [p for p, _ in quant.eligible_convs(det, skip=())]
    assert len(paths) == 53 + 8 + 8 + 3
    scales = {p: float(i + 1) for i, p in enumerate(paths)}
    flax_side = ckpt.act_scales_to_flax(scales)
    assert ckpt.act_scales_from_flax(flax_side) == scales
    assert flax_side["neck/extra_1/conv"] == scales["neck.fpn_convs.4.conv"]
    assert "backbone/layer3_5/conv3" in flax_side and "bbox_head/reg_conv3" in flax_side
    with pytest.raises(KeyError):
        ckpt.act_scales_from_flax({"roi_head/fc": 1.0})


# ------------------------------------------------------------ no jax anywhere

def test_low_precision_modules_run_without_jax():
    """quant, mma_cuda and the probe tool import, and a bf16 + int8 predict
    runs, with no jax / flax / ioudet module loaded."""
    code = (
        "import sys, numpy as np, torch\n"
        "from ioudet_torch.ops import quant, mma_cuda\n"
        "from ioudet_torch.tools import probe_tensor_cores\n"
        "from ioudet_torch.apis.inference import init_detector, inference_detector\n"
        "from tests.test_torch_inference import CFG\n"
        "cfg = dict(CFG, model=dict(CFG['model'], dtype='bfloat16'))\n"
        "h = init_detector(cfg, device='cpu')\n"
        "img = np.zeros((40, 60, 3), np.uint8)\n"
        "scales = quant.calibrate(h.model, lambda im: inference_detector(h, im), [img])\n"
        "with quant.quantize_calls(h.model, act_scale=scales):\n"
        "    inference_detector(h, img)\n"
        "assert probe_tensor_cores.main() == 1   # no card here\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'ioudet')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    if torch.cuda.is_available():
        code = code.replace("assert probe_tensor_cores.main() == 1   # no card here\n", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
