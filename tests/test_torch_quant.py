"""ioudet_torch/ops/quant.py against ioudet/ops/quant.py on the CPU: the two
quantizers, the quantized convolution (its dequantized product is the plain
version of the tensor-core kernel here), the skip list, calibration and the
window gather, on the same numpy-seeded inputs and bridged weights.

Tolerances.  The quantizers are exact (both round half to even).  The int32
accumulators of the convolution are exact on both sides; the dequantization
``acc * (sx * sw) + bias`` is f32 on both, where XLA may contract the
multiply-add: rtol 1e-6 of the largest output with a bias, bit-equal without
one.
"""

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from ioudet.ops import quant as jquant
from ioudet_torch.models.utils.layers import Conv2d, ConvModule, same_pads
from ioudet_torch.ops import _build, mma_cuda, quant
from tests.torch_twins import one_thread  # noqa: F401 (autouse)


def oihw(kernel):
    return torch.from_numpy(np.transpose(np.asarray(kernel), (3, 2, 0, 1)).copy())


def nchw(x):
    return torch.from_numpy(np.transpose(np.asarray(x), (0, 3, 1, 2)).copy())


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# --------------------------------------------------------------- quantizers

@pytest.mark.parametrize("scale", [None, 0.25, 0.037])
def test_quantize_tensor_matches_ioudet(scale):
    """Same int8 values and scale, values on .5 boundaries included (scale
    0.25 makes (n + 0.5) * scale / scale exact)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 8, (3, 5, 7, 4)).astype(np.float32)
    x[0, 0, :, 0] = (np.arange(7) - 3 + 0.5) * 0.25          # -2.5 .. 3.5 steps
    x[0, 1, :, 0] = (np.arange(7) * 40 - 130 + 0.5) * 0.25   # beyond +-127 too
    want_q, want_s = jquant._quantize_tensor(jnp.asarray(x), scale)
    st = None if scale is None else torch.tensor(scale, dtype=torch.float32)
    got_q, got_s = quant._quantize_tensor(torch.from_numpy(x), st)
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert float(got_s) == float(np.float32(want_s))
    if scale == 0.25:   # half to even, clipped at +-127
        assert got_q[0, 0, :, 0].tolist() == [-2, -2, 0, 0, 2, 2, 4]
        assert got_q[0, 1, 0, 0] == -127 and got_q[0, 1, 6, 0] == 110


def test_quantize_tensor_of_zeros_uses_the_floor():
    got_q, got_s = quant._quantize_tensor(torch.zeros(2, 3))
    want_q, want_s = jquant._quantize_tensor(jnp.zeros((2, 3)))
    assert float(got_s) == float(want_s) and not got_q.any()


def test_quantize_weight_matches_ioudet():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.1, (3, 3, 6, 8)).astype(np.float32)   # HWIO
    w[..., 2] = 0.0                                           # a dead channel: the floor
    w[0, 0, 0, 3] = 0.5 * 2.0 ** -3                            # .5 boundaries in channel 3
    w[..., 3] = np.round(w[..., 3] * 64) / 64
    want_q, want_s = jquant._quantize_weight(jnp.asarray(w))
    got_q, got_s = quant._quantize_weight(oihw(w))
    np.testing.assert_array_equal(got_q.permute(2, 3, 1, 0).numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s.shape == (8,) and int(got_q.abs().max()) == 127


# ------------------------------------------------------------ quantized conv

class SamePadded(nn.Module):
    """XLA's 'SAME' padding ahead of a conv (``ConvModule`` has no groups)."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        (kh, kw), (sh, sw) = self.conv.kernel_size, self.conv.stride
        ph, pw = same_pads(x.shape[2], kh, sh), same_pads(x.shape[3], kw, sw)
        return self.conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))


def conv_pair(features, groups, strides, padding, in_ch=8, seed=0, on_grid=False):
    """A flax conv with seeded params and the port's conv on the bridged
    weights: (flax module, variables, torch module)."""
    rng = np.random.default_rng(seed)
    conv = jnn.Conv(features, (3, 3), strides=strides, padding=padding,
                    feature_group_count=groups)
    k = rng.normal(0, 0.1, (3, 3, in_ch // groups, features)).astype(np.float32)
    b = np.zeros(features, np.float32) if on_grid else \
        rng.normal(0, 0.1, features).astype(np.float32)
    if on_grid:   # snap each output channel onto its own int8 grid
        ks = np.abs(k).max(axis=(0, 1, 2), keepdims=True) / 127.0
        k = (np.round(k / ks) * ks).astype(np.float32)
    v = {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}
    if padding == "SAME" and groups == 1:
        mod = ConvModule(in_ch, features, 3, stride=strides[0], padding="SAME", act=None)
        tconv = mod.conv
    else:
        tconv = mod = Conv2d(in_ch, features, 3, stride=strides,
                             padding=padding if isinstance(padding, int) else 0,
                             groups=groups)
        if padding == "SAME":
            mod = SamePadded(tconv)
    with torch.no_grad():
        tconv.weight.copy_(oihw(k))
        tconv.bias.copy_(torch.from_numpy(b))
    return conv, v, mod


# (features, groups, strides, padding); groups 4 of 2 input channels each, and
# a depthwise conv (groups = in_ch = 8)
CASES = [(16, 1, (1, 1), 1), (16, 4, (2, 2), "SAME"), (8, 1, (1, 1), "VALID"),
         (16, 1, (2, 2), "SAME"), (8, 1, (2, 2), 1), (8, 8, (1, 1), 1)]


@pytest.mark.parametrize("features,groups,strides,padding", CASES)
def test_quant_conv_matches_ioudet(features, groups, strides, padding):
    """Static scale, f32: the port's quantized conv equals ioudet's to f32
    roundoff, grouped convs included."""
    conv, v, mod = conv_pair(features, groups, strides, padding, seed=features)
    x = np.random.default_rng(2).normal(0, 1, (2, 10, 11, 8)).astype(np.float32)
    with jquant.quantize_calls(skip=(), act_scale=0.03):
        want = np.asarray(conv.apply(v, jnp.asarray(x)))
    with torch.no_grad(), quant.quantize_calls(mod, skip=(), act_scale=0.03):
        got = nhwc(mod(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    with torch.no_grad():
        exact = nhwc(mod(nchw(x)))
    assert 0 < np.abs(got - exact).max() < 0.1 * exact.std() + 1e-3   # quantized, and close


@pytest.mark.parametrize("features,groups,strides,padding", CASES)
def test_quant_conv_exact_on_grid(features, groups, strides, padding):
    """Weights and activations on the int8 grid, dynamic scale, no bias: the
    port's quantized conv is ioudet's bit for bit and reproduces the f32
    conv."""
    conv, v, mod = conv_pair(features, groups, strides, padding, seed=1, on_grid=True)
    rng = np.random.default_rng(1)
    x = rng.integers(-127, 128, (2, 10, 10, 8)).astype(np.float32) * 0.25
    x[0, 0, 0, 0] = 127.0 * 0.25   # pins the absmax, so the derived scale is 0.25
    with jquant.quantize_calls(skip=()):
        want = np.asarray(conv.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        with quant.quantize_calls(mod, skip=()):
            got = nhwc(mod(nchw(x)))
        exact = nhwc(mod(nchw(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-4)


def test_quant_conv_returns_the_compute_dtype():
    mod = Conv2d(8, 16, 3, padding=1, compute_dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (1, 8, 6, 6)).astype(np.float32))
    with torch.no_grad():
        y = quant.quant_conv_call(mod, x.bfloat16())
        f32 = quant.quant_conv_call(Conv2d(8, 16, 3, padding=1), x)
    assert y.dtype == torch.bfloat16 and f32.dtype == torch.float32
    assert tuple(y.shape) == (1, 16, 6, 6)


def three_pass_conv_call(mod, x, act_scale=None):
    """``quant_conv_call`` as it was before the dequantization moved into the
    product's epilogue: the int32 product, then three torch passes."""
    wmat, sw = quant.weight_matrix(mod)
    q, sx = quant._quantize_tensor(x, act_scale)
    ph, pw = quant._padding(mod)
    q = q.permute(0, 2, 3, 1)
    q = F.pad(q, (0, 0, pw, pw, ph, ph)) if ph or pw else q
    cols, ho, wo = quant.gather_windows(q.contiguous(), mod.kernel_size, mod.stride,
                                        mod.dilation)
    acc = mma_cuda.tiled_matmul(cols, wmat)
    y = acc * (sx * sw)
    if mod.bias is not None:
        y += mod.bias.detach().float()
    y = y.to(getattr(mod, "compute_dtype", torch.float32))
    return y.view(x.shape[0], ho, wo, -1).permute(0, 3, 1, 2)


@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,stride,padding,cin,bias", [
    (3, 1, 1, 8, True), (1, 1, 0, 16, False), (1, 2, 0, 16, True), (7, 2, 3, 3, False)])
def test_quant_conv_through_the_dequant_entry_is_bit_equal(kernel, stride, padding, cin,
                                                           bias, dtype, static):
    """The conv through ``tiled_matmul_dequant`` against the three passes it
    replaced, on the CPU: the same bits, f32 and bf16, with and without bias,
    static and dynamic scale."""
    torch.manual_seed(kernel * 10 + cin)
    mod = Conv2d(cin, 12, kernel, stride, padding, bias=bias, compute_dtype=dtype)
    x = torch.from_numpy(np.random.default_rng(cin).normal(0, 1, (2, cin, 13, 11))
                         .astype(np.float32)).to(dtype)
    scale = torch.tensor(0.03) if static else None
    with torch.no_grad():
        got = quant.quant_conv_call(mod, x, scale)
        want = three_pass_conv_call(mod, x, scale)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want) and float(got.float().abs().max()) > 0


@pytest.mark.parametrize("kernel,stride,dilation,channels", [
    (1, 1, 1, 16), (1, 1, 1, 5), (1, 2, 1, 16), (3, 1, 1, 3), (3, 2, 1, 16),
    (3, 1, 2, 8), (7, 2, 1, 3), ((3, 1), (1, 2), (2, 1), 4)])
def test_gather_windows_matches_unfold(kernel, stride, dilation, channels):
    """The strided window view, copied into rows of K padded to 16, against
    F.unfold of the same tensor."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(-127, 128, (2, 13, 17, channels)).astype(np.int8))
    cols, ho, wo = quant.gather_windows(q, kernel, stride, dilation)
    kh, kw = quant._pair(kernel)
    k = kh * kw * channels
    want = F.unfold(q.permute(0, 3, 1, 2).float(), (kh, kw), dilation=dilation, stride=stride)
    # unfold orders a column (C, kh, kw); the gather orders a row (kh, kw, C)
    want = want.reshape(2, channels, kh * kw, ho * wo).permute(0, 3, 2, 1).reshape(-1, k)
    assert cols.dtype == torch.int8 and cols.is_contiguous()
    assert cols.shape == (2 * ho * wo, k + -k % 16)
    assert torch.equal(cols[:, :k].float(), want) and not cols[:, k:].any()
    if (kernel, stride, channels) == (1, 1, 16):
        assert cols.data_ptr() == q.data_ptr()   # a 1x1 stride-1 conv copies nothing


# ------------------------------------------------------------- the skip list

class TwoConvFlax(jnn.Module):
    @jnn.compact
    def __call__(self, x):
        x = jnn.relu(jnn.Conv(16, (3, 3), padding=1, name="stem")(x))
        return (jnn.Conv(4, (3, 3), padding=1, name="retina_cls")(x),
                jnn.Conv(4, (3, 3), padding=1, name="branch")(x))


class TwoConv(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = Conv2d(8, 16, 3, padding=1)
        self.retina_cls = Conv2d(16, 4, 3, padding=1)
        self.branch = Conv2d(16, 4, 3, padding=1)

    def forward(self, x):
        x = F.relu(self.stem(x))
        return self.retina_cls(x), self.branch(x)


@pytest.fixture(scope="module")
def two_conv():
    m = TwoConvFlax()
    x0 = jnp.zeros((1, 8, 8, 8))
    v = m.init(jax.random.PRNGKey(5), x0)
    t = TwoConv().eval()
    with torch.no_grad():
        for name in ("stem", "retina_cls", "branch"):
            getattr(t, name).weight.copy_(oihw(v["params"][name]["kernel"]))
            getattr(t, name).bias.copy_(torch.from_numpy(np.array(v["params"][name]["bias"])))
    return m, v, t


def batches(n=3):
    rng = np.random.default_rng(4)
    return [(rng.normal(0, 1, (1, 8, 8, 8)) * s).astype(np.float32)
            for s in (1.0, 1.5, 0.7)[:n]]


def test_skip_list(two_conv):
    m, v, t = two_conv
    x = batches(1)[0]
    assert [p for p, _ in quant.eligible_convs(t)] == ["stem", "branch"]
    assert [p for p, _ in quant.eligible_convs(t, skip=())] == ["stem", "retina_cls", "branch"]
    with torch.no_grad():
        ref = t(nchw(x))
        with quant.quantize_calls(t):
            cls_q, br_q = t(nchw(x))
        with quant.quantize_calls(t, skip=()):
            cls_all, br_all = t(nchw(x))
    # branch is off the list: the same under both; retina_cls is on it
    assert torch.equal(br_q, br_all) and float((cls_q - cls_all).abs().max()) > 0.0
    assert float((cls_q - ref[0]).abs().max()) < 0.2 and float((br_q - ref[1]).abs().max()) < 0.2
    with jquant.quantize_calls():   # dynamic, default skip: against ioudet
        want = m.apply(v, jnp.asarray(x))
    for got, w in zip((cls_q, br_q), want):
        np.testing.assert_allclose(nhwc(got), np.asarray(w), rtol=0,
                                   atol=2e-6 * np.abs(np.asarray(w)).max())


@pytest.mark.parametrize("path,names", [
    ("bbox_head.cls_convs.0.conv", ("conv", "cls_convs.0")),
    ("backbone.layer1.0.downsample.0", ("downsample.0", "layer1.0")),
    ("bbox_head.retina_cls", ("retina_cls", "bbox_head")),
    ("conv1", ("conv1", "")), ("", ("", ""))])
def test_names_join_indices(path, names):
    assert quant._names(path) == names


def test_a_parent_on_the_skip_list_skips_its_convs():
    net = nn.Sequential()
    net.add_module("rpn_cls", nn.Sequential(Conv2d(4, 4, 1)))
    net.add_module("shared", ConvModule(4, 4, 3))
    assert [p for p, _ in quant.eligible_convs(net)] == ["shared.conv"]


# --------------------------------------------------------------- calibration

def test_calibrate_matches_ioudet(two_conv):
    m, v, t = two_conv
    xs = batches()
    want = jquant.calibrate(lambda x: m.apply(v, x), [jnp.asarray(x) for x in xs], margin=1.1)
    with torch.no_grad():
        got = quant.calibrate(t, t, [nchw(x) for x in xs], margin=1.1)
    assert sorted(got) == sorted(want) == ["branch", "stem"]
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-6)
    assert quant.calibrate(t, t, [torch.zeros(1, 8, 4, 4)])["stem"] == 1e-8 / 127.0


def test_static_against_dynamic(two_conv):
    """The batch with the largest absmax gives the calibrated scale, so its
    static and dynamic outputs nearly agree; both stay near f32."""
    m, v, t = two_conv
    xs = [nchw(x) for x in batches()]
    with torch.no_grad():
        scales = quant.calibrate(t, t, xs)
        ref = t(xs[1])
        with quant.quantize_calls(t, act_scale=scales):
            stat = t(xs[1])
        with quant.quantize_calls(t):
            dyn = t(xs[1])
        with quant.quantize_calls(t, act_scale=scales["stem"]):   # one scalar for all
            scalar = t(xs[1])
    for r, s, d, c in zip(ref, stat, dyn, scalar):
        assert float((s - r).abs().max()) < 0.25 and float((s - d).abs().max()) < 0.1
        assert float((c - r).abs().max()) < 0.5
    with jquant.quantize_calls(act_scale=scales):   # same keys on both sides here
        want = m.apply(v, jnp.asarray(batches()[1]))
    for got, w in zip(stat, want):
        np.testing.assert_allclose(nhwc(got), np.asarray(w), rtol=0,
                                   atol=2e-6 * np.abs(np.asarray(w)).max())


# ------------------------------------------------------- the context manager

def test_quantize_calls_leaves_the_module_untouched(two_conv):
    _, _, t = two_conv
    before = {k: v.clone() for k, v in t.state_dict().items()}
    x = nchw(batches(1)[0])
    _build.reset_launches()
    with torch.no_grad():
        ref = t(x)
        with quant.quantize_calls(t):
            assert "forward" in t.stem.__dict__ and "forward" not in t.retina_cls.__dict__
            assert list(t.state_dict()) == list(before)
            t(x)
        with pytest.raises(RuntimeError, match="boom"):
            with quant.quantize_calls(t):
                raise RuntimeError("boom")
        assert all("forward" not in m.__dict__ for m in t.modules())
        after = t(x)
    assert all(torch.equal(a, b) for a, b in zip(ref, after))
    sd = t.state_dict()
    assert list(sd) == list(before) and all(torch.equal(sd[k], before[k]) for k in sd)
    assert _build.launches["wgmma_dequant_s8"] == 0   # CPU tensors: the plain product
    assert _build.launches["tiled_matmul_s8"] == 0
