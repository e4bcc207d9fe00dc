"""The port's deformable conv (``ioudet_torch/ops/deform_conv.py``) against
``ioudet.ops.deform_conv2d`` on the same seeded numpy inputs.

Tolerances: the output within 1e-5 of the largest |output| (f32 sums over
Cin*K taps in another order; the taps themselves are bit-equal), the
gradients within 1e-4 of the largest |gradient| (x's goes through a
scatter-add in another order).  Random offsets are drawn at least 0.05 away
from integers, where ``floor`` decides a corner.  Zero and integer offsets
sample exact pixels: the output is F.conv2d's bit for bit (oneDNN off, so
that F.conv2d is the same unfold-and-product)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ioudet.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from ioudet_torch.ops.deform_conv import DeformConv, deform_conv2d, sample_taps
from tests.torch_twins import one_thread  # noqa: F401 (autouse)


def case(stride, dilation=1, b=2, c=5, h=9, w=11, o=7, seed=0):
    """NHWC inputs as ``ioudet`` takes them: offsets reaching 4 px out of the
    image both ways, their fractions in [0.05, 0.95]."""
    rng = np.random.default_rng(seed)
    # a 3x3 padded by its dilation keeps the size before the stride
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    kernel = rng.normal(0, 1, (3, 3, c, o)).astype(np.float32)
    whole = rng.integers(-4, 4, (b, ho, wo, 18))
    offsets = (whole + 0.05 + 0.9 * rng.random((b, ho, wo, 18))).astype(np.float32)
    mask = rng.uniform(0, 1, (b, ho, wo, 9)).astype(np.float32)
    bias = rng.normal(0, 1, (o,)).astype(np.float32)
    return x, offsets, kernel, mask, bias


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_forward_matches_ioudet(stride, dilation, modulated):
    x, offsets, kernel, mask, bias = case(stride, dilation, seed=stride + 3 * dilation)
    m = mask if modulated else None
    ref = np.asarray(jax_deform_conv2d(
        jnp.asarray(x), jnp.asarray(offsets), jnp.asarray(kernel), bias=jnp.asarray(bias),
        mask=None if m is None else jnp.asarray(m), stride=stride, dilation=dilation))
    out = deform_conv2d(nchw(x), nchw(offsets), oihw(kernel), torch.from_numpy(bias),
                        None if m is None else nchw(m), stride, dilation)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("stride", [1, 2])
def test_zero_and_integer_offsets_are_the_plain_conv(stride):
    x, offsets, kernel, _, _ = case(stride, seed=10 + stride)
    xt, wt = nchw(x), oihw(kernel)
    zero = torch.zeros(nchw(offsets).shape)
    with torch.backends.mkldnn.flags(enabled=False):
        assert torch.equal(deform_conv2d(xt, zero, wt, stride=stride),
                           F.conv2d(xt, wt, stride=stride, padding=1))
        # every tap moved by (dy, dx) = (2, -1): the plain conv of the shifted image
        shift = zero.view(zero.shape[0], 9, 2, *zero.shape[2:]).clone()
        shift[:, :, 0], shift[:, :, 1] = 2.0, -1.0
        # on the zero-padded image: moved[u, v] = padded[u + 2, v - 1]
        moved = F.pad(F.pad(xt, (1, 1, 1, 1)), (1, 0, 0, 2))[:, :, 2:, :-1]
        assert torch.equal(deform_conv2d(xt, shift.view(zero.shape), wt, stride=stride),
                           F.conv2d(moved, wt, stride=stride))


def test_integer_offsets_sample_exact_pixels():
    """Random integer offsets, in and out of the image: each tap is the
    pixel it names, or 0 outside."""
    x, offsets, _, mask, _ = case(2, seed=20)
    b, h, w, c = x.shape
    ho, wo = offsets.shape[1:3]
    whole = np.floor(offsets)
    taps = sample_taps(nchw(x), nchw(whole.astype(np.float32)), (3, 3), 2, 1,
                       nchw(mask)).numpy()
    ref = np.zeros((b, c, 9, ho, wo), np.float32)
    for i in range(b):
        for k in range(9):
            for y in range(ho):
                for xx in range(wo):
                    sy = int(y * 2 + k // 3 - 1 + whole[i, y, xx, 2 * k])
                    sx = int(xx * 2 + k % 3 - 1 + whole[i, y, xx, 2 * k + 1])
                    if 0 <= sy < h and 0 <= sx < w:
                        ref[i, :, k, y, xx] = x[i, sy, sx] * mask[i, y, xx, k]
    np.testing.assert_array_equal(taps, ref)


@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_gradients_match_jax_grad(stride, modulated):
    x, offsets, kernel, mask, _ = case(stride, seed=30 + stride)
    rng = np.random.default_rng(40 + stride)
    ho, wo = offsets.shape[1:3]
    cot = rng.normal(0, 1, (x.shape[0], ho, wo, kernel.shape[3])).astype(np.float32)

    def jax_loss(x, offsets, kernel, mask):
        out = jax_deform_conv2d(x, offsets, kernel, mask=mask if modulated else None,
                                stride=stride)
        return jnp.sum(out * cot)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(offsets), jnp.asarray(kernel), jnp.asarray(mask))
    leaves = [nchw(x), nchw(offsets), oihw(kernel), nchw(mask)]
    for t in leaves:
        t.requires_grad_(True)
    out = deform_conv2d(leaves[0], leaves[1], leaves[2],
                        mask=leaves[3] if modulated else None, stride=stride)
    (out * nchw(cot)).sum().backward()
    if not modulated:
        assert leaves[3].grad is None and not np.asarray(ref[3]).any()
    ours = [leaves[0].grad.permute(0, 2, 3, 1), leaves[1].grad.permute(0, 2, 3, 1),
            leaves[2].grad.permute(2, 3, 1, 0)]
    if modulated:
        ours.append(leaves[3].grad.permute(0, 2, 3, 1))
    for name, g, r in zip(("x", "offsets", "kernel", "mask"), ours, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)


def test_module_casts_to_its_compute_dtype():
    """``DeformConv`` casts x, offsets, mask and its f32 weight to
    ``compute_dtype`` and returns the product in f32, as ``ioudet``'s
    bottleneck casts its kernel and takes ``preferred_element_type``."""
    x, offsets, kernel, mask, _ = case(1, seed=50)
    mod = DeformConv(x.shape[3], kernel.shape[3], compute_dtype=torch.bfloat16)
    with torch.no_grad():
        mod.weight.copy_(oihw(kernel))
    out = mod(nchw(x), nchw(offsets), nchw(mask))
    bf = [t.to(torch.bfloat16) for t in (nchw(x), nchw(offsets), oihw(kernel), nchw(mask))]
    assert mod.weight.dtype == torch.float32 and out.dtype == torch.float32
    assert torch.equal(out, deform_conv2d(bf[0], bf[1], bf[2], mask=bf[3]))
