"""Port parity of the fused focal loss: the plain versions of the kernels
(ioudet_torch/ops/focal_cuda.py, what the wrappers run on CPU tensors) and
the autograd function against ioudet's Pallas pair (interpret mode on the
CPU) and against _fused_focal_sum_impl with jax.grad.

Tolerances, as tests/test_focal_pallas.py: the sum rtol 1e-6 (another
reduction order), dx rtol 1e-5 / atol 1e-6 in f32, and 2e-2 for bf16 outputs
(one bf16 rounding of slightly different f32 values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import focal_case
from ioudet.models.losses.focal_loss import _fused_focal_sum_impl
from ioudet.models.losses.focal_loss import fused_level_focal_sum as jax_fused
from ioudet.ops.focal_pallas import focal_level_dx as jax_dx
from ioudet.ops.focal_pallas import focal_level_sum as jax_sum
from ioudet_torch.models.losses import fused_level_focal_sum
from ioudet_torch.ops import focal_cuda
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

SHAPES = [(2, 6, 9, 3, 7), (3, 5, 7, 9, 80)]   # (B, H, W, A, C); the second is ragged
DX_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
          torch.bfloat16: dict(rtol=2e-2, atol=1e-6)}


def level(shape, dtype=torch.float32, layout="view"):
    """The port's inputs (logits as the permuted NCHW view the heads return,
    or contiguous; labels and lw as slices of wider tensors) and ioudet's."""
    b, h, w, a, c = shape
    nchw, labels_all, lw_all = focal_case(shape, seed=h)
    n = h * w * a
    x = torch.from_numpy(nchw).to(dtype).permute(0, 2, 3, 1)
    if layout == "contiguous":
        x = x.contiguous()
    ours = (x, torch.from_numpy(labels_all)[:, 5:5 + n], torch.from_numpy(lw_all)[:, 5:5 + n])
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = (jnp.asarray(np.transpose(nchw, (0, 2, 3, 1)), jdtype),
           jnp.asarray(labels_all[:, 5:5 + n]), jnp.asarray(lw_all[:, 5:5 + n]))
    return ours, ref, a


@pytest.mark.parametrize("layout", ["view", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_sum_and_dx_match_pallas(shape, dtype, layout):
    ours, ref, a = level(shape, dtype, layout)
    got = focal_cuda.focal_level_sum(*ours, 2.0, 0.25, a)
    np.testing.assert_allclose(float(got), float(jax_sum(*ref, 2.0, 0.25, a)), rtol=1e-6)
    np.testing.assert_allclose(
        float(got), float(_fused_focal_sum_impl(*ref, 2.0, 0.25, a)), rtol=1e-6)
    for g in (1.0, 3.0):
        dx = focal_cuda.focal_level_dx(g, *ours, 2.0, 0.25, a)
        assert dx.dtype == dtype and dx.stride() == ours[0].stride()
        want = jax_dx(jnp.float32(g), *ref, 2.0, 0.25, a)
        np.testing.assert_allclose(dx.float().numpy(), np.asarray(want, np.float32),
                                   **DX_TOL[dtype])


@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_function_matches_jax_grad(shape):
    """The gradient the train path takes (FusedLevelFocalSum.backward) against
    jax.grad of the straightforward jnp expression and of ioudet's custom_vjp."""
    ours, ref, a = level(shape)
    x = ours[0].clone().requires_grad_(True)   # keeps the view's strides
    loss = 2.0 * fused_level_focal_sum(x, ours[1], ours[2], 2.0, 0.25, a)
    loss.backward()
    assert x.grad.shape == x.shape
    for fn in (_fused_focal_sum_impl, jax_fused):
        val, grad = jax.value_and_grad(lambda z: 2.0 * fn(z, ref[1], ref[2], 2.0, 0.25, a))(ref[0])
        np.testing.assert_allclose(float(loss.detach()), float(val), rtol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-6)


def test_dx_equals_autograd_through_the_plain_sum():
    ours, _, a = level(SHAPES[1])
    x = ours[0].clone().requires_grad_(True)
    focal_cuda.focal_level_sum_plain(x, ours[1], ours[2], 2.0, 0.25, a).backward()
    dx = focal_cuda.focal_level_dx_plain(1.0, ours[0], ours[1], ours[2], 2.0, 0.25, a)
    torch.testing.assert_close(dx, x.grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("gamma,alpha", [(1.0, 0.5), (1.5, 0.25), (0.0, 0.75)])
def test_other_gammas(gamma, alpha):
    """pt ** gamma and pt ** (gamma - 1) away from gamma = 2, saturated
    logits included (pt reaches 0 and 1 in f32)."""
    ours, ref, a = level(SHAPES[0])
    ours = (ours[0] * 12.0, *ours[1:])
    ref = (ref[0] * 12.0, *ref[1:])
    got = focal_cuda.focal_level_sum(*ours, gamma, alpha, a)
    np.testing.assert_allclose(
        float(got), float(_fused_focal_sum_impl(*ref, gamma, alpha, a)), rtol=1e-6)
    if gamma >= 1.0:  # below 1 the derivative of pt ** gamma is unbounded at pt = 0
        dx = focal_cuda.focal_level_dx(1.0, *ours, gamma, alpha, a)
        np.testing.assert_allclose(dx.numpy(), np.asarray(
            jax_dx(jnp.float32(1.0), *ref, gamma, alpha, a)), rtol=1e-5, atol=1e-6)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    (x, labels, lw), _, a = level(SHAPES[0])
    with pytest.raises(ValueError):
        focal_cuda.focal_level_sum(x.double(), labels, lw, 2.0, 0.25, a)
    with pytest.raises(ValueError):
        focal_cuda.focal_level_sum(x, labels.long(), lw, 2.0, 0.25, a)
    with pytest.raises(ValueError):
        focal_cuda.focal_level_sum(x, labels[:, 1:], lw[:, 1:], 2.0, 0.25, a)
    with pytest.raises(ValueError):
        focal_cuda.focal_level_dx(1.0, x, labels, lw, 2.0, 0.25, a + 1)

