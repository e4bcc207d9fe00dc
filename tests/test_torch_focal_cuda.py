"""The CUDA focal-loss kernels against their plain torch versions on the
card (sum rtol 1e-6, dx rtol 1e-5 / atol 1e-6 in f32, 2e-2 in bf16) on the
level shapes chip_smoke.py checks, and the autograd function's gradient.
Skips without a GPU.  This file imports no JAX, so a GPU host without it
runs it as

    python -m pytest --noconftest -m cuda tests/test_torch_focal_cuda.py
"""

import pytest
import torch

import chip_smoke
from ioudet_torch.models.losses import fused_level_focal_sum
from ioudet_torch.ops import _build, focal_cuda


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _build.reset_launches()
    chip_smoke.phase_focal_kernels(focal_cuda)   # raises on a mismatch
    # per shape: 2 types x 2 layouts x (2 sums, 2 dx), then one of each in autograd
    n = len(chip_smoke.FOCAL_SHAPES)
    assert _build.launches["focal_sum_kernel"] == n * 9
    assert _build.launches["focal_dx_kernel"] == n * 9


@pytest.mark.cuda
def test_loss_entry_point_goes_through_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape = (2, 5, 7, 9, 80)
    nchw, labels, lw = chip_smoke.to_cuda(*chip_smoke.focal_case(shape))
    n = 5 * 7 * 9
    x = nchw.permute(0, 2, 3, 1).requires_grad_(True)
    _build.reset_launches()
    fused_level_focal_sum(x, labels[:, :n], lw[:, :n], 2.0, 0.25, 9).backward()
    torch.cuda.synchronize()
    assert _build.launches["focal_sum_kernel"] == 1
    assert _build.launches["focal_dx_kernel"] == 1
    assert bool(torch.isfinite(x.grad).all())


@pytest.mark.cuda
def test_sum_kernel_on_the_p3_view_is_one_wave_and_deterministic():
    """K3a on the flagship's P3 view at batch 2: runs of 4 f32, the grid the
    planner gives for the blocks an SM holds (at most one wave), the same bits
    twice, within 1e-6 of plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape = (2, 104, 168, 9, 80)
    n = 104 * 168 * 9
    nchw, labels, lw = chip_smoke.to_cuda(*chip_smoke.focal_case(shape, seed=1))
    x, labels, lw = nchw.permute(0, 2, 3, 1), labels[:, 5:5 + n], lw[:, 5:5 + n]
    plan = focal_cuda.sum_launch_plan(x, 9, 2.0)
    assert plan["vec"] == 4 and plan["resident"] >= 1
    assert plan["sms"] == torch.cuda.get_device_properties(0).multi_processor_count
    assert (plan["chunk"], plan["blocks"]) == focal_cuda.sum_plan(shape, 4, plan["sms"],
                                                                  plan["resident"])
    assert plan["blocks"] <= plan["sms"] * plan["resident"]
    _build.reset_launches()
    first = focal_cuda.focal_level_sum(x, labels, lw, 2.0, 0.25, 9)
    second = focal_cuda.focal_level_sum(x, labels, lw, 2.0, 0.25, 9)
    torch.cuda.synchronize()
    assert _build.launches["focal_sum_kernel"] == 2
    assert torch.equal(first, second)
    want = focal_cuda.focal_level_sum_plain(x, labels, lw, 2.0, 0.25, 9)
    torch.testing.assert_close(first, want, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_dx_kernel_on_the_p3_view_is_one_wave_and_deterministic():
    """K3b on the flagship's P3 view at batch 2: runs of 4 f32, the grid the
    planner gives for the blocks an SM holds (at most one wave), the same bits
    twice, within rtol 1e-5 / atol 1e-6 of plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape = (2, 104, 168, 9, 80)
    n = 104 * 168 * 9
    nchw, labels, lw = chip_smoke.to_cuda(*chip_smoke.focal_case(shape, seed=1))
    x, labels, lw = nchw.permute(0, 2, 3, 1), labels[:, 5:5 + n], lw[:, 5:5 + n]
    g = torch.full((), 3.0, device="cuda")
    plan = focal_cuda.dx_launch_plan(x, torch.empty_like(x), 9, 2.0)
    assert plan["vec"] == 4 and plan["resident"] >= 1
    assert plan["sms"] == torch.cuda.get_device_properties(0).multi_processor_count
    assert (plan["chunk"], plan["blocks"]) == focal_cuda.sum_plan(shape, 4, plan["sms"],
                                                                  plan["resident"])
    assert plan["blocks"] <= plan["sms"] * plan["resident"]
    _build.reset_launches()
    first = focal_cuda.focal_level_dx(g, x, labels, lw, 2.0, 0.25, 9)
    second = focal_cuda.focal_level_dx(g, x, labels, lw, 2.0, 0.25, 9)
    torch.cuda.synchronize()
    assert _build.launches["focal_dx_kernel"] == 2
    assert first.stride() == x.stride() and torch.equal(first, second)
    want = focal_cuda.focal_level_dx_plain(g, x, labels, lw, 2.0, 0.25, 9)
    torch.testing.assert_close(first, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma, alpha", [(0.5, 0.25), (1.5, 0.5), (3.0, 0.75)])
def test_sum_kernel_with_other_gammas(gamma, alpha):
    """The kernels' instances for gamma != 2 (pt ** gamma through powf) on
    runs of 4 and of 1: the sum within 1e-6 of plain, dx (for gamma >= 1,
    where d pt ** gamma / d pt is bounded) within 1e-5 / 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for shape in ((2, 26, 42, 9, 80), (2, 13, 21, 9, 80)):
        b, h, w, a, c = shape
        n = h * w * a
        nchw, labels, lw = chip_smoke.to_cuda(*chip_smoke.focal_case(shape, seed=h))
        x, labels, lw = nchw.permute(0, 2, 3, 1), labels[:, 5:5 + n], lw[:, 5:5 + n]
        got = focal_cuda.focal_level_sum(x, labels, lw, gamma, alpha, a)
        want = focal_cuda.focal_level_sum_plain(x, labels, lw, gamma, alpha, a)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
        if gamma >= 1.0:
            dx = focal_cuda.focal_level_dx(2.0, x, labels, lw, gamma, alpha, a)
            dx_want = focal_cuda.focal_level_dx_plain(2.0, x, labels, lw, gamma, alpha, a)
            torch.testing.assert_close(dx, dx_want, rtol=1e-5, atol=1e-6)
