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
