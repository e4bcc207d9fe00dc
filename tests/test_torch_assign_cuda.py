"""The CUDA anchor-assignment kernels against their plain torch versions on
the card: bit for bit, dw/dh to 1e-6, on the adversarial cases chip_smoke.py
checks.  Skips without a GPU.  This file imports no JAX, so a GPU host
without it runs it as

    python -m pytest --noconftest -m cuda tests/test_torch_assign_cuda.py
"""

import pytest
import torch

import chip_smoke
from ioudet_torch.ops import _build, assign_cuda


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _build.reset_launches()
    err = chip_smoke.phase_assign_kernels(assign_cuda)   # raises on a mismatch
    assert err["assign_gtmax_kernel"] == 0.0 and err["assign_targets_kernel"] <= 1e-6
    # two runs of each kernel per case: (shapes + grid cases) x settings x gts_valid
    cases = (len(chip_smoke.ASSIGN_SHAPES) + len(chip_smoke.GRID_CASES)) * 2 * 2
    assert _build.launches["assign_gtmax_kernel"] == 2 * cases
    assert _build.launches["assign_targets_kernel"] == 2 * cases


@pytest.mark.cuda
def test_fused_anchor_assign_launches_both_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    anchors, valid, gt, gtv, gtl = chip_smoke.to_cuda(*chip_smoke.assign_case(2, 9000, 17))
    _build.reset_launches()
    outs = assign_cuda.fused_anchor_assign(anchors, valid, gt, gtv, gtl, 0.5, 0.4)
    torch.cuda.synchronize()
    assert _build.launches["assign_gtmax_kernel"] == 1
    assert _build.launches["assign_targets_kernel"] == 1
    cpu = assign_cuda.fused_anchor_assign(anchors.cpu(), valid.cpu(), gt.cpu(), gtv.cpu(),
                                          gtl.cpu(), 0.5, 0.4)
    for o, c in zip(outs[:3] + outs[4:], cpu[:3] + cpu[4:]):
        assert torch.equal(o.cpu(), c)
    torch.testing.assert_close(outs[3].cpu(), cpu[3], rtol=0.0, atol=1e-6)
