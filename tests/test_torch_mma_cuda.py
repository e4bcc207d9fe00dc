"""The CUDA tensor-core kernels (chain, accumulate and tiled products, int8
and bf16) against their plain torch versions on the card, on the cases
chip_smoke.py checks (int8 bit-equal; bf16 within the limits stated there),
and the quantized convolution through the tiled int8 kernel.  Skips without a
GPU.  This file imports no JAX, so a GPU host without it runs it as

    python -m pytest --noconftest -m cuda tests/test_torch_mma_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ioudet_torch.models.utils.layers import Conv2d
from ioudet_torch.ops import _build, mma_cuda, quant


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _build.reset_launches()
    err = chip_smoke.phase_mma_kernels(mma_cuda)   # raises on a mismatch
    assert err["tiled_matmul_s8"] == err["chain_matmul_s8"] == err["accum_matmul_s8"] == 0.0
    n = len(chip_smoke.MMA_SHAPES)
    assert _build.launches["tiled_matmul_s8"] == n
    assert _build.launches["tiled_matmul_bf16"] == n
    assert _build.launches["chain_matmul_s8"] == 3 * 5     # three shapes x five loop counts
    assert _build.launches["chain_matmul_bf16"] == 3 * 3
    assert _build.launches["accum_matmul_s8"] == 3 * 3
    assert _build.launches["accum_matmul_bf16"] == 3 * 3


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    a = torch.ones(8, 64, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):
        mma_cuda.tiled_matmul(a.t(), a.t())                       # not contiguous
    with pytest.raises(ValueError):
        mma_cuda.tiled_matmul(a, a.cpu())                         # two devices
    odd = torch.ones(8, 40, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):
        mma_cuda.chain_matmul(odd, torch.ones(40, 40, dtype=torch.int8, device="cuda"), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride,padding,cin", [(3, 1, 1, 64), (1, 1, 0, 64),
                                                       (1, 2, 0, 64), (7, 2, 3, 3)])
def test_quantized_conv_goes_through_the_kernel(kernel, stride, padding, cin):
    """The same conv on the card (tiled int8 kernel) and on the CPU (plain
    product): the int32 accumulators are exact and every scale is a tensor,
    so the two agree to the last f32 bit of the dequantization."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(0)
    conv = Conv2d(cin, 32, kernel, stride, padding)
    x = torch.from_numpy(rng.normal(0, 1, (2, cin, 37, 41)).astype(np.float32))
    scale = torch.tensor(0.03)
    with torch.no_grad():
        want = quant.quant_conv_call(conv, x, scale)
        _build.reset_launches()
        got = quant.quant_conv_call(conv.cuda(), x.cuda(), scale.cuda())
        torch.cuda.synchronize()
    assert _build.launches["tiled_matmul_s8"] == 1
    assert torch.equal(got.cpu(), want)
