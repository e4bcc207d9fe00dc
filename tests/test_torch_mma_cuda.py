"""The CUDA tensor-core kernels (chain, accumulate and tiled products, int8
and bf16, the tiled one through its wgmma and its mma.sync kernel) against
their plain torch versions on the card, on the cases chip_smoke.py checks
(int8 bit-equal; bf16 within the limits stated there; the wgmma kernel's edge
shapes and its dequantize epilogue), and the quantized convolution through
that epilogue.  Skips without a GPU.  This file imports no JAX, so a GPU host without it runs it as

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
    assert err["wgmma_matmul_s8"] == err["wgmma_dequant_s8"] == 0.0
    n = len(chip_smoke.MMA_SHAPES)
    # the mma.sync kernel at every shape and again where the wrapper chooses it
    odd_s8 = sum(k % 16 != 0 for _, _, k in chip_smoke.MMA_SHAPES)
    odd_bf16 = sum(2 * k % 16 != 0 for _, _, k in chip_smoke.MMA_SHAPES)
    edges = sum(len(ms) * len(ns) * len(ks) for ms, ns, ks in chip_smoke.WGMMA_EDGES)
    assert _build.launches["tiled_matmul_s8"] == n + odd_s8
    assert _build.launches["tiled_matmul_bf16"] == n + odd_bf16
    assert _build.launches["wgmma_matmul_s8"] == n - odd_s8 + edges
    assert _build.launches["wgmma_matmul_bf16"] == n - odd_bf16 + edges
    assert _build.launches["wgmma_dequant_s8"] == 4 * len(chip_smoke.DEQUANT_SHAPES)
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
    with pytest.raises(ValueError):   # the dequantize epilogue needs TMA's alignment
        mma_cuda.tiled_matmul_dequant(odd, odd, torch.ones(8, device="cuda"))
    with pytest.raises(ValueError):
        mma_cuda.tiled_matmul_dequant(a, a, torch.ones(8))        # scale on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["whole", "offset rows", "offset bytes"])
def test_the_route_follows_the_operands(view):
    """16-byte aligned operands take the wgmma kernel; a view that starts off
    the 16-byte grid takes the mma.sync kernel; both give the plain product."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    a, b_t = chip_smoke.mma_operands(301, 70, 160, torch.int8, seed=1)
    if view == "offset rows":      # still aligned: rows are 160 bytes
        a = a[5:]
    elif view == "offset bytes":   # a contiguous copy placed 8 bytes into a buffer
        buf = torch.empty(a.numel() + 8, dtype=torch.int8, device="cuda")
        buf[8:] = a.reshape(-1)
        a = buf[8:].view(a.shape)
    _build.reset_launches()
    out = mma_cuda.tiled_matmul(a, b_t)
    torch.cuda.synchronize()
    assert torch.equal(out, mma_cuda.tiled_matmul_plain(a, b_t))
    new, old = _build.launches["wgmma_matmul_s8"], _build.launches["tiled_matmul_s8"]
    assert (new, old) == ((0, 1) if view == "offset bytes" else (1, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride,padding,cin", [(3, 1, 1, 64), (1, 1, 0, 64),
                                                       (1, 2, 0, 64), (7, 2, 3, 3)])
def test_quantized_conv_goes_through_the_kernel(kernel, stride, padding, cin):
    """The same conv on the card (the wgmma kernel's dequantize epilogue) and
    on the CPU (plain product and three torch passes): the int32 accumulators
    are exact, every scale is a tensor and the epilogue rounds where the
    passes do, so the two agree to the last bit."""
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
    assert _build.launches["wgmma_dequant_s8"] == 1
    assert _build.launches["tiled_matmul_s8"] == 0
    assert torch.equal(got.cpu(), want)
