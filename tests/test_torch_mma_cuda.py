"""The CUDA tensor-core kernels (chain, accumulate and tiled products, int8
and bf16; the tiled one through its wgmma kernel, TMA-fed or, for operands
off the 16-byte grid, fed through registers, and through the mma.sync kernel;
the chain and the accumulate through their wgmma cluster kernels and the
mma.sync ones) against their
plain torch versions on the card, on the cases chip_smoke.py checks (int8
bit-equal; bf16 within the limits stated there; the wgmma kernels' edge
shapes and the dequantize epilogue), the quantized convolution through that
epilogue and the probe tool's launches.  Skips without a GPU.  This file imports no JAX, so a GPU host without it runs it as

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
    assert err["wgmma_accum_s8"] == 0.0
    assert err["wgmma_matmul_s8"] == err["wgmma_dequant_s8"] == 0.0
    assert err["wgmma_unaligned_s8"] == err["wgmma_chain_s8"] == 0.0
    n = len(chip_smoke.MMA_SHAPES)
    # the mma.sync kernel at every shape, then the wgmma kernel the wrapper chooses
    odd_s8 = sum(k % 16 != 0 for _, _, k in chip_smoke.MMA_SHAPES)
    odd_bf16 = sum(2 * k % 16 != 0 for _, _, k in chip_smoke.MMA_SHAPES)
    edges = sum(len(ms) * len(ns) * len(ks) for ms, ns, ks in chip_smoke.WGMMA_EDGES)
    ms, ns, kbytes = chip_smoke.UNALIGNED_EDGES
    offsets = chip_smoke.UNALIGNED_OFFSETS
    unaligned_s8 = len(ms) * len(ns) * len(kbytes) + 3 * len(offsets)
    unaligned_bf16 = (len(ms) * len(ns) * sum(kb % 2 == 0 for kb in kbytes) +
                      2 * sum(off % 2 == 0 for off in offsets))   # K 160 and 2048 bytes
    assert _build.launches["tiled_matmul_s8"] == n
    assert _build.launches["tiled_matmul_bf16"] == n
    assert _build.launches["wgmma_matmul_s8"] == n - odd_s8 + edges
    assert _build.launches["wgmma_matmul_bf16"] == n - odd_bf16 + edges
    assert _build.launches["wgmma_unaligned_s8"] == odd_s8 + unaligned_s8
    assert _build.launches["wgmma_unaligned_bf16"] == odd_bf16 + unaligned_bf16
    assert _build.launches["wgmma_dequant_s8"] == 4 * len(chip_smoke.DEQUANT_SHAPES)
    chains = len(chip_smoke.CHAIN_SHAPES) * len(chip_smoke.CHAIN_LOOPS)
    live = chip_smoke.LIVE_LOOP   # the live bf16 chain, one launch a step count
    assert _build.launches["wgmma_chain_s8"] == chains
    assert _build.launches["wgmma_chain_bf16"] == chains + live
    # the mma.sync chain: loops (0, 1, 2, 3, 64), (1, 2, 3) and (1, 2, 3, 64) at three shapes
    assert _build.launches["chain_matmul_s8"] == 12
    assert _build.launches["chain_matmul_bf16"] == 12 + live
    # the accumulate: every edge case and the unaligned one at each loop count
    # through both kernels, the one-hot b_t at loops 64 and 300 through both,
    # the probe shape twice through the wgmma kernel and once through the mma.sync one
    ms, ns, kbytes = chip_smoke.ACCUM_EDGES
    accum = len(ms) * len(ns) * len(kbytes) + len(chip_smoke.ACCUM_LOOPS) + 2
    for t in ("s8", "bf16"):
        assert _build.launches[f"accum_matmul_{t}"] == accum + 1
        assert _build.launches[f"wgmma_accum_{t}"] == accum + 2


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
    with pytest.raises(ValueError):   # the mma.sync chain: K a multiple of 64 bytes
        mma_cuda.chain_matmul_mma_sync(odd, torch.ones(40, 40, dtype=torch.int8, device="cuda"), 1)
    for k in (40, 64, 200, 8192):      # the wgmma chain: K = cs x 128 or cs x 256, cs <= 16
        with pytest.raises(ValueError):
            mma_cuda.chain_matmul(torch.ones(8, k, dtype=torch.int8, device="cuda"),
                                  torch.ones(k, k, dtype=torch.int8, device="cuda"), 1)
    with pytest.raises(ValueError):   # the dequantize epilogue needs TMA's alignment
        mma_cuda.tiled_matmul_dequant(odd, odd, torch.ones(8, device="cuda"))
    with pytest.raises(ValueError):
        mma_cuda.tiled_matmul_dequant(a, a, torch.ones(8))        # scale on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["whole", "offset rows", "offset bytes"])
def test_the_route_follows_the_operands(view):
    """16-byte aligned operands take the TMA-fed wgmma kernel; a view that
    starts off the 16-byte grid takes the one fed through registers; both give
    the plain product, and the mma.sync kernel is not launched."""
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
    tma, regs = _build.launches["wgmma_matmul_s8"], _build.launches["wgmma_unaligned_s8"]
    assert (tma, regs) == ((0, 1) if view == "offset bytes" else (1, 0))
    assert _build.launches["tiled_matmul_s8"] == 0


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


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [4, 64])
def test_grouped_quantized_conv_goes_through_the_kernel(groups):
    """A grouped conv (4 groups; depthwise) on the card and on the CPU: one
    dequantize launch a group, the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(groups)
    conv = Conv2d(64, 64, 3, 1, 1, groups=groups)
    x = torch.from_numpy(rng.normal(0, 1, (2, 64, 37, 41)).astype(np.float32))
    scale = torch.tensor(0.03)
    with torch.no_grad():
        want = quant.quant_conv_call(conv, x, scale)
        _build.reset_launches()
        got = quant.quant_conv_call(conv.cuda(), x.cuda(), scale.cuda())
        torch.cuda.synchronize()
    assert _build.launches["wgmma_dequant_s8"] == groups
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_probe_launches_the_wgmma_kernels():
    """The probe tool's chain and unaligned questions run on the wgmma
    kernels, and the mma.sync kernels they replaced are not launched
    (chip_smoke's phase asserts the counts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    counts = chip_smoke.phase_probe(_build)
    assert counts["wgmma_chain_s8"] > 0 and counts["wgmma_unaligned_bf16"] > 0
    assert counts["wgmma_accum_s8"] > 0 and counts["wgmma_accum_bf16"] > 0
    assert counts["chain_matmul_s8"] == counts["tiled_matmul_bf16"] == 0
    assert counts["accum_matmul_s8"] == counts["accum_matmul_bf16"] == 0


@pytest.mark.cuda
def test_accum_probe_shape_goes_through_the_wgmma_kernel():
    """The probe's accumulate, (512, 2048) x (2048, 2048) loop 64 in int8,
    launches the wgmma accumulate kernel once (K split over a cluster) and
    not the mma.sync one, and is bit-equal to the plain sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    m, k, n = chip_smoke.PROBE_MKN
    a, b_t = chip_smoke.mma_operands(m, n, k, torch.int8, seed=3, amp=1.0)
    _build.reset_launches()
    out = mma_cuda.accum_matmul(a, b_t, 64)
    torch.cuda.synchronize()
    assert _build.launches["wgmma_accum_s8"] == 1 and _build.launches["accum_matmul_s8"] == 0
    assert torch.equal(out, mma_cuda.accum_matmul_plain(a, b_t, 64))
    plan = mma_cuda.accum_plan(m, n, k, mma_cuda.num_sms(a.device),
                               mma_cuda.accum_fits(a.device, torch.int8))
    assert plan[1] > 1
