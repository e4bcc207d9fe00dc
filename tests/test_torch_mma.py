"""The plain versions of the port's three tensor-core products
(ioudet_torch/ops/mma_cuda.py) against the bodies of the TPU kernels they
replace, run in Pallas interpret mode on the CPU: tools/probe_mxu_rate.py
(P1, chain), tools/probe_mxu_rate2.py (P2, accumulate) and
tools/probe_pallas_int8_matmul.py (P3, tiled), on the same numpy-seeded
operands.  The tools have no interpret switch and are not edited: the test
sets their module global LOOP and wraps their kernel bodies in its own
pallas_call.

Tolerances.  int8: exact everywhere (int32 accumulators).  bf16: products of
two bf16 values are exact in f32, so the two sides differ only in the order of
the f32 sum: 1e-5 of the largest sum of |a| |b| for P2 and P3; P1 rounds y to
bf16 after every step, so a sum on a rounding boundary moves y by one bf16
step: 2^-7 relative plus 1e-3 of the largest |y|, at loop <= 3 (the values
shrink a hundredfold a step and a longer chain compares zeros).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ioudet_torch.ops import _build, mma_cuda

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)
import probe_mxu_rate as p1  # noqa: E402
import probe_mxu_rate2 as p2  # noqa: E402
import probe_pallas_int8_matmul as p3  # noqa: E402
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

sys.path.remove(TOOLS)

SHAPES = [(16, 64, 64), (24, 96, 96)]   # (M, K, N), N == K so that P1 chains


def operands(m, k, n, kind, seed=0):
    """a (m, k) and b (k, n) as the probes make them, as numpy: int8 or
    float32 values that bf16 holds exactly."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    if kind == "int8":
        return (np.clip(np.round(x * 3), -127, 127).astype(np.int8),
                np.clip(np.round(w / np.abs(w).max() * 127), -127, 127).astype(np.int8))
    return (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)),
            np.asarray(jnp.asarray(w * 0.02, jnp.bfloat16).astype(jnp.float32)))


def to_jax(a, kind):
    return jnp.asarray(a, jnp.int8 if kind == "int8" else jnp.bfloat16)


def to_torch(a, kind):
    t = torch.from_numpy(np.array(a))   # a writable, contiguous copy
    return t if kind == "int8" else t.bfloat16()


def as_f32(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


def abs_product(a, b):
    return float((np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))).max())


@pytest.mark.parametrize("kind", ["int8", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + [(7, 33, 5)])
def test_tiled_matmul_matches_pallas_body(kind, shape):
    m, k, n = shape
    a, b = operands(m, k, n, kind, seed=m)
    acc = jnp.int32 if kind == "int8" else jnp.float32
    want = pl.pallas_call(functools.partial(p3._mm_kernel, acc_dtype=acc),
                          out_shape=jax.ShapeDtypeStruct((m, n), acc),
                          interpret=True)(to_jax(a, kind), to_jax(b, kind))
    got = mma_cuda.tiled_matmul(to_torch(a, kind), to_torch(b.T, kind))
    assert got.dtype == (torch.int32 if kind == "int8" else torch.float32)
    if kind == "int8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * abs_product(a, b))


@pytest.mark.parametrize("loop", [1, 2, 3])
@pytest.mark.parametrize("kind", ["int8", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_chain_matmul_matches_pallas_body(monkeypatch, kind, shape, loop):
    m, k, n = shape
    a, b = operands(m, k, n, kind, seed=loop)
    monkeypatch.setattr(p1, "LOOP", loop)
    body, dt = (p1._int8_kernel, jnp.int8) if kind == "int8" else (p1._bf16_kernel, jnp.bfloat16)
    want = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((m, n), dt),
                          interpret=True)(to_jax(a, kind), to_jax(b, kind))
    got = mma_cuda.chain_matmul(to_torch(a, kind), to_torch(b.T, kind), loop, 0.01)
    assert got.dtype == (torch.int8 if kind == "int8" else torch.bfloat16)
    if kind == "int8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert np.abs(got.numpy()).max() > 0
    else:
        w = as_f32(want)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(as_f32(got), w, rtol=2 ** -7, atol=1e-3 * np.abs(w).max())


def test_chain_matmul_int8_long_chain_saturates_and_matches(monkeypatch):
    """At the probe's own loop count the int8 chain is still exact: it
    saturates at +-127 instead of dying out."""
    m, k, n = SHAPES[0]
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    monkeypatch.setattr(p1, "LOOP", 64)
    want = pl.pallas_call(p1._int8_kernel, out_shape=jax.ShapeDtypeStruct((m, n), jnp.int8),
                          interpret=True)(jnp.asarray(a), jnp.asarray(b))
    got = mma_cuda.chain_matmul(torch.from_numpy(a), torch.from_numpy(b.T.copy()), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.abs(got.numpy()) == 127).any()


@pytest.mark.parametrize("loop", [1, 3, 9, 64])
@pytest.mark.parametrize("kind", ["int8", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_accum_matmul_matches_pallas_body(monkeypatch, kind, shape, loop):
    m, k, n = shape
    a, b = operands(m, k, n, kind, seed=10 + loop)
    if kind == "int8":
        a[0, 0], a[1, 1] = -128, 127   # a XOR i reaches both ends of int8
    monkeypatch.setattr(p2, "LOOP", loop)
    body, acc = (p2._int8_kernel, jnp.int32) if kind == "int8" else (p2._bf16_kernel, jnp.float32)
    want = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((m, n), acc),
                          scratch_shapes=[pltpu.VMEM((m, n), acc)],
                          interpret=True)(to_jax(a, kind), to_jax(b, kind))
    got = mma_cuda.accum_matmul(to_torch(a, kind), to_torch(b.T, kind), loop)
    if kind == "int8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        scale = sum(abs_product(a + i, b) for i in range(loop))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("loop", [0, 1])
@pytest.mark.parametrize("kind", ["int8", "bfloat16"])
@pytest.mark.parametrize("m", [65, 130])
def test_chain_matmul_plain_matches_pallas_body_off_the_band(monkeypatch, m, kind, loop):
    """The wgmma chain kernel works on bands of 64 rows and masks the last
    one: its plain version against P1's body at M one and two past a band,
    K = 128 (the narrowest split the kernel takes), loop 0 (a copy) and 1."""
    k = 128
    a, b = operands(m, k, k, kind, seed=m + loop)
    monkeypatch.setattr(p1, "LOOP", loop)
    body, dt = (p1._int8_kernel, jnp.int8) if kind == "int8" else (p1._bf16_kernel, jnp.bfloat16)
    want = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((m, k), dt),
                          interpret=True)(to_jax(a, kind), to_jax(b, kind))
    got = mma_cuda.chain_matmul_plain(to_torch(a, kind), to_torch(b.T, kind), loop, 0.01)
    assert got.dtype == (torch.int8 if kind == "int8" else torch.bfloat16)
    assert tuple(got.shape) == (m, k)
    if kind == "int8" or loop == 0:
        np.testing.assert_array_equal(as_f32(got), as_f32(want))
    else:
        w = as_f32(want)
        np.testing.assert_allclose(as_f32(got), w, rtol=2 ** -7, atol=1e-3 * np.abs(w).max())


def test_int8_plain_product_is_exact_against_numpy_int64():
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, (50, 4608)).astype(np.int8)
    b = rng.integers(-127, 128, (70, 4608)).astype(np.int8)
    a[0], b[0] = -128, -127   # the largest sum the convolutions can reach
    got = mma_cuda.tiled_matmul_plain(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


def test_perturbed_wraps_like_an_int8_cast():
    a = torch.tensor([[-128, -1, 0, 1, 127]], dtype=torch.int8)
    for i in (0, 1, 63, 127, 128, 200, 255):
        want = a.numpy() ^ np.array(i).astype(np.int8)
        np.testing.assert_array_equal(mma_cuda._perturbed(a, i).numpy(), want)
    b = torch.tensor([[0.00390625, 1.0, -3.0]], dtype=torch.bfloat16)
    out = mma_cuda._perturbed(b, 63)
    assert out.dtype == torch.bfloat16 and out.tolist() == [[63.0, 64.0, 60.0]]


def test_cpu_calls_count_no_launch():
    _build.reset_launches()
    a = torch.ones(4, 32, dtype=torch.int8)
    mma_cuda.tiled_matmul(a, a)
    mma_cuda.tiled_matmul_dequant(a, a, torch.ones(4), None, torch.bfloat16)
    mma_cuda.accum_matmul(a, a, 2)
    mma_cuda.chain_matmul(torch.ones(4, 4, dtype=torch.int8), torch.ones(4, 4, dtype=torch.int8), 1)
    assert all(_build.launches[k] == 0 for k in LAUNCH_KEYS)


LAUNCH_KEYS = [f"{k}_{t}" for k in ("tiled_matmul", "chain_matmul", "accum_matmul",
                                    "wgmma_matmul", "wgmma_unaligned", "wgmma_chain",
                                    "wgmma_accum")
               for t in ("s8", "bf16")] + ["wgmma_dequant_s8"]


@pytest.mark.parametrize("call", [
    lambda: mma_cuda.tiled_matmul(torch.ones(4, 8), torch.ones(4, 8)),                 # f32
    lambda: mma_cuda.tiled_matmul(torch.ones(4, 8, dtype=torch.int8),
                                  torch.ones(4, 8, dtype=torch.bfloat16)),             # mixed
    lambda: mma_cuda.tiled_matmul(torch.ones(4, 8, dtype=torch.int8),
                                  torch.ones(8, 4, dtype=torch.int8)),                 # (K, N) given
    lambda: mma_cuda.tiled_matmul(torch.ones(0, 8, dtype=torch.int8),
                                  torch.ones(4, 8, dtype=torch.int8)),                 # empty
    lambda: mma_cuda.chain_matmul(torch.ones(4, 8, dtype=torch.int8),
                                  torch.ones(4, 8, dtype=torch.int8), 1),              # not square
    lambda: mma_cuda.accum_matmul(torch.ones(4, 8, dtype=torch.int8),
                                  torch.ones(4, 8, dtype=torch.int8), 0),              # loop 0
    lambda: mma_cuda.tiled_matmul(torch.ones(2, 4, 8, dtype=torch.int8),
                                  torch.ones(4, 8, dtype=torch.int8)),                 # 3-d
    lambda: mma_cuda.tiled_matmul_dequant(torch.ones(4, 16, dtype=torch.bfloat16),
                                          torch.ones(4, 16, dtype=torch.bfloat16),
                                          torch.ones(4)),                              # not int8
    lambda: mma_cuda.tiled_matmul_dequant(torch.ones(4, 16, dtype=torch.int8),
                                          torch.ones(4, 16, dtype=torch.int8),
                                          torch.ones(5)),                              # scale (N,)
    lambda: mma_cuda.tiled_matmul_dequant(torch.ones(4, 16, dtype=torch.int8),
                                          torch.ones(4, 16, dtype=torch.int8),
                                          torch.ones(4), torch.ones(4, 1)),            # bias 2-d
    lambda: mma_cuda.tiled_matmul_dequant(torch.ones(4, 16, dtype=torch.int8),
                                          torch.ones(4, 16, dtype=torch.int8),
                                          torch.ones(4), None, torch.float16),         # out type
    lambda: mma_cuda.tiled_matmul_mma_sync(torch.ones(4, 16, dtype=torch.int8),
                                           torch.ones(4, 16, dtype=torch.int8)),       # CPU
    lambda: mma_cuda.chain_matmul_mma_sync(torch.ones(4, 64, dtype=torch.int8),
                                           torch.ones(64, 64, dtype=torch.int8), 1),   # CPU
    lambda: mma_cuda.chain_matmul(torch.ones(4, 128, dtype=torch.int8),
                                  torch.ones(128, 128, dtype=torch.int8), -1),         # loop < 0
    lambda: mma_cuda.accum_matmul(torch.ones(4, 8, dtype=torch.int8),
                                  torch.ones(4, 8, dtype=torch.int8), -1),             # loop < 1
    lambda: mma_cuda.accum_matmul(torch.ones(4, 8, dtype=torch.bfloat16),
                                  torch.ones(4, 8, dtype=torch.int8), 1),              # mixed
    lambda: mma_cuda.accum_matmul(torch.ones(4, 8, dtype=torch.int8, device="meta"),
                                  torch.ones(4, 8, dtype=torch.int8, device="meta"), 1),  # meta
    lambda: mma_cuda.accum_matmul_mma_sync(torch.ones(4, 16, dtype=torch.int8),
                                           torch.ones(4, 16, dtype=torch.int8), 1),    # CPU
    lambda: mma_cuda.accum_matmul_mma_sync(torch.ones(4, 16, dtype=torch.int8),
                                           torch.ones(4, 16, dtype=torch.int8), 0),    # loop 0
])
def test_wrappers_refuse_bad_operands(call):
    with pytest.raises(ValueError):
        call()


def test_tile_width_and_chain_blocks():
    # the wgmma kernel: the widest of 256 and 128 that N fills and that gives 132 SMs a tile
    assert mma_cuda.tile_width(4_472_832, 64) == 64        # the stem: narrow N
    assert mma_cuda.tile_width(279_552, 256) == 256        # a tower conv at P3
    assert mma_cuda.tile_width(4_368, 256) == 64           # ... at P6: 35 row tiles
    assert mma_cuda.tile_width(17_472, 128) == 128         # 137 row tiles of 128 columns
    assert mma_cuda.tile_width(4096, 4096) == 256
    assert mma_cuda.tile_width(4096, 4096, sms=1024) == 128   # a card with more SMs
    assert mma_cuda.tile_width(512, 2048) == 64            # the probe: 64 wide tiles < 132 SMs
    # the mma.sync kernels keep their rule
    assert mma_cuda.mma_sync_tile_width(4_472_832, 64) == 64
    assert mma_cuda.mma_sync_tile_width(279_552, 256) == 128
    assert mma_cuda.mma_sync_tile_width(512, 2048) == 64
    assert mma_cuda.mma_sync_tile_width(4096, 4096) == 128
    assert mma_cuda.chain_blocks(512) == 32 and mma_cuda.chain_blocks(17) == 2


@pytest.mark.parametrize("k,options", [
    (128, [(1, 128)]), (256, [(2, 128), (1, 256)]), (384, [(3, 128)]),
    (1152, [(9, 128)]), (2048, [(16, 128), (8, 256)]), (4096, [(16, 256)]),
    (64, []), (200, []), (4224, []), (8192, [])])
def test_chain_splits_of_k(k, options):
    """K splits into clusters of at most 16 blocks with slices of 128 or 256
    columns, largest cluster first; any other K has none."""
    assert mma_cuda.chain_options(k) == options


@pytest.mark.parametrize("m,k,fits,plan", [
    (512, 2048, {16: 8, 8: 16}, (16, 128)),   # 8 bands of 16 blocks fit at once: 128 SMs
    (512, 2048, {16: 7, 8: 15}, (8, 256)),    # the H100: 7 of 16 -> two waves; 8 x 256 in one
    (512, 2048, {16: 0, 8: 15}, (8, 256)),    # no cluster of 16 at all
    (512, 2048, {16: 4, 8: 4}, (16, 128)),    # two waves either way: the narrower slice
    (65, 2048, {16: 7, 8: 15}, (16, 128)),    # two bands: both fit as clusters of 16
    (1, 256, {2: 66, 1: 132}, (2, 128)),
    (5, 128, {1: 132}, (1, 128)),
    (4096, 4096, {16: 7}, (16, 256))])
def test_chain_plan(m, k, fits, plan):
    assert mma_cuda.chain_plan(m, k, fits) == plan


@pytest.mark.parametrize("m,k,fits", [
    (512, 64, {}),                        # K off the 128-column grid
    (512, 200, {}),
    (512, 2048, {16: 0, 8: 0}),           # no cluster of either size fits the card
    (512, 8192, {16: 7})])                # slices wider than 256
def test_chain_plan_refuses(m, k, fits):
    with pytest.raises(ValueError):
        mma_cuda.chain_plan(m, k, fits)


# K of every quantized conv of the flagship (window size x input channels,
# padded to 16): the stem's 147 -> 160, the 1x1 and 3x3 convs of layer1-4, the
# FPN's laterals and 3x3 convs, the towers
FLAGSHIP_K = [160, 64, 576, 256, 1152, 128, 512, 2304, 1024, 4608, 2048]


@pytest.mark.parametrize("k", FLAGSHIP_K)
def test_route_of_the_flagships_convs_is_wgmma(k):
    assert mma_cuda.tiled_route(k) == "wgmma"                       # int8: K bytes a row
    assert mma_cuda.tiled_route(k, 0x7f0000000200, 0x7f0000100000) == "wgmma"


@pytest.mark.parametrize("row_bytes,a_ptr,b_ptr", [
    (147, 0, 0), (33, 0, 0), (7, 0, 0), (1, 0, 0),      # ragged K in int8
    (2 * 1023, 0, 0), (2 * 31, 0, 0), (8, 0, 0),        # ... in bf16; half a unit
    (160, 8, 0), (160, 0, 0x7f0000000204)])             # a view off the 16-byte grid
def test_route_of_unaligned_operands_is_mma_sync(row_bytes, a_ptr, b_ptr):
    """Operands off TMA's 16-byte grid (named for the mma.sync kernel that
    took them before) go to the wgmma kernel whose producer loads through
    registers."""
    assert mma_cuda.tiled_route(row_bytes, a_ptr, b_ptr) == "wgmma_unaligned"


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 64, 24), (37, 160, 7)])
def test_dequant_plain_matches_ioudet_arithmetic(shape, out, bias):
    """``tiled_matmul_dequant_plain`` against the dequantization of
    ioudet/ops/quant.py (``acc.astype(f32) * (sx * sw)``, ``+ bias``,
    ``.astype(dtype)``) on the same int8 operands, scales over eight orders of
    magnitude.  Without a bias the two are bit-equal.  With one, XLA may
    contract the multiply-add on the CPU: one f32 step (2^-23 relative to the
    larger of |y| and |bias|) for an f32 output, one bf16 step (2^-8) for a
    bf16 one."""
    m, k, n = shape
    rng = np.random.default_rng(m + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b_t = rng.integers(-127, 128, (n, k)).astype(np.int8)
    sx = np.float32(10.0 ** rng.uniform(-4, 0))
    sw = (10.0 ** rng.uniform(-4, 0, n)).astype(np.float32)
    bvec = (rng.standard_normal(n) * 10.0 ** rng.uniform(-2, 2, n)).astype(np.float32)
    acc = jnp.asarray(a.astype(np.int32) @ b_t.astype(np.int32).T)
    want = acc.astype(jnp.float32) * (jnp.float32(sx) * jnp.asarray(sw))
    if bias:
        want = want + jnp.asarray(bvec).astype(jnp.float32)
    want = as_f32(want.astype(jnp.float32 if out == "float32" else jnp.bfloat16))
    got = mma_cuda.tiled_matmul_dequant(
        torch.from_numpy(a), torch.from_numpy(b_t), torch.tensor(sx) * torch.from_numpy(sw),
        torch.from_numpy(bvec) if bias else None, getattr(torch, out))
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == (m, n)
    if not bias:
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        step = 2.0 ** -23 if out == "float32" else 2.0 ** -8
        top = np.maximum(np.abs(want), np.abs(bvec)[None, :])
        assert (np.abs(got.float().numpy() - want) <= step * top).all()


@pytest.mark.parametrize("name", ["no_store", "no_mma", "loads_only", "chain_no_mma",
                                  "chain_no_push", "chain_no_wait", "chain_b_only",
                                  "accum_no_mma", "accum_no_perturb", "accum_no_exchange",
                                  "accum_loads_only"])
def test_parts_probe_finds_its_lines_in_the_kernel_source(name):
    """The probe of the wgmma kernels' parts cuts whole lines out of the
    kernels' source: each must be there exactly once."""
    from ioudet_torch.tools import probe_wgmma_parts
    source = mma_cuda.WGMMA_LIBRARY.source.read_text()
    cuts = {**probe_wgmma_parts.CUTS, **probe_wgmma_parts.CHAIN_CUTS,
            **probe_wgmma_parts.ACCUM_CUTS}[name]
    assert cuts
    for cut in cuts:
        assert source.count(cut) == 1


def test_parts_probe_needs_a_card(monkeypatch):
    from ioudet_torch.tools import probe_wgmma_parts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_wgmma_parts.main() == 1


@pytest.mark.parametrize("needle", [
    "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8",
    "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16",
    "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes",
    "mbarrier.try_wait.parity", "setmaxnreg.dec", "CU_TENSOR_MAP_SWIZZLE_128B",
    "__fmul_rn(__int2float_rn(",
    # the unaligned producer: aligned words shifted into place for the async proxy
    "__funnelshift_r", "fence.proxy.async.shared::cta",
    # the chain: y's slabs pushed to the cluster's blocks, clusters of up to 16
    "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes",
    "mbarrier.expect_tx.relaxed", "cudaFuncAttributeNonPortableClusterSizeAllowed",
    "%cluster_nctarank",
    # the accumulate: A perturbed in registers for register-A wgmma, partial
    # sums added through distributed shared memory
    'WGMMA_STEP_RS("wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8"',
    'WGMMA_STEP_RS("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16"',
    "ldmatrix.sync.aligned.m8n8.x4.shared.b16", "xor.b32", "add.rn.bf16x2",
    "ld.shared::cluster.v4.u32", 'extern "C" int ioudet_wgmma_accum(',
    'extern "C" int ioudet_accum_fit('])
def test_wgmma_source_is_built_from_the_hopper_parts(needle):
    assert needle in mma_cuda.WGMMA_LIBRARY.source.read_text()


@pytest.mark.parametrize("entry", ["ioudet_wgmma_accum", "ioudet_accum_fit"])
def test_wgmma_library_binds_the_accumulate_entries(entry):
    assert entry in mma_cuda.WGMMA_LIBRARY.functions


# clusters of the accumulate kernel an H100 runs at once, by (tile width,
# cluster size), as the card answered cudaOccupancyMaxActiveClusters
H100_ACCUM_FITS = {(bn, ks): f for bn in (128, 64)
                   for ks, f in ((1, 132), (2, 66), (4, 30), (8, 15))}


@pytest.mark.parametrize("m,n,row_bytes,fits,plan", [
    (512, 2048, 2048, H100_ACCUM_FITS, (128, 2)),    # the probe, int8: 64 tiles x 2
    (512, 2048, 4096, H100_ACCUM_FITS, (128, 2)),    # ... bf16
    (1, 8, 16, H100_ACCUM_FITS, (64, 1)),            # one slab: no split
    (63, 65, 144, H100_ACCUM_FITS, (64, 1)),         # two slabs: fewer than 4 a block
    (129, 257, 512, H100_ACCUM_FITS, (64, 1)),       # four slabs: still ks = 1
    (7, 33, 160, H100_ACCUM_FITS, (64, 1)),
    (4096, 4096, 4096, H100_ACCUM_FITS, (128, 1)),   # tiles enough to fill the card
    (1, 2048, 4096, H100_ACCUM_FITS, (64, 8)),       # 32 narrow tiles in 3 waves of 15 x 8
    (512, 2048, 2048, {(128, 2): 66, (64, 1): 132}, (128, 2)),
    (512, 2048, 2048, {(64, 1): 132}, (64, 1)),      # only one option fits
    (512, 2048, 2048, {(128, 4): 32, (128, 2): 66}, (128, 2))])   # a tie: the smaller cluster
def test_accum_plan(m, n, row_bytes, fits, plan):
    assert mma_cuda.accum_plan(m, n, row_bytes, 132, fits) == plan


@pytest.mark.parametrize("m,n,row_bytes", [(512, 2048, 2048), (512, 2048, 4096), (63, 65, 144),
                                           (1, 8, 16), (4096, 4096, 4096), (200, 300, 1024)])
def test_accum_plan_keeps_a_share_of_slabs_a_block(m, n, row_bytes):
    """K is split only into shares of at least ACCUM_MIN_SLABS slabs (so
    never into more blocks than K has slabs), and the first wave never takes
    more SMs than the card has."""
    bn, ks = mma_cuda.accum_plan(m, n, row_bytes, 132, H100_ACCUM_FITS)
    slabs = -(-row_bytes // mma_cuda.SLAB)
    assert ks == 1 or slabs >= ks * mma_cuda.ACCUM_MIN_SLABS
    assert ks <= slabs
    assert mma_cuda.accum_sms(m, n, (bn, ks), H100_ACCUM_FITS) <= 132


def test_accum_plan_fills_the_card_at_the_probe_shape():
    for row_bytes in (2048, 4096):   # int8, bf16
        plan = mma_cuda.accum_plan(512, 2048, row_bytes, 132, H100_ACCUM_FITS)
        assert mma_cuda.accum_sms(512, 2048, plan, H100_ACCUM_FITS) >= 128


@pytest.mark.parametrize("m,n,row_bytes,fits", [
    (512, 2048, 2047, H100_ACCUM_FITS),   # a row pitch off the 16-byte grid
    (0, 2048, 2048, H100_ACCUM_FITS),     # no rows
    (512, 0, 2048, H100_ACCUM_FITS),
    (512, 2048, 2048, {}),                # nothing fits the card
    (512, 2048, 2048, {(128, 1): 0, (64, 2): 0})])
def test_accum_plan_refuses(m, n, row_bytes, fits):
    with pytest.raises(ValueError):
        mma_cuda.accum_plan(m, n, row_bytes, 132, fits)


@pytest.mark.parametrize("kind", ["int8", "bfloat16"])
@pytest.mark.parametrize("k", [1, 7, 33, 147, 16, 24])
def test_accum_operands_pad_changes_no_bit(kind, k):
    """K zero-padded to a 16-byte pitch gives the same sum, bit for bit, at
    the loop count where int8(i) wraps twice and bf16(i) rounds: a padded
    column of a becomes int8(i) or bf16(i) but meets a zero column of b_t."""
    a, b = operands(9, k, 5, kind, seed=k)
    ta, tb = to_torch(a, kind), to_torch(b.T, kind).contiguous()   # as the card requires
    pa, pb = mma_cuda.accum_operands(ta, tb)
    step = 16 // ta.element_size()
    assert pa.shape == (9, -(-k // step) * step) and pb.shape == (5, pa.shape[1])
    assert pa.is_contiguous() and pb.is_contiguous()
    assert pa.data_ptr() % 16 == 0 and pb.data_ptr() % 16 == 0
    assert torch.equal(pa[:, :k], ta) and not pa[:, k:].any() and not pb[:, k:].any()
    if pa.shape[1] == k:
        assert pa is ta and pb is tb   # already aligned: no copy
    want = mma_cuda.accum_matmul_plain(ta, tb, 300)
    got = mma_cuda.accum_matmul_plain(pa, pb, 300)
    assert torch.equal(got, want)


@pytest.mark.parametrize("loop,value,want", [
    (64, 0.0, 2016.0),                      # 0 + 1 + ... + 63: exact either way
    (64, -2.0 ** -25, 2016.0 - 2.0 ** -13),  # kept below 1.0's last bit, then truncated
    (2, -2.0 ** -133, 1.0),                 # below the 2 extra bits of 1.0: dropped
    (2, 3.3e38, float("inf")),              # past 2^128: +inf, not the largest f32
])
def test_tensor_core_sum_truncates_as_the_card(loop, value, want):
    """chip_smoke.tensor_core_sum, the one-hot bf16 sums chip_smoke.py holds
    both accumulate kernels to bit for bit, on sums worked by hand; the
    second differs from plain, which rounds to nearest (2016.0)."""
    from chip_smoke import tensor_core_sum
    a = torch.full((1, 1), value, dtype=torch.bfloat16)
    got = float(tensor_core_sum(mma_cuda, a, loop))
    assert got == want
    plain = float(mma_cuda.accum_matmul_plain(a, torch.ones(1, 1, dtype=torch.bfloat16), loop))
    assert (got != plain) == (value == -2.0 ** -25)
