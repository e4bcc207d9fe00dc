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


@pytest.mark.parametrize("loop", [1, 3, 9])
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
    mma_cuda.accum_matmul(a, a, 2)
    mma_cuda.chain_matmul(torch.ones(4, 4, dtype=torch.int8), torch.ones(4, 4, dtype=torch.int8), 1)
    assert all(_build.launches[k] == 0 for k in LAUNCH_KEYS)


LAUNCH_KEYS = [f"{k}_{t}" for k in ("tiled_matmul", "chain_matmul", "accum_matmul")
               for t in ("s8", "bf16")]


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
])
def test_wrappers_refuse_bad_operands(call):
    with pytest.raises(ValueError):
        call()


def test_tile_width_and_chain_blocks():
    assert mma_cuda.tile_width(4_472_832, 64) == 64        # the stem: narrow N
    assert mma_cuda.tile_width(279_552, 256) == 128        # a tower conv at P3
    assert mma_cuda.tile_width(512, 2048) == 64            # the probe: 64 wide tiles < 132 SMs
    assert mma_cuda.tile_width(4096, 4096) == 128
    assert mma_cuda.chain_blocks(512) == 32 and mma_cuda.chain_blocks(17) == 2
