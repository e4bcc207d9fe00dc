"""The port's deformable conv on the card against the same call on the CPU:
forward within 1e-5 of the largest |output|, gradients of x, offsets, kernel
and mask within 1e-4 of the largest |gradient| (x's goes through atomic
scatter-adds on the card, in no fixed order), TF32 off; and no host sync in
the forward.  Skips without a GPU.  This file imports no JAX, so a GPU host
without it runs it as

    python -m pytest --noconftest -m cuda tests/test_torch_deform_conv_cuda.py
"""

import numpy as np
import pytest
import torch

from ioudet_torch.ops.deform_conv import deform_conv2d


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kept = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = kept


def inputs(stride, b=2, c=64, h=26, w=42, o=48, seed=0):
    """NCHW; offsets up to 4 px out of the image, fractions in [0.05, 0.95]."""
    rng = np.random.default_rng(seed)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.normal(0, 1, (b, c, h, w)).astype(np.float32)
    offsets = (rng.integers(-4, 4, (b, 18, ho, wo)) + 0.05 +
               0.9 * rng.random((b, 18, ho, wo))).astype(np.float32)
    weight = rng.normal(0, 0.1, (o, c, 3, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, 9, ho, wo)).astype(np.float32)
    cot = rng.normal(0, 1, (b, o, ho, wo)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, offsets, weight, mask, cot)]


def run(tensors, stride, modulated, device):
    x, offsets, weight, mask, cot = [t.to(device).requires_grad_(i < 4)
                                     for i, t in enumerate(tensors)]
    out = deform_conv2d(x, offsets, weight, mask=mask if modulated else None, stride=stride)
    (out * cot).sum().backward()
    grads = [t.grad for t in (x, offsets, weight, mask) if t.grad is not None]
    return [out.detach().cpu()] + [g.cpu() for g in grads]


@pytest.mark.cuda
@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_card_matches_cpu(card, stride, modulated):
    tensors = inputs(stride, seed=stride + 2 * modulated)
    on_card = run(tensors, stride, modulated, "cuda")
    on_cpu = run(tensors, stride, modulated, "cpu")
    assert len(on_card) == len(on_cpu) == (5 if modulated else 4)
    for i, (g, c) in enumerate(zip(on_card, on_cpu)):
        scale = float(c.abs().max())
        assert scale > 0
        limit = 1e-5 if i == 0 else 1e-4
        assert float((g - c).abs().max()) <= limit * scale, i


@pytest.mark.cuda
def test_forward_needs_no_host_sync(card):
    x, offsets, weight, mask, _ = [t.cuda() for t in inputs(2)]
    deform_conv2d(x, offsets, weight, mask=mask, stride=2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = deform_conv2d(x, offsets, weight, mask=mask, stride=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.shape == (2, 48, 13, 21)
