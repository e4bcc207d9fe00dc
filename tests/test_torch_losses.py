"""Port parity of the loss modules against ioudet.models.losses on seeded
numpy inputs: values to rtol 1e-6 (the same f32 formulas; sums in another
order) and gradients to rtol 1e-5 / atol 1e-7, with the avg_factor rules."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.models.losses import cross_entropy_loss as jce
from ioudet.models.losses import focal_loss as jfocal
from ioudet.models.losses.utils import weight_reduce_loss as jax_reduce
from ioudet_torch.models import losses as L
from ioudet_torch.models.builder import build_loss
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

# the package exports a function of the module's name
jsl1 = importlib.import_module("ioudet.models.losses.smooth_l1_loss")

RNG = np.random.default_rng(0)
N, C = 57, 6
PRED = RNG.normal(0, 3, (N, C)).astype(np.float32)
LABELS = RNG.integers(0, C + 1, N).astype(np.int32)
WEIGHT = (RNG.uniform(size=N) < 0.8).astype(np.float32)
BOX_PRED = RNG.normal(0, 0.3, (N, 4)).astype(np.float32)
BOX_TGT = RNG.normal(0, 0.3, (N, 4)).astype(np.float32)
BOX_W = np.repeat((RNG.uniform(size=(N, 1)) < 0.5).astype(np.float32), 4, 1)
SOFT = RNG.uniform(size=N).astype(np.float32)


def close(ours, ref, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def grad_pair(torch_fn, jax_fn, x):
    """Gradients of two scalar functions of x."""
    tx = torch.from_numpy(x).requires_grad_(True)
    torch_fn(tx).backward()
    return tx.grad, jax.grad(jax_fn)(jnp.asarray(x))


@pytest.mark.parametrize("reduction,avg_factor", [("mean", None), ("mean", 13.0),
                                                  ("sum", None), ("none", None),
                                                  ("none", 5.0)])
def test_weight_reduce_loss_rules(reduction, avg_factor):
    loss = np.abs(PRED)
    w = WEIGHT[:, None]
    ours = L.weight_reduce_loss(torch.from_numpy(loss), torch.from_numpy(w), reduction,
                                None if avg_factor is None else torch.tensor(avg_factor))
    close(ours, jax_reduce(jnp.asarray(loss), jnp.asarray(w), reduction, avg_factor))
    if avg_factor is not None:  # a Python number works as a device tensor does
        close(L.weight_reduce_loss(torch.from_numpy(loss), torch.from_numpy(w),
                                   reduction, avg_factor), ours)


def test_avg_factor_rejects_sum_and_floors_at_zero():
    with pytest.raises(ValueError):
        L.weight_reduce_loss(torch.ones(3), None, "sum", 2.0)
    with pytest.raises(ValueError):
        L.reduce_loss(torch.ones(3), "median")
    assert float(L.weight_reduce_loss(torch.zeros(3), None, "mean", torch.tensor(0.0))) == 0.0


@pytest.mark.parametrize("gamma,alpha", [(2.0, 0.25), (1.5, 0.5)])
def test_sigmoid_focal_loss(gamma, alpha):
    p, lab, w = torch.from_numpy(PRED), torch.from_numpy(LABELS), torch.from_numpy(WEIGHT)
    kw = dict(gamma=gamma, alpha=alpha, reduction="mean", avg_factor=9.0)
    close(L.sigmoid_focal_loss(p, lab, w, **kw),
          jfocal.sigmoid_focal_loss(jnp.asarray(PRED), jnp.asarray(LABELS),
                                    jnp.asarray(WEIGHT), **kw))
    onehot = (LABELS[:, None] == np.arange(1, C + 1)).astype(np.float32)
    close(L.sigmoid_focal_loss_with_logits(p, torch.from_numpy(onehot), gamma, alpha),
          jfocal.sigmoid_focal_loss_with_logits(jnp.asarray(PRED), jnp.asarray(onehot),
                                                gamma, alpha), atol=1e-6)
    ours, ref = grad_pair(
        lambda x: L.sigmoid_focal_loss(x, lab, w, **kw),
        lambda x: jfocal.sigmoid_focal_loss(x, jnp.asarray(LABELS), jnp.asarray(WEIGHT), **kw),
        PRED)
    close(ours, ref, rtol=1e-5)


def test_focal_loss_module_and_build_loss():
    cfg = dict(type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25, loss_weight=0.5)
    ours = build_loss(cfg)(torch.from_numpy(PRED), torch.from_numpy(LABELS),
                           torch.from_numpy(WEIGHT), avg_factor=torch.tensor(4.0))
    ref = jfocal.FocalLoss(loss_weight=0.5)(jnp.asarray(PRED), jnp.asarray(LABELS),
                                            jnp.asarray(WEIGHT), avg_factor=4.0)
    close(ours, ref)
    with pytest.raises(NotImplementedError):
        build_loss(dict(cfg, use_sigmoid=False))
    with pytest.raises(KeyError, match="MSELoss"):
        build_loss(dict(type="MSELoss"))


@pytest.mark.parametrize("beta", [0.11, 1.0])
def test_smooth_l1(beta):
    args = (BOX_PRED, BOX_TGT, BOX_W)
    ours = L.SmoothL1Loss(beta=beta, loss_weight=2.0)(
        *map(torch.from_numpy, args), avg_factor=torch.tensor(7.0))
    close(ours, jsl1.SmoothL1Loss(beta=beta, loss_weight=2.0)(
        *map(jnp.asarray, args), avg_factor=7.0))
    close(L.smooth_l1_loss(*map(torch.from_numpy, args[:2]), reduction="none", beta=beta),
          jsl1.smooth_l1_loss(*map(jnp.asarray, args[:2]), reduction="none", beta=beta))
    ours, ref = grad_pair(
        lambda x: L.smooth_l1_loss(x, torch.from_numpy(BOX_TGT), torch.from_numpy(BOX_W),
                                   avg_factor=7.0, beta=beta),
        lambda x: jsl1.smooth_l1_loss(x, jnp.asarray(BOX_TGT), jnp.asarray(BOX_W),
                                      avg_factor=7.0, beta=beta), BOX_PRED)
    close(ours, ref, rtol=1e-5)


def test_l1():
    args = (BOX_PRED, BOX_TGT, BOX_W)
    close(L.L1Loss()(*map(torch.from_numpy, args), reduction_override="sum"),
          jsl1.L1Loss()(*map(jnp.asarray, args), reduction_override="sum"))


def test_bce_with_soft_targets():
    """The IoU branch's loss: soft targets, value and gradient, saturated
    logits included.  (At x exactly 0 the port's gradient is sigmoid(0) - t;
    jax's subgradient of max(x, 0) + log1p(exp(-|x|)) there is another.)"""
    x = np.concatenate([PRED[:, 0], [1e-3, 40.0, -40.0, 25.0]]).astype(np.float32)
    t = np.concatenate([SOFT, [0.3, 1.0, 0.0, 0.5]]).astype(np.float32)
    close(L.binary_cross_entropy_with_logits(torch.from_numpy(x), torch.from_numpy(t)),
          jce.binary_cross_entropy_with_logits(jnp.asarray(x), jnp.asarray(t)), atol=1e-6)
    ours, ref = grad_pair(
        lambda z: L.binary_cross_entropy_with_logits(z, torch.from_numpy(t)).sum(),
        lambda z: jce.binary_cross_entropy_with_logits(z, jnp.asarray(t)).sum(), x)
    close(ours, ref, rtol=1e-5)


@pytest.mark.parametrize("use_sigmoid", [True, False])
def test_cross_entropy_loss(use_sigmoid):
    labels = LABELS if use_sigmoid else np.minimum(LABELS, C - 1)
    ours = L.CrossEntropyLoss(use_sigmoid=use_sigmoid)(
        torch.from_numpy(PRED), torch.from_numpy(labels), torch.from_numpy(WEIGHT),
        avg_factor=torch.tensor(11.0))
    close(ours, jce.CrossEntropyLoss(use_sigmoid=use_sigmoid)(
        jnp.asarray(PRED), jnp.asarray(labels), jnp.asarray(WEIGHT), avg_factor=11.0))
    with pytest.raises(NotImplementedError):
        L.CrossEntropyLoss(use_mask=True)
