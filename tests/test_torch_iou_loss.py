"""The port's box decode and IoU losses against ``ioudet``'s on the CPU:
``distance2bbox`` (with and without the clamp), ``Scale``, and ``iou_loss``,
``bounded_iou_loss``, ``giou_loss`` through their loss classes with a
per-box and a per-coordinate weight, 'mean' with ``avg_factor``, 'sum' and
'none', and their gradients w.r.t. the predicted boxes; the classes from the
builder's loss table.  ``ioudet``'s side is one jitted program.

Tolerances: ``distance2bbox`` exact; losses rtol 1e-5 (the same f32 steps,
``bbox_overlaps``'s +1 convention); gradients within 1e-5 of each one's
largest |value|, plus 1e-6 absolute near the IoU clamp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.core.bbox import distance2bbox as jax_distance2bbox
from ioudet.models.losses.iou_loss import BoundedIoULoss, GIoULoss, IoULoss
from ioudet_torch.core.bbox import distance2bbox
from ioudet_torch.models.builder import build_loss
from ioudet_torch.models.utils.layers import Scale
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

NAMES = ("IoULoss", "BoundedIoULoss", "GIoULoss")
MODES = ("mean", "sum", "none", "per_coord")


def boxes(seed: int = 0, n: int = 64) -> tuple:
    """Predicted and target boxes: overlapping pairs, disjoint ones (IoU at
    the clamp), a pair equal, a degenerate predicted box."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(2, 60, (n, 2))
    target = np.concatenate([xy, xy + wh], -1)
    pred = target + rng.normal(0, 6, (n, 4))
    pred[:4] += 200.0                   # disjoint
    pred[4] = target[4]                 # equal
    pred[5, 2:] = pred[5, :2] - 1.0     # degenerate: zero +1-width
    weight = rng.uniform(0, 1, (n, 4))
    weight[rng.random(n) < 0.3] = 0.0
    return tuple(a.astype(np.float32) for a in (pred, target, weight))


def call(loss, pred, target, weight, mode):
    """The loss in one of MODES.  BoundedIoULoss runs unweighted: in
    ``ioudet`` it averages a (N, 4) weight to (N,) like the others and then
    cannot broadcast it against its (N, 4) loss, and the port copies that
    (``test_bounded_iou_loss_takes_no_weight``)."""
    if type(loss).__name__ == "BoundedIoULoss":
        weight = None
    if mode == "per_coord":
        return loss(pred, target, weight, avg_factor=17.0)
    w = None if weight is None else weight[:, 0]
    if mode == "mean":
        return loss(pred, target, w, avg_factor=23.0)
    return loss(pred, target, w, reduction_override=mode)


@pytest.fixture(scope="module")
def ref():
    pred, target, weight = boxes()
    classes = {"IoULoss": IoULoss(), "BoundedIoULoss": BoundedIoULoss(),
               "GIoULoss": GIoULoss(loss_weight=2.0)}

    def run(p, tg, w):
        out = {}
        for name, loss in classes.items():
            for mode in MODES:
                def f(q):
                    v = call(loss, q, tg, w, mode)
                    return jnp.sum(v * jnp.arange(1, v.size + 1).reshape(v.shape)), v
                (_, v), g = jax.value_and_grad(f, has_aux=True)(p)
                out[f"{name}/{mode}"] = (v, g)
        pts = tg[:, :2] + 3.0
        out["distance2bbox"] = (jax_distance2bbox(pts, jnp.abs(p[:, :4]) / 4),
                                jax_distance2bbox(pts, jnp.abs(p[:, :4]) / 4, (60, 90)))
        return out

    return jax.device_get(jax.jit(run)(pred, target, weight))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradient_match_ioudet(ref, name, mode):
    pred, target, weight = (torch.from_numpy(a) for a in boxes())
    loss = build_loss(dict(type=name, loss_weight=2.0) if name == "GIoULoss" else dict(type=name))
    p = pred.clone().requires_grad_()
    v = call(loss, p, target, weight, mode)
    (v * torch.arange(1, v.numel() + 1).reshape(v.shape)).sum().backward()
    want_v, want_g = ref[f"{name}/{mode}"]
    assert v.shape == want_v.shape
    np.testing.assert_allclose(v.detach().numpy(), want_v, rtol=1e-5, atol=1e-6)
    g = p.grad.numpy()
    assert np.isfinite(g).all() and np.abs(want_g).max() > 0
    np.testing.assert_allclose(g, want_g, rtol=1e-4,
                               atol=1e-5 * np.abs(want_g).max() + 1e-6)


def test_distance2bbox_matches_ioudet(ref):
    pred, target, _ = boxes()
    pts = torch.from_numpy(target[:, :2]) + 3.0
    dist = torch.from_numpy(np.abs(pred[:, :4])) / 4
    plain, clamped = ref["distance2bbox"]
    np.testing.assert_array_equal(distance2bbox(pts, dist).numpy(), plain)
    np.testing.assert_array_equal(distance2bbox(pts, dist, (60, 90)).numpy(), clamped)
    assert clamped[..., 0::2].max() == 89 and clamped[..., 1::2].max() == 59


def test_scale_is_a_learned_scalar():
    s = Scale(1.5)
    assert [n for n, _ in s.named_parameters()] == ["scale"] and s.scale.dim() == 0
    x = torch.arange(6.0).reshape(2, 3)
    y = s(x)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), 1.5 * x.numpy())
    assert float(s.scale.grad) == 15.0


def test_bounded_iou_loss_takes_no_weight():
    """ioudet's BoundedIoULoss refuses a weight (its (N, 4) loss against the
    weight averaged to (N,)); the port's refuses it too."""
    pred, target, weight = boxes(n=6)
    with pytest.raises((TypeError, ValueError)):
        BoundedIoULoss()(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(weight))
    with pytest.raises(RuntimeError):
        build_loss(dict(type="BoundedIoULoss"))(*(torch.from_numpy(a) for a in (pred, target,
                                                                                   weight)))
