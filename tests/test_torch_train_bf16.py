"""bf16 training of the port against ioudet on the CPU: the tiny R-18
detector of tests/test_torch_train.py built with ``dtype="bfloat16"``
(parameters f32, convolutions in bf16 through the modules' per-call casts,
the losses and the optimizer state f32, no loss scaling), on weights bridged
from the same seeded f32 model.  One step of the IoU-aware RetinaNet and one
of the plain RetinaNet (the family of configs/retinanet_r50_fpn_bf16_1x.py)
against ``jax.value_and_grad`` of ioudet's ``forward_train`` in bf16: the
losses and every trained parameter's gradient through the bridge; then three
steps of ``make_train_step`` against ioudet's step on the same optax chain
and jitted gradient, the losses and the parameters.  The focal kernels' plain versions take the bf16 logits and give
a bf16 gradient, as ioudet's.

Tolerance, fixed before the runs: the port's distance from ioudet in bf16
is at most twice ioudet's own distance between its bf16 and its f32 run on
the same inputs (2x: two implementations that round to bf16 at different
places each carry a rounding error of that size).  Distances, each taken
over the whole tree: of the losses, the largest |difference| of a term; of
the gradients and of the parameters' changes after three steps, the L2 norm
of the difference over every leaf, and the largest |difference| of a leaf
as a share of that leaf's largest |f32 value|.  The tree and not each leaf:
XLA on the CPU keeps some bf16 intermediates in f32 (it folds f32 -> bf16 ->
f32 conversion pairs), where PyTorch rounds each op's output, so a leaf fed
from a 1x1 map (P6 / P7 at this size, one product a weight) can sit 2-4x
further from ioudet's bf16 than ioudet's bf16 from its f32, while the tree
as a whole sits at half that distance."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ioudet.apis import train as jtrain
from ioudet.models import build_detector as jax_build_detector
from ioudet_torch.apis import train as ttrain
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.models import build_detector
from ioudet_torch.utils.debug import check_finite, grads_of
from tests.test_torch_train import (FROZEN, KEYS, LR_CONFIG, MODEL, OPTIMIZER, TRAIN_CFG,
                                    bridge, make_batch, new_model, tbatch)
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

RETINA = dict(MODEL, type="RetinaNet", bbox_head=dict(MODEL["bbox_head"], type="RetinaHead"))
FAMILIES = {"iou_aware": MODEL, "retinanet": RETINA}
STEPS = 3
IPE = 100


def twin(model_cfg: dict, dtype: str, seed: int = 0):
    """The port's model in ``dtype`` on the f32 weights of
    tests/test_torch_train.py's ``new_model``."""
    src = new_model(seed).state_dict()
    model = build_detector(dict(model_cfg, dtype=dtype), TRAIN_CFG, None).train()
    own = model.state_dict()   # the plain head has no retina_iou
    model.load_state_dict({k: v for k, v in src.items() if k in own})
    return model


@pytest.fixture(scope="module")
def ioudet_grad_fns():
    """family -> dtype -> ioudet's jitted ``value_and_grad`` of
    ``forward_train``'s total loss: (total, losses), grads."""
    fns = {}
    for family, model_cfg in FAMILIES.items():
        for dtype in ("bfloat16", "float32"):
            det = jax_build_detector(dict(model_cfg, dtype=dtype), TRAIN_CFG, None)

            def total(p, batch, det=det):
                losses = det.apply({"params": p}, *(batch[k] for k in KEYS),
                                   method=det.forward_train)
                return jtrain.parse_losses(losses)[0], losses

            fns.setdefault(family, {})[dtype] = jax.jit(jax.value_and_grad(total, has_aux=True))
    return fns


def ioudet_grads(fn, params, batch):
    (_, losses), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return ({k: float(v) for k, v in losses.items()},
            state_dict_from_flax(jax.device_get(grads)))


def tree_distances(a: dict, b: dict, scale: dict) -> tuple:
    """(L2 norm of a - b over the tree, largest max|a - b| / max|scale|
    over the leaves)."""
    l2 = math.sqrt(sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in scale))
    rel = max(float((a[k] - b[k]).abs().max()) / max(float(scale[k].abs().max()), 1e-30)
              for k in scale)
    return l2, rel


def assert_within_twice(ours: tuple, ioudet_own: tuple, what: str) -> None:
    for name, got, limit in zip(("L2", "leaf max share"), ours, ioudet_own):
        assert got <= 2 * limit, f"{what}: {name} distance {got:.3e} > 2 x {limit:.3e}"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_one_bf16_step_losses_and_gradients(ioudet_grad_fns, family):
    model_cfg = FAMILIES[family]
    batch = make_batch()
    model = twin(model_cfg, "bfloat16")
    params = bridge(model)
    ttrain.make_trainable_mask(model)
    model.zero_grad()
    losses = model.forward_train(*(tbatch(batch)[k] for k in KEYS))
    assert all(v.dtype == torch.float32 for v in losses.values())
    sum(losses.values()).backward()
    ours = {k: float(v.detach()) for k, v in losses.items()}
    grads = grads_of(model)
    assert not check_finite(grads) and all(g.dtype == torch.float32 for g in grads.values())

    ref_losses, ref = ioudet_grads(ioudet_grad_fns[family]["bfloat16"], params, batch)
    f32_losses, f32 = ioudet_grads(ioudet_grad_fns[family]["float32"], params, batch)
    assert sorted(ours) == sorted(ref_losses)
    loss_gap = max(abs(ours[k] - ref_losses[k]) for k in ref_losses)
    loss_own = max(abs(ref_losses[k] - f32_losses[k]) for k in ref_losses)
    assert 0 < loss_gap <= 2 * loss_own, (ours, ref_losses, f32_losses)
    trained = {k: f32[k] for k in grads}
    assert set(grads) == {n for n in f32 if not n.startswith(FROZEN) and "running_" not in n}
    assert_within_twice(tree_distances(grads, ref, trained),
                        tree_distances(ref, f32, trained), f"{family} gradients")


def test_bf16_logits_give_a_bf16_focal_gradient():
    model = twin(MODEL, "bfloat16")
    batch = tbatch(make_batch())
    cls_scores, bbox_preds, iou_preds = model(batch["img"])
    assert all(c.dtype == torch.bfloat16 for c in cls_scores)
    losses = model.bbox_head.loss(cls_scores, bbox_preds, iou_preds,
                                  *(batch[k] for k in KEYS[1:]), model.train_cfg)
    dx = torch.autograd.grad(losses["loss_cls"], cls_scores)
    assert all(d.dtype == torch.bfloat16 and d.shape == c.shape
               for d, c in zip(dx, cls_scores))


def test_three_bf16_steps_match_ioudet(ioudet_grad_fns):
    """The port's ``make_train_step`` against ioudet's step on the same
    chain (``build_optimizer``: clipping, decay, momentum, warm-up LR) and
    its jitted gradient, in bf16 and in f32."""
    batch = make_batch()
    model = twin(MODEL, "bfloat16")
    params = bridge(model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    sched = ttrain.make_lr_schedule(OPTIMIZER["lr"], LR_CONFIG, IPE, 12)
    ttrain.make_trainable_mask(model)
    opt = ttrain.build_optimizer(model, OPTIMIZER)
    step = ttrain.make_train_step(model, opt, sched, dict(max_norm=35))
    tb = tbatch(batch)
    ours = [{k: float(v) for k, v in step(tb, i).items()} for i in range(STEPS)]
    assert all(opt.state[p]["momentum_buffer"].dtype == torch.float32 for p in opt.state)

    runs = {}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for dtype in ("bfloat16", "float32"):
        jsched = jtrain.make_lr_schedule(OPTIMIZER["lr"], dict(LR_CONFIG), IPE, 12)
        tx = jtrain.build_optimizer(dict(OPTIMIZER), jsched,
                                    jtrain.make_trainable_mask(params, frozen_stages=1),
                                    grad_clip=dict(max_norm=35))
        p = jax.tree.map(jnp.asarray, params)
        opt_state = tx.init(p)

        @jax.jit
        def update(grads, opt_state, p, tx=tx):
            updates, opt_state = tx.update(grads, opt_state, p)
            return optax.apply_updates(p, updates), opt_state

        logs = []
        for _ in range(STEPS):
            (total, losses), grads = ioudet_grad_fns["iou_aware"][dtype](p, jbatch)
            p, opt_state = update(grads, opt_state, p)
            logs.append(dict({k: float(v) for k, v in losses.items()}, loss=float(total)))
        runs[dtype] = logs, state_dict_from_flax(jax.device_get(p))
    (ref_logs, ref), (f32_logs, f32) = runs["bfloat16"], runs["float32"]
    for i in range(STEPS):
        gap = max(abs(ours[i][k] - ref_logs[i][k]) for k in ref_logs[i])
        own = max(abs(ref_logs[i][k] - f32_logs[i][k]) for k in ref_logs[i])
        assert gap <= 2 * own, (i, ours[i], ref_logs[i], f32_logs[i])
    sd = model.state_dict()
    moved = [n for n, p in model.named_parameters() if p.requires_grad]

    def change(tree):
        return {k: tree[k] - start[k] for k in moved}

    scale = change(f32)
    assert_within_twice(tree_distances(change(sd), change(ref), scale),
                        tree_distances(change(ref), scale, scale), "parameters after 3 steps")
    for k, v in sd.items():
        if k not in moved:
            assert torch.equal(v, start[k]), k
