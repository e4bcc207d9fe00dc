"""Port parity of the train path on the CPU at a tiny size: on weights
bridged between the two packages (convert_torch_retinanet /
state_dict_from_flax), forward_train's losses, the gradient of every trained
parameter and three optimizer steps of ioudet_torch against ioudet's
forward_train, jax.grad and make_train_step; then the LR schedule, the
trainable mask and gradient clipping.  Checkpoints and the runner are in
tests/test_torch_train_runner.py.

Tolerances.  Losses: 1e-4 relative (f32 sums over some 30 layers in another
order).  Gradients: per tensor, max |diff| <= 2e-3 of the tensor's largest
|gradient|, the bound the forward parity tests use, for the same reason: the
backward pass sums the same terms in another order in the two libraries.
Parameters after each step: rtol 1e-4, atol 2e-6 (LR 3e-3 times that gradient
difference)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ioudet.apis import train as jtrain
from ioudet.apis.checkpoint import convert_torch_retinanet
from ioudet.models import build_detector as jax_build_detector
from ioudet_torch.apis import train as ttrain
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.models import build_detector
from tests.test_torch_detector import randomize
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

MODEL = dict(
    type="IoUAwareRetinaNet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1,
                  norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
              start_level=1, add_extra_convs=True, num_outs=5),
    bbox_head=dict(type="IoUAwareRetinaHead", num_classes=5, in_channels=32,
                   feat_channels=32, stacked_convs=1,
                   anchor_strides=(8, 16, 32, 64, 128),
                   loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0,
                                 alpha=0.25, loss_weight=1.0),
                   loss_bbox=dict(type="SmoothL1Loss", beta=0.11, loss_weight=1.0)))
TRAIN_CFG = dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                               neg_iou_thr=0.4, min_pos_iou=0, ignore_iof_thr=-1),
                 allowed_border=-1, pos_weight=-1)
OPTIMIZER = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=0.0001)
LR_CONFIG = dict(policy="step", warmup="linear", warmup_iters=500,
                 warmup_ratio=1.0 / 3, step=[8, 11])
CFG = dict(model=MODEL, train_cfg=TRAIN_CFG, optimizer=OPTIMIZER, lr_config=LR_CONFIG,
           optimizer_config=dict(grad_clip=None), total_epochs=2,
           log_config=dict(interval=1), checkpoint_config=dict(interval=1))
KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")


def make_batch(seed=0, B=2, G=4, canvas=(64, 64)):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 30, (B, G, 2)).astype(np.float32)
    wh = rng.uniform(12, 30, (B, G, 2)).astype(np.float32)
    valid = np.ones((B, G), bool)
    valid[1, -1] = False
    shapes = np.tile(np.array([canvas], np.int32), (B, 1))
    return dict(img=rng.normal(0, 1, (B,) + canvas + (3,)).astype(np.float32),
                gt_bboxes=np.concatenate([xy, xy + wh], -1),
                gt_labels=rng.integers(1, 5, (B, G)).astype(np.int32),
                gt_valid=valid, img_shape=shapes, pad_shape=shapes.copy())


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def new_model(seed=0):
    model = randomize(build_detector(MODEL, TRAIN_CFG, None), seed=seed)
    with torch.no_grad():  # the focal prior, as at the start of training
        model.bbox_head.retina_cls.bias.fill_(-2.0)
    return model.train()


def bridge(model):
    """ioudet's parameter tree of the port's weights, as copies: numpy views
    of the torch parameters would alias the memory the port updates in place
    (jnp.asarray does not copy an aligned numpy array on the CPU)."""
    tree = convert_torch_retinanet(model.state_dict(), depth=18, num_laterals=3,
                                   stacked_convs=1)
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def twins():
    """The port's model, ioudet's detector, the bridged parameters, a batch."""
    model = new_model()
    det = jax_build_detector(dict(MODEL), TRAIN_CFG, None)
    return model, det, bridge(model), make_batch()


def jax_losses(det, params, batch):
    return det.apply({"params": params}, *(jnp.asarray(batch[k]) for k in KEYS),
                     method=det.forward_train)


def test_forward_train_losses_and_gradients(twins):
    model, det, params, batch = twins
    tb = tbatch(batch)
    model.zero_grad()
    ours = model.forward_train(*(tb[k] for k in KEYS))
    total, log_vars = ttrain.parse_losses(ours)
    total.backward()

    def total_loss(p):
        losses = jax_losses(det, p, batch)
        return jtrain.parse_losses(losses)[0], losses

    (_, ref), grads = jax.jit(jax.value_and_grad(total_loss, has_aux=True))(params)
    assert sorted(ours) == sorted(ref) == ["loss_bbox", "loss_cls", "loss_iou"]
    for k in ref:
        np.testing.assert_allclose(float(ours[k].detach()), float(ref[k]), rtol=1e-4)
    assert float(log_vars["loss"].detach()) == pytest.approx(float(sum(ref.values())), rel=1e-4)

    ref_grads = state_dict_from_flax(jax.device_get(grads))
    checked = 0
    for name, p in model.named_parameters():
        if name.startswith(FROZEN):
            assert p.grad is None, name
            continue
        g, r = p.grad.numpy(), ref_grads[name].numpy()
        assert np.abs(r).max() > 0, name
        assert np.abs(g - r).max() <= 2e-3 * np.abs(r).max(), name
        checked += 1
    assert checked == len(list(model.parameters())) - 15  # the stem and layer1


def test_three_steps_match_make_train_step(twins):
    _, det, _, batch = twins
    model = new_model()
    params = bridge(model)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    ipe = 100
    sched = ttrain.make_lr_schedule(OPTIMIZER["lr"], LR_CONFIG, ipe, 12)
    ttrain.make_trainable_mask(model)
    opt = ttrain.build_optimizer(model, OPTIMIZER)
    step = ttrain.make_train_step(model, opt, sched)

    jsched = jtrain.make_lr_schedule(OPTIMIZER["lr"], dict(LR_CONFIG), ipe, 12)
    tx = jtrain.build_optimizer(dict(OPTIMIZER), jsched,
                                jtrain.make_trainable_mask(params, frozen_stages=1))
    state = dict(params=jax.tree.map(jnp.asarray, params), step=jnp.zeros((), jnp.int32))
    state["opt_state"] = tx.init(state["params"])
    jstep = jtrain.make_train_step(det, tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = tbatch(batch)
    for i in range(3):
        logs = step(tb, i)
        state, jlogs = jstep(state, jbatch)
        for k in ("loss_cls", "loss_bbox", "loss_iou", "loss"):
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-4)
        ref = state_dict_from_flax(jax.device_get(state["params"]))
        sd = model.state_dict()
        for name, v in sd.items():
            np.testing.assert_allclose(v.numpy(), ref[name].numpy(), rtol=1e-4,
                                       atol=2e-6, err_msg=f"step {i + 1} {name}")
            if name.startswith(FROZEN) or "running_" in name:
                assert torch.equal(v, initial[name]), name
    moved = [n for n, _ in model.named_parameters() if not n.startswith(FROZEN)]
    assert all(not torch.equal(sd[n], initial[n]) for n in moved)


@pytest.mark.parametrize("lr_config", [
    LR_CONFIG,
    dict(policy="cosine", warmup="exp", warmup_iters=300, warmup_ratio=0.1),
    dict(policy="step", warmup="constant", warmup_iters=10, warmup_ratio=0.5,
         step=[2], gamma=0.5),
    dict(policy="fixed"),
])
def test_lr_schedule_values(lr_config):
    ipe = 700
    ours = ttrain.make_lr_schedule(0.01, lr_config, ipe, 12)
    ref = jtrain.make_lr_schedule(0.01, dict(lr_config), ipe, 12)
    for s in (0, 1, 9, 10, 299, 300, 499, 500, 2 * ipe, 8 * ipe, 11 * ipe, 12 * ipe - 1):
        assert isinstance(ours(s), float)
        # atol: ioudet's schedule is f32, and the cosine's last steps cancel
        np.testing.assert_allclose(ours(s), float(ref(s)), rtol=1e-5, atol=1e-9,
                                   err_msg=str(s))
    if lr_config is LR_CONFIG:
        assert ours(0) == pytest.approx(0.01 / 3) and ours(500) == 0.01
        assert ours(8 * ipe) == pytest.approx(0.001) and ours(11 * ipe) == pytest.approx(1e-4)


def test_trainable_mask_and_optimizer():
    model = build_detector(MODEL, TRAIN_CFG, None)
    for p in model.parameters():
        p.requires_grad_(True)
    mask = ttrain.make_trainable_mask(model)
    assert not any(v for k, v in mask.items() if k.startswith(FROZEN))
    assert all(v for k, v in mask.items() if not k.startswith(FROZEN))
    assert mask["backbone.layer2.0.bn1.weight"] and mask["backbone.layer2.0.bn1.bias"]
    assert all(p.requires_grad == mask[n] for n, p in model.named_parameters())
    opt = ttrain.build_optimizer(model, OPTIMIZER)
    assert len(opt.param_groups[0]["params"]) == sum(mask.values())
    assert opt.defaults["momentum"] == 0.9 and opt.defaults["weight_decay"] == 1e-4
    assert all(ttrain.make_trainable_mask(model, frozen_stages=-1).values())
    adam = ttrain.build_optimizer(model, dict(type="Adam", lr=1e-3, weight_decay=1e-4))
    assert isinstance(adam, torch.optim.AdamW)   # decoupled decay, as optax's chain
    with pytest.raises(KeyError):
        ttrain.build_optimizer(model, dict(type="RMSprop", lr=1e-3))


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_grad_clip_matches_optax(max_norm):
    rng = np.random.default_rng(1)
    grads = [rng.normal(0, 1, s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = ttrain.clip_grad_norm(params, max_norm)
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6)


def test_parse_losses():
    losses = dict(loss_cls=torch.tensor(1.0), rpn_loss_cls=torch.tensor(2.0),
                  s0_loss_bbox=torch.tensor(4.0), acc=torch.tensor(99.0))
    total, log_vars = ttrain.parse_losses(losses)
    assert float(total) == 7.0 and float(log_vars["loss"]) == 7.0
    assert float(log_vars["acc"]) == 99.0


