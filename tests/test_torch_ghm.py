"""Port parity of GHM RetinaNet on the CPU: ``GHMC``, ``GHMR`` and their
anchor-head adapters against ``ioudet``'s, stateless and with the configs'
momentum, over three steps (loss, gradient, ``acc_sum``); a tiny GHM
RetinaNet (R-18, FPN and head 32 wide, 5 classes; the configs' GHM
constants) through two steps of the port's ``make_train_step`` against
``ioudet``'s with its 'ghm' collection (losses, gradients, parameters, the
EMA buffers); the buffers written by training steps only; resume from an
``ioudet`` checkpoint directory that holds ``model_state['ghm']`` and from
the port's ``.pth``; and two gloo ranks against one process.

The anchor sampler of the tiny model takes every anchor (``num`` above the
1161 anchors a 64x96 canvas has), so both packages select alike whatever
their draws.  The twins are ``ioudet``'s parameter tree filled by
``tests/torch_twins.random_params`` and bridged by ``state_dict_from_flax``.

Bin edges.  An entry's bin is ``floor(g * bins)``; ``torch.sigmoid`` and
XLA's logistic can differ in the last bit and move an entry across an edge.
The tests count the valid entries whose bin differs between the packages:
none in the losses' three steps and before the tiny model's first step, so
there the counts are equal and the EMA sums are held bit for bit.  Before
its second step, after an update from gradients that differ in their last
bits, 10-11 of the 9288 classification entries (by the number of intra-op
threads; none of the box coordinates) sit in another bin; each sum is then held to ``m * its last offset + (1 -
m) * the entries moved`` (a moved entry takes 1 from one bin's count and
adds it to another's) and the losses to rtol 2e-4.

Tolerances.  Losses rtol 1e-5 (1e-4 for the detector: f32 sums over some
30 layers in another order); the losses' gradients rtol 1e-5; the
detector's gradients within 1e-3 of each tensor's largest |value|, and so
each parameter after a step within 1e-3 of its update's largest |value|
plus rtol 1e-6 (a few f32 roundings of the sum; GHMR's loss weight of 10
makes the updates large against tests/test_torch_train.py's fixed 2e-6):
step 1 of the chain, and step 2 from ``ioudet``'s own step-1 state (the
resume test).  Step 2 of the chain holds the losses and the sums only: its
moved entries weigh the gradients some 2% of an update apart.
Two ranks against one process: step 1's sums bit for bit, the ranks' sums
bit-equal to each other at every step (so DDP's buffer broadcast, which the
port leaves off, would change nothing), losses rtol 1e-5, each parameter
within 1e-3 of its update's largest |value| plus rtol 1e-6: the gradients
sum two images a rank, then the ranks, against four at once, and GHM's
density weights (up to hundreds in a sparse bin) amplify the cancellation
(1.04e-4 measured)."""

import copy
import functools
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ioudet_torch.apis import train as ttrain
from ioudet_torch.apis.checkpoint import (load_checkpoint, module_types, save_checkpoint,
                                          state_dict_from_flax)
from ioudet_torch.models import build_detector
from ioudet_torch.models.losses.ghm_loss import GHMC, GHMR, GHMCAdapter, GHMRAdapter
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# configs/retinanet_ghm_r50_fpn_1x.py's losses
GHMC_CFG = dict(type="GHMCAdapter", bins=30, momentum=0.75, loss_weight=1.0)
GHMR_CFG = dict(type="GHMRAdapter", mu=0.02, bins=10, momentum=0.7, loss_weight=10.0)
MODEL = dict(
    type="RetinaNet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1, norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32, start_level=1,
              add_extra_convs=True, num_outs=5),
    bbox_head=dict(type="RetinaHead", num_classes=5, in_channels=32, feat_channels=32,
                   stacked_convs=1, anchor_strides=(8, 16, 32, 64, 128),
                   loss_cls=GHMC_CFG, loss_bbox=GHMR_CFG))
TRAIN_CFG = dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5, neg_iou_thr=0.4,
                               min_pos_iou=0, ignore_iof_thr=-1),
                 sampler=dict(type="RandomSampler", num=2048, pos_fraction=0.5, neg_pos_ub=-1),
                 allowed_border=-1, pos_weight=-1)
OPTIMIZER = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=0.0001)
GRAD_CLIP = dict(max_norm=35, norm_type=2)   # the configs' optimizer_config
KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")
BUFFERS = ("bbox_head.cls_acc_sum", "bbox_head.bbox_acc_sum")
CANVAS = (64, 96)
WORLD = 2


def lr(step: int) -> float:
    return 0.01


def make_batch(seed: int, B: int = 2, G: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 50, (B, G, 2)).astype(np.float32)
    wh = rng.uniform(12, 40, (B, G, 2)).astype(np.float32)
    valid = np.ones((B, G), bool)
    valid[1, -1] = False
    shapes = np.tile(np.array([CANVAS], np.int32), (B, 1))
    return dict(img=rng.normal(0, 1, (B,) + CANVAS + (3,)).astype(np.float32),
                gt_bboxes=np.concatenate([xy, xy + wh], -1),
                gt_labels=rng.integers(1, 5, (B, G)).astype(np.int32),
                gt_valid=valid, img_shape=shapes, pad_shape=shapes.copy())


def tbatch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ the losses

def loss_inputs(kind: str, step: int) -> tuple:
    """(pred, target or labels, weight) of step ``step``, seeded."""
    rng = np.random.default_rng(10 * step + len(kind))
    if kind in ("GHMC", "GHMCAdapter"):
        pred = rng.normal(0, 2, (256, 8)).astype(np.float32)
        if kind == "GHMC":
            target = (rng.uniform(size=pred.shape) < 0.2).astype(np.float32)
            weight = (rng.uniform(size=pred.shape) < 0.8).astype(np.float32)
        else:
            target = rng.integers(0, 9, pred.shape[0]).astype(np.int32)
            weight = (rng.uniform(size=pred.shape[0]) < 0.8).astype(np.float32)
    else:
        pred = rng.normal(0, 0.3, (64, 4)).astype(np.float32)
        target = rng.normal(0, 0.3, (64, 4)).astype(np.float32)
        weight = (rng.uniform(size=(64, 4)) < 0.6).astype(np.float32)
    return pred, target, weight


def bin_ids(kind: str, pred, target, bins: int, sigmoid) -> np.ndarray:
    """Each entry's bin as the loss computes it, with ``sigmoid`` (numpy in,
    numpy out) for the classification losses."""
    pred = np.asarray(pred, np.float32)
    if kind == "GHMCAdapter":
        target = (np.asarray(target)[:, None] == np.arange(1, pred.shape[1] + 1)).astype(np.float32)
    if kind in ("GHMC", "GHMCAdapter"):
        g = np.abs(np.asarray(sigmoid(pred), np.float32) - np.asarray(target, np.float32))
    else:
        d = pred - np.asarray(target, np.float32)
        g = np.abs(d / np.sqrt(np.float32(0.02 * 0.02) + d * d))
    return np.clip((g * np.float32(bins)).astype(np.int32), 0, bins - 1)


LOSSES = {"GHMC": (GHMC, dict(bins=30)), "GHMR": (GHMR, dict(mu=0.02, bins=10, loss_weight=10.0)),
          "GHMCAdapter": (GHMCAdapter, dict(bins=30)),
          "GHMRAdapter": (GHMRAdapter, dict(mu=0.02, bins=10, loss_weight=10.0))}


@pytest.mark.parametrize("momentum", [0.0, 0.75])
@pytest.mark.parametrize("kind", sorted(LOSSES))
def test_ghm_losses_match_ioudet(kind, momentum):
    import jax
    import jax.numpy as jnp
    from ioudet.models.losses import ghm_loss as jghm

    cls, kw = LOSSES[kind]
    ours = cls(momentum=momentum, **kw)
    ref = getattr(jghm, kind)(momentum=momentum, **kw)
    assert ours.stateful == ref.stateful == (momentum > 0)
    bins = kw["bins"]

    @jax.jit
    def jax_step(pred, target, weight, acc):
        def f(p):
            out = ref(p, target, weight, acc_sum=acc if ref.stateful else None)
            return out if ref.stateful else (out, acc)
        (loss, new_acc), grad = jax.value_and_grad(f, has_aux=True)(pred)
        return loss, new_acc, grad

    acc = torch.zeros(bins)
    jacc = jnp.zeros((bins,), jnp.float32)
    for step in range(3):
        pred, target, weight = loss_inputs(kind, step)
        apart = (bin_ids(kind, pred, target, bins, lambda x: torch.sigmoid(t(x)).numpy()) !=
                 bin_ids(kind, pred, target, bins, lambda x: jax.nn.sigmoid(jnp.asarray(x))))
        assert int(apart.sum()) == 0   # no entry on a bin edge between the packages
        x = t(pred).requires_grad_()
        out = ours(x, t(target), t(weight), acc_sum=acc if ours.stateful else None)
        loss, new_acc = out if ours.stateful else (out, None)
        loss.backward()
        jloss, jacc, jgrad = jax_step(jnp.asarray(pred), jnp.asarray(target),
                                      jnp.asarray(weight), jacc)
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(np.asarray(jgrad)).max()),
                                   err_msg=f"step {step}")
        if ours.stateful:
            np.testing.assert_array_equal(new_acc.numpy(), np.asarray(jacc), f"step {step}")
            assert float(new_acc.sum()) > 0
            acc = new_acc


# ------------------------------------------------------------------ the detector

@functools.lru_cache(maxsize=None)
def jax_det():
    from ioudet.models import build_detector as jax_build_detector

    return jax_build_detector(MODEL, TRAIN_CFG, None)


def new_twin(seed: int = 0) -> tuple:
    """ioudet's detector and its seeded parameters, and the port's model on
    them (train mode, zero EMA sums)."""
    import jax.numpy as jnp

    det = jax_det()
    params = random_params(param_shapes(det, jnp.zeros((1,) + CANVAS + (3,))), seed)
    model = build_detector(MODEL, TRAIN_CFG, None)
    sd = state_dict_from_flax(params, module_types(model))
    sd.update({k: torch.zeros_like(model.state_dict()[k]) for k in BUFFERS})
    model.load_state_dict(sd, strict=True)
    return det, params, model.train()


_JAX_TRAIN = {}   # ioudet's optimizer and its make_train_step, compiled once


def jax_state(params) -> tuple:
    """ioudet's train state {params, opt_state, step, model_state: {'ghm':
    zeros}} and its jitted make_train_step."""
    import jax
    import jax.numpy as jnp
    from ioudet.apis import train as jtrain

    if not _JAX_TRAIN:
        tx = jtrain.build_optimizer(dict(OPTIMIZER), lr,
                                    jtrain.make_trainable_mask(params, frozen_stages=1),
                                    grad_clip=GRAD_CLIP)
        _JAX_TRAIN.update(tx=tx, step=jtrain.make_train_step(jax_det(), tx))
    p = jax.tree.map(jnp.asarray, params)
    ghm = {"bbox_head": {"cls_acc_sum": jnp.zeros((30,), jnp.float32),
                         "bbox_acc_sum": jnp.zeros((10,), jnp.float32)}}
    state = dict(params=p, opt_state=_JAX_TRAIN["tx"].init(p), step=jnp.zeros((), jnp.int32),
                 model_state={"ghm": ghm})
    return state, _JAX_TRAIN["step"]


def port_step(model):
    ttrain.make_trainable_mask(model)
    opt = ttrain.build_optimizer(model, dict(OPTIMIZER))
    return opt, ttrain.make_train_step(model, opt, lr, GRAD_CLIP)


def buffers(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items() if k in BUFFERS}


def jax_buffers(state) -> dict:
    ghm = state["model_state"]["ghm"]["bbox_head"]
    return {f"bbox_head.{k}": np.asarray(v) for k, v in ghm.items()}


@functools.lru_cache(maxsize=None)
def jax_forward():
    """ioudet's head outputs of the tiny model, one compiled program."""
    import jax

    return jax.jit(lambda p, x: jax_det().apply({"params": p}, x))


def moved_entries(model, params, batch) -> tuple:
    """(classification entries, box coordinates) of ``batch`` whose GHM bin
    differs between the two packages' head outputs, among the valid ones
    (the targets are the port's, equal to ``ioudet``'s on the CPU)."""
    import jax
    import jax.numpy as jnp

    b = tbatch(batch)
    with torch.no_grad():
        cls, reg = model(b["img"])
    jcls, jreg = jax_forward()(params, jnp.asarray(batch["img"]))
    head = model.bbox_head
    _, tg, _ = head._targets([tuple(c.shape[1:3]) for c in cls], b["gt_bboxes"], b["gt_labels"],
                             b["gt_valid"], b["img_shape"], b["pad_shape"], TRAIN_CFG, None, None,
                             torch.Generator().manual_seed(0))
    C = head.cls_out_channels

    def flat(levels, ch):
        return np.concatenate([np.asarray(lv).reshape(2, -1, ch) for lv in levels], 1)

    onehot = (tg.labels.numpy()[..., None] == np.arange(1, C + 1)).astype(np.float32)
    ids = [bin_ids("GHMC", flat(c, C), onehot, 30, sig) for c, sig in (
        (cls, lambda x: torch.sigmoid(t(x)).numpy()), (jcls, lambda x: jax.nn.sigmoid(x)))]
    cls_moved = int(((ids[0] != ids[1]) & (tg.label_weights.numpy() > 0)[..., None]).sum())
    ids = [bin_ids("GHMR", flat(r, 4), tg.bbox_targets.numpy(), 10, None) for r in (reg, jreg)]
    reg_moved = int(((ids[0] != ids[1]) & (tg.bbox_weights.numpy() > 0)).sum())
    return cls_moved, reg_moved


@pytest.fixture(scope="module")
def steps():
    """Two steps of both packages from the same weights on two batches:
    what each saw (losses, buffers, parameters), ioudet's gradient of step 1
    and the port's, the valid entries whose bin differs before each step."""
    import jax
    import jax.numpy as jnp

    det, params, model = new_twin()
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    state, jstep = jax_state(params)
    _, step = port_step(model)
    batches = [make_batch(1), make_batch(2)]

    def loss_fn(p, ms, b):
        out, new = det.apply({"params": p, **ms}, *(b[k] for k in KEYS),
                             method=det.forward_train, mutable=["ghm"],
                             rngs={"sampler": jax.random.PRNGKey(0)})
        return sum(out.values()), (out, new)

    (_, (jout, _)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state["params"], state["model_state"], {k: jnp.asarray(v) for k, v in
                                               batches[0].items()})
    twin = copy.deepcopy(model)
    out = twin.forward_train(*(tbatch(batches[0])[k] for k in KEYS))
    sum(out.values()).backward()
    first = ({k: float(v.detach()) for k, v in out.items()},
             {n: p.grad for n, p in twin.named_parameters()}, buffers(twin))
    seen = []
    for i, b in enumerate(batches):
        moved = moved_entries(model, jax.device_get(state["params"]), b)
        logs = step(tbatch(b), i)
        state, jlogs = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        seen.append(dict(moved=moved, logs={k: float(v) for k, v in logs.items()},
                         jlogs={k: float(v) for k, v in jlogs.items()}, buffers=buffers(model),
                         jbuffers=jax_buffers(state),
                         params={k: v.clone() for k, v in model.state_dict().items()},
                         jparams=state_dict_from_flax(jax.device_get(state["params"]),
                                                      module_types(model))))
    return first, (jax.device_get(jout), jax.device_get(jgrads)), seen, model, initial


def test_step_one_losses_and_gradients_match_ioudet(steps):
    (losses, grads, bufs), (jout, jgrads), _, model, _ = steps
    assert sorted(losses) == sorted(jout) == ["loss_bbox", "loss_cls"]
    for k, v in losses.items():
        assert float(jout[k]) > 0
        np.testing.assert_allclose(v, float(jout[k]), rtol=1e-4, err_msg=k)
    ref = state_dict_from_flax(jgrads, module_types(model))
    for name, g in grads.items():
        if name.startswith(FROZEN):
            assert g is None, name
            continue
        r = ref[name].numpy()
        assert np.abs(r).max() > 0, name
        assert np.abs(g.numpy() - r).max() <= 1e-3 * np.abs(r).max(), name
    assert all(float(v.sum()) > 0 for v in bufs.values())


def test_two_steps_match_make_train_step(steps):
    _, _, seen, _, initial = steps
    # the valid entries whose bin differs: none before step 1; before step 2,
    # after one update from gradients that differ in their last bits, a few
    # (10-11 of the 9288 classification entries by the number of intra-op
    # threads, none of the box coordinates): at most 2e-3 of them
    assert seen[0]["moved"] == (0, 0)
    assert seen[1]["moved"][0] <= 2e-3 * 2 * 1161 * 4 and seen[1]["moved"][1] <= 4
    tol = {k: 0.0 for k in BUFFERS}
    for i, s in enumerate(seen):
        # a moved entry takes 1 from one bin's count and adds it to another:
        # each sum is off by at most momentum * its last offset + (1 -
        # momentum) * the entries moved
        for k, m, n in zip(BUFFERS, (0.75, 0.7), s["moved"]):
            tol[k] = m * tol[k] + (1 - m) * n
            np.testing.assert_allclose(s["buffers"][k].numpy(), s["jbuffers"][k], rtol=0,
                                       atol=tol[k], err_msg=f"step {i + 1} {k}")
        for k in ("loss_cls", "loss_bbox", "loss"):
            # step 2: the moved entries' bins weigh them apart (8.2e-5 on
            # this machine)
            np.testing.assert_allclose(s["logs"][k], s["jlogs"][k], rtol=1e-4 if i == 0 else 2e-4,
                                       err_msg=f"step {i + 1} {k}")
        if i == 0:
            # step 2's parameters weigh the moved entries apart (2% of an
            # update): step 2 from ioudet's own state is held in
            # test_resume_from_an_ioudet_checkpoint_directory
            assert_params(s["params"], s["jparams"], initial, "step 1")
    # the EMA moves every step: step 2's sums are not step 1's
    assert all(not torch.equal(seen[0]["buffers"][k], seen[1]["buffers"][k]) for k in BUFFERS)


def assert_params(ours: dict, theirs: dict, initial: dict, what: str) -> None:
    """Each parameter within 1e-3 of its update's largest |value|, plus rtol
    1e-6."""
    for name, v in ours.items():
        if name in BUFFERS:
            continue
        update = float((theirs[name] - initial[name]).abs().max())
        np.testing.assert_allclose(v.numpy(), theirs[name].numpy(), rtol=1e-6, atol=1e-3 * update,
                                   err_msg=f"{what} {name}")


def test_buffers_move_in_training_steps_only():
    _, _, model = new_twin(seed=3)
    b = tbatch(make_batch(4))
    args = [b[k] for k in KEYS]
    zero = buffers(model)
    model.eval()
    with torch.no_grad():
        model.simple_test(b["img"], b["img_shape"], torch.ones(2), b["pad_shape"])
    model.forward_train(*args)                  # eval mode: a loss for logging
    model.train()
    with torch.no_grad():
        model.forward_train(*args)              # no autograd: a loss for logging
    assert all(torch.equal(v, zero[k]) for k, v in buffers(model).items())
    model.forward_train(*args)
    assert all(float(v.sum()) > 0 for v in buffers(model).values())


def test_resume_from_an_ioudet_checkpoint_directory(tmp_path):
    """ioudet's step 1 written by its save_checkpoint; the port resumes from
    the directory (parameters, momentum, the 'ghm' sums) and its step 2
    from that same state equals ioudet's: no valid entry in another bin,
    the sums bit for bit, losses and parameters as step 1.  Another
    model_state collection raises naming it."""
    import jax
    import jax.numpy as jnp
    from ioudet.apis.checkpoint import save_checkpoint as jax_save_checkpoint

    det, params, _ = new_twin(seed=5)
    state, jstep = jax_state(params)
    b1, b2 = make_batch(6), make_batch(7)
    state, _ = jstep(state, {k: jnp.asarray(v) for k, v in b1.items()})
    path = jax_save_checkpoint(str(tmp_path), "epoch_1", jax.device_get(state),
                               meta=dict(epoch=1, step=1))
    model = build_detector(MODEL, TRAIN_CFG, None).train()
    opt, step = port_step(model)
    meta = load_checkpoint(model, path, optimizer=opt)
    assert meta["step"] == 1
    for k, v in jax_buffers(state).items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v, k)
        assert v.sum() > 0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert moved_entries(model, jax.device_get(state["params"]), b2) == (0, 0)
    logs = step(tbatch(b2), 1)
    state, jlogs = jstep(state, {k: jnp.asarray(v) for k, v in b2.items()})
    for k in ("loss_cls", "loss_bbox"):
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-4, err_msg=k)
    for k, v in jax_buffers(state).items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v, k)
    assert_params(model.state_dict(), state_dict_from_flax(jax.device_get(state["params"]),
                                                           module_types(model)), before, "step 2")

    other = dict(jax.device_get(state), model_state={"batch_stats": {"x": np.zeros(2)}})
    bad = jax_save_checkpoint(str(tmp_path / "other"), "epoch_1", other)
    with pytest.raises(NotImplementedError, match="batch_stats"):
        load_checkpoint(build_detector(MODEL, TRAIN_CFG, None), bad)


def test_pth_resume_continues_bit_equal(tmp_path):
    """Three steps unbroken against two, a ``.pth`` save, a fresh model
    resumed from it, and the third: parameters and EMA sums bit-equal."""
    _, _, model = new_twin(seed=8)
    start = copy.deepcopy(model.state_dict())
    batches = [tbatch(make_batch(10 + i)) for i in range(3)]
    opt, step = port_step(model)
    for i, b in enumerate(batches):
        step(b, i)
        if i == 1:
            path = save_checkpoint(str(tmp_path), "epoch_1", model, opt, dict(epoch=1, step=2))
    fresh = build_detector(MODEL, TRAIN_CFG, None).train()
    fresh.load_state_dict(start)
    fopt, fstep = port_step(fresh)
    load_checkpoint(fresh, path, optimizer=fopt)
    fstep(batches[2], 2)
    live = model.state_dict()
    assert all(torch.equal(v, live[k]) for k, v in fresh.state_dict().items())
    assert all(float(live[k].sum()) > 0 for k in BUFFERS)


def test_bf16_and_int8_raise_named_errors():
    from ioudet_torch.ops import quant

    with pytest.raises(NotImplementedError, match="GHMCAdapter in torch.bfloat16"):
        build_detector(dict(MODEL, dtype="bfloat16"), TRAIN_CFG, None)
    with pytest.raises(NotImplementedError, match="int8 serving of GHMCAdapter"):
        with quant.quantize_calls(build_detector(MODEL, TRAIN_CFG, None)):
            pass


# ------------------------------------------------------------------ two ranks

DP_STEPS = 2


def dp_batches() -> list:
    return [make_batch(20 + i, B=2 * WORLD) for i in range(DP_STEPS)]


def dp_worker(port: str, rank: int, init_path: str, out: str) -> None:
    """One rank: its half of each global batch through the port's
    make_train_step under DDP; writes its logs, EMA sums and parameters."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = int(rank)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        model = build_detector(MODEL, TRAIN_CFG, None).train()
        model.load_state_dict(torch.load(init_path, weights_only=True))
        _, step = port_step(model)
        seen = []
        for i, b in enumerate(dp_batches()):
            half = {k: v[2 * rank:2 * rank + 2] for k, v in b.items()}
            logs = step(tbatch(half), i)
            seen.append(dict(logs={k: float(v) for k, v in logs.items()}, buffers=buffers(model)))
        with open(out, "wb") as f:
            pickle.dump(dict(seen=seen, params=model.state_dict()), f)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_one_process(tmp_path):
    _, _, model = new_twin(seed=9)
    start = copy.deepcopy(model.state_dict())
    init = str(tmp_path / "init.pth")
    torch.save(model.state_dict(), init)
    port = str(free_port())
    outs = [str(tmp_path / f"rank{r}.pkl") for r in range(WORLD)]
    code = "import sys; from tests.test_torch_ghm import dp_worker; dp_worker(*sys.argv[1:])"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, port, str(r), init, outs[r]],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    ranks = []
    for o in outs:
        with open(o, "rb") as f:
            ranks.append(pickle.load(f))

    _, step = port_step(model)
    for i, b in enumerate(dp_batches()):
        one = step(tbatch(b), i)
        bufs = buffers(model)
        for r, got in enumerate(ranks):
            s = got["seen"][i]
            for k in BUFFERS:
                assert torch.equal(s["buffers"][k], ranks[0]["seen"][i]["buffers"][k]), (r, k)
                if i == 0:
                    assert torch.equal(s["buffers"][k], bufs[k]), k
                else:
                    np.testing.assert_allclose(s["buffers"][k].numpy(), bufs[k].numpy(),
                                               rtol=1e-5, err_msg=k)
            for k in ("loss_cls", "loss_bbox", "loss"):
                np.testing.assert_allclose(s["logs"][k], float(one[k]), rtol=1e-5,
                                           err_msg=f"rank {r} step {i + 1} {k}")
    for r, got in enumerate(ranks):
        for name, v in model.state_dict().items():
            update = (v - start[name]).abs().max()
            np.testing.assert_allclose(got["params"][name].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-3 * float(update), err_msg=f"rank {r} {name}")
