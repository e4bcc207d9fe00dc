"""Port parity of Faster R-CNN's train path on the CPU: the tiny model and
weights of tests/test_torch_two_stage.py, with sampling that takes every
candidate whatever the draw (``faster_rcnn_cfgs``: the RPN's sampler num
above the anchor count, the R-CNN's the proposals plus the gts), so that
the port's draws and ``ioudet``'s select the same anchors and rois and the
sums differ only in order.  Held against ``ioudet``: ``forward_train``'s
four losses and every trained parameter's gradient, one ``make_train_step``
step against ``ioudet``'s optimizer chain applied to its gradient, OHEM's
per-candidate loss.  Two gloo ranks against one process are in
tests/test_torch_two_stage_dp.py.

Tolerances.  Losses rtol 1e-5.  Gradients: per tensor, max |diff| <= 1e-3
of the tensor's largest |gradient| (sums of the same terms in another
order; f32 holds it, no wider tree-level tolerance is needed).  Parameters
after the step: rtol 1e-4, atol 2e-6, tests/test_torch_train.py's limit.
OHEM's losses 1e-5 abs."""


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
from tests._torch_mp_worker import (GRAD_CLIP, LR_CONFIG, OPTIMIZER, faster_rcnn_cfgs,
                                    two_stage_batches)
from tests.test_torch_two_stage import bridge, randomize
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

MODEL, TRAIN_CFG, TEST_CFG = faster_rcnn_cfgs()
KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")


def new_model(train_cfg=TRAIN_CFG):
    return randomize(build_detector(MODEL, train_cfg, TEST_CFG), seed=0).train()


@pytest.fixture(scope="module")
def twins():
    """The port's model, ioudet's parameters, a batch of 2, and ioudet's
    losses and gradients of forward_train on it (one compile)."""
    model = new_model()
    params = bridge(model)
    det = jax_build_detector(dict(MODEL), TRAIN_CFG, TEST_CFG)
    batch = {k: v[:2] for k, v in two_stage_batches(1)[0].items()}

    def total(p):
        losses = det.apply({"params": p}, *(jnp.asarray(batch[k]) for k in KEYS),
                           method=det.forward_train,
                           rngs={"sampler": jax.random.PRNGKey(3)})
        return jtrain.parse_losses(losses)[0], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    return model, params, batch, jax.device_get(losses), jax.device_get(grads)


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_forward_train_losses_and_gradients(twins):
    model, _, batch, ref, grads = twins
    tb = tbatch(batch)
    model.zero_grad()
    ours = model.forward_train(*(tb[k] for k in KEYS),
                               generator=torch.Generator().manual_seed(5))
    ttrain.parse_losses(ours)[0].backward()
    assert sorted(ours) == sorted(ref) == ["loss_bbox", "loss_cls", "rpn_loss_bbox",
                                           "rpn_loss_cls"]
    for k in ref:
        np.testing.assert_allclose(float(ours[k].detach()), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    ref_grads = state_dict_from_flax(grads)
    zero = []
    for name, p in model.named_parameters():
        if name.startswith(FROZEN):
            assert p.grad is None, name
            continue
        g, r = p.grad.numpy(), ref_grads[name].numpy()
        assert np.abs(g - r).max() <= 1e-3 * np.abs(r).max(), name
        if not np.abs(r).any():
            zero.append(name)
    # on a 64x96 canvas no anchor above P2 lies inside the image (the RPN's
    # allowed_border 0) and every roi maps to P2: P3-P5's output convs get
    # no gradient, in both packages
    assert sorted(zero) == [f"neck.fpn_convs.{i}.conv.{w}" for i in (1, 2, 3)
                            for w in ("bias", "weight")]


def test_one_make_train_step_step(twins):
    """The port's make_train_step (SGD, warm-up LR, clip at 35) against
    ioudet's optimizer chain (build_optimizer with its trainable mask)
    applied to ioudet's gradient of the same batch."""
    _, params, batch, ref, grads = twins
    model = new_model()
    ipe = 100
    sched = ttrain.make_lr_schedule(OPTIMIZER["lr"], LR_CONFIG, ipe, 12)
    ttrain.make_trainable_mask(model)
    step = ttrain.make_train_step(model, ttrain.build_optimizer(model, OPTIMIZER), sched,
                                  GRAD_CLIP)
    logs = step(tbatch(batch), 0)
    assert float(logs["loss"]) == pytest.approx(float(sum(ref.values())), rel=1e-5)

    jsched = jtrain.make_lr_schedule(OPTIMIZER["lr"], dict(LR_CONFIG), ipe, 12)
    tx = jtrain.build_optimizer(dict(OPTIMIZER), jsched, jtrain.make_trainable_mask(params, 1),
                                grad_clip=GRAD_CLIP)

    @jax.jit
    def update(g, p):
        return optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])

    want = state_dict_from_flax(jax.device_get(update(grads, params)))
    initial = state_dict_from_flax(params)
    for name, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=1e-4, atol=2e-6,
                                   err_msg=name)
        if name.startswith(FROZEN):
            assert torch.equal(v, initial[name]), name
    assert not torch.equal(model.state_dict()["bbox_head.fc_cls.weight"],
                           initial["bbox_head.fc_cls.weight"])


def test_ohem_hardness_matches_ioudet(twins):
    """OHEM's per-candidate loss (the box head's CE of each candidate
    against its assigned label, no gradient) against the same computation
    on ioudet's modules; and forward_train with the OHEM sampler runs."""
    model, params, batch, _, _ = twins
    det = jax_build_detector(dict(MODEL), TRAIN_CFG, TEST_CFG)
    rng = np.random.default_rng(30)
    xy = rng.uniform(0, 60, (2, 40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (2, 40, 2))], -1).astype(np.float32)
    labels = rng.integers(-1, 5, (2, 40)).astype(np.int32)

    def hardness(m, img, boxes, labels):
        feats = m.extract_feat(img, train=True)
        rf = m._roi_forward(feats, m._to_rois(boxes), train=True)
        cls, _ = m.bbox_head(rf, train=True)
        logp = jax.nn.log_softmax(cls.astype(jnp.float32), axis=-1)
        tgt = jnp.clip(labels.reshape(-1), 0, None)
        return -jnp.take_along_axis(logp, tgt[:, None], axis=1)[:, 0].reshape(labels.shape)

    want = jax.jit(lambda p, *a: det.apply({"params": p}, *a, method=hardness))(
        params, jnp.asarray(batch["img"]), jnp.asarray(boxes), jnp.asarray(labels))
    tb = tbatch(batch)
    with torch.no_grad():
        feats = model.extract_feat(tb["img"])
        got = model.hardness(feats, torch.from_numpy(boxes), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    ohem = dict(TRAIN_CFG, rcnn=dict(TRAIN_CFG["rcnn"], sampler=dict(
        type="OHEMSampler", num=32, pos_fraction=0.25, add_gt_as_proposals=True)))
    model.train_cfg = ohem
    try:
        losses = model.forward_train(*(tb[k] for k in KEYS),
                                     generator=torch.Generator().manual_seed(0))
    finally:
        model.train_cfg = TRAIN_CFG
    assert all(bool(torch.isfinite(v)) for v in losses.values())
