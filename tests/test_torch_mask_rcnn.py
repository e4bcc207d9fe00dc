"""Port parity of Mask R-CNN on the CPU: the tiny model of
tests/test_mask_rcnn.py (R-18, FPN and heads 64 wide, 5 classes, two mask
convs, 64x96 canvases) with tests/test_torch_two_stage.py's weights and the
sampling of ``faster_rcnn_cfgs`` (every candidate taken, so the port's
draws and ``ioudet``'s select alike), built in both packages on the same
weights (to ``ioudet`` by its ``convert_torch_mask_rcnn``, back by the
port's ``state_dict_from_flax``) and held against ``ioudet`` on the same
seeded inputs: the upsample's kernel flip, ``mask_target``, the mask head's
logits and loss, ``forward_train``'s five losses and the gradients,
``simple_test``.  One compiled ``ioudet`` program serves each of the train
and the test side.

Tolerances: ``mask_target`` 1e-6 abs (one float32 rounding of a bilinear
blend of 0 / 1 values); head logits within 1e-5 of their largest |value|,
its loss rtol 1e-4; losses rtol 1e-5; gradients per tensor within 1e-3 of
the tensor's largest |gradient| (tests/test_torch_two_stage_train.py's);
``simple_test`` labels exact, dets rtol 1e-5 and 1e-4 abs (the two-stage
test's), masks 1e-5 abs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.apis import train as jtrain
from ioudet.apis.checkpoint import convert_torch_mask_rcnn
from ioudet.core.mask import mask_target as jax_mask_target
from ioudet.models import build_detector as jax_build_detector
from ioudet.models.mask_heads.fcn_mask_head import FCNMaskHead as JaxFCNMaskHead
from ioudet_torch.apis import train as ttrain
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.core.mask import mask_target
from ioudet_torch.models import build_detector
from tests._torch_mp_worker import faster_rcnn_cfgs, mask_rcnn_cfgs, two_stage_batches
from tests.test_torch_two_stage import FACTORS, PAD, SHAPES, images, randomize
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

FASTER = faster_rcnn_cfgs()[0]
MODEL, TRAIN_CFG, TEST_CFG = mask_rcnn_cfgs()
KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")


def new_model():
    """The two-stage test's weights, the mask head's drawn on top (logits
    spread so that masks sit away from 0.5)."""
    model = randomize(build_detector(MODEL, TRAIN_CFG, TEST_CFG), seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for conv in model.mask_head.convs:
            conv.conv.weight.normal_(0.0, 0.08, generator=g)
            conv.conv.bias.uniform_(-0.1, 0.1, generator=g)
        model.mask_head.upsample.weight.normal_(0.0, 0.15, generator=g)
        model.mask_head.conv_logits.weight.normal_(0.0, 0.3, generator=g)
    return model


def bridge(model) -> dict:
    """ioudet's parameter tree of the port's weights, as copies.  ioudet's
    converter takes mmdet's conv_logits with a background channel first and
    drops it; the port has none, so a zero one goes in front."""
    sd = dict(model.state_dict())
    for k in ("weight", "bias"):
        v = sd[f"mask_head.conv_logits.{k}"]
        sd[f"mask_head.conv_logits.{k}"] = torch.cat([torch.zeros_like(v[:1]), v])
    tree = convert_torch_mask_rcnn(sd, depth=18, num_laterals=4, head_in_channels=64,
                                   mask_num_convs=2)
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def train_batch() -> dict:
    """Two images of ``two_stage_batches`` with a seeded box-frame mask for
    every gt slot."""
    batch = {k: v[:2] for k, v in two_stage_batches(1)[0].items()}
    rng = np.random.default_rng(17)
    batch["gt_masks"] = (rng.uniform(size=batch["gt_labels"].shape + (112, 112)) > 0.4
                         ).astype(np.uint8)
    return batch


@pytest.fixture(scope="module")
def twins():
    """The port's model (eval), ioudet's parameters, and one compiled ioudet
    program for the test side: simple_test of the Mask R-CNN at SHAPES /
    FACTORS / PAD."""
    model = new_model().eval()
    params = bridge(model)
    det = jax_build_detector(dict(MODEL), TRAIN_CFG, TEST_CFG)

    @jax.jit
    def ref(x):
        return det.apply({"params": params}, x, jnp.asarray(SHAPES), jnp.asarray(FACTORS),
                         jnp.asarray(PAD), method=det.simple_test)

    return model, params, det, ref


def test_bridge_round_trip_is_identity(twins):
    model, params, _, _ = twins
    sd = model.state_dict()
    back = state_dict_from_flax(params)
    assert sorted(back) == sorted(sd)
    assert sum(k.startswith("mask_head.") for k in back) == 8
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_upsample_kernel_is_flipped():
    """flax's ConvTranspose and torch's ConvTranspose2d on one asymmetric
    2x2 kernel (one tap, then a ramp) through the bridge: the same output.
    Without the spatial flip the taps land on the mirrored pixels."""
    import flax.linen as nn

    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 5, 7, 3)).astype(np.float32)
    for kernel in (np.zeros((2, 2, 3, 4), np.float32), rng.normal(0, 1, (2, 2, 3, 4))):
        kernel = np.asarray(kernel, np.float32)
        if not kernel.any():
            kernel[0, 1, 1, 2] = 1.0
        kernel += np.arange(4, dtype=np.float32).reshape(2, 2, 1, 1) * 0.25
        leaf = {"kernel": kernel, "bias": np.linspace(-1, 1, 4).astype(np.float32)}
        want = nn.ConvTranspose(4, (2, 2), strides=(2, 2)).apply({"params": leaf}, x)
        sd = state_dict_from_flax({"mask_head": {"upsample": leaf}})
        up = torch.nn.ConvTranspose2d(3, 4, 2, stride=2)
        up.load_state_dict({"weight": sd["mask_head.upsample.weight"],
                            "bias": sd["mask_head.upsample.bias"]})
        with torch.no_grad():
            got = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            unflipped = torch.nn.functional.conv_transpose2d(
                torch.from_numpy(x).permute(0, 3, 1, 2),
                torch.from_numpy(kernel).permute(2, 3, 0, 1),
                up.bias, stride=2).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        assert np.abs(unflipped.numpy() - np.asarray(want)).max() > 0.1


def test_mask_target_matches_ioudet():
    rng = np.random.default_rng(5)
    bsz, g, n = 2, 5, 40
    masks = (rng.uniform(size=(bsz, g, 112, 112)) < 0.5).astype(np.uint8)
    xy = rng.uniform(0, 80, (bsz, g, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 60, (bsz, g, 2))], -1).astype(np.float32)
    boxes[0, 0, 2:] = boxes[0, 0, :2]   # a degenerate gt: its side floors at 1e-3
    idx = rng.integers(0, g, (bsz, n)).astype(np.int32)
    # each roi its gt's box, moved by up to 10 pixels a side
    rois = (np.take_along_axis(boxes, idx[..., None].astype(np.int64), 1)
            + rng.uniform(-10, 10, (bsz, n, 4))).astype(np.float32)
    pos = rng.uniform(size=(bsz, n)) < 0.7
    want = np.stack([np.asarray(jax_mask_target(*map(jnp.asarray, (
        masks[b], boxes[b], rois[b], idx[b], pos[b])))) for b in range(bsz)])
    got = mask_target(*map(torch.from_numpy, (masks, boxes, rois, idx, pos)))
    assert tuple(got.shape) == (bsz, n, 28, 28)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert 0.2 < float((got > 0).float().mean()) and not got[~torch.from_numpy(pos)].any()


def test_mask_head_logits_and_loss(twins):
    """FCNMaskHead alone through the bridge: logits of seeded 14x14 RoI
    features, then the loss on seeded targets, labels and positives."""
    model, params, _, _ = twins
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (12, 14, 14, 64)).astype(np.float32)
    head = JaxFCNMaskHead(num_convs=2, in_channels=64, conv_out_channels=64, num_classes=5)
    want = np.asarray(head.apply({"params": params["mask_head"]}, jnp.asarray(x)))
    with torch.no_grad():
        got = model.mask_head(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == (12, 28, 28, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    targets = rng.uniform(0, 1, (12, 28, 28)).astype(np.float32)
    labels = rng.integers(0, 5, 12).astype(np.int32)
    pos = (labels > 0) & (rng.uniform(size=12) < 0.8)
    jloss = JaxFCNMaskHead.loss(jnp.asarray(want), jnp.asarray(targets), jnp.asarray(labels),
                                jnp.asarray(pos.astype(np.float32)))
    tloss = model.mask_head.loss(got.permute(0, 3, 1, 2), torch.from_numpy(targets),
                                 torch.from_numpy(labels), torch.from_numpy(pos))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)


def test_forward_train_losses_and_gradients():
    """forward_train's five losses and every trained parameter's gradient
    against ioudet's on the same batch, gt masks and weights."""
    model = new_model().train()
    params = bridge(model)
    det = jax_build_detector(dict(MODEL), TRAIN_CFG, TEST_CFG)
    batch = train_batch()

    def total(p):
        losses = det.apply({"params": p}, *(jnp.asarray(batch[k]) for k in KEYS),
                           jnp.asarray(batch["gt_masks"]), method=det.forward_train,
                           rngs={"sampler": jax.random.PRNGKey(3)})
        return jtrain.parse_losses(losses)[0], losses

    (_, ref), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ttrain.make_trainable_mask(model)
    ours = model.forward_train(*(tb[k] for k in KEYS), gt_masks=tb["gt_masks"],
                               generator=torch.Generator().manual_seed(5))
    ttrain.parse_losses(ours)[0].backward()
    assert sorted(ours) == sorted(ref) == ["loss_bbox", "loss_cls", "loss_mask",
                                           "rpn_loss_bbox", "rpn_loss_cls"]
    for k in ref:
        np.testing.assert_allclose(float(ours[k].detach()), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(ours["loss_mask"].detach()) > 0.1
    ref_grads = state_dict_from_flax(jax.device_get(grads))
    for name, p in model.named_parameters():
        if name.startswith(FROZEN):
            assert p.grad is None, name
            continue
        g, r = p.grad.numpy(), ref_grads[name].numpy()
        assert np.abs(g - r).max() <= 1e-3 * np.abs(r).max(), name
    assert np.abs(ref_grads["mask_head.conv_logits.weight"].numpy()).max() > 0


@pytest.mark.parametrize("seed", [2, 3])
def test_simple_test_matches_ioudet(twins, seed):
    model, _, _, ref = twins
    x = images(seed)
    want_d, want_l, want_m = ref(jnp.asarray(x))
    meta = tuple(map(torch.from_numpy, (SHAPES, FACTORS, PAD)))
    with torch.no_grad():
        dets, labels, masks = model.simple_test(torch.from_numpy(x), *meta)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    assert int((labels >= 0).sum()) >= 10
    np.testing.assert_allclose(dets.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)
    assert tuple(masks.shape) == (2, 20, 28, 28)
    np.testing.assert_allclose(masks.numpy(), np.asarray(want_m), rtol=0, atol=1e-5)
    m = masks.numpy()[labels.numpy() >= 0]
    assert 0.05 < float((m > 0.5).mean()) < 0.95


def test_faster_rcnn_outputs_unchanged(twins):
    """The Mask R-CNN's boxes are the Faster R-CNN's: the same weights
    without the mask branch give bit-equal dets and labels (simple_test of
    the two-stage detector computes its features once and hands them to
    simple_test_bboxes, which the mask detector shares)."""
    model, _, _, _ = twins
    faster = build_detector(FASTER, TRAIN_CFG, TEST_CFG).eval()
    faster.load_state_dict({k: v for k, v in model.state_dict().items()
                            if not k.startswith("mask_")})
    x = torch.from_numpy(images(7))
    meta = tuple(map(torch.from_numpy, (SHAPES, FACTORS, PAD)))
    with torch.no_grad():
        d1, l1 = faster.simple_test(x, *meta)
        d2, l2, _ = model.simple_test(x, *meta)
    assert torch.equal(d1, d2) and torch.equal(l1, l2)
    assert int((l1 >= 0).sum()) >= 10
