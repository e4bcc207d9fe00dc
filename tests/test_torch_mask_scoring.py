"""Port parity of Mask Scoring R-CNN on the CPU: the tiny model of
tests/test_mask_scoring.py (R-18, FPN and heads 64 wide, 5 classes, two
mask convs, a mask-IoU head of two convs and one FC) on the sampling of
``mask_rcnn_cfgs`` (every candidate taken, so the port's draws and
``ioudet``'s select alike), on ``ioudet``'s parameter tree filled with seeded
values and bridged (``tests/torch_twins.py``), held against ``ioudet`` on
the same seeded inputs: the mask-IoU head, its target and loss,
``forward_train``'s six losses and every gradient, and the rescored
``simple_test``.  Two compiled ``ioudet`` programs: the test side and the
train side with its gradients.

Tolerances: the head's IoUs within 1e-5 of their largest |value|; the
target 1e-6 abs (sums of 0 / 1 pixels and bilinear targets in another
order), the loss rtol 1e-6; the losses rtol 1e-5 (the sampled rois come in
another order: the same sums in another order); gradients per tensor
within 1e-3 of the tensor's largest |gradient| (tests/test_torch_mask_rcnn.py's);
``simple_test`` labels exact, dets rtol 1e-5 and 1e-4 abs
(tests/test_torch_mask_rcnn.py's), masks 5e-5 abs (tests/test_torch_htc.py's
on twin weights: the mask head's logits spread wider than on the hand-drawn
weights of tests/test_torch_mask_rcnn.py, so the ~1e-4 px that the boxes
differ by move a sigmoid by up to ~2e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.apis import checkpoint as jckpt
from ioudet.apis import train as jtrain
from ioudet.models import build_detector as jax_build_detector
from ioudet.models.mask_heads.maskiou_head import MaskIoUHead as JaxMaskIoUHead
from ioudet_torch.apis import train as ttrain
from ioudet_torch.apis.checkpoint import load_checkpoint, state_dict_from_flax
from ioudet_torch.models import build_detector
from ioudet_torch.models.detectors.two_stage import to_rois
from ioudet_torch.models.mask_heads.maskiou_head import MaskIoUHead
from tests._torch_mp_worker import mask_rcnn_cfgs, two_stage_batches
from tests.test_torch_two_stage import FACTORS, PAD, SHAPES, images
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

MASK_MODEL, TRAIN_CFG, TEST_CFG = mask_rcnn_cfgs()
MODEL = dict(MASK_MODEL, type="MaskScoringRCNN",
             mask_iou_head=dict(type="MaskIoUHead", num_convs=2, num_fcs=1, in_channels=64,
                                conv_out_channels=64, fc_out_channels=64, num_classes=5))
KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")


def train_batch() -> dict:
    """Two images of ``two_stage_batches`` with a seeded box-frame mask for
    every gt slot (the last slot's crop empty: its gt has no mask area)."""
    batch = {k: v[:2] for k, v in two_stage_batches(1)[0].items()}
    rng = np.random.default_rng(17)
    masks = (rng.uniform(size=batch["gt_labels"].shape + (112, 112)) > 0.4).astype(np.uint8)
    masks[:, -1] = 0
    batch["gt_masks"] = masks
    return batch


@pytest.fixture(scope="module")
def twins():
    """(port model, ioudet's parameters, the ioudet detector, its jitted
    simple_test).  The mask-IoU head's output layer is scaled by 0.2 and its
    bias lifted by 0.5 so that the predicted IoUs sit inside (0, 1) and the
    clip does not hide them."""
    det = jax_build_detector(dict(MODEL), TRAIN_CFG, TEST_CFG)
    meta = tuple(map(jnp.asarray, (SHAPES, FACTORS, PAD)))
    params = random_params(param_shapes(det, jnp.asarray(images(2)), *meta,
                                        method=det.simple_test), seed=0)
    params["mask_iou_head"]["fc_mask_iou"]["kernel"] *= 0.2
    params["mask_iou_head"]["fc_mask_iou"]["bias"] += 0.5
    model = build_detector(MODEL, TRAIN_CFG, TEST_CFG)
    model.load_state_dict(state_dict_from_flax(params))

    @jax.jit
    def ref(p, x):
        return det.apply({"params": p}, x, *meta, method=det.simple_test)

    return model.eval(), params, det, ref


def test_bridge_takes_the_mask_iou_head_under_mmdet_names(twins):
    model, params, _, _ = twins
    assert sorted(params["mask_iou_head"]) == ["conv0", "conv1", "fc0", "fc_mask_iou"]
    keys = sorted(k for k in model.state_dict() if k.startswith("mask_iou_head."))
    assert keys == [f"mask_iou_head.{n}.{p}" for n in ("convs.0", "convs.1", "fc_mask_iou",
                                                        "fcs.0") for p in ("bias", "weight")]
    # fc0 takes ioudet's (7, 7, 64) flatten: its rows land on the port's (64, 7, 7)
    kernel = np.asarray(params["mask_iou_head"]["fc0"]["kernel"])
    w = model.mask_iou_head.fcs[0].weight.detach().numpy()
    assert np.array_equal(w.reshape(64, 64, 7, 7)[5, 3, 2, 6], kernel[(2 * 7 + 6) * 64 + 3, 5])


def test_mask_iou_head_forward_matches_ioudet(twins):
    model, params, _, _ = twins
    rng = np.random.default_rng(6)
    feat = rng.normal(0, 1, (10, 14, 14, 64)).astype(np.float32)
    masks = rng.uniform(0, 1, (10, 28, 28)).astype(np.float32)
    head = JaxMaskIoUHead(num_convs=2, num_fcs=1, in_channels=64, conv_out_channels=64,
                          fc_out_channels=64, num_classes=5)
    want = np.asarray(head.apply({"params": params["mask_iou_head"]}, jnp.asarray(feat),
                                 jnp.asarray(masks)))
    with torch.no_grad():
        got = model.mask_iou_head(torch.from_numpy(feat).permute(0, 3, 1, 2),
                                  torch.from_numpy(masks))
    assert tuple(got.shape) == (10, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def _target_case(name: str) -> tuple:
    """(pred, target, roi, gt, crop fraction, expected IoU) of one named case
    in a 28x28 raster."""
    ones = np.ones((1, 28, 28), np.float32)
    full = np.array([[0.0, 0.0, 56.0, 56.0]], np.float32)
    if name == "half_covering_roi":   # a perfect prediction over half the gt
        return ones, ones, np.array([[0.0, 0.0, 56.0, 28.0]], np.float32), full, [1.0], 0.5
    if name == "full_cover":
        return ones, ones, full, full, [1.0], 1.0
    return ones, np.zeros_like(ones), full, full, [0.0], 0.0   # an empty gt


@pytest.mark.parametrize("name", ["half_covering_roi", "full_cover", "empty_gt"])
def test_mask_iou_target_cases(name):
    pred, tgt, roi, gt, frac, expected = _target_case(name)
    args = tuple(np.asarray(a, np.float32) for a in (pred, tgt, roi, gt, frac))
    got = MaskIoUHead.mask_iou_target_ref(*map(torch.from_numpy, args))
    want = JaxMaskIoUHead.mask_iou_target_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), [expected], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_mask_iou_target_and_loss_match_ioudet():
    """Seeded predictions, bilinear-like targets, rois around their gts and
    crop fractions (some gts empty), at thresholds 0.5 and 0.3; then the
    loss on seeded IoU predictions, labels and positives."""
    rng = np.random.default_rng(8)
    n = 40
    pred = rng.uniform(0, 1, (n, 28, 28)).astype(np.float32)
    tgt = np.clip(rng.normal(0.6, 0.5, (n, 28, 28)), 0, 1).astype(np.float32)
    xy = rng.uniform(0, 60, (n, 2))
    gt = np.concatenate([xy, xy + rng.uniform(2, 50, (n, 2))], 1).astype(np.float32)
    roi = (gt + rng.uniform(-8, 8, (n, 4))).astype(np.float32)
    frac = rng.uniform(0.1, 1.0, n).astype(np.float32)
    frac[:4] = 0.0
    for thr in (0.5, 0.3):
        got = MaskIoUHead.mask_iou_target_ref(*map(torch.from_numpy, (pred, tgt, roi, gt, frac)),
                                              thr=thr)
        want = JaxMaskIoUHead.mask_iou_target_ref(*map(jnp.asarray, (pred, tgt, roi, gt, frac)),
                                                  thr=thr)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        assert not got[:4].any() and 0.05 < float(got[4:].mean()) < 0.95
    iou_pred = rng.normal(0.5, 0.3, (n, 4)).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    pos = (labels > 0) & (rng.uniform(size=n) < 0.7)
    tloss = MaskIoUHead.loss(torch.from_numpy(iou_pred), got, torch.from_numpy(labels),
                             torch.from_numpy(pos))
    jloss = JaxMaskIoUHead.loss(jnp.asarray(iou_pred), want, jnp.asarray(labels),
                                jnp.asarray(pos.astype(np.float32)))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    assert float(tloss) > 0


def test_load_checkpoint_reads_an_ioudet_directory(twins, tmp_path):
    """``ioudet``'s checkpoint directory of the twin's parameters, read by
    the port's ``load_checkpoint`` through the bridge: the twin's weights."""
    model, params = twins[:2]
    jckpt.save_checkpoint(str(tmp_path), "iter_1", {"params": params})
    fresh = build_detector(MODEL, TRAIN_CFG, TEST_CFG)
    load_checkpoint(fresh, str(tmp_path / "iter_1"))
    want = model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in fresh.state_dict().items())


def test_forward_train_losses_and_gradients(twins):
    """forward_train's six losses and every trained parameter's gradient
    against ioudet's on the same batch, gt masks and weights."""
    model, params, det, _ = twins
    model = model.train()
    batch = train_batch()

    def total(p):
        losses = det.apply({"params": p}, *(jnp.asarray(batch[k]) for k in KEYS),
                           jnp.asarray(batch["gt_masks"]), method=det.forward_train,
                           rngs={"sampler": jax.random.PRNGKey(3)})
        return jtrain.parse_losses(losses)[0], losses

    (_, ref), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jax.tree.map(lambda a: np.array(a, copy=True), params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ttrain.make_trainable_mask(model)
    try:
        ours = model.forward_train(*(tb[k] for k in KEYS), gt_masks=tb["gt_masks"],
                                   generator=torch.Generator().manual_seed(5))
        ttrain.parse_losses(ours)[0].backward()
        assert sorted(ours) == sorted(ref) == ["loss_bbox", "loss_cls", "loss_mask",
                                               "loss_mask_iou", "rpn_loss_bbox", "rpn_loss_cls"]
        for k in ref:
            np.testing.assert_allclose(float(ours[k].detach()), float(ref[k]), rtol=1e-5,
                                       err_msg=k)
        assert float(ours["loss_mask_iou"].detach()) > 1e-3
        ref_grads = state_dict_from_flax(jax.device_get(grads))
        for name, p in model.named_parameters():
            if name.startswith(FROZEN):
                assert p.grad is None, name
                continue
            g, r = p.grad.numpy(), ref_grads[name].numpy()
            assert np.abs(g - r).max() <= 1e-3 * np.abs(r).max(), name
        # the mask-IoU loss reaches its head and, through the predicted mask
        # it is fed, the mask head
        assert np.abs(ref_grads["mask_iou_head.fc_mask_iou.weight"].numpy()).max() > 0
        assert np.abs(ref_grads["mask_iou_head.convs.0.weight"].numpy()).max() > 0
    finally:
        model.zero_grad(set_to_none=True)
        for p in model.parameters():
            p.requires_grad_(True)
        model.eval()


@pytest.mark.parametrize("seed", [2, 3])
def test_simple_test_rescored_matches_ioudet(twins, seed):
    model, params, _, ref = twins
    x = images(seed)
    want_d, want_l, want_m = ref(params, jnp.asarray(x))
    meta = tuple(map(torch.from_numpy, (SHAPES, FACTORS, PAD)))
    with torch.no_grad():
        dets, labels, masks = model.simple_test(torch.from_numpy(x), *meta)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    assert int((labels >= 0).sum()) >= 10
    np.testing.assert_allclose(dets.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(masks.numpy(), np.asarray(want_m), rtol=0, atol=5e-5)


def test_rescored_scores_are_mask_rcnn_scores_times_the_clipped_iou(twins):
    """The same weights without the mask-IoU head (a Mask R-CNN) give the
    same boxes, labels and masks, and scores that the mask-IoU head's
    clipped IoU of each detection's class scales to the rescored ones."""
    model, _, _, _ = twins
    plain = build_detector(MASK_MODEL, TRAIN_CFG, TEST_CFG).eval()
    plain.load_state_dict({k: v for k, v in model.state_dict().items()
                           if not k.startswith("mask_iou_head.")})
    x = torch.from_numpy(images(7))
    meta = tuple(map(torch.from_numpy, (SHAPES, FACTORS, PAD)))
    with torch.no_grad():
        d0, l0, m0 = plain.simple_test(x, *meta)
        d1, l1, m1 = model.simple_test(x, *meta)
        boxes = d0[..., :4] * torch.from_numpy(FACTORS)[:, None, None]
        feats = model.extract_feat(x)
        iou = model.mask_iou_head(model.mask_roi_extractor(feats, to_rois(boxes)),
                                  m0.flatten(0, 1))
    own = iou.gather(1, l0.reshape(-1, 1).clamp(min=0))[:, 0].reshape(l0.shape).clamp(0, 1)
    assert torch.equal(l0, l1) and torch.equal(m0, m1) and torch.equal(d0[..., :4], d1[..., :4])
    assert torch.equal(d1[..., 4], d0[..., 4] * own)
    valid = l0 >= 0
    assert int(valid.sum()) >= 10 and 0.05 < float(own[valid].mean()) < 0.95
    assert not torch.equal(d1[..., 4][valid], d0[..., 4][valid])
