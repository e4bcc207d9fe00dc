"""Port parity of Grid R-CNN on the CPU: the grid helpers, targets, loss and
decode against ``ioudet``'s on seeded inputs, and the tiny Grid R-CNN of
tests/test_longtail_detectors.py (R-18, FPN and heads 64 wide, 5 classes, a
grid head of two convs and 8 channels a point, 72 in all, so that GN(36)
divides them; 64x96 canvases) on the sampling of ``faster_rcnn_cfgs``
(every candidate taken), on ``ioudet``'s parameter tree filled with seeded
values and bridged (``tests/torch_twins.py``): the grid head, the losses
and every gradient of ``forward_train`` with ``ioudet``'s draws fed to the
port (its sampler's, the sample's order and the jitter: the port's rois
then come in ``ioudet``'s order, each with its jitter), and
``simple_test``.  Two compiled ``ioudet`` programs: the test side and the
train side with its gradients.

Tolerances: the helpers and targets exact (the targets are 0 / 1 and the
weights flags; the points 1e-6 relative); the loss rtol 1e-5; the decode
1e-4 abs on boxes of ~100 px (the argmax positions are exact; the weighted
means round in another order); the grid head's logits within 1e-5 of their
largest |value|; the losses rtol 1e-5 and gradients per tensor within 1e-3
of the tensor's largest |gradient| (tests/test_torch_mask_rcnn.py's), 5e-3
in the grid head: against the port's own run in float64, ``ioudet``'s f32
gradients there are up to 2.1e-3 off (its fusion convs') and the port's up
to 2.8e-3 (the first conv's bias, ahead of GN, a difference of near-equal
sums), where the port's fusion convs are within 1e-6;
``simple_test`` labels exact, dets rtol 1e-5 and 1e-4 abs (the two-stage
test's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.apis import checkpoint as jckpt
from ioudet.apis import train as jtrain
from ioudet.models import build_detector as jax_build_detector
from ioudet.models.mask_heads import grid_head as jgrid
from ioudet_torch.apis import train as ttrain
from ioudet_torch.apis.checkpoint import load_checkpoint, state_dict_from_flax
from ioudet_torch.core.bbox import samplers
from ioudet_torch.models import build_detector
from ioudet_torch.models.detectors import grid_rcnn, two_stage
from ioudet_torch.models.mask_heads import grid_head
from tests._torch_mp_worker import faster_rcnn_cfgs, two_stage_batches
from tests.test_torch_roi_ops import jax_draws
from tests.test_torch_two_stage import FACTORS, PAD, SHAPES, images
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

FASTER, TRAIN_CFG, TEST_CFG = faster_rcnn_cfgs()
MODEL = dict(FASTER, type="GridRCNN",
             grid_roi_extractor=dict(type="SingleRoIExtractor", out_channels=64,
                                     featmap_strides=(4, 8, 16, 32),
                                     roi_layer=dict(out_size=14, sample_num=2)),
             grid_head=dict(type="GridHead", num_convs=2, in_channels=64, point_feat_channels=8,
                            conv_out_channels=72, heatmap_size=56))
KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")


def boxes(rng, n: int) -> np.ndarray:
    xy = rng.uniform(0, 80, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(4, 90, (n, 2))], 1).astype(np.float32)


# ------------------------------------------------------------------ helpers

def test_grid_points_extend_and_neighbors_match_ioudet():
    b = boxes(np.random.default_rng(1), 30)
    np.testing.assert_allclose(grid_head.grid_points_of_box(torch.from_numpy(b)).numpy(),
                               np.asarray(jgrid.grid_points_of_box(jnp.asarray(b))), rtol=1e-6)
    for factor in (2.0, 1.5):
        np.testing.assert_allclose(grid_head.extend_box(torch.from_numpy(b), factor).numpy(),
                                   np.asarray(jgrid.extend_box(jnp.asarray(b), factor)),
                                   rtol=1e-6)
    assert grid_head.NEIGHBORS == jgrid._NEIGHBORS


def grid_inputs(seed: int = 2, n: int = 24) -> tuple:
    """(rois extended from jittered gts, gts): most points inside, some out."""
    rng = np.random.default_rng(seed)
    gt = boxes(rng, n)
    jittered = gt + rng.uniform(-0.3, 0.3, (n, 4)).astype(np.float32) * \
        np.tile(gt[:, 2:] - gt[:, :2], 2)
    return np.array(jgrid.extend_box(jnp.asarray(jittered), 1.4)), gt


def test_get_targets_and_loss_match_ioudet():
    rois, gt = grid_inputs()
    head = grid_head.GridHead(num_convs=1, in_channels=8, point_feat_channels=4,
                              conv_out_channels=36)
    jhead = jgrid.GridHead(heatmap_size=56)
    t, w = head.get_targets(torch.from_numpy(rois), torch.from_numpy(gt))
    jt, jw = jhead.get_targets(jnp.asarray(rois), jnp.asarray(gt))
    assert tuple(t.shape) == (24, 9, 56, 56)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert 0 < float(w.mean()) < 1 and float(t.sum()) > 0
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (24, 56, 56, 9)).astype(np.float32)
    pos = rng.uniform(size=24) < 0.6
    got = head.loss(torch.from_numpy(logits).permute(0, 3, 1, 2), t, w, torch.from_numpy(pos))
    want = jhead.loss(jnp.asarray(logits), jt, jw, jnp.asarray(pos.astype(np.float32)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_get_bboxes_matches_ioudet_with_ties():
    """The decode of seeded logits, then of logits with two equal maxima a
    point (the first in raster order wins in both) and a point whose maxima
    fill its map."""
    rng = np.random.default_rng(4)
    det, _ = grid_inputs(5, 16)
    det = det / 1.4
    logits = rng.normal(0, 2, (16, 56, 56, 9)).astype(np.float32)
    tied = np.full_like(logits, -4.0)
    for r in range(16):
        for p in range(9):
            a, b = rng.choice(56 * 56, 2, replace=False)
            tied[r].reshape(-1, 9)[[a, b], p] = 3.0
    tied[0, :, :, 4] = 1.0
    head = grid_head.GridHead(num_convs=1, in_channels=8, point_feat_channels=4,
                              conv_out_channels=36)
    jhead = jgrid.GridHead(heatmap_size=56)
    for x in (logits, tied):
        got = head.get_bboxes(torch.from_numpy(det), torch.from_numpy(x).permute(0, 3, 1, 2))
        want = jhead.get_bboxes(jnp.asarray(det), jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    # the first of two tied maxima decides: lowering the later one changes nothing
    lowered = tied.copy()
    for r in range(16):
        flat = lowered[r].reshape(-1, 9)
        for p in range(9):
            top = np.flatnonzero(flat[:, p] == 3.0)
            flat[top[1:], p] = 2.5
    a, b = (head.get_bboxes(torch.from_numpy(det), torch.from_numpy(x).permute(0, 3, 1, 2))
            for x in (tied, lowered))
    assert torch.equal(a, b)


# ------------------------------------------------------------- the detector

def train_batch() -> dict:
    return {k: v[:2] for k, v in two_stage_batches(1)[0].items()}


@pytest.fixture(scope="module")
def twins():
    """(port model, ioudet's parameters, the ioudet detector, its jitted
    simple_test)."""
    det = jax_build_detector(dict(MODEL), TRAIN_CFG, TEST_CFG)
    meta = tuple(map(jnp.asarray, (SHAPES, FACTORS, PAD)))
    params = random_params(param_shapes(det, jnp.asarray(images(2)), *meta,
                                        method=det.simple_test), seed=0)
    model = build_detector(MODEL, TRAIN_CFG, TEST_CFG)
    model.load_state_dict(state_dict_from_flax(params))

    @jax.jit
    def ref(p, x):
        return det.apply({"params": p}, x, *meta, method=det.simple_test)

    return model.eval(), params, det, ref


def test_bridge_takes_the_grid_head(twins):
    model, params, _, _ = twins
    tree = params["grid_head"]
    assert sorted(tree) == sorted(["conv0", "conv1", "gn0", "gn1", "deconv1", "gn_deconv1",
                                   "deconv2"] + [f"fuse_{o}_{j}to{i}" for o in ("o1", "o2")
                                                 for i, js in jgrid._NEIGHBORS.items()
                                                 for j in js])
    sd = model.state_dict()
    assert sum(k.startswith("grid_head.") for k in sd) == 2 * 48 + 4 * 2 + 6
    assert torch.equal(sd["grid_head.fusion_o2.3to4.bias"],
                       torch.from_numpy(np.asarray(tree["fuse_o2_3to4"]["bias"])))
    assert torch.equal(sd["grid_head.norm1.weight"],
                       torch.from_numpy(np.asarray(tree["gn_deconv1"]["scale"])))


def test_grid_head_matches_ioudet(twins):
    model, params, _, _ = twins
    x = np.random.default_rng(6).normal(0, 1, (6, 14, 14, 64)).astype(np.float32)
    jhead = jgrid.GridHead(num_convs=2, in_channels=64, point_feat_channels=8,
                           conv_out_channels=72, heatmap_size=56)
    want = np.asarray(jhead.apply({"params": params["grid_head"]}, jnp.asarray(x)))
    with torch.no_grad():
        got = model.grid_head(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == (6, 56, 56, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def ioudet_draws(key, batch: int, candidates: int, samples: int) -> list:
    """ioudet's draws of ``GridRCNN.forward_train(rng=key)`` past the RPN, in
    the order the port draws them: the sampler's positives and negatives
    and the sample's order noise (each (batch, candidates), an image's key
    a row), then the jitter (batch * samples, 4)."""
    rng, jrng = jax.random.split(key)
    rows = []
    for k in jax.random.split(rng, batch):
        k1, k2 = jax.random.split(k)
        rows.append(jax_draws(TRAIN_CFG["rcnn"]["sampler"], k1, (candidates,)) +
                    [np.array(jax.random.uniform(k2, (candidates,)))])
    return [np.stack(col) for col in zip(*rows)] + \
        [np.array(jax.random.uniform(jrng, (batch * samples, 4)))]


def test_load_checkpoint_reads_an_ioudet_directory(twins, tmp_path):
    """``ioudet``'s checkpoint directory of the twin's parameters, read by
    the port's ``load_checkpoint`` through the bridge: the twin's weights."""
    model, params = twins[:2]
    jckpt.save_checkpoint(str(tmp_path), "iter_1", {"params": params})
    fresh = build_detector(MODEL, TRAIN_CFG, TEST_CFG)
    load_checkpoint(fresh, str(tmp_path / "iter_1"))
    want = model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in fresh.state_dict().items())


def test_forward_train_losses_and_gradients(twins, monkeypatch):
    model, params, det, _ = twins
    model = model.train()
    batch = train_batch()
    key = jax.random.PRNGKey(3)

    def total(p):
        losses = det.apply({"params": p}, *(jnp.asarray(batch[k]) for k in KEYS),
                           rng=key, method=det.forward_train,
                           rngs={"sampler": jax.random.PRNGKey(9)})
        return jtrain.parse_losses(losses)[0], losses

    (_, ref), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jax.tree.map(lambda a: np.array(a, copy=True), params))
    num = TRAIN_CFG["rcnn"]["sampler"]["num"]
    candidates = TRAIN_CFG["rpn_proposal"]["max_num"] + batch["gt_bboxes"].shape[1]
    feed = ioudet_draws(key, 2, candidates, num)

    def uniform(shape, generator, device):
        # the RPN's anchor draws are its own (every anchor is taken); the rest are ioudet's
        if feed and tuple(shape) == feed[0].shape:
            return torch.from_numpy(feed.pop(0))
        return torch.rand(shape, generator=generator, device=device)

    for mod in (samplers, two_stage, grid_rcnn):
        monkeypatch.setattr(mod, "uniform", uniform)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ttrain.make_trainable_mask(model)
    try:
        ours = model.forward_train(*(tb[k] for k in KEYS),
                                   generator=torch.Generator().manual_seed(5))
        assert not feed
        ttrain.parse_losses(ours)[0].backward()
        assert sorted(ours) == sorted(ref) == ["loss_bbox", "loss_cls", "loss_grid",
                                               "rpn_loss_bbox", "rpn_loss_cls"]
        for k in ref:
            np.testing.assert_allclose(float(ours[k].detach()), float(ref[k]), rtol=1e-5,
                                       err_msg=k)
        assert float(ours["loss_grid"].detach()) > 0.1
        ref_grads = state_dict_from_flax(jax.device_get(grads))
        for name, p in model.named_parameters():
            if name.startswith(FROZEN):
                assert p.grad is None, name
                continue
            g, r = p.grad.numpy(), ref_grads[name].numpy()
            tol = 5e-3 if name.startswith("grid_head.") else 1e-3
            assert np.abs(g - r).max() <= tol * np.abs(r).max(), name
        assert np.abs(ref_grads["grid_head.fusion_o1.0to1.weight"].numpy()).max() > 0
    finally:
        model.zero_grad(set_to_none=True)
        for p in model.parameters():
            p.requires_grad_(True)
        model.eval()


@pytest.mark.parametrize("seed", [2, 3])
def test_simple_test_matches_ioudet(twins, seed):
    model, params, _, ref = twins
    x = images(seed)
    want_d, want_l = ref(params, jnp.asarray(x))
    args = (torch.from_numpy(x), *map(torch.from_numpy, (SHAPES, FACTORS, PAD)))
    with torch.no_grad():
        dets, labels = model.simple_test(*args)
        # on the canvas: the grid's boxes against the box path's detections
        refined, _ = model.simple_test(*args, rescale=False)
        boxes, _ = model.simple_test_bboxes(model.extract_feat(args[0]), *args[1:],
                                            rescale=False)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    valid = labels >= 0
    assert int(valid.sum()) >= 10
    np.testing.assert_allclose(dets.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)
    # the grid moved every valid detection and left the padding rows alone
    moved = (refined[..., :4] - boxes[..., :4]).abs().amax(-1)
    assert bool((moved[valid] > 1e-3).all()) and torch.equal(refined[~valid], boxes[~valid])
    assert torch.equal(refined[..., 4], boxes[..., 4])
