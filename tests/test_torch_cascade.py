"""Port parity of Cascade R-CNN on the CPU: the tiny model of
tests/test_cascade.py (R-18, FPN and heads 64 wide, 5 classes, three
stages of box heads with the stages' stds, 64x96 canvases) in the sampling
of ``cascade_rcnn_cfgs`` (every valid candidate of every stage taken, so
the port's draws and ``ioudet``'s select alike), on ``ioudet``'s parameter
tree filled with seeded values and bridged (``tests/torch_twins.py``), held
against ``ioudet`` on the same seeded inputs: a stage's decode by the
argmax class, ``simple_test`` and the per-stage losses.  Cascade Mask
R-CNN (``ioudet``'s HTC with interleaving, information flow and the
semantic branch off) goes through tests/test_torch_htc.py's helpers here:
``simple_test`` with masks and the losses with ``s<i>_loss_mask``.  One
compiled ``ioudet`` program a detector serves its test and train side.

Tolerances: the decode 1e-5 abs on boxes of ~100 px; ``simple_test``
labels exact, dets rtol 1e-4 and 1e-3 abs (PERF.md section 2: three
stages' decodes on top of the two-stage path's 1e-4); the losses rtol
1e-5 (every stage samples its rois in another order than ``ioudet``: the
same sums in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.models import build_detector as jax_build_detector
from ioudet.models.detectors.cascade_rcnn import CascadeRCNN as JaxCascade
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.models import build_detector
from ioudet_torch.models.detectors.cascade_rcnn import decode_stage
from tests._torch_mp_worker import cascade_rcnn_cfgs, two_stage_batches
from tests.test_torch_htc import (check_bridge, check_simple_test, check_train_losses,
                                   htc_params, htc_twin)
from tests.test_torch_two_stage import FACTORS, PAD, SHAPES, images
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

MODEL, TRAIN_CFG, TEST_CFG = cascade_rcnn_cfgs()
KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")


def train_batch() -> dict:
    return {k: v[:2] for k, v in two_stage_batches(1)[0].items()}


@pytest.fixture(scope="module")
def twins():
    """(port model, ioudet's parameters, the ioudet detector, one jitted
    program of simple_test and forward_train, the parameters an argument)."""
    det = jax_build_detector(dict(MODEL), TRAIN_CFG, TEST_CFG)
    meta = tuple(map(jnp.asarray, (SHAPES, FACTORS, PAD)))
    params = random_params(param_shapes(det, jnp.asarray(images(2)), *meta,
                                        method=det.simple_test), seed=0)
    model = build_detector(MODEL, TRAIN_CFG, TEST_CFG)
    model.load_state_dict(state_dict_from_flax(params))
    batch = train_batch()

    @jax.jit
    def ref(p, x):
        dets = det.apply({"params": p}, x, *meta, method=det.simple_test)
        losses = det.apply({"params": p}, *(jnp.asarray(batch[k]) for k in KEYS),
                           method=det.forward_train, rngs={"sampler": jax.random.PRNGKey(3)})
        return dets, losses

    return model, params, det, functools.partial(ref, params)


def test_three_stage_heads_bridge(twins):
    model, params, _, _ = twins
    assert sorted(k for k in params if k.startswith("bbox_head")) == \
        ["bbox_head_0", "bbox_head_1", "bbox_head_2"]
    sd = model.state_dict()
    assert {k.split(".")[1] for k in sd if k.startswith("bbox_head.")} == {"0", "1", "2"}
    stds = [tuple(h["target_stds"]) for h in MODEL["bbox_head"]]
    assert [h.target_stds for h in model.bbox_head] == stds


def test_decode_stage_takes_the_argmax_class_background_included(twins):
    """A stage's refinement decodes each roi by the deltas of its argmax
    class, background (0) included, as ioudet's ``_decode_stage``."""
    model, _, det, _ = twins
    rng = np.random.default_rng(4)
    n, nc = 30, 5
    xy = rng.uniform(0, 60, (n, 2))
    rois = np.concatenate([np.zeros((n, 1)), xy, xy + rng.uniform(5, 40, (n, 2))], 1)
    rois = rois.astype(np.float32)
    pred = rng.normal(0, 1, (n, 4 * nc)).astype(np.float32)
    labels = rng.integers(0, nc, n)
    labels[:5] = 0
    head = det.bbox_head[1]
    want = jax.jit(lambda r, d, c: JaxCascade._decode_stage(None, head, r, d, c))(
        jnp.asarray(rois[:, 1:]), jnp.asarray(pred), jnp.asarray(labels))
    got = decode_stage(model.bbox_head[1], torch.from_numpy(rois), torch.from_numpy(pred),
                       torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [2, 3])
def test_simple_test_matches_ioudet(twins, seed):
    model, _, _, ref = twins
    x = images(seed)
    (want_d, want_l), _ = ref(jnp.asarray(x))
    meta = tuple(map(torch.from_numpy, (SHAPES, FACTORS, PAD)))
    with torch.no_grad():
        dets, labels = model.eval().simple_test(torch.from_numpy(x), *meta)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    assert int((labels >= 0).sum()) >= 10
    np.testing.assert_allclose(dets.numpy(), np.asarray(want_d), rtol=1e-4, atol=1e-3)


def test_per_stage_losses_match_ioudet(twins):
    model, _, _, ref = twins
    _, want = ref(jnp.asarray(images(2)))
    tb = {k: torch.from_numpy(v) for k, v in train_batch().items()}
    with torch.no_grad():
        ours = model.train().forward_train(*(tb[k] for k in KEYS),
                                           generator=torch.Generator().manual_seed(5))
    stage_keys = [f"s{s}_{k}" for s in range(3) for k in ("loss_cls", "loss_bbox")]
    assert sorted(ours) == sorted(want) == sorted(stage_keys + ["rpn_loss_bbox", "rpn_loss_cls"])
    for k in want:
        np.testing.assert_allclose(float(ours[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert all(float(ours[f"s{s}_loss_bbox"]) > 0 for s in range(3))


@pytest.fixture(scope="module")
def cascade_mask_twins():
    return htc_twin("cascade_mask_rcnn", htc_params())


def test_cascade_mask_rcnn_bridges_without_conv_res(cascade_mask_twins):
    check_bridge("cascade_mask_rcnn", cascade_mask_twins[0])


@pytest.mark.parametrize("seed", [2, 3])
def test_cascade_mask_rcnn_simple_test_matches_ioudet(cascade_mask_twins, seed):
    check_simple_test(*cascade_mask_twins, seed)


def test_cascade_mask_rcnn_losses_match_ioudet(cascade_mask_twins):
    check_train_losses("cascade_mask_rcnn", *cascade_mask_twins)
