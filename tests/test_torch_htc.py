"""Port parity of HTC on the CPU: the tiny model of ``htc_cfgs`` (R-18, FPN
and heads 64 wide, 5 classes, three stages, two 64-wide ``HTCMaskHead``
convs a stage, a two-conv ``FusedSemanticHead`` over 7 classes, 64x96
canvases) in the sampling of ``cascade_rcnn_cfgs`` (every valid candidate
taken at every stage, the interleaved mask samples too), on ``ioudet``'s
parameter tree filled with seeded values and bridged
(``tests/torch_twins.py``; each setting takes its part of the full HTC's
tree), here the full HTC; the helpers below serve the other two flag
settings in tests/test_torch_htc_without_semantic.py and
tests/test_torch_cascade.py (Cascade Mask R-CNN's), one ``ioudet``
program to compile a file or two, which keeps each file within its time.  Held against ``ioudet`` on the
same seeded inputs: the semantic head's logits, feature and loss, the mask
head's information flow, and at each setting
``simple_test`` (dets, labels, masks) and every train loss.  One compiled
``ioudet`` program a setting serves its test and its train side.

Tolerances: head outputs within 1e-5 of their largest |value|, the
semantic loss rtol 1e-5; ``simple_test`` labels exact, dets rtol 1e-4 and
1e-3 abs (tests/test_torch_cascade.py's), masks 5e-5 abs (the mean of
three sigmoids of RoI features sampled at the detections' boxes, which
agree to ~2e-4 px after three decodes); the losses rtol 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.models import build_detector as jax_build_detector
from ioudet.models.mask_heads.fcn_mask_head import HTCMaskHead as JaxHTCMaskHead
from ioudet.models.mask_heads.fused_semantic_head import FusedSemanticHead as JaxSemantic
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.models import build_detector
from ioudet_torch.models.mask_heads.fcn_mask_head import HTCMaskHead
from ioudet_torch.models.mask_heads.fused_semantic_head import FusedSemanticHead
from tests._torch_mp_worker import htc_cfgs, two_stage_batches
from tests.test_torch_two_stage import FACTORS, PAD, SHAPES, images
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")
# (interleaved, mask_info_flow, semantic); Cascade Mask R-CNN's is all off
SETTINGS = {"cascade_mask_rcnn": (False, False, False), "without_semantic": (True, True, False),
            "htc": (True, True, True)}


def train_batch() -> dict:
    """Two images of ``two_stage_batches`` with a seeded box-frame mask for
    every gt slot and a seeded 7-class label map at stride 8 with an
    ignored band."""
    batch = {k: v[:2] for k, v in two_stage_batches(1)[0].items()}
    rng = np.random.default_rng(17)
    batch["gt_masks"] = (rng.uniform(size=batch["gt_labels"].shape + (112, 112)) > 0.4
                         ).astype(np.uint8)
    seg = rng.integers(0, 7, (2, 8, 12)).astype(np.int32)
    seg[:, 6:] = 255
    batch["gt_semantic_seg"] = seg
    return batch


def htc_params() -> dict:
    """Seeded values for the full HTC's parameter tree (the semantic branch,
    ``conv_res`` in stages 1-2); each setting takes its part of it."""
    model_cfg, train_cfg, test_cfg = htc_cfgs()
    det = jax_build_detector(dict(model_cfg), train_cfg, test_cfg)
    meta = tuple(map(jnp.asarray, (SHAPES, FACTORS, PAD)))
    return random_params(param_shapes(det, jnp.asarray(images(2)), *meta,
                                      method=det.simple_test), seed=0)


def htc_twin(setting: str, full: dict) -> tuple:
    """(port model, one jitted ioudet program: images -> (simple_test's
    outputs, forward_train's losses on ``train_batch``)) of a setting, on
    its part of ``htc_params``.  The parameters enter the program as an
    argument: as constants, XLA takes ~3 s longer to compile it."""
    _, flow, semantic = SETTINGS[setting]
    params = {k: ({n: leaf for n, leaf in v.items() if flow or n != "conv_res"}
                  if k.startswith("mask_head_") else v)
              for k, v in full.items() if semantic or k != "semantic_head"}
    model_cfg, train_cfg, test_cfg = htc_cfgs(*SETTINGS[setting])
    det = jax_build_detector(dict(model_cfg), train_cfg, test_cfg)
    meta = tuple(map(jnp.asarray, (SHAPES, FACTORS, PAD)))
    model = build_detector(model_cfg, train_cfg, test_cfg)
    model.load_state_dict(state_dict_from_flax(params))
    batch = {k: jnp.asarray(v) for k, v in train_batch().items()}
    kw = dict(gt_semantic_seg=batch["gt_semantic_seg"]) if semantic else {}

    @jax.jit
    def ref(p, x):
        outs = det.apply({"params": p}, x, *meta, method=det.simple_test)
        losses = det.apply({"params": p}, *(batch[k] for k in KEYS),
                           gt_masks=batch["gt_masks"], method=det.forward_train,
                           rngs={"sampler": jax.random.PRNGKey(3)}, **kw)
        return outs, losses

    return model, functools.partial(ref, params)


def check_bridge(setting: str, model) -> None:
    sd = model.state_dict()
    flow = SETTINGS[setting][1]
    assert [f"mask_head.{s}.conv_res.weight" in sd for s in range(3)] == [False, flow, flow]
    assert any(k.startswith("semantic_head.") for k in sd) == SETTINGS[setting][2]


def check_simple_test(model, ref, seed: int) -> None:
    x = images(seed)
    (want_d, want_l, want_m), _ = ref(jnp.asarray(x))
    meta = tuple(map(torch.from_numpy, (SHAPES, FACTORS, PAD)))
    with torch.no_grad():
        dets, labels, masks = model.eval().simple_test(torch.from_numpy(x), *meta)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    assert int((labels >= 0).sum()) >= 10
    np.testing.assert_allclose(dets.numpy(), np.asarray(want_d), rtol=1e-4, atol=1e-3)
    assert tuple(masks.shape) == (2, 20, 28, 28)
    np.testing.assert_allclose(masks.numpy(), np.asarray(want_m), rtol=0, atol=5e-5)
    m = masks.numpy()[labels.numpy() >= 0]   # spread over (0, 1), not one value
    assert float(m.std()) > 0.05 and 0.0 < float(m.min()) and float(m.max()) < 1.0


def check_train_losses(setting: str, model, ref) -> None:
    _, want = ref(jnp.asarray(images(2)))
    tb = {k: torch.from_numpy(v) for k, v in train_batch().items()}
    kw = dict(gt_semantic_seg=tb["gt_semantic_seg"]) if SETTINGS[setting][2] else {}
    with torch.no_grad():
        ours = model.train().forward_train(*(tb[k] for k in KEYS), gt_masks=tb["gt_masks"],
                                           generator=torch.Generator().manual_seed(5), **kw)
    keys = ["rpn_loss_bbox", "rpn_loss_cls"] + [
        f"s{s}_{k}" for s in range(3) for k in ("loss_cls", "loss_bbox", "loss_mask")]
    if SETTINGS[setting][2]:
        keys.append("loss_semantic_seg")
    assert sorted(ours) == sorted(want) == sorted(keys)
    for k in want:
        np.testing.assert_allclose(float(ours[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert all(float(ours[f"s{s}_loss_mask"]) > 0.05 for s in range(3))


@pytest.fixture(scope="module")
def twins():
    return ("htc",) + htc_twin("htc", htc_params())


def test_bridge_takes_each_stage_and_the_semantic_head(twins):
    check_bridge(twins[0], twins[1])


@pytest.mark.parametrize("seed", [2, 3])
def test_simple_test_matches_ioudet(twins, seed):
    check_simple_test(twins[1], twins[2], seed)


def test_train_losses_match_ioudet(twins):
    check_train_losses(*twins)


def test_semantic_head_matches_ioudet():
    """FusedSemanticHead alone through the bridge on five seeded levels of
    a 64x96 canvas (strides 4-64, the 8x12 fusion level's neighbours at
    non-integer ratios): logits, feature, and the loss on labels with an
    ignored region."""
    rng = np.random.default_rng(8)
    feats = [rng.normal(0, 1, (2, h, w, 16)).astype(np.float32)
             for h, w in ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))]
    jhead = JaxSemantic(num_ins=5, fusion_level=1, num_convs=2, in_channels=16,
                        conv_out_channels=16, num_classes=7)
    params = random_params(param_shapes(jhead, [jnp.asarray(f) for f in feats]), seed=1)
    want_pred, want_feat = jax.jit(jhead.apply)({"params": params}, [jnp.asarray(f) for f in feats])
    head = FusedSemanticHead(num_ins=5, fusion_level=1, num_convs=2, in_channels=16,
                             conv_out_channels=16, num_classes=7)
    sd = state_dict_from_flax({"semantic_head": params})
    head.load_state_dict({k[len("semantic_head."):]: v for k, v in sd.items()})
    with torch.no_grad():
        pred, feat = head([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for got, want in ((pred, want_pred), (feat, want_feat)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    seg = rng.integers(0, 7, (2, 8, 12)).astype(np.int32)
    seg[0, :3] = 255
    want = jax.jit(lambda p, x, y: jhead.apply({"params": p}, x, y, method=jhead.loss))(
        params, want_pred, jnp.asarray(seg))
    got = head.loss(pred, torch.from_numpy(seg))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    all_ignored = head.loss(pred, torch.full((2, 8, 12), 255, dtype=torch.int32))
    assert float(all_ignored) == 0.0


def test_mask_head_information_flow_matches_ioudet():
    """HTCMaskHead with the previous stage's feature through conv_res:
    logits and the pre-upsample feature it hands on."""
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (6, 14, 14, 16)).astype(np.float32)
    res = rng.normal(0, 1, (6, 14, 14, 16)).astype(np.float32)
    jhead = JaxHTCMaskHead(num_convs=2, in_channels=16, conv_out_channels=16, num_classes=5)
    params = random_params(param_shapes(jhead, jnp.asarray(x), jnp.asarray(res),
                                        return_feat=True), seed=2)
    want_logits, want_feat = jax.jit(lambda p, a, b: jhead.apply(
        {"params": p}, a, b, return_feat=True))(params, jnp.asarray(x), jnp.asarray(res))
    head = HTCMaskHead(num_convs=2, in_channels=16, conv_out_channels=16, num_classes=5)
    sd = state_dict_from_flax({"mask_head": params})
    head.load_state_dict({k[len("mask_head."):]: v for k, v in sd.items()})
    with torch.no_grad():
        logits, feat = head(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (x, res)))
    for got, want in ((logits, want_logits), (feat, want_feat)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
