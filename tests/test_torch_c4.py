"""The C4 form of Faster R-CNN on the CPU, against ``ioudet``: R-50 in caffe
style cut after its third stage (the stride-16, 1024-channel map), one RPN
level, RoIAlign at 14x14 and the ResNet's res5 (``ResLayer``, FrozenBN) as
the shared head before an avg-pooled ``BBoxHead`` of 5 classes, as
configs/faster_rcnn_r50_caffe_c4_1x.py builds it but with a few proposals
an image on 64x96 canvases; ``ioudet``'s parameter tree filled with seeded
values and bridged (``tests/torch_twins.py``).  Held: ``ResLayer`` alone,
``simple_test`` and the losses (every candidate sampled, as in
``faster_rcnn_cfgs``), and the chunked RoIAlign (``ops/roi_align.py``)
bit-equal to one chunk, forward and input gradient, on the C4 map and on
FPN levels, and its row gather's backward (``index_add_`` into f32) against
autograd's own.

Tolerances: ``ResLayer`` 1e-4 of its largest |output| (three bottlenecks
of 512 planes in f32); ``simple_test`` labels exact, dets rtol 1e-4 and
1e-3 abs (PERF.md section 2); losses rtol 1e-5; the chunks: forward
bit-equal, and the gradient of the maps within 1e-6 of its largest
|value|: autograd sums the chunks' scatter-adds of the same terms in
another order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.models import build_detector as jax_build_detector
from ioudet.models.shared_heads.res_layer import ResLayer as JaxResLayer
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.models import build_detector
from ioudet_torch.models.shared_heads.res_layer import ResLayer
from ioudet_torch.ops import roi_align
from tests._torch_mp_worker import faster_rcnn_cfgs, two_stage_batches
from tests.test_torch_two_stage import FACTORS, PAD, SHAPES, images
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")
MAX_NUM = 12


def c4_cfgs(num_gts: int = 4, max_num: int = MAX_NUM) -> tuple:
    model, train, test = faster_rcnn_cfgs(num_gts, max_num)
    model = dict(
        type="FasterRCNN",
        backbone=dict(type="ResNet", depth=50, num_stages=3, out_indices=(2,), style="caffe",
                      strides=(1, 2, 2), frozen_stages=1, norm_cfg=dict(type="FrozenBN")),
        shared_head=dict(type="ResLayer", depth=50, stage=3, stride=2, style="caffe"),
        rpn_head=dict(model["rpn_head"], in_channels=1024, feat_channels=1024,
                      anchor_scales=[2, 4, 8, 16, 32], anchor_strides=[16]),
        bbox_roi_extractor=dict(type="SingleRoIExtractor", out_channels=1024,
                                featmap_strides=[16], roi_layer=dict(out_size=14, sample_num=2)),
        bbox_head=dict(type="BBoxHead", with_avg_pool=True, roi_feat_size=7, in_channels=2048,
                       num_classes=5))
    return model, train, test


MODEL, TRAIN_CFG, TEST_CFG = c4_cfgs()


def test_res_layer_matches_ioudet():
    jlayer = JaxResLayer(depth=50, stage=3, stride=2, style="caffe")
    x = np.random.default_rng(0).normal(0, 1, (3, 14, 14, 1024)).astype(np.float32)
    params = random_params(param_shapes(jlayer, jnp.asarray(x)), seed=2)
    want = jax.jit(lambda p, a: jlayer.apply({"params": p}, a))(params, jnp.asarray(x))
    layer = ResLayer(depth=50, stage=3, stride=2, style="caffe")
    sd = state_dict_from_flax({"shared_head": params})
    assert sorted(sd) == sorted(f"shared_head.{k}" for k in layer.state_dict())
    assert "shared_head.layer4.0.downsample.1.running_var" in sd
    layer.load_state_dict({k[len("shared_head."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    assert tuple(got.shape) == want.shape == (3, 2048, 7, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def twins():
    det = jax_build_detector(dict(MODEL), TRAIN_CFG, TEST_CFG)
    meta = tuple(map(jnp.asarray, (SHAPES, FACTORS, PAD)))
    params = random_params(param_shapes(det, jnp.asarray(images(2)), *meta,
                                        method=det.simple_test), seed=0)
    model = build_detector(MODEL, TRAIN_CFG, TEST_CFG)
    model.load_state_dict(state_dict_from_flax(params))
    batch = {k: v[:2] for k, v in two_stage_batches(1)[0].items()}

    @jax.jit
    def ref(p, x):
        dets = det.apply({"params": p}, x, *meta, method=det.simple_test)
        losses = det.apply({"params": p}, *(jnp.asarray(batch[k]) for k in KEYS),
                           method=det.forward_train, rngs={"sampler": jax.random.PRNGKey(3)})
        return dets, losses

    return model, batch, functools.partial(ref, params)


@pytest.mark.parametrize("seed", [2, 3])
def test_c4_simple_test_matches_ioudet(twins, seed):
    model, _, ref = twins
    x = images(seed)
    (want_d, want_l), _ = ref(jnp.asarray(x))
    with torch.no_grad():
        dets, labels = model.eval().simple_test(
            torch.from_numpy(x), *map(torch.from_numpy, (SHAPES, FACTORS, PAD)))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    assert int((labels >= 0).sum()) >= 6
    np.testing.assert_allclose(dets.numpy(), np.asarray(want_d), rtol=1e-4, atol=1e-3)


def test_c4_losses_match_ioudet(twins):
    model, batch, ref = twins
    _, want = ref(jnp.asarray(images(2)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ours = model.train().forward_train(*(tb[k] for k in KEYS),
                                       generator=torch.Generator().manual_seed(5))
    assert sorted(ours) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(ours[k].detach()), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    sum(ours.values()).backward()
    assert float(model.shared_head.layer4[2].conv3.weight.grad.abs().max()) > 0


@pytest.mark.parametrize("levels", [1, 4])
def test_chunked_roi_align_is_one_chunk(monkeypatch, levels):
    """A chunk of 3 rois against one chunk of all: the output bit for bit,
    the maps' gradient within 1e-6 of its largest |value|."""
    rng = np.random.default_rng(levels)
    feats = [torch.from_numpy(rng.normal(0, 1, (2, 16, 24 >> i, 32 >> i)).astype(np.float32))
             for i in range(levels)]
    n = 29
    xy = rng.uniform(0, 90, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 60, (n, 2))], 1)
    rois = torch.from_numpy(np.concatenate([rng.integers(-1, 2, (n, 1)), boxes], 1)
                            .astype(np.float32))
    lvl = torch.from_numpy(rng.integers(0, levels, n))
    scales = [1.0 / 4 / 2 ** i for i in range(levels)]
    w = torch.from_numpy(rng.normal(0, 1, (n, 16, 7, 7)).astype(np.float32))

    def run():
        fs = [f.clone().requires_grad_(True) for f in feats]
        out = roi_align.roi_align_levels(fs, rois, lvl, scales, 7, 2)
        (out * w).sum().backward()
        return out.detach(), [f.grad for f in fs]

    whole, whole_grads = run()
    monkeypatch.setattr(roi_align, "CHUNK_BYTES", 3 * 14 * 14 * 16 * 4)
    assert roi_align.chunk_rois(14, 16) == 3
    chunked, chunked_grads = run()
    assert torch.equal(whole, chunked)
    assert bool((whole[rois[:, 0] < 0] == 0).all()) and float(whole.abs().max()) > 0
    for g, h in zip(whole_grads, chunked_grads):
        torch.testing.assert_close(h, g, rtol=0, atol=1e-6 * float(g.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_backward_is_autograds(dtype):
    """RoIAlign's row gather (``roi_align._RowGather``): the forward is
    ``table[idx]`` bit for bit; the backward, ``index_add_`` into f32 cast
    once, is autograd's own backward of ``table[idx]`` taken in f32 and cast
    once, with 567 rows gathered from 5 (each index repeated ~110 times).
    Tolerance: 1e-6 of the largest |gradient| in f32 (the same sums, maybe
    in another order), one bf16 step of it in bf16."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(0, 1, (40, 16)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 5, (7, 9, 9)))
    grad = torch.from_numpy(rng.normal(0, 1, (7, 9, 9, 16)).astype(np.float32)).to(dtype)
    ours = table.clone().requires_grad_(True)
    out = roi_align._RowGather.apply(ours, idx)
    out.backward(grad)
    assert out.dtype == dtype and torch.equal(out, table[idx])
    ref = table.float().requires_grad_(True)
    ref[idx].backward(grad.float())
    want = ref.grad.to(dtype)
    assert ours.grad.dtype == dtype and not want[5:].any()
    step = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(ours.grad, want, rtol=0,
                               atol=step * float(want.float().abs().max()))
