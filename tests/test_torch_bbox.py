"""Port parity: box math and anchors of ioudet_torch against ioudet on the
same seeded numpy inputs.  Elementwise f32 formulas in the same operation
order are exact; the ones through exp/log are held to 1e-6 relative (f32
roundoff of the two libraries' transcendentals)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.core.anchor.anchor_generator import AnchorGenerator as JaxAnchors
from ioudet.core.bbox import geometry as jgeo, transforms as jtr
from ioudet.models.heads.anchor_head import clip_boxes as jclip
from ioudet_torch.core.anchor import AnchorGenerator
from ioudet_torch.core.bbox import bbox2delta, bbox2result, bbox_overlaps, delta2bbox
from ioudet_torch.models.heads.anchor_head import clip_boxes
from tests.torch_twins import one_thread  # noqa: F401 (autouse)


def boxes(rng, shape, lo=0.0, hi=300.0):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(0.0, 80.0, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("mode", ["iou", "iof"])
@pytest.mark.parametrize("aligned", [False, True])
def test_bbox_overlaps(mode, aligned):
    rng = np.random.default_rng(0)
    a = boxes(rng, (2, 37))
    b = boxes(rng, (2, 37 if aligned else 23))
    b[0, :5] = a[0, :5]                 # identical boxes: IoU exactly 1
    b[1, 3] = [1e5, 1e5, 1e5 + 9, 1e5 + 9]  # disjoint, far away
    ref = np.asarray(jgeo.bbox_overlaps(jnp.asarray(a), jnp.asarray(b), mode=mode,
                                        is_aligned=aligned))
    out = bbox_overlaps(torch.from_numpy(a), torch.from_numpy(b), mode=mode,
                        is_aligned=aligned).numpy()
    np.testing.assert_array_equal(out, ref)


def test_bbox_overlaps_bad_mode():
    with pytest.raises(ValueError):
        bbox_overlaps(torch.zeros(1, 4), torch.zeros(1, 4), mode="giou")


def test_bbox2delta_and_back():
    rng = np.random.default_rng(1)
    props, gt = boxes(rng, (50,)), boxes(rng, (50,))
    means, stds = (0.1, -0.1, 0.0, 0.2), (0.5, 0.5, 1.0, 2.0)
    ref = np.asarray(jtr.bbox2delta(jnp.asarray(props), jnp.asarray(gt), means, stds))
    out = bbox2delta(torch.from_numpy(props), torch.from_numpy(gt), means, stds).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("max_shape", [None, (120, 160)])
def test_delta2bbox(k, max_shape):
    rng = np.random.default_rng(2)
    rois = boxes(rng, (3, 40))
    deltas = rng.normal(0, 2.0, (3, 40, 4 * k)).astype(np.float32)
    deltas[0, :3, 2] = [10.0, -10.0, 4.2]  # beyond the wh_ratio_clip bound
    means, stds = (0.0, 0.1, 0.0, -0.1), (1.0, 1.0, 0.5, 0.5)
    ref = np.asarray(jtr.delta2bbox(jnp.asarray(rois),
                                    jnp.asarray(deltas), means, stds,
                                    max_shape=max_shape))
    out = delta2bbox(torch.from_numpy(rois), torch.from_numpy(deltas), means, stds,
                     max_shape=max_shape).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)


def test_bbox2result_drops_padding():
    rng = np.random.default_rng(3)
    dets = rng.uniform(0, 100, (10, 5)).astype(np.float32)
    labels = np.array([0, 2, -1, 1, 0, -1, 2, 2, -1, 0])
    ref = jtr.bbox2result(dets, labels, 4)
    out = bbox2result(torch.from_numpy(dets), torch.from_numpy(labels), 4)
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    empty = bbox2result(np.zeros((3, 5), np.float32), np.full(3, -1), 4)
    assert [e.shape for e in empty] == [(0, 5)] * 3


@pytest.mark.parametrize("base,stride,size", [(8, 8, (7, 11)), (128, 128, (1, 2)),
                                              (16, 16, (4, 3))])
def test_anchor_generator(base, stride, size):
    scales = [4 * 2 ** (i / 3) for i in range(3)]
    ratios = (0.5, 1.0, 2.0)
    ref = JaxAnchors(base, scales, ratios)
    gen = AnchorGenerator(base, scales, ratios)
    np.testing.assert_array_equal(gen.base_anchors, ref.base_anchors)
    np.testing.assert_array_equal(gen.grid_anchors(size, stride).numpy(),
                                  np.asarray(ref.grid_anchors(size, stride)))
    valid_hw = [(size[0], size[1]), (max(size[0] - 1, 0), 1)]
    out = gen.valid_flags(size, (torch.tensor([v[0] for v in valid_hw]),
                                 torch.tensor([v[1] for v in valid_hw]))).numpy()
    for i, v in enumerate(valid_hw):
        np.testing.assert_array_equal(out[i], np.asarray(ref.valid_flags(size, v)))


def test_get_anchors_matches_ioudet():
    from ioudet.models.heads.retina_head import RetinaHead as JaxRetinaHead
    from ioudet_torch.models.heads.retina_head import RetinaHead

    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    pads = np.array([[64, 96], [40, 70]], np.int32)
    kw = dict(num_classes=5, anchor_strides=(8, 16, 32, 64, 128))
    ja, jv = JaxRetinaHead(**kw).get_anchors(sizes, jnp.asarray(pads))
    ta, tv = RetinaHead(in_channels=8, feat_channels=8, stacked_convs=1,
                        **kw).get_anchors(sizes, torch.from_numpy(pads))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_clip_boxes():
    rng = np.random.default_rng(4)
    b = boxes(rng, (2, 30), lo=-50.0, hi=200.0)
    shapes = np.array([[100, 150], [60, 90]], np.int32)
    out = clip_boxes(torch.from_numpy(b), torch.from_numpy(shapes)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(
            out[i], np.asarray(jclip(jnp.asarray(b[i]), jnp.asarray(shapes[i]))))
