"""Port parity: ioudet_torch.ops.preprocess against ioudet.ops.preprocess
on the same seeded uint8 images.  Tolerance 1e-4 absolute on the normalised
canvas (values of order 1): the bilinear sums are the same f32 formula, but
XLA may fuse them into other roundings."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.data.pipelines.transforms import Normalize as JaxNormalize
from ioudet.data.pipelines.transforms import Pad as JaxPad
from ioudet.data.pipelines.transforms import Resize as JaxResize
from ioudet.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, _resize_bilinear_hpc
from ioudet.ops.preprocess import preprocess as jax_preprocess
from ioudet.ops.preprocess import preprocess_batch as jax_preprocess_batch
from ioudet_torch.ops.preprocess import preprocess, preprocess_batch
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

CANVAS, SCALE = (64, 96), (96, 64)


@pytest.mark.parametrize("src,flip", [((40, 60), False), ((60, 40), True),
                                      ((37, 90), False), ((64, 96), True)])
def test_preprocess_matches_ioudet(src, flip):
    rng = np.random.default_rng(0)
    buf = np.zeros((72, 100, 3), np.uint8)  # content in the top-left
    buf[:src[0], :src[1]] = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    kw = dict(canvas=CANVAS, max_scale=SCALE, flip_channels=flip)
    out, shape, factor = preprocess(torch.from_numpy(buf),
                                    torch.tensor(src, dtype=torch.int32), **kw)
    r_out, r_shape, r_factor = jax_preprocess(jnp.asarray(buf),
                                              jnp.asarray(src, jnp.int32), **kw)
    np.testing.assert_array_equal(shape.numpy(), np.asarray(r_shape))
    assert float(factor) == float(r_factor)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=0, atol=1e-4)


def test_preprocess_batch_matches_ioudet():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (3, 50, 80, 3), dtype=np.uint8)
    srcs = np.array([[50, 80], [30, 70], [50, 41]], np.int32)
    out, shapes, factors = preprocess_batch(torch.from_numpy(imgs),
                                            torch.from_numpy(srcs),
                                            canvas=CANVAS, max_scale=SCALE)
    r_out, r_shapes, r_factors = jax_preprocess_batch(
        jnp.asarray(imgs), jnp.asarray(srcs), canvas=CANVAS, max_scale=SCALE)
    np.testing.assert_array_equal(shapes.numpy(), np.asarray(r_shapes))
    np.testing.assert_array_equal(factors.numpy(), np.asarray(r_factors))
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=0, atol=1e-4)
    # the pad region is exactly zero
    for i, (h, w) in enumerate(shapes.tolist()):
        assert not out[i, h:].any() and not out[i, :, w:].any()


@pytest.mark.parametrize("scale,norm", [((300, 300), dict(mean=(123.675, 116.28, 103.53),
                                                           std=(1.0, 1.0, 1.0))),
                                        ((48, 80), dict())])
def test_preprocess_without_keep_ratio_matches_ioudet(scale, norm):
    """Resize(keep_ratio=False) -> Normalize(to_rgb) -> Pad(size, orient_aware=False),
    SSD's test pipeline, on a batch of a landscape and a portrait image:
    img_shape and the (w, h, w, h) factors exactly ``ioudet``'s host Resize's;
    the canvas within 1e-4 of ``ioudet``'s float half-pixel sampler at the
    target size, normalised, and within one uint8 step of its host pipeline,
    whose cv2 resize rounds each pixel to uint8."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, 72, 100, 3), dtype=np.uint8)
    srcs = np.array([[50, 80], [70, 41]], np.int32)
    out, shapes, factors = preprocess_batch(torch.from_numpy(imgs), torch.from_numpy(srcs),
                                            canvas=scale, max_scale=scale, flip_channels=True,
                                            keep_ratio=False, **norm)
    steps = [JaxResize(img_scale=scale, keep_ratio=False), JaxNormalize(to_rgb=True, **norm),
             JaxPad(size=scale, orient_aware=False)]
    mean = np.asarray(norm.get("mean", IMAGENET_MEAN), np.float32)
    std = np.asarray(norm.get("std", IMAGENET_STD), np.float32)
    for i, (h, w) in enumerate(srcs):
        host = dict(img=imgs[i, :h, :w].copy())
        for step in steps:
            host = step(host)
        assert tuple(shapes[i].tolist()) == host["img_shape"] == scale
        np.testing.assert_array_equal(factors[i].numpy(), host["scale_factor"])
        np.testing.assert_allclose(out[i].numpy(), host["img"], rtol=0,
                                   atol=1.0 / float(std.min()))
        sampled = _resize_bilinear_hpc(jnp.asarray(imgs[i, :, :, ::-1].copy()), *scale,
                                       jnp.float32(h), jnp.float32(w))
        np.testing.assert_allclose(out[i].numpy(), (np.asarray(sampled) - mean) / std,
                                   rtol=0, atol=1e-4)
