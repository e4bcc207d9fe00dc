"""Port parity: ioudet_torch.ops.preprocess against ioudet.ops.preprocess
on the same seeded uint8 images.  Tolerance 1e-4 absolute on the normalised
canvas (values of order 1): the bilinear sums are the same f32 formula, but
XLA may fuse them into other roundings."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.ops.preprocess import preprocess as jax_preprocess
from ioudet.ops.preprocess import preprocess_batch as jax_preprocess_batch
from ioudet_torch.ops.preprocess import preprocess, preprocess_batch

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
