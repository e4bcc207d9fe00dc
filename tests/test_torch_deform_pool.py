"""Deformable RoI pooling of the port (``ops/deform_pool.py``) on the CPU,
against ``ioudet/ops/deform_pool.py``: ``deform_roi_pool`` with seeded
offsets, forward and the gradients of the map and of the offsets; both
packs (``DeformRoIPoolingPack``, ``ModulatedDeformRoIPoolingPack``) on
``ioudet``'s parameter tree filled with seeded values (the last offset fc
drawn nonzero) and bridged (the mmdet layout: fc1's input (C, S, S), the
offsets as (x, y[, mask]) planes); and ``SingleRoIExtractor`` with the
modulated packs on four FPN levels, each roi on its own level.

The inputs keep every sample off the map's border by more than float
noise: there ``jnp.clip`` and ``torch.clamp`` may give a position's
gradient to different sides of a tie.  Rois partly off the map are in,
with their samples clamped strictly inside the clamp.

Tolerances: outputs and gradients within 5e-5 of each tensor's largest
|value|.  XLA's program rounds the sample positions otherwise than the
port in the last bit (most outputs differ, by up to ~1e-5 on O(1) maps,
with the offsets at zero too, as RoIAlign's do in
tests/test_torch_roi_ops.py, atol 1e-5): one rounding of a position moves
a bilinear weight by ~4e-6 at 50 px (PERF.md section 6), and a map's
gradient sums many such terms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.models.roi_extractors.single_level import SingleRoIExtractor as JaxExtractor
from ioudet.ops.deform_pool import (DeformRoIPoolingPack as JaxPack,
                                    ModulatedDeformRoIPoolingPack as JaxModPack,
                                    deform_roi_pool as jax_deform_roi_pool)
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.models.roi_extractors.single_level import SingleRoIExtractor
from ioudet_torch.ops.deform_pool import (DeformRoIPoolingPack, ModulatedDeformRoIPoolingPack,
                                          deform_roi_pool)
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

C = 8
REL = 5e-5


def scaled_close(got: torch.Tensor, want, rel: float = REL) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def rois_on(rng, n: int, h: int, w: int, stride: int) -> np.ndarray:
    """(n, 5) rois in image coordinates on two images, one padding roi."""
    xy = rng.uniform(-0.1, 0.8, (n, 2)) * (w * stride, h * stride)
    wh = rng.uniform(0.15, 0.6, (n, 2)) * (w * stride, h * stride)
    rois = np.concatenate([rng.integers(0, 2, (n, 1)), xy, xy + wh], 1)
    rois[-1, 0] = -1
    return rois.astype(np.float32)


def nhwc(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def to_nchw(y) -> np.ndarray:
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_deform_roi_pool_matches_ioudet_with_gradients(seed):
    rng = np.random.default_rng(seed)
    h, w, stride, n = 12, 17, 8, 11
    feat = rng.normal(0, 1, (2, C, h, w)).astype(np.float32)
    rois = rois_on(rng, n, h, w, stride)
    off = rng.normal(0, 1, (n, 7, 7, 2)).astype(np.float32)
    wout = rng.normal(0, 1, (n, 7, 7, C)).astype(np.float32)

    def loss(f, o):
        y = jax_deform_roi_pool(f, jnp.asarray(rois), o, 7, 1.0 / stride, 2, 0.1)
        return (y * wout).sum(), y

    (_, want), (gf, go) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        nhwc(feat), jnp.asarray(off))
    ft = torch.from_numpy(feat).requires_grad_(True)
    ot = torch.from_numpy(off).requires_grad_(True)
    got = deform_roi_pool(ft, torch.from_numpy(rois), ot, 7, 1.0 / stride, 2, 0.1)
    scaled_close(got.permute(0, 2, 3, 1), want)
    assert float(got[-1].abs().max()) == 0.0   # the padding roi
    (got.permute(0, 2, 3, 1) * torch.from_numpy(wout)).sum().backward()
    scaled_close(ft.grad, to_nchw(gf))
    scaled_close(ot.grad, go)
    assert float(ot.grad.abs().max()) > 0


def pack_pair(modulated: bool, seed: int):
    """(port pack, ioudet pack, its parameters) on a stride-8 map."""
    jcls, tcls = (JaxModPack, ModulatedDeformRoIPoolingPack) if modulated else \
        (JaxPack, DeformRoIPoolingPack)
    jpack = jcls(out_size=7, spatial_scale=1.0 / 8, sample_num=2, trans_std=0.1,
                 deform_fc_channels=32)
    feat = jnp.zeros((2, 12, 17, C))
    params = random_params(param_shapes(jpack, feat, jnp.zeros((3, 5))), seed=seed)
    pack = tcls(7, C, 1.0 / 8, 2, 0.1, deform_fc_channels=32)
    sd = state_dict_from_flax({"bbox_roi_extractor": {"deform_pool0": params}})
    prefix = "bbox_roi_extractor.roi_layers.0."
    assert sorted(sd) == sorted(prefix + k for k in pack.state_dict())
    pack.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return pack, jpack, params


@pytest.mark.parametrize("modulated", [False, True])
def test_packs_match_ioudet_with_gradients(modulated):
    rng = np.random.default_rng(3 + modulated)
    pack, jpack, params = pack_pair(modulated, seed=4)
    feat = rng.normal(0, 1, (2, C, 12, 17)).astype(np.float32)
    rois = rois_on(rng, 9, 12, 17, 8)
    wout = rng.normal(0, 1, (9, 7, 7, C)).astype(np.float32)

    def loss(p, f):
        y = jpack.apply({"params": p}, f, jnp.asarray(rois))
        return (y * wout).sum(), y

    (_, want), (gp, gf) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, nhwc(feat))
    ft = torch.from_numpy(feat).requires_grad_(True)
    got = pack(ft, torch.from_numpy(rois))
    scaled_close(got.permute(0, 2, 3, 1), want)
    (got.permute(0, 2, 3, 1) * torch.from_numpy(wout)).sum().backward()
    scaled_close(ft.grad, to_nchw(gf))
    grads = state_dict_from_flax({"bbox_roi_extractor": {"deform_pool0": gp}})
    for k, g in grads.items():
        p = dict(pack.named_parameters())[k[len("bbox_roi_extractor.roi_layers.0."):]]
        scaled_close(p.grad, g.numpy())
    assert float(pack.offset_fc[4].weight.grad.abs().max()) > 0


def test_zero_offsets_pool_as_roi_align():
    """The packs start with offset_fc's last layer at zero: the second pass
    is the first, RoIAlign (and the modulation a factor 1/2)."""
    rng = np.random.default_rng(6)
    feat = torch.from_numpy(rng.normal(0, 1, (2, C, 12, 17)).astype(np.float32))
    rois = torch.from_numpy(rois_on(rng, 5, 12, 17, 8))
    for cls, factor in ((DeformRoIPoolingPack, 1.0), (ModulatedDeformRoIPoolingPack, 0.5)):
        pack = cls(7, C, 1.0 / 8, 2, 0.1, deform_fc_channels=16)
        pack.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():
            assert torch.equal(pack(feat, rois), deform_roi_pool(feat, rois, None, 7, 1.0 / 8)
                               * factor)


def test_extractor_with_modulated_packs_matches_ioudet():
    """Four levels, a pack each, each roi on its own level: the output and
    the gradient of every pack and level."""
    rng = np.random.default_rng(7)
    cfg = dict(out_channels=C, featmap_strides=(4, 8, 16, 32),
               roi_layer=dict(type="ModulatedDeformRoIPoolingPack", out_size=7, sample_num=2,
                              trans_std=0.1))
    jext = JaxExtractor(**cfg)
    feats = [rng.normal(0, 1, (2, C, 128 >> i, 160 >> i)).astype(np.float32) for i in range(4)]
    n = 16
    wh = np.exp(rng.uniform(np.log(40), np.log(600), (n, 1))) * rng.uniform(0.8, 1.2, (n, 2))
    xy = rng.uniform(0, 1, (n, 2)) * np.maximum((640, 512) - wh, 1)
    rois = np.concatenate([rng.integers(0, 2, (n, 1)), xy, xy + wh], 1).astype(np.float32)
    params = random_params(param_shapes(jext, [jnp.asarray(f.transpose(0, 2, 3, 1))
                                               for f in feats], jnp.asarray(rois)), seed=8)
    ext = SingleRoIExtractor(**cfg)
    sd = state_dict_from_flax({"bbox_roi_extractor": params})
    ext.load_state_dict({k[len("bbox_roi_extractor."):]: v for k, v in sd.items()})
    levels = ext.map_roi_levels(torch.from_numpy(rois))
    assert sorted(set(levels.tolist())) == [0, 1, 2, 3]
    wout = rng.normal(0, 1, (n, 7, 7, C)).astype(np.float32)

    def loss(p, fs):
        y = jext.apply({"params": p}, fs, jnp.asarray(rois))
        return (y * wout).sum(), y

    (_, want), (gp, gfs) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, [nhwc(f) for f in feats])
    fts = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    got = ext(fts, torch.from_numpy(rois))
    scaled_close(got.permute(0, 2, 3, 1), want)
    (got.permute(0, 2, 3, 1) * torch.from_numpy(wout)).sum().backward()
    for f, g in zip(fts, gfs):
        scaled_close(f.grad, to_nchw(g))
    named = dict(ext.named_parameters())
    grads = state_dict_from_flax({"bbox_roi_extractor": gp})
    assert sorted(grads) == sorted(f"bbox_roi_extractor.{k}" for k in named)
    for k, g in grads.items():
        scaled_close(named[k[len("bbox_roi_extractor."):]].grad, g.numpy())
