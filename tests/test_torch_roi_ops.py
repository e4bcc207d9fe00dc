"""Port parity of the two-stage detector's parts on the CPU, against
``ioudet`` on the same seeded inputs: RoIAlign / RoIPool, the single-level
RoI extractor, the samplers, top-k accuracy, the box head (forward through
the weight bridge, and its loss) and the sampled anchor targets of the RPN.

Tolerances.  RoIAlign / RoIPool and the extractor's features: 1e-5 abs on
unit-scale maps (four products and a mean in another order); the
extractor's levels, every sampler's masks and the accuracy: exact.  Box
head outputs: 1e-4 of their scale (three f32 products of 3136, 64 and 64
terms); its losses rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.core.bbox import samplers as jsamplers
from ioudet.core.bbox.assigners import AssignResult as JaxAssignResult
from ioudet.models.bbox_heads.bbox_head import SharedFCBBoxHead as JaxSharedFC
from ioudet.models.bbox_heads.bbox_head import bbox_target_single as jax_bbox_target
from ioudet.models.losses.accuracy import accuracy as jax_accuracy
from ioudet.models.roi_extractors.single_level import SingleRoIExtractor as JaxExtractor
from ioudet.ops.roi_align import roi_align as jax_roi_align, roi_pool as jax_roi_pool
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.core.bbox import samplers
from ioudet_torch.core.bbox.assigners import AssignResult
from ioudet_torch.models.bbox_heads.bbox_head import SharedFCBBoxHead, bbox_target_single
from ioudet_torch.models.losses import accuracy
from ioudet_torch.models.roi_extractors.single_level import SingleRoIExtractor
from ioudet_torch.ops.roi_align import roi_align, roi_pool
from tests.torch_twins import one_thread  # noqa: F401 (autouse)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def roi_cases(seed=0, n=48):
    """rois (n, 5) on a 2-image batch of 13x17 maps at scale 1/4 (image
    52x68): inside, across the border, outside, degenerate (x2 < x1, a
    point) and padding (batch index -1)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-30, 80, (n, 2))
    wh = rng.uniform(0.5, 45, (n, 2))
    rois = np.concatenate([rng.integers(0, 2, (n, 1)), xy, xy + wh], 1)
    rois[:4, 1:] = [[5, 6, 30, 40], [0, 0, 67, 51], [-20, -10, 10, 8], [60, 45, 90, 70]]
    rois[4, 1:] = [200, 200, 260, 240]            # wholly outside
    rois[5, 1:] = [30, 20, 12, 4]                 # x2 < x1, y2 < y1
    rois[6, 1:] = [11, 9, 11, 9]                  # a point
    rois[7:10, 0] = -1                            # padding rows
    return rois.astype(np.float32)


@pytest.mark.parametrize("sample_num", [0, 2])
@pytest.mark.parametrize("op", ["align", "pool"])
def test_roi_align_and_pool_match_ioudet(op, sample_num):
    feats = np.random.default_rng(1).normal(0, 1, (2, 13, 17, 8)).astype(np.float32)
    rois = roi_cases()
    ours, ref = (roi_align, jax_roi_align) if op == "align" else (roi_pool, jax_roi_pool)
    got = ours(nchw(feats), torch.from_numpy(rois), 7, 0.25, sample_num)
    want = np.asarray(ref(jnp.asarray(feats), jnp.asarray(rois), pooled_size=7,
                          spatial_scale=0.25, sample_num=sample_num))
    assert tuple(got.shape) == (48, 8, 7, 7)
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-5)
    assert not got[7:10].any() and got[:4].abs().sum() > 0


def test_extractor_gathers_each_roi_on_its_own_level():
    """Level mapping exact; features equal to ioudet's sum over every level
    masked by the level (the masked terms are exact zeros)."""
    rng = np.random.default_rng(2)
    sizes = ((32, 48), (16, 24), (8, 12), (4, 6), (2, 3))
    feats = [rng.normal(0, 1, (2, h, w, 16)).astype(np.float32) for h, w in sizes]
    xy = rng.uniform(0, 150, (60, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(700), (60, 2)))
    rois = np.concatenate([rng.integers(0, 2, (60, 1)), xy, xy + wh], 1).astype(np.float32)
    rois[-2:, 0] = -1
    cfg = dict(out_channels=16, featmap_strides=(4, 8, 16, 32),
               roi_layer=dict(out_size=7, sample_num=2))
    ours = SingleRoIExtractor(**cfg)
    ref = JaxExtractor(**cfg)
    levels = ours.map_roi_levels(torch.from_numpy(rois))
    np.testing.assert_array_equal(levels.numpy(),
                                  np.asarray(ref.map_roi_levels(jnp.asarray(rois))))
    assert set(levels.tolist()) == {0, 1, 2, 3}
    got = ours([nchw(f) for f in feats], torch.from_numpy(rois))
    want = ref.apply({}, [jnp.asarray(f) for f in feats], jnp.asarray(rois))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=1e-5)
    # deformable RoI pooling is ported (tests/test_torch_deform_pool.py): a
    # pack a level; another layer type is named as not ported
    assert len(SingleRoIExtractor(roi_layer=dict(type="DeformRoIPoolingPack",
                                                 out_size=7)).roi_layers) == 4
    with pytest.raises(KeyError, match="not ported"):
        SingleRoIExtractor(roi_layer=dict(type="PSRoIPool", out_size=7))


# ------------------------------------------------------------------ samplers

def assign_case(seed, n=300, gts=6):
    """An AssignResult pair (port, ioudet) over n candidates: ignored (-1),
    negatives (0) and positives of ``gts`` instances, with overlaps."""
    rng = np.random.default_rng(seed)
    gt_inds = rng.choice(np.arange(-1, gts + 1), n, p=[0.2, 0.5] + [0.3 / gts] * gts)
    max_ov = np.where(gt_inds > 0, rng.uniform(0.5, 1, n), rng.uniform(0, 0.5, n))
    max_ov = np.where(gt_inds < 0, -1.0, max_ov).astype(np.float32)
    labels = np.where(gt_inds > 0, gt_inds % 3 + 1, 0)
    arrays = (gt_inds.astype(np.int32), max_ov, labels.astype(np.int32))
    return (AssignResult(*map(torch.from_numpy, arrays)),
            JaxAssignResult(*map(jnp.asarray, arrays)))


@pytest.mark.parametrize("levels", [4, 1000])
def test_cap_by_rank_matches_ioudet_with_ties(levels):
    """Integer-valued priorities: most of them tie, and ties go to the lower
    index in both packages."""
    rng = np.random.default_rng(levels)
    mask = rng.uniform(size=(3, 200)) < 0.6
    prio = np.floor(rng.uniform(size=(3, 200)) * levels).astype(np.float32)
    for limit in (0, 1, 37, 200):
        got = samplers._cap_by_rank(torch.from_numpy(mask), limit, torch.from_numpy(prio))
        for b in range(3):
            want = jsamplers._cap_by_rank(jnp.asarray(mask[b]), limit, jnp.asarray(prio[b]))
            np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
        assert int(got.sum(-1).max()) <= limit


SAMPLER_CFGS = {
    "random": dict(type="RandomSampler", num=64, pos_fraction=0.25),
    "random_neg_pos_ub": dict(type="RandomSampler", num=64, pos_fraction=0.5, neg_pos_ub=2),
    "instance_balanced": dict(type="InstanceBalancedPosSampler", num=64, pos_fraction=0.5),
    "iou_balanced": dict(type="IoUBalancedNegSampler", num=96, pos_fraction=0.25,
                         num_bins=3),
    "combined": dict(type="CombinedSampler",
                     pos_sampler=dict(type="InstanceBalancedPosSampler", num=64,
                                      pos_fraction=0.25),
                     neg_sampler=dict(type="IoUBalancedNegSampler", num=64,
                                      pos_fraction=0.25)),
}


def jax_draws(cfg: dict, key, shape) -> list:
    """ioudet's uniform draws of one ``sample(assign, key)``, in the order
    the port's samplers draw them (positives, then negatives; a combined
    sampler's positive sampler first)."""
    if cfg["type"] == "CombinedSampler":
        k1, k2 = jax.random.split(key)
        return jax_draws(cfg["pos_sampler"], k1, shape) + jax_draws(cfg["neg_sampler"], k2, shape)
    return [np.array(jax.random.uniform(k, shape)) for k in jax.random.split(key)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("name", sorted(SAMPLER_CFGS))
def test_sampler_masks_equal_ioudet_on_its_draws(name, ties, monkeypatch):
    """ioudet's draws fed to the port's sampler through its ``uniform``:
    the masks are ioudet's bit for bit, one image at a time and as a batch.
    With ``ties`` both packages draw noise rounded down to eighths, so most
    priorities tie and the order of ties decides."""
    cfg = SAMPLER_CFGS[name]
    if ties:
        uniform = jax.random.uniform
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape: jnp.floor(uniform(key, shape) * 8) / 8)
    cases = [assign_case(seed) for seed in (3, 4)]
    keys = [jax.random.PRNGKey(seed) for seed in (7, 8)]
    draws = [jax_draws(cfg, k, (300,)) for k in keys]
    got = []
    for (ours, ref), key, d in zip(cases, keys, draws):
        feed = iter(d)
        monkeypatch.setattr(samplers, "uniform", lambda *a: torch.from_numpy(next(feed)))
        pos, neg = samplers.build_sampler(cfg).sample(ours, None)
        want = jsamplers.build_sampler(cfg).sample(ref, key)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(want.pos_mask))
        np.testing.assert_array_equal(neg.numpy(), np.asarray(want.neg_mask))
        assert int(pos.sum()) > 0 and int(neg.sum()) > 0
        got.append((pos, neg))
    # the same draws stacked: a batch of two images gives each image's masks
    feed = iter([np.stack(pair) for pair in zip(*draws)])
    monkeypatch.setattr(samplers, "uniform", lambda *a: torch.from_numpy(next(feed)))
    batch = AssignResult(*(torch.stack(t) for t in zip(*(c[0] for c in cases))))
    pos, neg = samplers.build_sampler(cfg).sample(batch, None)
    for b, (p, n) in enumerate(got):
        assert torch.equal(pos[b], p) and torch.equal(neg[b], n)


def test_ohem_selects_by_the_losses_as_ioudet_does():
    ours, ref = assign_case(5)
    losses = np.floor(np.random.default_rng(6).uniform(0, 8, 300)).astype(np.float32)  # ties
    pos, neg = samplers.OHEMSampler(64, 0.25).sample_with_losses(ours, torch.from_numpy(losses))
    want = jsamplers.OHEMSampler(64, 0.25).sample_with_losses(ref, jnp.asarray(losses),
                                                              jax.random.PRNGKey(0))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want.pos_mask))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(want.neg_mask))
    assert int(pos.sum()) == 16 and int(neg.sum()) == 48


def test_pseudo_sampler_and_unknown_type():
    ours, ref = assign_case(9)
    pos, neg = samplers.build_sampler(dict(type="PseudoSampler")).sample(ours)
    want = jsamplers.PseudoSampler().sample(ref)
    assert np.array_equal(pos.numpy(), np.asarray(want.pos_mask))
    assert np.array_equal(neg.numpy(), np.asarray(want.neg_mask))
    with pytest.raises(KeyError):
        samplers.build_sampler(dict(type="ScoreHLRSampler", num=4, pos_fraction=0.5))


@pytest.mark.parametrize("neg_pos_ub", [-1, 3])
def test_generator_draws_respect_the_caps(neg_pos_ub):
    """Drawn from a torch.Generator: a batch's counts per image, positives
    capped at num * pos_fraction, negatives at neg_pos_ub times the
    positives, the same masks for the same seed."""
    ours = AssignResult(*(torch.stack(t) for t in zip(*(assign_case(s)[0] for s in (10, 11)))))
    sampler = samplers.RandomSampler(128, 0.25, neg_pos_ub=neg_pos_ub)
    pos, neg = sampler.sample(ours, torch.Generator().manual_seed(0))
    n_pos = (ours.gt_inds > 0).sum(-1)
    assert torch.equal(pos.sum(-1), n_pos.clamp(max=32))
    want_neg = 128 - pos.sum(-1)
    if neg_pos_ub >= 0:
        want_neg = torch.minimum(want_neg, neg_pos_ub * pos.sum(-1))
    assert torch.equal(neg.sum(-1), want_neg.clamp(max=(ours.gt_inds == 0).sum(-1)))
    assert not (pos & (ours.gt_inds <= 0)).any() and not (neg & (ours.gt_inds != 0)).any()
    again = sampler.sample(ours, torch.Generator().manual_seed(0))
    assert torch.equal(again[0], pos) and torch.equal(again[1], neg)
    other = sampler.sample(ours, torch.Generator().manual_seed(1))
    assert not torch.equal(other[1], neg)


@pytest.mark.parametrize("topk", [1, (1, 3)])
def test_accuracy_matches_ioudet(topk):
    rng = np.random.default_rng(12)
    pred = np.floor(rng.normal(0, 2, (40, 6))).astype(np.float32)   # ties
    target = rng.integers(0, 6, 40)
    got = accuracy(torch.from_numpy(pred), torch.from_numpy(target), topk)
    want = jax_accuracy(jnp.asarray(pred), jnp.asarray(target), topk)
    for g, w in zip(np.atleast_1d(got if isinstance(got, list) else [got]),
                    np.atleast_1d(want if isinstance(want, list) else [want])):
        assert float(g) == pytest.approx(float(w), abs=1e-4)


# ------------------------------------------------------------------ box head

@pytest.fixture(scope="module")
def box_heads():
    """ioudet's SharedFCBBoxHead with seeded parameters and the port's on
    the bridged weights, 16 channels, 7x7, 6 classes."""
    ref = JaxSharedFC(num_classes=6, in_channels=16, fc_out_channels=32)
    x = np.random.default_rng(13).normal(0, 1, (20, 7, 7, 16)).astype(np.float32)
    params = ref.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: np.array(a, copy=True), params)
    ours = SharedFCBBoxHead(num_classes=6, in_channels=16, fc_out_channels=32)
    sd = {k[len("bbox_head."):]: v for k, v in
          state_dict_from_flax(dict(bbox_head=params)).items()}
    ours.load_state_dict(sd)
    return ours, ref, params, x


def test_box_head_forward_through_the_bridge(box_heads):
    """The bridge permutes shared_fc0's input from ioudet's (S, S, C)
    flatten to the port's (C, S, S): without the permutation the outputs
    differ."""
    ours, ref, params, x = box_heads
    with torch.no_grad():
        cls, reg = ours(nchw(x))
    jcls, jreg = ref.apply({"params": params}, jnp.asarray(x))
    for g, w in ((cls, jcls), (reg, jreg)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    assert tuple(reg.shape) == (20, 24)
    unpermuted = dict(ours.state_dict())
    unpermuted["shared_fcs.0.weight"] = torch.from_numpy(
        np.asarray(params["shared_fc0"]["kernel"]).T.copy())
    plain = SharedFCBBoxHead(num_classes=6, in_channels=16, fc_out_channels=32)
    plain.load_state_dict(unpermuted)
    with torch.no_grad():
        assert not np.allclose(plain(nchw(x))[0].numpy(), np.asarray(jcls), atol=1e-2)


def _dense_leaf(n_in: int, n_out: int) -> dict:
    return dict(kernel=np.zeros((n_in, n_out), np.float32), bias=np.zeros(n_out, np.float32))


@pytest.mark.parametrize("tree", [
    # the plain BBoxHead: fc_cls / fc_reg take the flattened RoI feature
    dict(fc_cls=_dense_leaf(7 * 7 * 16, 6), fc_reg=_dense_leaf(7 * 7 * 16, 24)),
    # ConvFCBBoxHead with a shared conv and no shared fc (the gn / gn+ws
    # heads' shared convs before their fc are bridged: tests/test_torch_gn_ws.py)
    dict(shared_conv0=dict(conv=dict(kernel=np.zeros((3, 3, 16, 16), np.float32))),
         fc_cls=_dense_leaf(7 * 7 * 16, 6), fc_reg=_dense_leaf(7 * 7 * 16, 24)),
], ids=["plain_bbox_head", "shared_conv"])
def test_bridge_refuses_other_box_heads(tree):
    """Only a ConvFCBBoxHead's tree with shared fcs is bridged; another box
    head's raises rather than guessing which layer takes the RoI feature."""
    with pytest.raises(NotImplementedError):
        state_dict_from_flax(dict(bbox_head=tree))


def test_box_head_loss_and_targets_match_ioudet(box_heads):
    ours, ref, params, x = box_heads
    rng = np.random.default_rng(14)
    n = x.shape[0]
    rois = np.concatenate([rng.uniform(0, 50, (n, 2)), rng.uniform(60, 120, (n, 2))],
                          1).astype(np.float32)
    gts = (rois + rng.normal(0, 4, (n, 4))).astype(np.float32)
    pos = rng.uniform(size=n) < 0.4
    labels = rng.integers(1, 6, n).astype(np.int32)
    got_t = bbox_target_single(*map(torch.from_numpy, (rois, pos, gts, labels)))
    want_t = jax_bbox_target(*map(jnp.asarray, (rois, pos, gts, labels)))
    np.testing.assert_array_equal(got_t[0].numpy(), np.asarray(want_t[0]))
    np.testing.assert_allclose(got_t[1].numpy(), np.asarray(want_t[1]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_t[2].numpy(), np.asarray(want_t[2]))
    label_w = (rng.uniform(size=n) < 0.8).astype(np.float32)
    cls, reg = ours(nchw(x))
    got = ours.loss(cls, reg, got_t[0], torch.from_numpy(label_w), got_t[1], got_t[2])
    jcls, jreg = ref.apply({"params": params}, jnp.asarray(x))
    want = ref.loss(jcls, jreg, want_t[0], jnp.asarray(label_w), want_t[1], want_t[2])
    for k in ("loss_cls", "loss_bbox"):
        assert float(got[k].detach()) == pytest.approx(float(want[k]), rel=1e-5), k
    assert float(got["loss_bbox"].detach()) > 0
