"""Port parity of SSD300 on the CPU (configs/ssd300_coco.py at full width:
VGG-16, 81 softmax classes): ``ioudet``'s parameter tree filled with seeded
values and bridged by ``state_dict_from_flax`` (the VGG convs He-normal so
that activations keep their scale, the first one scaled to SSD's pixel-scale
inputs, the L2Norm scale drawn), on the same
seeded inputs at batch 2.  One jitted ``ioudet`` program serves the
forward side (the backbone's maps, the head's outputs, ``decode_candidates``,
``simple_test``) and one the training side (the losses and every
parameter's gradient of ``forward_train``, and the head's loss on planted
logits with ties at the mining threshold, whose gradient shows ``ioudet``'s
mined anchors).

Tolerances (TF32 off): feature maps and head outputs within 1e-5 of each
map's largest |value| (rtol 1e-5 at that scale); anchors bit for bit;
candidates rtol 1e-5; ``simple_test`` labels exact, dets rtol 1e-4; the
mined mask exact; losses rtol 1e-4 and each parameter's gradient within
2e-3 of the tensor's largest |gradient| (tests/test_torch_train.py's bound):
the first VGG convs' f32 gradients of either package sit up to 1.5e-3 of
that off an f64 run of the port, through twenty layers of VGG."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.apis import checkpoint as jckpt
from ioudet.core.bbox.transforms import bbox2result as jax_bbox2result
from ioudet.data.pipelines.transforms import Resize as JaxResize
from ioudet.models import build_detector as jax_build_detector
from ioudet.ops.preprocess import _resize_bilinear_hpc
from ioudet.utils.config import Config as JaxConfig
from ioudet_torch.apis.checkpoint import load_checkpoint, module_types, state_dict_from_flax
from ioudet_torch.apis.inference import DetectorHandle, inference_detector
from ioudet_torch.models import build_detector
from ioudet_torch.models.losses.cross_entropy_loss import cross_entropy
from ioudet_torch.ops import assign_cuda
from ioudet_torch.utils.config import Config
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSD300 = "ssd300_coco.py"
KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")


def configs(name: str) -> tuple:
    """(the port's config dict, ioudet's) of configs/<name>."""
    path = os.path.join(ROOT, "configs", name)
    return Config.fromfile(path).todict(), JaxConfig.fromfile(path).todict()


def ssd_twin(name: str, seed: int = 0, test_cfg=None) -> tuple:
    """(ioudet's detector, its seeded parameters, the port's model on the
    bridged weights) of configs/<name>."""
    cfg, jcfg = configs(name)
    test_cfg = test_cfg or jcfg["test_cfg"]
    det = jax_build_detector(jcfg["model"], jcfg["train_cfg"], test_cfg)
    size = jcfg["model"]["backbone"]["input_size"]
    params = random_params(param_shapes(det, jnp.zeros((1, size, size, 3))), seed)
    rng = np.random.default_rng(seed + 100)
    for leaf in params["backbone"].values():
        if "kernel" in leaf:   # He-normal: random activations keep their scale
            leaf["kernel"] *= 2.0
    # SSD's inputs keep the pixel scale (std 1): the first conv brings them to O(1)
    params["backbone"]["conv1_1"]["kernel"] /= 64.0
    params["backbone"]["l2norm"]["gamma"] = rng.uniform(10, 30, 512).astype(np.float32)
    model = build_detector(cfg["model"], cfg["train_cfg"], test_cfg)
    model.load_state_dict(state_dict_from_flax(params, module_types(model)), strict=True)
    return det, params, model


def images(batch: int, size: int, seed: int = 0) -> np.ndarray:
    """Normalized-looking canvases: smooth blobs plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = np.stack([np.sin(6 * xx + c) * np.cos(5 * yy - c) for c in range(3)], -1)
    return (60 * base[None] + rng.normal(0, 20, (batch, size, size, 3))).astype(np.float32)


def train_batch(seed: int = 3) -> dict:
    """Two 300x300 images with 5 gt slots, the last of the second invalid:
    gts of every anchor level's size (21, 45, 99, 153, 207, 261 px), so that
    each level has positives and every parameter a gradient."""
    rng = np.random.default_rng(seed)
    sizes = np.array([[24, 60, 110, 160, 265], [23, 45, 100, 210, 150]], np.float32)
    wh = sizes[..., None] * rng.uniform(0.9, 1.1, (2, 5, 2))
    xy = rng.uniform(0, 1, (2, 5, 2)) * (300 - wh)
    valid = np.ones((2, 5), bool)
    valid[1, -1] = False
    shapes = np.full((2, 2), 300, np.int32)
    return dict(img=images(2, 300, seed),
                gt_bboxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
                gt_labels=rng.integers(1, 81, (2, 5)).astype(np.int32), gt_valid=valid,
                img_shape=shapes, pad_shape=shapes.copy())


@pytest.fixture(autouse=True, scope="module")
def no_tf32():
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.fixture(scope="module")
def twin():
    return ssd_twin(SSD300)


SHAPES = np.full((2, 2), 300, np.int32)
FACTORS = np.array([1.25, 0.6], np.float32)
# Resize(keep_ratio=False) of a 480x640 and a 333x500 image to 300x300: (w, h, w, h)
FACTORS4 = np.array([[300 / 640, 300 / 480] * 2, [300 / 500, 300 / 333] * 2], np.float32)


def raw_image(seed: int = 7) -> np.ndarray:
    """A 240x320 BGR uint8 photo-like image for inference_detector."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:240, 0:320] / 240
    base = np.stack([np.sin(7 * xx + 2 * c) * np.cos(4 * yy + c) for c in range(3)], -1)
    return np.clip(128 + 90 * base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)


def ioudet_served_image(jcfg: dict) -> tuple:
    """ioudet's serving inputs of ``raw_image()`` under SSD300's test
    pipeline: its float half-pixel resize to 300x300 (its device
    preprocess's sampler) on the RGB image, the config's Normalize, and
    img_shape and the (4,) scale factor of its host Resize(keep_ratio=False)."""
    raw = raw_image()
    norm = next(s for s in jcfg["data"]["test"]["pipeline"] if s["type"] == "Normalize")
    resized = _resize_bilinear_hpc(jnp.asarray(raw[..., ::-1].copy()), 300, 300,
                                   jnp.float32(raw.shape[0]), jnp.float32(raw.shape[1]))
    canvas = (resized - jnp.asarray(norm["mean"], jnp.float32)) / jnp.asarray(norm["std"],
                                                                              jnp.float32)
    meta = JaxResize(img_scale=(300, 300), keep_ratio=False)(dict(img=raw))
    return (np.asarray(canvas)[None], np.asarray([meta["img_shape"]], np.int32),
            meta["scale_factor"][None])


@pytest.fixture(scope="module")
def served(twin):
    """ioudet's forward side at batch 2 (and ``raw_image()``'s canvas
    behind it), one compiled program: (feats, cls_scores, bbox_preds,
    candidate boxes, candidate scores, (dets, labels) rescaled by (B,)
    factors, (dets, labels) rescaled by (B, 4) factors, (dets, labels) of
    ``raw_image()``, as ``simple_test`` gives them), and the inputs."""
    det, params, _ = twin
    test_cfg = dict(det.test_cfg)
    one = ioudet_served_image(configs(SSD300)[1])

    def run(m, img, shapes, factors, factors4, img1, shape1, factor1):
        # one forward of the three canvases, split behind the head
        feats3 = m.extract_feat(jnp.concatenate([img, img1]))
        cls3, reg3 = m.bbox_head(feats3)
        feats, cls, reg = ([t[:2] for t in ts] for ts in (feats3, cls3, reg3))
        boxes, scores = m.bbox_head.decode_candidates(cls, reg, shapes, test_cfg)
        scalar, per_axis = (m.bbox_head.get_bboxes(cls, reg, shapes, f, shapes, test_cfg,
                                                   rescale=True) for f in (factors, factors4))
        served1 = m.bbox_head.get_bboxes([t[2:] for t in cls3], [t[2:] for t in reg3], shape1,
                                         factor1, jnp.full((1, 2), 300), test_cfg, rescale=True)
        return feats, cls, reg, boxes, scores, scalar, per_axis, served1

    img = images(2, 300)
    fn = jax.jit(lambda p, *a: det.apply({"params": p}, *a, method=run))
    out = jax.device_get(fn(params, *(jnp.asarray(a) for a in (img, SHAPES, FACTORS, FACTORS4)
                                      + one)))
    return out, img


def assert_close_scaled(got, ref, tol, what):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0, what
    np.testing.assert_allclose(np.asarray(got), ref, rtol=tol, atol=tol * scale, err_msg=what)


@pytest.fixture(scope="module")
def forward(twin, served):
    """The port's backbone maps and head outputs on ``served``'s canvases,
    one forward."""
    _, img = served
    model = twin[2].eval()
    with torch.no_grad():
        feats = model.backbone(torch.from_numpy(img).permute(0, 3, 1, 2).contiguous())
        return feats, model.bbox_head(feats)


def test_feature_maps_match_ioudet(served, forward):
    (feats, *_), _ = served
    ours = forward[0]
    assert [tuple(f.shape[2:]) for f in ours] == [(37, 37), (18, 18), (9, 9), (5, 5), (3, 3),
                                                  (1, 1)]
    for i, (o, r) in enumerate(zip(ours, feats)):
        assert tuple(o.permute(0, 2, 3, 1).shape) == r.shape
        assert_close_scaled(o.permute(0, 2, 3, 1).numpy(), r, 1e-5, f"level {i}")


def test_anchors_match_ioudet(twin):
    det, _, model = twin
    sizes = [(37, 37), (18, 18), (9, 9), (5, 5), (3, 3), (1, 1)]
    pads = np.array([[300, 300], [200, 260]], np.int32)
    ref_anchors, ref_valid = jax.jit(lambda p: det.apply(
        {}, sizes, p, method=lambda m, s, q: m.bbox_head.get_anchors(s, q)))(jnp.asarray(pads))
    anchors, valid = model.bbox_head.get_anchors(sizes, torch.from_numpy(pads))
    assert anchors.shape == (8096, 4)
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(ref_anchors))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert not valid[1].all() and valid[0].all()


def test_head_outputs_match_ioudet(served, forward):
    (_, cls, reg, *_), _ = served
    ours_cls, ours_reg = forward[1]
    for i, (o, r) in enumerate(zip(ours_cls + ours_reg, list(cls) + list(reg))):
        assert tuple(o.shape) == r.shape
        assert_close_scaled(o.numpy(), r, 1e-5, f"output {i}")


def test_decode_candidates_on_the_same_head_outputs(twin, served):
    """ioudet's head outputs through the port's decode: the softmax drops
    the background column, each level keeps its top 1000 (all of the
    smaller ones), 2676 candidates of 80 classes an image."""
    (_, cls, reg, boxes, scores, *_), _ = served
    model = twin[2]
    with torch.no_grad():
        cand_boxes, cand_scores = model.bbox_head.decode_candidates(
            [torch.from_numpy(c) for c in cls], [torch.from_numpy(r) for r in reg],
            torch.from_numpy(SHAPES), dict(model.test_cfg))
    assert cand_scores.shape == (2, 1000 + 1000 + 486 + 150 + 36 + 4, 80)
    np.testing.assert_allclose(cand_scores.numpy(), scores, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(cand_boxes.numpy(), boxes, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("factors", ["scalar", "per_axis"])
def test_simple_test_matches_ioudet(twin, served, factors):
    """The port's ``simple_test`` on the same canvases (its forward, decode
    and K1's plain NMS) against ioudet's: all 200 slots an image, labels
    exact, dets rtol 1e-4; rescaled by a (B,) factor, or by the (B, 4)
    (w, h, w, h) factors of a Resize without keep_ratio, SSD's own."""
    out, img = served
    ref_dets, ref_labels = out[5] if factors == "scalar" else out[6]
    f = FACTORS if factors == "scalar" else FACTORS4
    with torch.no_grad():
        dets, labels = twin[2].eval().simple_test(
            torch.from_numpy(img), torch.from_numpy(SHAPES), torch.from_numpy(f),
            torch.from_numpy(SHAPES))
    assert (ref_labels >= 0).all()
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_allclose(dets.numpy(), ref_dets, rtol=1e-4, atol=1e-6)


def test_inference_detector_matches_ioudet(twin, served):
    """SSD's serving path end to end: a 240x320 BGR image through the port's
    ``inference_detector`` (Resize without keep_ratio to 300x300 on the
    model's device, the (4,) factor) against ioudet's ``simple_test`` on
    its own float resize of the image and its host Resize's factor: per
    class, the same boxes in the same order, rtol 1e-4."""
    (*_, (ref_dets, ref_labels)), _ = served
    handle = DetectorHandle(model=twin[2].eval(), cfg=configs(SSD300)[0],
                            device=torch.device("cpu"))
    res = inference_detector(handle, raw_image())
    want = jax_bbox2result(ref_dets[0], ref_labels[0], 81)
    assert len(res) == len(want) == 80
    assert sum(map(len, want)) > 0
    for c, (got, ref) in enumerate(zip(res, want)):
        assert got.shape == ref.shape, c
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6, err_msg=f"class {c}")


# ------------------------------------------------------------------ training


def planted_logits(model, batch: dict, seed: int = 5) -> tuple:
    """Head outputs whose cross-entropies are planted around each image's
    mining threshold: k - 2 negatives of distinct large losses, a tie of 5
    at the threshold, every other anchor small.  Returns (cls_scores,
    bbox_preds) per level (NHWC) and the positive and negative masks."""
    head = model.bbox_head
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    sizes = [(37, 37), (18, 18), (9, 9), (5, 5), (3, 3), (1, 1)]
    anchors, valid = head.get_anchors(sizes, tb["pad_shape"])
    from ioudet_torch.core.anchor import anchor_target
    from ioudet_torch.core.bbox import MaxIoUAssigner
    cfg = {k: v for k, v in model.train_cfg["assigner"].items() if k != "type"}
    t = anchor_target(anchors, valid, tb["gt_bboxes"], tb["gt_valid"], tb["gt_labels"],
                      tb["img_shape"], MaxIoUAssigner(**cfg), head.target_means,
                      head.target_stds)
    pos = (t.bbox_weights[..., 0] > 0).numpy()
    neg = (t.label_weights > 0).numpy() & ~pos
    rng = np.random.default_rng(seed)
    C = head.cls_out_channels
    logits = rng.normal(0, 0.1, (2, anchors.shape[0], C)).astype(np.float32)
    logits[..., 0] = 6.0   # background confident: small losses
    for b in range(2):
        k = 3 * int(pos[b].sum())
        idx = rng.permutation(np.flatnonzero(neg[b]))
        assert 5 < k < len(idx) - 10
        logits[b, idx[:k - 2], 0] = -np.linspace(2.0, 6.0, k - 2)   # distinct, large
        logits[b, idx[k - 2:k + 3]] = logits[b, idx[k - 2]]          # a tie of 5 ...
        logits[b, idx[k - 2:k + 3], 0] = -1.0                         # ... at the threshold
    deltas = rng.normal(0, 0.5, (2, anchors.shape[0], 4)).astype(np.float32)
    cls, reg, start = [], [], 0
    for (h, w), a in zip(sizes, head.level_num_anchors):
        n = h * w * a
        cls.append(logits[:, start:start + n].reshape(2, h, w, a * C))
        reg.append(deltas[:, start:start + n].reshape(2, h, w, a * 4))
        start += n
    return cls, reg, pos, neg


@pytest.fixture(scope="module")
def trained(twin):
    """ioudet's training side in one compiled program: forward_train's
    losses and gradient w.r.t. every parameter at batch 2, and the head's
    loss on planted logits with its gradient w.r.t. those logits."""
    det, params, model = twin
    batch = train_batch()
    cls, reg, pos, neg = planted_logits(model, batch)
    cfg = dict(det.train_cfg)

    def losses(p, *a):
        out = det.apply({"params": p}, *a, method=det.forward_train)
        return sum(out.values()), out

    def planted(c, r, gb, gl, gv, shapes):
        out = det.apply({}, c, r, gb, gl, gv, shapes, shapes, cfg,
                        method=lambda m, *a: m.bbox_head.loss(*a))
        return out["loss_cls"], out

    def run(p, c, r, *a):
        (_, out), grads = jax.value_and_grad(losses, has_aux=True)(p, *a)
        gb, gl, gv, shapes = a[1], a[2], a[3], a[4]
        (_, pout), dcls = jax.value_and_grad(planted, has_aux=True)(c, r, gb, gl, gv, shapes)
        return out, grads, pout, dcls

    fn = jax.jit(run)
    out = jax.device_get(fn(params, [jnp.asarray(c) for c in cls],
                            [jnp.asarray(r) for r in reg],
                            *(jnp.asarray(batch[k]) for k in KEYS)))
    return out, batch, (cls, reg, pos, neg)


def test_losses_and_gradients_match_ioudet(twin, trained):
    (ref, grads, _, _), batch, _ = trained
    model = twin[2].train()
    model.zero_grad()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model.forward_train(tb["img"], tb["gt_bboxes"], tb["gt_labels"], tb["gt_valid"],
                              tb["img_shape"], tb["pad_shape"])
    assert sorted(out) == sorted(ref) == ["loss_bbox", "loss_cls"]
    for k in out:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-4, err_msg=k)
    assert float(ref["loss_bbox"]) > 0
    sum(out.values()).backward()
    ref_grads = state_dict_from_flax(grads, module_types(model))
    named = dict(model.named_parameters())
    assert sorted(ref_grads) == sorted(named)
    for k, p in named.items():
        assert p.grad is not None, k
        assert_close_scaled(p.grad.numpy(), ref_grads[k].numpy(), 2e-3, k)


def test_mined_negatives_match_ioudet_with_ties_at_the_threshold(twin, trained):
    """ioudet's mined anchors are those whose logits get a gradient from
    loss_cls, less the positives; the port's ``mine_negatives`` on the same
    cross-entropies gives them, ties at the threshold all mined, and its
    loss equals ioudet's."""
    (_, _, ref_out, dcls), batch, (cls, reg, pos, neg) = trained
    head = twin[2].bbox_head
    C = head.cls_out_channels
    touched = np.concatenate([np.abs(d).reshape(2, -1, C).sum(-1) for d in dcls], 1) > 0
    ref_mined = touched & ~pos
    assert np.array_equal(touched & pos, pos)
    logits = torch.from_numpy(np.concatenate([c.reshape(2, -1, C) for c in cls], 1))
    ce = cross_entropy(logits, torch.zeros(logits.shape[:2], dtype=torch.long),
                       reduction="none")   # the negatives' label: background
    mined = head.mine_negatives(ce, torch.from_numpy(pos), torch.from_numpy(neg)).numpy()
    np.testing.assert_array_equal(mined, ref_mined)
    for b in range(2):
        assert mined[b].sum() == 3 * pos[b].sum() + 3   # k - 2 above, the tie of 5

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = head.loss([torch.from_numpy(c) for c in cls], [torch.from_numpy(r) for r in reg],
                    tb["gt_bboxes"], tb["gt_labels"], tb["gt_valid"], tb["img_shape"],
                    tb["pad_shape"], dict(twin[2].train_cfg))
    for k in ("loss_cls", "loss_bbox"):
        np.testing.assert_allclose(float(out[k]), float(ref_out[k]), rtol=1e-5, err_msg=k)


def test_loss_takes_the_plain_assigner_path(twin, monkeypatch):
    """gt_max_assign_all=False keeps SSD off the fused assignment kernels
    (K2): the general path assigns, and K2's wrapper is never reached."""
    def k2(*a, **kw):
        raise AssertionError("K2 reached")

    monkeypatch.setattr(assign_cuda, "fused_anchor_assign", k2)
    head = twin[2].bbox_head
    assert head.level_num_anchors == [4, 6, 6, 6, 4, 4]
    assert twin[2].train_cfg["assigner"]["gt_max_assign_all"] is False
    batch = train_batch()
    sizes = [(37, 37), (18, 18), (9, 9), (5, 5), (3, 3), (1, 1)]
    C = head.cls_out_channels
    cls = [torch.zeros(2, h, w, a * C) for (h, w), a in zip(sizes, head.level_num_anchors)]
    reg = [torch.zeros(2, h, w, a * 4) for (h, w), a in zip(sizes, head.level_num_anchors)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = head.loss(cls, reg, tb["gt_bboxes"], tb["gt_labels"], tb["gt_valid"],
                    tb["img_shape"], tb["pad_shape"], dict(twin[2].train_cfg))
    assert float(out["loss_cls"]) > 0


def test_the_bridge_takes_ssd_only_when_named(twin):
    """SSD's tree is bridged as SSDVGG and SSDHead only where the detector's
    module types name them; without them the ResNet form is taken and the
    first VGG name raises."""
    _, params, model = twin
    assert module_types(model) == dict(backbone="SSDVGG", bbox_head="SSDHead")
    with pytest.raises(KeyError, match="unknown backbone param"):
        state_dict_from_flax(params)
    with pytest.raises(KeyError, match="unknown SSD backbone param"):
        state_dict_from_flax(dict(backbone=dict(layer1_0={})), module_types(model))


def test_load_checkpoint_reads_an_ioudet_directory(twin, tmp_path):
    """ioudet's checkpoint directory of the SSD tree (msgpack, mmdet's names
    through the bridge) loads into a freshly built port model, strict."""
    _, params, model = twin
    jckpt.save_checkpoint(str(tmp_path), "iter_3", dict(params=params, step=np.int32(3)),
                          dict(epoch=1, step=3))
    cfg, _ = configs(SSD300)
    fresh = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"])
    assert load_checkpoint(fresh, str(tmp_path / "iter_3")) == dict(epoch=1, step=3)
    for (k, a), b in zip(fresh.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), k
