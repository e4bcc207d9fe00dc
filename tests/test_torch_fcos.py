"""Port parity of FCOS on the CPU: the tiny model of
tests/test_detectors.py's ``TestFCOS`` (R-18, FPN and towers 32 wide, so GN
of 32 groups has one channel a group; 5 classes; two tower convs), built
from ``ioudet``'s parameter tree filled with seeded values and bridged by
``state_dict_from_flax``, on the same seeded inputs at batch 2 on 96x128
canvases.  One jitted ``ioudet`` program serves every case: the head's
outputs, ``decode_candidates`` (on the outputs and on planted outputs whose
score x centerness products tie across the top-k cut), ``simple_test``,
the point targets of a gt set with equal-area overlapping gts and padded
slots, the centerness targets, and ``forward_train``'s losses with every
parameter's gradient.

Tolerances: head outputs within 1e-4 of each output's largest |value| (f32
sums over some 20 layers in another order); points, targets and labels
exact; the centerness target within one f32 rounding (rtol 2e-7);
candidates rtol 1e-5; ``simple_test`` labels exact, dets rtol 1e-4; losses
rtol 1e-4 and each gradient within 1e-3 of its tensor's largest |value|.
The focal term is the sum of five per-level sums in the port (K3's
plain version at A = 1) and one flat sum in ``ioudet``: they differ only in
summation order."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.models import build_detector as jax_build_detector
from ioudet.models.heads.fcos_head import level_points as jax_level_points
from ioudet_torch.apis.checkpoint import module_types, state_dict_from_flax
from ioudet_torch.apis.test import aug_test
from ioudet_torch.models import build_detector
from ioudet_torch.models.heads.fcos_head import FCOSHead, level_points
from ioudet_torch.ops import quant
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

MODEL = dict(
    type="FCOS",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1, norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32, start_level=1,
              add_extra_convs=True, num_outs=5),
    bbox_head=dict(type="FCOSHead", num_classes=5, in_channels=32, feat_channels=32,
                   stacked_convs=2, strides=(8, 16, 32, 64, 128)))
TEST_CFG = dict(nms_pre=60, score_thr=0.05, nms=dict(iou_thr=0.5), max_per_img=20)
CANVAS = (96, 128)
SIZES = [(12, 16), (6, 8), (3, 4), (2, 2), (1, 1)]
SHAPES = np.array([[96, 128], [80, 112]], np.int32)
FACTORS = np.array([1.0, 0.625], np.float32)
G = 8
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")   # frozen_stages=1
TOWER_BIAS = re.compile(r"bbox_head\.(cls|reg)_convs\.\d+\.conv\.bias")


def images(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (2,) + CANVAS + (3,)).astype(np.float32)


def gts() -> tuple:
    """Two images' gts, G slots: sizes for P3 (< 64 px from a point) to P4
    (64-128), two overlapping gts of equal area (a tie for the smallest
    area: the first index must win), the same box twice, and padded slots
    (gt_valid False) lying over valid boxes."""
    b = np.zeros((2, G, 4), np.float32)
    b[0, :6] = [[4, 6, 40, 38], [10, 12, 46, 44], [50, 20, 110, 90], [2, 2, 125, 93],
                [60, 40, 90, 70], [60, 40, 90, 70]]
    b[1, :5] = [[20, 20, 52, 52], [8, 30, 100, 78], [30, 10, 70, 50], [70, 5, 106, 41],
                [12, 12, 28, 28]]
    b[1, 5:7] = [[20, 20, 52, 52], [8, 30, 100, 78]]    # padding over valid boxes
    valid = np.zeros((2, G), bool)
    valid[0, :6] = True
    valid[1, :5] = True
    labels = np.array([[1, 2, 3, 4, 2, 3, 0, 0], [4, 1, 2, 3, 1, 2, 3, 0]], np.int32)
    return b, labels, valid


def planted_outputs(seed: int = 4) -> tuple:
    """Head outputs whose score x centerness products tie: a few logit
    values only, so that many points share their largest product, several
    of them across level 0's top-60 cut."""
    rng = np.random.default_rng(seed)
    cls, reg, ctr = [], [], []
    for h, w in SIZES:
        cls.append(rng.choice([-1.0, 0.5, 2.0], (2, h, w, 4)).astype(np.float32))
        ctr.append(rng.choice([0.0, 1.5], (2, h, w, 1)).astype(np.float32))
        reg.append(rng.uniform(2, 40, (2, h, w, 4)).astype(np.float32))
    return cls, reg, ctr


def twin(seed: int = 0) -> tuple:
    det = jax_build_detector(MODEL, dict(), TEST_CFG)
    params = random_params(param_shapes(det, jnp.zeros((1,) + CANVAS + (3,))), seed)
    model = build_detector(MODEL, dict(), TEST_CFG)
    model.load_state_dict(state_dict_from_flax(params, module_types(model)), strict=True)
    return det, params, model


@pytest.fixture(scope="module")
def pair():
    return twin()


@pytest.fixture(scope="module")
def ref(pair):
    """ioudet's side, one compiled program."""
    det, params, _ = pair
    gt_bboxes, gt_labels, gt_valid = gts()
    cfg = dict(TEST_CFG)

    def forward_side(m, img, shapes, factors, gb, gl, gv, pc, pr, pz):
        cls, reg, ctr = m(img)
        cand = m.bbox_head.decode_candidates(cls, reg, ctr, shapes, cfg)
        dets = m.bbox_head.get_bboxes(cls, reg, ctr, shapes, factors, shapes, cfg,
                                      rescale=True)
        planted = m.bbox_head.decode_candidates(pc, pr, pz, shapes, cfg)
        head = m.bbox_head
        pts = jnp.concatenate([jnp.asarray(jax_level_points(fs, s))
                               for fs, s in zip(SIZES, head.strides)])
        rngs = jnp.concatenate([jnp.broadcast_to(jnp.asarray(r, jnp.float32), (fs[0] * fs[1], 2))
                                for fs, r in zip(SIZES, head.regress_ranges)])
        labels, ltrb = jax.vmap(lambda b, v, lab: head._targets_single(pts, rngs, b, v, lab))(
            gb, gv, gl)
        return (cls, reg, ctr), cand, dets, planted, (labels, ltrb,
                                                       head.centerness_target(ltrb))

    def losses(p, *a):
        out = det.apply({"params": p}, *a, method=det.forward_train)
        return sum(out.values()), out

    def run(p, img, shapes, factors, gb, gl, gv, pc, pr, pz):
        fwd = det.apply({"params": p}, img, shapes, factors, gb, gl, gv, pc, pr, pz,
                        method=forward_side)
        (_, out), grads = jax.value_and_grad(losses, has_aux=True)(
            p, img, gb, gl, gv, shapes, shapes)
        return fwd, out, grads

    img = images()
    pc, pr, pz = planted_outputs()
    args = [img, SHAPES, FACTORS, gt_bboxes, gt_labels, gt_valid]
    out = jax.device_get(jax.jit(run)(params, *(jnp.asarray(a) for a in args),
                                      [jnp.asarray(c) for c in pc], [jnp.asarray(r) for r in pr],
                                      [jnp.asarray(z) for z in pz]))
    return out, img


def t(a):
    return torch.from_numpy(np.array(a))


def assert_close_scaled(got, want, tol, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * scale, err_msg=what)


def test_level_points_match_ioudet():
    for (h, w), s in zip([(12, 16), (7, 5), (1, 1)], (8, 16, 128)):
        np.testing.assert_array_equal(level_points((h, w), s, "cpu").numpy(),
                                      jax_level_points((h, w), s))


def test_head_outputs_match_ioudet(pair, ref):
    (fwd, _, _), img = ref
    with torch.no_grad():
        outs = pair[2].eval()(t(img))
    for i, (ours, theirs) in enumerate(zip(outs, fwd[0])):
        for lvl, (o, r) in enumerate(zip(ours, theirs)):
            assert tuple(o.shape) == r.shape
            assert_close_scaled(o.numpy(), r, 1e-4, f"output {i} level {lvl}")
    assert (np.asarray(fwd[0][1][0]) > 0).all()   # exp'd distances


def test_targets_match_ioudet_with_ties_and_padding(pair, ref):
    (fwd, _, _), _ = ref
    ref_labels, ref_ltrb, ref_ctr = fwd[4]
    head = pair[2].bbox_head
    gb, gl, gv = (t(a) for a in gts())
    points, ranges = head.points(SIZES, "cpu")
    labels, ltrb = head.targets(points, ranges, gb, gv, gl)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_array_equal(ltrb.numpy(), ref_ltrb)
    # the tie: P3's points inside both equal-area gts 4 and 5 of image 0 take
    # gt 4's label (2), not gt 5's (3)
    both = ((points[:, 0] > 60) & (points[:, 0] < 90) & (points[:, 1] > 40) &
            (points[:, 1] < 70) & (torch.arange(len(points)) < 12 * 16))
    assert both.sum() > 4 and (labels[0][both] == 2).all()
    # the padding over image 1's valid boxes changes nothing
    head2 = head.targets(points, ranges, gb[1:, :5], gv[1:, :5], gl[1:, :5])
    np.testing.assert_array_equal(head2[0].numpy(), labels[1:].numpy())
    for lvl in range(2):   # gts of both P3's and P4's regress range are positives
        start = sum(h * w for h, w in SIZES[:lvl])
        assert (labels[:, start:start + SIZES[lvl][0] * SIZES[lvl][1]] > 0).any()
    np.testing.assert_allclose(FCOSHead.centerness_target(ltrb).numpy(), ref_ctr, rtol=2e-7,
                               atol=0)


def test_decode_with_tied_products_keeps_ioudets_order(pair, ref):
    """Planted outputs of three logit values and two centerness values: the
    top-60 of level 0 (192 points) cuts through a run of tied products,
    and the port keeps ``lax.top_k``'s lower indices."""
    (fwd, _, _), _ = ref
    boxes, scores = fwd[3]
    head = pair[2].bbox_head
    pc, pr, pz = planted_outputs()
    with torch.no_grad():
        b, s = head.decode_candidates([t(c) for c in pc], [t(r) for r in pr],
                                      [t(z) for z in pz], t(SHAPES), TEST_CFG)
    prod = (torch.sigmoid(t(pc[0])) * torch.sigmoid(t(pz[0]))).amax(-1).reshape(2, -1)
    cut = prod.sort(dim=1, descending=True).values[:, 59]
    assert ((prod == cut[:, None]).sum(1) > 5).all()   # a run of ties at the cut
    np.testing.assert_array_equal(s.numpy(), scores)
    np.testing.assert_array_equal(b.numpy(), boxes)


def test_decode_and_simple_test_match_ioudet(pair, ref):
    (fwd, _, _), img = ref
    boxes, scores = fwd[1]
    ref_dets, ref_labels = fwd[2]
    model = pair[2].eval()
    with torch.no_grad():
        outs = model(t(img))
        b, s = model.bbox_head.decode_candidates(*[[t(o) for o in lvl] for lvl in fwd[0]],
                                                 t(SHAPES), TEST_CFG)
        dets, labels = model.simple_test(t(img), t(SHAPES), t(FACTORS), t(SHAPES))
    assert s.shape == (2, 60 + 48 + 12 + 4 + 1, 4) and len(outs) == 3
    np.testing.assert_allclose(s.numpy(), scores, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b.numpy(), boxes, rtol=1e-5, atol=1e-4)
    assert (ref_labels >= 0).sum() > 10
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_allclose(dets.numpy(), ref_dets, rtol=1e-4, atol=1e-4)


def test_losses_and_gradients_match_ioudet(pair, ref):
    (_, ref_out, grads), img = ref
    model = pair[2].train()
    model.zero_grad()
    gb, gl, gv = (t(a) for a in gts())
    out = model.forward_train(t(img), gb, gl, gv, t(SHAPES), t(SHAPES))
    assert sorted(out) == sorted(ref_out) == ["loss_bbox", "loss_centerness", "loss_cls"]
    for k in out:
        assert float(ref_out[k]) > 0
        np.testing.assert_allclose(float(out[k].detach()), float(ref_out[k]), rtol=1e-4,
                                   err_msg=k)
    sum(out.values()).backward()
    ref_grads = state_dict_from_flax(grads, module_types(model))
    named = dict(model.named_parameters())
    zero = []
    for k, p in named.items():
        if k.startswith(FROZEN):
            assert p.grad is None, k
        elif TOWER_BIAS.fullmatch(k):
            # a conv bias under GN of one channel a group cancels in the
            # group's mean: both gradients are f32 noise
            weight = named[k[:-4] + "weight"].grad.abs().max()
            assert p.grad.abs().max() < 1e-5 * weight and ref_grads[k].abs().max() < 1e-5 * weight
        elif not ref_grads[k].any():
            assert not p.grad.any(), k
            zero.append(k)
        else:
            assert_close_scaled(p.grad.numpy(), ref_grads[k].numpy(), 1e-3, k)
    # P7 is 1x1 on a 96x128 canvas: GN of one channel a group over one
    # pixel outputs its bias, so the conv that makes P7 gets no gradient; no
    # gt reaches P5-P7's regress ranges (128 px and more from a point), so
    # their scales get none either; in both packages
    assert sorted(zero) == ["bbox_head.scales.2.scale", "bbox_head.scales.3.scale",
                            "bbox_head.scales.4.scale", "neck.fpn_convs.4.conv.bias",
                            "neck.fpn_convs.4.conv.weight"]
    assert float(named["bbox_head.scales.0.scale"].grad.abs()) > 0


def test_the_bridge_takes_fcos_only_when_named(pair):
    _, params, model = pair
    assert module_types(model)["bbox_head"] == "FCOSHead"
    with pytest.raises(KeyError, match="unknown head param"):
        state_dict_from_flax(params)
    sd = state_dict_from_flax(params, module_types(model))
    assert {"bbox_head.cls_convs.1.gn.weight", "bbox_head.cls_convs.0.conv.bias",
            "bbox_head.scales.4.scale", "bbox_head.fcos_centerness.weight"} <= set(sd)


def test_bf16_int8_and_tta_raise_named_errors(pair):
    with pytest.raises(NotImplementedError, match="FCOSHead in torch.bfloat16"):
        build_detector(dict(MODEL, dtype="bfloat16"), dict(), TEST_CFG)
    with pytest.raises(NotImplementedError, match="int8 serving of FCOSHead"):
        with quant.quantize_calls(pair[2]):
            pass
    with pytest.raises(NotImplementedError, match="multi-scale / flip test of FCOSHead"):
        aug_test(pair[2], [])


@pytest.mark.parametrize("name", ["fcos_r50_caffe_fpn_gn_1x_4gpu.py",
                                  "fcos_mstrain_640_800_r101_caffe_fpn_gn_2x_4gpu.py"])
def test_mstrain_pipeline_samples_equal_ioudet(name, tmp_path):
    """The FCOS configs' train pipelines (the mstrain config's
    ``Resize(multiscale_mode="range")`` draws a long and a short edge an
    image) on planted images, under the same streams: every array of every
    sample equal to ioudet's, and the draws differ between images."""
    from ioudet.data import build_dataset as jax_build_dataset
    from ioudet.data.rng import make_sample_rng as jax_make_rng, set_sample_rng as jax_set_rng
    from ioudet.utils.config import Config as JaxConfig
    from ioudet_torch.data import build_dataset
    from ioudet_torch.data.rng import make_sample_rng, set_sample_rng
    from ioudet_torch.utils.config import Config
    from tests.test_torch_data_pipeline import assert_samples_equal, plant_coco

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "configs", name)
    ann_file, img_dir = plant_coco(str(tmp_path), [(60, 100), (100, 60), (80, 96)])
    pipes = [Config.fromfile(path).todict()["train_pipeline"],
             JaxConfig.fromfile(path).todict()["train_pipeline"]]
    ours, theirs = (build(dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
                               pipeline=p))
                    for build, p in zip((build_dataset, jax_build_dataset), pipes))
    shapes = set()
    for idx in range(len(ours)):
        set_sample_rng(make_sample_rng(3, 1, idx))
        jax_set_rng(jax_make_rng(3, 1, idx))
        try:
            a, b = ours[idx], theirs[idx]
        finally:
            set_sample_rng(None)
            jax_set_rng(None)
        assert_samples_equal(a, b)
        assert sorted(a["img"].shape) == [3, 832, 1344]
        shapes.add(min(a["img_shape"]))
    # the fixed scale gives every image a short edge of 800 or its long edge
    # 1333; the range draws short edges between 640 and 800
    assert (min(shapes) < 760) == ("mstrain" in name), shapes


def small(pipeline: list, scale=(128, 96), canvas=(96, 128), max_gt=8) -> list:
    """A config pipeline at a small scale and canvas."""
    out = []
    for s in pipeline:
        s = dict(s)
        if s["type"] == "Resize":
            s["img_scale"] = scale
        elif s["type"] == "Pad":
            s["size"] = canvas
        elif s["type"] == "DefaultFormatBundle":
            s["max_gt"] = max_gt
        out.append(s)
    return out


def test_entry_points_on_a_planted_set(pair, tmp_path):
    """The tiny FCOS through the port's entry points on the CPU, with
    configs/fcos_r50_caffe_fpn_gn_1x_4gpu.py's pipelines at a small scale:
    ``inference_detector`` and both routes of ``single_device_test`` detect,
    ``evaluate``
    gives finite metrics, ``tools.test`` on a saved checkpoint the same
    metrics, and ``tools.train`` one step with the three losses finite."""
    from ioudet_torch.apis.checkpoint import save_checkpoint
    from ioudet_torch.apis.inference import DetectorHandle, inference_detector
    from ioudet_torch.apis.test import single_device_test
    from ioudet_torch.data import build_dataset
    from ioudet_torch.data.pipelines.loading import imread
    from ioudet_torch.tools import test as test_tool
    from ioudet_torch.tools import train as train_tool
    from ioudet_torch.utils.config import Config
    from tests.test_torch_data_pipeline import plant_coco

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.fromfile(os.path.join(root, "configs", "fcos_r50_caffe_fpn_gn_1x_4gpu.py")
                          ).todict()
    ann_file, img_dir = plant_coco(str(tmp_path), [(60, 100), (48, 80), (90, 56)], seed=5,
                                   num_cats=4, crowd=False)
    data = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir)
    test_data = dict(data, pipeline=small(cfg["test_pipeline"]), test_mode=True)
    model = pair[2].eval()
    dataset = build_dataset(test_data)
    # the host pipeline resizes uint8 pixels, the device route floats: each
    # route's own detections
    results = [single_device_test(model, dataset, imgs_per_batch=2, progress=False,
                                  device_preprocess=dp) for dp in (False, True)]
    assert all(sum(len(r) for img in res for r in img) > 0 for res in results)
    handle = DetectorHandle(model, dict(model=MODEL, test_cfg=TEST_CFG,
                                        data=dict(test=test_data)), torch.device("cpu"))
    # its resize reads an image-sized buffer, the device route a 256-px
    # bucket (the content's last row and column blend other pixels): per
    # class lists of finite (k, 5) arrays, not the same numbers
    one = inference_detector(handle, imread(os.path.join(img_dir, "0.ppm")))
    assert len(one) == 4 and sum(map(len, one)) > 0
    assert all(a.shape[1:] == (5,) and np.isfinite(a).all() for a in one)
    metrics = dataset.evaluate(results[0])
    assert all(np.isfinite(v) for v in metrics.values())

    ckpt = save_checkpoint(str(tmp_path), "weights", model)
    config = tmp_path / "cfg.py"
    train_data = dict(data, pipeline=small(cfg["train_pipeline"]))
    config.write_text("".join(f"{k} = {v!r}\n" for k, v in dict(
        model=MODEL, train_cfg=dict(), test_cfg=TEST_CFG,
        data=dict(imgs_per_gpu=2, workers_per_gpu=1, train=train_data, test=test_data),
        optimizer=dict(type="SGD", lr=0.001, momentum=0.9, weight_decay=0.0001),
        optimizer_config=dict(grad_clip=dict(max_norm=35)), lr_config=dict(policy="step", step=[8]),
        total_epochs=1, log_config=dict(interval=1), checkpoint_config=dict(interval=1)).items()))
    out = test_tool.main([str(config), ckpt, "--eval", "bbox", "--batch", "2", "--device", "cpu"])
    assert out == {"bbox": metrics}
    work = tmp_path / "work"
    runner = train_tool.main([str(config), "--work_dir", str(work), "--device", "cpu"])
    assert runner.step == 1   # the two landscape images; the portrait one alone is no batch
    with open(work / "log.json") as f:
        logged = [json.loads(line) for line in f]
    assert all(np.isfinite(r[k]) for r in logged
               for k in ("loss_cls", "loss_bbox", "loss_centerness"))
