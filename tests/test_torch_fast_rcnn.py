"""Fast R-CNN and Fast Mask R-CNN of the port on the CPU, against ``ioudet``:

  * the proposals through the data pipeline: ``LoadProposals`` on (n, 4)
    and (n, 5) arrays (the stable score sort, the cut, the zero padding and
    ``prop_valid``), the ``.pkl`` and ``.npy`` proposal files of a planted
    COCO-style set through ``CocoDataset`` with the config's own train and
    test pipelines at a small scale (``Resize`` scales the proposals,
    ``RandomFlip`` flips them and keeps the padding rows at 0; a filtered
    image's proposals go with it): every array bit-equal to ``ioudet``'s;
  * the tiny model of tests/test_detectors.py (R-18, FPN and heads 64 wide,
    5 classes, 64x96 canvases) as ``FastMaskRCNN`` on ``ioudet``'s parameter
    tree filled with seeded values and bridged (``tests/torch_twins.py``),
    on seeded proposals with padding rows: ``simple_test`` and the losses
    of the port's ``FastMaskRCNN`` and of its ``FastRCNN`` (the same
    weights without the mask branch) against one compiled ``ioudet``
    ``FastMaskRCNN`` program.  The sampler's ``num`` is the proposals plus
    the gts with no cap on positives, so that it takes every candidate
    whatever the draw (the step's one draw: there is no RPN).

Tolerances: pipeline arrays exact; ``simple_test`` labels exact, dets 1e-4
abs and rtol 1e-5, masks 1e-4 abs (PERF.md section 2); losses rtol 1e-5
(the rois in another order: the same sums in another order)."""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.data import build_dataset as jax_build_dataset
from ioudet.data.pipelines.loading import LoadProposals as JaxLoadProposals
from ioudet.data.rng import make_sample_rng as jax_make_rng, set_sample_rng as jax_set_rng
from ioudet.models import build_detector as jax_build_detector
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.data import build_dataset
from ioudet_torch.data.pipelines.loading import LoadProposals
from ioudet_torch.data.rng import make_sample_rng, set_sample_rng
from ioudet_torch.models import build_detector
from ioudet_torch.utils.config import Config
from tests._torch_mp_worker import faster_rcnn_cfgs, two_stage_batches
from tests.test_torch_data_pipeline import assert_samples_equal, plant_coco
from tests.test_torch_two_stage import FACTORS, PAD, SHAPES, images
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_PROPS = 32
KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")


def fast_rcnn_cfgs(num_gts: int = 4, num_props: int = NUM_PROPS) -> tuple:
    """(model, train_cfg, test_cfg): ``faster_rcnn_cfgs``'s tiny model as
    Fast Mask R-CNN (no RPN; the mask branch of tests/test_mask_rcnn.py);
    the sampler takes every candidate."""
    model, train, test = faster_rcnn_cfgs(num_gts, num_props)
    model = dict(model, type="FastMaskRCNN", rpn_head=None,
                 mask_roi_extractor=dict(type="SingleRoIExtractor", out_channels=64,
                                         featmap_strides=(4, 8, 16, 32),
                                         roi_layer=dict(out_size=14, sample_num=2)),
                 mask_head=dict(type="FCNMaskHead", num_convs=2, in_channels=64,
                                conv_out_channels=64, num_classes=5))
    model = {k: v for k, v in model.items() if v is not None}
    return model, dict(rcnn=train["rcnn"]), dict(rcnn=test["rcnn"])


MODEL, TRAIN_CFG, TEST_CFG = fast_rcnn_cfgs()
BOX_MODEL = {k: v for k, v in dict(MODEL, type="FastRCNN").items()
             if not k.startswith("mask_")}


def proposals(seed: int, batch: int = 2, valid_rows=(NUM_PROPS, 20)) -> tuple:
    """(B, NUM_PROPS, 4) seeded boxes on the 64x96 canvas, the rows past
    ``valid_rows`` of each image zero, and their validity."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 70, (batch, NUM_PROPS, 2)) * np.array([1.0, 0.6])
    wh = rng.uniform(8, 40, (batch, NUM_PROPS, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.arange(NUM_PROPS)[None] < np.asarray(valid_rows)[:, None]
    return boxes * valid[..., None], valid


def train_batch() -> dict:
    """Two images of ``two_stage_batches`` with box-frame masks and
    proposals: half of them the gts jittered (positives), half seeded."""
    batch = {k: v[:2] for k, v in two_stage_batches(1)[0].items()}
    rng = np.random.default_rng(17)
    batch["gt_masks"] = (rng.uniform(size=batch["gt_labels"].shape + (112, 112)) > 0.4
                         ).astype(np.uint8)
    boxes, valid = proposals(5)
    near = np.repeat(batch["gt_bboxes"], NUM_PROPS // 8, axis=1)
    near = near + rng.uniform(-3, 3, near.shape).astype(np.float32)
    boxes[:, :near.shape[1]] = near * valid[:, :near.shape[1], None]
    batch["proposals"], batch["prop_valid"] = boxes, valid
    return batch


# ------------------------------------------------------------ data pipeline

@pytest.mark.parametrize("rows,cols,cap", [(50, 4, 40), (30, 4, 40), (50, 5, 40), (30, 5, 40),
                                           (12, 5, None), (0, 4, 16)])
def test_load_proposals_equals_ioudet(rows, cols, cap):
    rng = np.random.default_rng(rows + cols)
    props = rng.uniform(0, 100, (rows, cols)).astype(np.float32)
    if cols == 5:
        props[:, 4] = rng.integers(0, 4, rows) / 4.0   # tied scores: the sort is stable
    ours = LoadProposals(cap)(dict(proposals=props.copy()))
    ref = JaxLoadProposals(cap)(dict(proposals=props.copy()))
    assert_samples_equal(ours, ref)
    n = min(rows, cap or rows)
    assert ours["proposals"].shape == (cap or rows, 4) and int(ours["prop_valid"].sum()) == n
    assert not ours["proposals"][n:].any()


def test_load_proposals_refuses_other_shapes():
    with pytest.raises(ValueError, match=r"\(n, 4\|5\)"):
        LoadProposals(8)(dict(proposals=np.zeros((3, 6), np.float32)))


SIZES = [(60, 100), (100, 60), (80, 96), (20, 40), (120, 200), (45, 90), (150, 96)]


def fast_pipeline(name: str, cap: int) -> list:
    """The Fast R-CNN config's pipeline at a small scale and canvas, with
    ``cap`` proposals."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "fast_rcnn_r50_fpn_1x.py")).todict()
    steps = []
    for s in cfg[name]:
        s = dict(s)
        if s["type"] == "Resize":
            s["img_scale"] = (160, 96)
        elif s["type"] == "Pad":
            s["size"] = (96, 160)
        elif s["type"] == "LoadProposals":
            s["num_max_proposals"] = cap
        elif s["type"] == "DefaultFormatBundle":
            s["max_gt"] = 8
        steps.append(s)
    return steps


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """A planted COCO-style set with (n, 5) proposals an image (n from 10
    to 60, some boxes beyond the image) written as .pkl and .npy."""
    root = str(tmp_path_factory.mktemp("fast"))
    ann_file, img_dir = plant_coco(root, SIZES)
    rng = np.random.default_rng(3)
    props = []
    for h, w in SIZES:
        n = int(rng.integers(10, 60))
        xy = rng.uniform(0, 1, (n, 2)) * (w, h)
        wh = rng.uniform(0.02, 0.6, (n, 2)) * (w, h)
        props.append(np.concatenate([xy, xy + wh, rng.uniform(0, 1, (n, 1))], 1)
                     .astype(np.float32))
    files = {"pkl": os.path.join(root, "props.pkl"), "npy": os.path.join(root, "props.npy")}
    with open(files["pkl"], "wb") as f:
        pickle.dump(props, f)
    arr = np.empty(len(props), object)
    arr[:] = props
    np.save(files["npy"], arr, allow_pickle=True)
    return ann_file, img_dir, files, props


@pytest.mark.parametrize("kind", ["pkl", "npy"])
def test_proposal_files_through_the_train_pipeline(planted, kind):
    ann_file, img_dir, files, props = planted
    cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
               proposal_file=files[kind], pipeline=fast_pipeline("train_pipeline", 40))
    ours, ref = build_dataset(cfg), jax_build_dataset(cfg)
    assert len(ours) == len(ref) == len(SIZES) - 1   # the 20x40 image is filtered
    kept = [i for i, s in enumerate(SIZES) if min(s) >= 32]
    for got, want in zip(ours.proposals, [props[i] for i in kept]):
        np.testing.assert_array_equal(got, want)
    flips, padded = set(), 0
    for idx in range(len(ours)):
        set_sample_rng(make_sample_rng(7, 0, idx))
        jax_set_rng(jax_make_rng(7, 0, idx))
        try:
            a, b = ours[idx], ref[idx]
        finally:
            set_sample_rng(None)
            jax_set_rng(None)
        assert_samples_equal(a, b)
        flips.add(bool(a["flip"]))
        pad = ~a["prop_valid"]
        padded += int(pad.sum())
        assert not a["proposals"][pad].any(), "padding rows stay 0 through Resize and RandomFlip"
        # the valid rows are the file's, sorted by score, scaled and flipped
        raw = ours.proposals[idx]
        raw = raw[np.argsort(-raw[:, 4], kind="stable")][:40, :4] * a["scale_factor"]
        if a["flip"]:
            w = int(a["img_shape"][1])
            raw = np.stack([w - raw[:, 2] - 1, raw[:, 1], w - raw[:, 0] - 1, raw[:, 3]], 1)
        np.testing.assert_array_equal(a["proposals"][a["prop_valid"]], raw)
    assert flips == {False, True} and padded > 0


def test_proposal_file_through_the_test_pipeline(planted):
    ann_file, img_dir, files, _ = planted
    cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir, test_mode=True,
               proposal_file=files["pkl"], pipeline=fast_pipeline("test_pipeline", 30))
    ours, ref = build_dataset(cfg), jax_build_dataset(cfg)
    assert len(ours) == len(SIZES)
    for idx in range(len(ours)):
        a = ours[idx]
        assert_samples_equal(a, ref[idx])
        assert sorted(a) == sorted(["img", "proposals", "prop_valid", "ori_shape", "img_shape",
                                    "pad_shape", "scale_factor", "flip", "idx"])


# --------------------------------------------------------------- detectors

@pytest.fixture(scope="module")
def twins():
    """(port FastMaskRCNN, port FastRCNN on the same box weights, one jitted
    ioudet FastMaskRCNN program of simple_test and forward_train)."""
    det = jax_build_detector(dict(MODEL), TRAIN_CFG, TEST_CFG)
    meta = tuple(map(jnp.asarray, (SHAPES, FACTORS, PAD)))
    props = tuple(map(jnp.asarray, proposals(2)))
    params = random_params(param_shapes(det, jnp.asarray(images(2)), *meta, *props,
                                        method=det.simple_test), seed=0)
    model = build_detector(MODEL, TRAIN_CFG, TEST_CFG)
    model.load_state_dict(state_dict_from_flax(params))
    box = build_detector(BOX_MODEL, TRAIN_CFG, TEST_CFG)
    box.load_state_dict(state_dict_from_flax({k: v for k, v in params.items()
                                              if k != "mask_head"}))
    batch = train_batch()

    @jax.jit
    def ref(p, x, props, valid):
        outs = det.apply({"params": p}, x, *meta, props, valid, method=det.simple_test)
        losses = det.apply({"params": p}, *(jnp.asarray(batch[k]) for k in KEYS),
                           proposals=jnp.asarray(batch["proposals"]),
                           prop_valid=jnp.asarray(batch["prop_valid"]),
                           gt_masks=jnp.asarray(batch["gt_masks"]),
                           method=det.forward_train, rngs={"sampler": jax.random.PRNGKey(3)})
        return outs, losses

    return model, box, functools.partial(ref, params)


@pytest.mark.parametrize("seed", [2, 3])
def test_simple_test_matches_ioudet(twins, seed):
    model, box, ref = twins
    x = images(seed)
    props, valid = proposals(seed + 10)
    (want_d, want_l, want_m), _ = ref(jnp.asarray(x), jnp.asarray(props), jnp.asarray(valid))
    meta = tuple(map(torch.from_numpy, (SHAPES, FACTORS, PAD, props, valid)))
    with torch.no_grad():
        dets, labels, masks = model.eval().simple_test(torch.from_numpy(x), *meta)
        box_dets, box_labels = box.eval().simple_test(torch.from_numpy(x), *meta)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    assert int((labels >= 0).sum()) >= 10
    np.testing.assert_allclose(dets.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(masks.numpy(), np.asarray(want_m), rtol=0, atol=1e-4)
    assert torch.equal(box_dets, dets) and torch.equal(box_labels, labels)


def test_padding_proposals_never_detect(twins):
    """With every proposal of image 1 padding, image 1 has no detection."""
    model, _, _ = twins
    props, valid = proposals(7, valid_rows=(NUM_PROPS, 0))
    meta = tuple(map(torch.from_numpy, (SHAPES, FACTORS, PAD, props, valid)))
    with torch.no_grad():
        _, labels, _ = model.eval().simple_test(torch.from_numpy(images(4)), *meta)
    assert int((labels[0] >= 0).sum()) > 0 and not bool((labels[1] >= 0).any())


def test_losses_match_ioudet(twins):
    model, box, ref = twins
    _, want = ref(jnp.asarray(images(2)), *map(jnp.asarray, proposals(2)))
    tb = {k: torch.from_numpy(v) for k, v in train_batch().items()}
    kw = dict(proposals=tb["proposals"], prop_valid=tb["prop_valid"])
    ours = model.train().forward_train(*(tb[k] for k in KEYS), gt_masks=tb["gt_masks"],
                                       generator=torch.Generator().manual_seed(5), **kw)
    box_losses = box.train().forward_train(*(tb[k] for k in KEYS),
                                           generator=torch.Generator().manual_seed(6), **kw)
    assert sorted(ours) == sorted(want) == ["loss_bbox", "loss_cls", "loss_mask"]
    assert sorted(box_losses) == ["loss_bbox", "loss_cls"]
    for k in want:
        np.testing.assert_allclose(float(ours[k].detach()), float(want[k]), rtol=1e-5, err_msg=k)
    for k in box_losses:
        np.testing.assert_allclose(float(box_losses[k].detach()), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert all(float(v) > 0 for v in ours.values())
    sum(ours.values()).backward()
    assert float(model.bbox_head.shared_fcs[0].weight.grad.abs().max()) > 0
    assert float(model.mask_head.conv_logits.weight.grad.abs().max()) > 0


def test_proposals_are_required(twins):
    model, _, _ = twins
    meta = tuple(map(torch.from_numpy, (SHAPES, FACTORS, PAD)))
    with pytest.raises(ValueError, match="proposals"):
        model.simple_test(torch.from_numpy(images(2)), *meta)
