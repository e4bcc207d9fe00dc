"""The evaluation slice as a whole on the CPU, against ioudet: a tiny
IoU-aware RetinaNet (weights bridged through state_dict_from_flax) on a
planted COCO-style dataset through single_device_test and evaluate, by the
host pipeline and by the device-preprocess route; the port's tools/test.py
driven in process; one train_detector step fed from a dataset against
ioudet's losses on the same first batch; and a subprocess run on .ppm files
that leaves jax, flax, cv2, PIL and ioudet out of sys.modules.

Tolerances: labels exact; dets rtol 1e-3, atol 1e-4 (the decode of head
outputs that differ by f32 roundoff, on scores the randomized weights keep
apart); metrics on the same detections exactly equal; losses rtol 1e-4."""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.apis import single_device_test as jax_single_device_test
from ioudet.apis.checkpoint import convert_torch_retinanet
from ioudet.data import build_dataset as jax_build_dataset
from ioudet.data import build_dataloader as jax_build_dataloader
from ioudet.models import build_detector as jax_build_detector
from ioudet_torch.apis.checkpoint import save_checkpoint, state_dict_from_flax
from ioudet_torch.apis.test import eval_batches, single_device_test
from ioudet_torch.apis.train import train_detector
from ioudet_torch.data import build_dataset
from ioudet_torch.models import build_detector
from ioudet_torch.tools import test as test_tool
from ioudet_torch.tools import train as train_tool
from tests.test_torch_data_pipeline import plant_coco
from tests.test_torch_detector import randomize
from tests.test_torch_inference import CFG
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL, TEST_CFG = CFG["model"], CFG["test_cfg"]
TEST_PIPELINE = CFG["data"]["test"]["pipeline"]
# 7 landscape and 3 portrait images: ragged batches of 4 in both groups
SIZES = [(48, 80), (64, 96), (40, 72), (80, 56), (56, 90), (96, 64), (60, 100),
         (44, 70), (72, 48), (52, 84)]


def bridged(model_cfg=MODEL, seed=0, train_cfg=None, test_cfg=TEST_CFG):
    """The port's model and ioudet's parameters on the same weights: seeded
    randomized weights, to ioudet's tree (copied: numpy views would alias
    the port's parameters), back into a fresh port model through
    state_dict_from_flax."""
    src = randomize(build_detector(model_cfg, train_cfg, test_cfg), seed=seed)
    tree = convert_torch_retinanet(src.state_dict(), depth=18, num_laterals=3,
                                   stacked_convs=1)
    params = jax.tree.map(lambda a: np.array(a, copy=True), tree)
    model = build_detector(model_cfg, train_cfg, test_cfg)
    model.load_state_dict(state_dict_from_flax(params))
    return model.eval(), params


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    ann_file, img_dir = plant_coco(root, SIZES, seed=3)
    cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
               pipeline=TEST_PIPELINE, test_mode=True)
    return root, cfg, build_dataset(cfg), jax_build_dataset(cfg)


@pytest.fixture(scope="module")
def twins():
    model, params = bridged()
    return model, jax_build_detector(dict(MODEL), None, TEST_CFG), params


def assert_results_close(ours, ref):
    assert len(ours) == len(ref) == len(SIZES)
    n = 0
    for per_img, ref_img in zip(ours, ref):
        assert len(per_img) == len(ref_img) == MODEL["bbox_head"]["num_classes"] - 1
        for o, r in zip(per_img, ref_img):
            assert o.dtype == np.float32 and o.shape == r.shape   # labels exact
            np.testing.assert_allclose(o, r, rtol=1e-3, atol=1e-4)
            n += len(o)
    assert n > 2 * len(SIZES)   # not trivially empty


@pytest.mark.parametrize("device_preprocess", [False, True])
def test_single_device_test_and_evaluate_match_ioudet(planted, twins, device_preprocess):
    _, _, ds, jds = planted
    model, det, params = twins
    ours = single_device_test(model, ds, imgs_per_batch=4, workers=2, progress=False,
                              device_preprocess=device_preprocess)
    ref = jax_single_device_test(det, params, jds, imgs_per_batch=4, workers=2,
                                 progress=False, device_preprocess=device_preprocess)
    assert_results_close(ours, ref)
    # the port's evaluate on ioudet's detections: ioudet's metrics exactly
    assert ds.evaluate(ref) == jds.evaluate(ref)
    metrics = ds.evaluate(ours)
    assert set(metrics) == set(jds.evaluate(ref)) and all(np.isfinite(list(metrics.values())))


def test_eval_batches_cover_every_image_once(planted):
    """One orientation a batch; the ragged tails run at their own size; the
    portrait canvas is the landscape one turned."""
    _, _, ds, _ = planted
    for dp in (False, True):
        seen = []
        for idxs, (img, shapes, factors, pads) in eval_batches(ds, "cpu", 4, 2, dp):
            assert img.shape[0] == len(idxs) == shapes.shape[0] == factors.shape[0] == pads.shape[0]
            portrait = ds.img_infos[idxs[0]]["height"] > ds.img_infos[idxs[0]]["width"]
            assert tuple(img.shape[1:3]) == ((96, 64) if portrait else (64, 96))
            seen += idxs
        assert sorted(seen) == list(range(len(SIZES))) and len(seen) == len(set(seen))


def test_test_tool_writes_results(planted, twins, tmp_path):
    root, ds_cfg, ds, jds = planted
    model, _, _ = twins
    ckpt = save_checkpoint(str(tmp_path), "weights", model)
    config = tmp_path / "cfg.py"
    config.write_text(f"model = {MODEL!r}\ntest_cfg = {TEST_CFG!r}\n"
                      f"data = {dict(test=ds_cfg)!r}\n")
    out, js = tmp_path / "res.pkl", tmp_path / "res.json"
    metrics = test_tool.main([str(config), ckpt, "--eval", "bbox", "--out", str(out),
                              "--json_out", str(js), "--batch", "4", "--device", "cpu"])
    results = single_device_test(model, ds, imgs_per_batch=4, progress=False)
    with open(out, "rb") as f:
        written = pickle.load(f)
    for a, b in zip(written, results):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    with open(js) as f:
        assert json.load(f) == json.loads(json.dumps(jds.results2json(results)))
    assert metrics == {"bbox": ds.evaluate(results)}
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        test_tool.main([str(config), ckpt, "--eval", "bbox"])


TRAIN_MODEL = dict(MODEL, bbox_head=dict(
    MODEL["bbox_head"], loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0,
                                      alpha=0.25, loss_weight=1.0),
    loss_bbox=dict(type="SmoothL1Loss", beta=0.11, loss_weight=1.0)))
TRAIN_CFG = dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5, neg_iou_thr=0.4,
                               min_pos_iou=0, ignore_iof_thr=-1),
                 allowed_border=-1, pos_weight=-1)
TRAIN_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True),
    dict(type="Resize", img_scale=(96, 64), keep_ratio=True),
    dict(type="RandomFlip", flip_ratio=0.5),
    dict(type="Normalize", mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375),
         to_rgb=True),
    dict(type="Pad", size_divisor=32, size=(64, 96)),
    dict(type="DefaultFormatBundle", max_gt=8),
    dict(type="Collect", keys=["img", "gt_bboxes", "gt_labels", "gt_valid"]),
]


def test_train_detector_on_a_dataset_matches_ioudet_step(tmp_path):
    """Two landscape images at two a batch: one step an epoch.  The step's
    losses equal ioudet's forward_train on the first batch of ioudet's
    loader built the same way from cfg.data; with ``validate`` the epoch
    ends with an evaluation, logged as mode 'val'."""
    ann_file, img_dir = plant_coco(str(tmp_path), [(48, 80), (56, 90)], seed=9, crowd=False)
    ds_cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir,
                  pipeline=TRAIN_PIPELINE)
    cfg = dict(model=TRAIN_MODEL, train_cfg=TRAIN_CFG,
               data=dict(imgs_per_gpu=2, workers_per_gpu=2, train=ds_cfg),
               optimizer=dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=0.0001),
               optimizer_config=dict(grad_clip=dict(max_norm=35)),
               lr_config=dict(policy="step", warmup="linear", warmup_iters=5,
                              warmup_ratio=0.1, step=[8]),
               total_epochs=1, log_config=dict(interval=1), checkpoint_config=dict(interval=1))
    model, params = bridged(TRAIN_MODEL, seed=2, train_cfg=TRAIN_CFG, test_cfg=None)
    with torch.no_grad():
        model.bbox_head.retina_cls.bias.fill_(-2.0)
    params["bbox_head"]["retina_cls"]["bias"][:] = -2.0
    seen = []
    val = build_dataset(dict(ds_cfg, pipeline=TEST_PIPELINE, test_mode=True))
    runner = train_detector(model, build_dataset(ds_cfg), cfg, str(tmp_path / "work"),
                            device="cpu", step_hook=lambda step, lv: seen.append(lv),
                            validate=True, val_dataset=val)
    assert runner.step == 1 and len(seen) == 1
    assert os.path.isfile(tmp_path / "work" / "epoch_1.pth")
    with open(tmp_path / "work" / "log.json") as f:
        records = [json.loads(line) for line in f]
    assert [r["mode"] for r in records] == ["train", "val"]
    assert set(records[1]) >= {"epoch", "AP", "AP50", "AR100"} and records[1]["epoch"] == 1

    jds = jax_build_dataset(ds_cfg)
    batch = next(iter(jax_build_dataloader(jds, 2, 2, shuffle=True, seed=0, num_shards=1,
                                           shard_index=0)))
    det = jax_build_detector(dict(TRAIN_MODEL), TRAIN_CFG, None)
    keys = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape")
    forward = jax.jit(lambda p, *a: det.apply({"params": p}, *a, method=det.forward_train))
    ref = forward(params, *(jnp.asarray(batch[k]) for k in keys))
    assert sorted(ref) == ["loss_bbox", "loss_cls", "loss_iou"]
    for k, v in ref.items():
        np.testing.assert_allclose(float(seen[0][k]), float(v), rtol=1e-4)
    assert float(ref["loss_bbox"]) > 0   # the batch has positive anchors


def test_train_tool_trains_and_validates(tmp_path):
    """tools/train.py in process: a config file with a dataset, one epoch,
    --validate; the work dir gets the config, a checkpoint and a log with the
    train and the val record."""
    ann_file, img_dir = plant_coco(str(tmp_path), [(48, 80), (56, 90)], seed=9, crowd=False)
    data = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir)
    cfg = dict(model=TRAIN_MODEL, train_cfg=TRAIN_CFG, test_cfg=TEST_CFG,
               data=dict(imgs_per_gpu=2, workers_per_gpu=1, train=dict(data, pipeline=TRAIN_PIPELINE),
                         val=dict(data, pipeline=TEST_PIPELINE, test_mode=True)),
               optimizer=dict(type="SGD", lr=0.001, momentum=0.9, weight_decay=0.0001),
               optimizer_config=dict(grad_clip=dict(max_norm=35)),
               lr_config=dict(policy="step", step=[8]), total_epochs=1,
               log_config=dict(interval=1), checkpoint_config=dict(interval=1))
    config = tmp_path / "cfg.py"
    config.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    work = tmp_path / "work"
    runner = train_tool.main([str(config), "--work_dir", str(work), "--validate",
                              "--device", "cpu", "--seed", "3"])
    assert runner.step == 1
    assert (work / "config.py").read_text() == config.read_text()
    assert (work / "epoch_1.pth").is_file()
    with open(work / "log.json") as f:
        assert [json.loads(line)["mode"] for line in f] == ["train", "val"]


def test_dataset_run_imports_no_jax_and_no_image_library(tmp_path):
    """A dataset of .ppm files through both routes of single_device_test and
    evaluate, in a fresh interpreter: jax, flax, cv2, PIL and ioudet stay
    out of sys.modules."""
    code = (
        "import json, os, sys, numpy as np\n"
        "from ioudet_torch.apis.inference import init_detector\n"
        "from ioudet_torch.apis.test import single_device_test\n"
        "from ioudet_torch.data import build_dataset\n"
        "from ioudet_torch.data.pipelines.loading import imwrite_netpbm\n"
        "from tests.test_torch_inference import CFG\n"
        f"root = {str(tmp_path)!r}\n"
        "rng = np.random.default_rng(0)\n"
        "images = []\n"
        "for i, (h, w) in enumerate([(48, 80), (80, 48), (40, 64)]):\n"
        "    imwrite_netpbm(os.path.join(root, f'{i}.ppm'), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))\n"
        "    images.append(dict(id=i, file_name=f'{i}.ppm', width=w, height=h))\n"
        "anns = [dict(id=i, image_id=i, category_id=1, bbox=[4, 4, 20, 16], area=320, iscrowd=0) for i in range(3)]\n"
        "json.dump(dict(images=images, annotations=anns, categories=[dict(id=c, name=str(c)) for c in (1, 2, 3)]),\n"
        "          open(os.path.join(root, 'ann.json'), 'w'))\n"
        "ds = build_dataset(dict(type='CocoDataset', ann_file=os.path.join(root, 'ann.json'), img_prefix=root,\n"
        "                        pipeline=CFG['data']['test']['pipeline'], test_mode=True))\n"
        "h = init_detector(CFG, device='cpu')\n"
        "for dp in (False, True):\n"
        "    ds.evaluate(single_device_test(h, ds, 2, progress=False, device_preprocess=dp))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'cv2', 'PIL', 'ioudet')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
