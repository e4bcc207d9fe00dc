"""The port's inference API on the CPU at a tiny config: init_detector,
predict and inference_detector (on arrays and paths), the absence of jax
from a run of the port, and no silent CPU fallback when a card is asked
for."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ioudet_torch.apis.inference import (init_detector, inference_detector,
                                         pipeline_settings, predict)
from ioudet_torch.utils.config import Config
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(
    model=dict(
        type="IoUAwareRetinaNet",
        backbone=dict(type="ResNet", depth=18, frozen_stages=1,
                      norm_cfg=dict(type="FrozenBN")),
        neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
                  start_level=1, add_extra_convs=True, num_outs=5),
        bbox_head=dict(type="IoUAwareRetinaHead", num_classes=4, in_channels=32,
                       feat_channels=32, stacked_convs=1,
                       anchor_strides=(8, 16, 32, 64, 128))),
    test_cfg=dict(nms_pre=100, score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                  max_per_img=10, rescoring_alpha=0.5, class_topk=2),
    data=dict(test=dict(pipeline=[
        dict(type="LoadImageFromFile"),
        dict(type="Resize", img_scale=(96, 64), keep_ratio=True),
        dict(type="Normalize", mean=(123.675, 116.28, 103.53),
             std=(58.395, 57.12, 57.375), to_rgb=True),
        dict(type="Pad", size_divisor=32, size=(64, 96)),
        dict(type="Collect", keys=["img"]),
    ])),
)


@pytest.fixture(scope="module")
def handle():
    h = init_detector(CFG, device="cpu", seed=0)
    with torch.no_grad():
        h.model.bbox_head.retina_cls.bias.zero_()  # random weights: let scores clear score_thr
    return h


def test_init_detector_is_seeded(handle):
    again = init_detector(CFG, device="cpu", seed=0)
    other = init_detector(CFG, device="cpu", seed=1)
    sd, sa, so = (h.model.state_dict() for h in (handle, again, other))
    key = "backbone.layer1.0.conv1.weight"
    assert torch.equal(sd[key], sa[key]) and not torch.equal(sd[key], so[key])
    assert not handle.model.training
    assert not handle.model.backbone.layer1[0].conv1.weight.requires_grad
    assert handle.model.backbone.layer2[0].conv1.weight.requires_grad


def test_predict_and_inference_detector(handle):
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32))
    shapes = torch.tensor([[64, 96], [48, 80]], dtype=torch.int32)
    dets, labels = predict(handle, imgs, shapes, torch.tensor([1.0, 0.5]),
                           torch.tensor([[64, 96]] * 2, dtype=torch.int32))
    assert tuple(dets.shape) == (2, 10, 5) and tuple(labels.shape) == (2, 10)
    assert bool(torch.isfinite(dets).all())
    assert bool(((labels >= -1) & (labels < 3)).all()) and int((labels >= 0).sum()) > 0

    for hw in ((50, 70), (70, 50)):
        img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        res = inference_detector(handle, img)
        assert len(res) == 3
        assert all(r.dtype == np.float32 and r.shape[1:] == (5,) for r in res)
        assert 0 < sum(map(len, res)) <= 10
        # boxes are clipped to (new - 1) on the canvas, then scaled back to
        # the original image: within [0, size] there
        allb = np.concatenate(res)
        assert (allb[:, :4] >= 0).all()
        assert (allb[:, [0, 2]] <= hw[1]).all() and (allb[:, [1, 3]] <= hw[0]).all()


def test_pipeline_settings():
    canvas, scale, mean, std, to_rgb, keep_ratio = pipeline_settings(CFG)
    assert (canvas, scale, to_rgb, keep_ratio) == ((64, 96), (96, 64), True, True)
    assert pipeline_settings(dict(model=CFG["model"]))[:2] == ((832, 1344), (1333, 800))
    ssd = Config.fromfile(os.path.join(ROOT, "configs", "ssd300_coco.py")).todict()
    assert pipeline_settings(ssd)[:2] + pipeline_settings(ssd)[4:] == (
        (300, 300), (300, 300), True, False)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        init_detector(CFG, device="cuda")


def test_rejects_paths_and_bad_images(handle, tmp_path):
    """A path is read as ioudet's inference_detector reads one (a .ppm by
    the port's own decoder): the same result as the decoded array; a
    missing file raises, and so does an array that is not (H, W, 3) uint8."""
    from ioudet_torch.data.pipelines.loading import imwrite_netpbm

    img = np.random.default_rng(3).integers(0, 256, (52, 76, 3), dtype=np.uint8)
    path = str(tmp_path / "request.ppm")
    imwrite_netpbm(path, img)
    from_path, from_array = inference_detector(handle, path), inference_detector(handle, img)
    assert sum(map(len, from_array)) > 0
    for a, b in zip(from_path, from_array):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        inference_detector(handle, str(tmp_path / "missing.ppm"))
    with pytest.raises(ValueError):
        inference_detector(handle, np.zeros((10, 10), np.uint8))


TWO_STAGE_RUN = """
from ioudet_torch.apis.inference import predict
from ioudet_torch.apis import train as ttrain
from ioudet_torch.apis.test import masks_to_segm_result
from tests._torch_mp_worker import mask_rcnn_cfgs
torch.set_num_threads(2)
x = torch.randn(1, 64, 96, 3)
meta = (torch.tensor([[64, 96]], dtype=torch.int32), torch.ones(1),
        torch.tensor([[64, 96]], dtype=torch.int32))
h = init_detector(os.path.join('configs', 'rpn_r50_fpn_1x.py'), device='cpu')
assert tuple(predict(h, x, *meta)[0].shape) == (1, 2000, 5)
model_cfg, train_cfg, test_cfg = mask_rcnn_cfgs()
test_cfg['rcnn']['score_thr'] = 0.0
h = init_detector(dict(model=model_cfg, train_cfg=train_cfg, test_cfg=test_cfg), device='cpu')
dets, labels, masks = predict(h, x, *meta)
assert tuple(masks.shape) == (1, 20, 28, 28) and int((labels >= 0).sum()) > 0
segm = masks_to_segm_result(dets[0].numpy(), labels[0].numpy(), masks[0].numpy(), 5, 64, 96)
assert sum(map(len, segm)) == int((labels >= 0).sum())
bbox_res, segm_res = inference_detector(h, np.zeros((48, 80, 3), np.uint8))
assert [len(b) for b in bbox_res] == [len(s) for s in segm_res]
assert all(r['size'] == [48, 80] for s in segm_res for r in s)
model = h.model.train()
ttrain.make_trainable_mask(model)
step = ttrain.make_train_step(model, ttrain.build_optimizer(model, dict(type='SGD', lr=0.01)),
                              lambda s: 0.01)
gts = torch.tensor([[[10., 8., 40., 50.], [50., 5., 90., 30.]]])
logs = step(dict(img=x, gt_bboxes=gts, gt_labels=torch.tensor([[3, 4]], dtype=torch.int32),
                 gt_valid=torch.ones(1, 2, dtype=torch.bool), img_shape=meta[0],
                 pad_shape=meta[2], gt_masks=torch.ones(1, 2, 112, 112, dtype=torch.uint8)), 0)
assert sorted(logs) == ['loss', 'loss_bbox', 'loss_cls', 'loss_mask', 'rpn_loss_bbox',
                        'rpn_loss_cls']
assert all(bool(torch.isfinite(v)) for v in logs.values())
import struct, tempfile, zlib
from ioudet_torch.data.pipelines import Compose
from tests._torch_mp_worker import htc_cfgs
model_cfg, train_cfg, test_cfg = htc_cfgs()
test_cfg['rcnn']['score_thr'] = 0.0
h = init_detector(dict(model=model_cfg, train_cfg=train_cfg, test_cfg=test_cfg), device='cpu')
dets, labels, masks = predict(h, x, *meta)
assert tuple(masks.shape) == (1, 20, 28, 28) and int((labels >= 0).sum()) > 0
seg = (np.arange(64 * 96).reshape(64, 96) // 97 % 7).astype(np.uint8)
def chunk(kind, data):
    return struct.pack('>I', len(data)) + kind + data + struct.pack('>I', zlib.crc32(kind + data))
png = (b'\\x89PNG\\r\\n\\x1a\\n' + chunk(b'IHDR', struct.pack('>IIBBBBB', 96, 64, 8, 0, 0, 0, 0))
       + chunk(b'IDAT', zlib.compress(b''.join(b'\\x00' + r.tobytes() for r in seg)))
       + chunk(b'IEND', b''))
with tempfile.TemporaryDirectory() as seg_dir:
    with open(os.path.join(seg_dir, 'a.png'), 'wb') as f:
        f.write(png)
    sample = Compose([dict(type='LoadAnnotations', with_seg=True),
                      dict(type='SegRescale', scale_factor=0.125)])(dict(
        img=np.zeros((64, 96, 3), np.uint8), img_info=dict(filename='a.ppm'),
        ann_info=dict(bboxes=np.zeros((0, 4), np.float32), labels=np.zeros(0, np.int64)),
        seg_prefix=seg_dir))
assert (sample['gt_semantic_seg'] == seg[::8, ::8]).all()
model = h.model.train()
ttrain.make_trainable_mask(model)
step = ttrain.make_train_step(model, ttrain.build_optimizer(model, dict(type='SGD', lr=0.01)),
                              lambda s: 0.01)
logs = step(dict(img=x, gt_bboxes=gts, gt_labels=torch.tensor([[3, 4]], dtype=torch.int32),
                 gt_valid=torch.ones(1, 2, dtype=torch.bool), img_shape=meta[0],
                 pad_shape=meta[2], gt_masks=torch.ones(1, 2, 112, 112, dtype=torch.uint8),
                 gt_semantic_seg=torch.from_numpy(sample['gt_semantic_seg'][None].astype(int))), 0)
assert 'loss_semantic_seg' in logs and 's2_loss_mask' in logs
assert all(bool(torch.isfinite(v)) for v in logs.values())
from tests._torch_mp_worker import faster_rcnn_cfgs
model_cfg, train_cfg, test_cfg = faster_rcnn_cfgs()
model_cfg = dict(model_cfg, type='FastRCNN', rpn_head=None)
test_cfg['rcnn']['score_thr'] = 0.0
h = init_detector(dict(model=model_cfg, test_cfg=test_cfg), device='cpu')
props = torch.tensor([[[4., 6., 40., 50.], [30., 10., 90., 60.], [0., 0., 0., 0.]]])
dets, labels = predict(h, x, *meta, props, torch.tensor([[True, True, False]]))
assert tuple(dets.shape) == (1, 20, 5) and int((labels >= 0).sum()) > 0
try:
    inference_detector(h, np.zeros((48, 80, 3), np.uint8))
    raise AssertionError('inference_detector took a Fast R-CNN without proposals')
except NotImplementedError:
    pass
"""


SSD_RUN = """
import tempfile
from ioudet_torch.data.pipelines import Compose
from ioudet_torch.data.pipelines.loading import imwrite_netpbm
from ioudet_torch.utils.config import Config
cfg = Config.fromfile(os.path.join('configs', 'ssd300_coco.py')).todict()
h = init_detector(cfg, device='cpu')
img = np.random.default_rng(0).integers(0, 256, (120, 160, 3), dtype=np.uint8)
res = inference_detector(h, img)
assert len(res) == 80 and sum(map(len, res)) > 0
with tempfile.TemporaryDirectory() as root:
    imwrite_netpbm(os.path.join(root, 'a.ppm'), img)
    ann = dict(bboxes=np.array([[10., 20., 70., 90.], [60., 5., 150., 60.]], np.float32),
               labels=np.array([3, 17]))
    samples = [Compose(cfg['train_pipeline'])(dict(img_info=dict(filename='a.ppm'),
                                                   img_prefix=root, ann_info=ann))
               for _ in range(2)]
batch = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
         for k in ('img', 'gt_bboxes', 'gt_labels', 'gt_valid', 'img_shape', 'pad_shape')}
assert tuple(batch['img'].shape) == (2, 300, 300, 3)
model = h.model.train()
ttrain.make_trainable_mask(model)
step = ttrain.make_train_step(model, ttrain.build_optimizer(model, dict(type='SGD', lr=1e-3)),
                              lambda s: 1e-3)
logs = step(batch, 0)
assert sorted(logs) == ['loss', 'loss_bbox', 'loss_cls']
assert all(bool(torch.isfinite(v)) for v in logs.values())
"""


def test_port_runs_without_jax():
    """import ioudet_torch and a CPU run of the slice leave jax (and flax,
    cv2, PIL) out of sys.modules: the IoU-aware RetinaNet's serving, the
    RPN from its config file through init_detector and predict, a tiny
    Mask R-CNN's predict, its masks pasted and encoded, inference_detector
    and one make_train_step step, a tiny HTC's predict and one step on
    a semantic map read from a PNG by LoadAnnotations, a tiny Fast
    R-CNN's predict on given proposals, and SSD300 at full width:
    inference_detector, two samples through its train pipeline (the three
    augmentations in numpy) and one train step."""
    code = (
        "import os, sys, numpy as np, torch\n"
        "import ioudet_torch\n"
        "from ioudet_torch.apis.inference import init_detector, inference_detector\n"
        "from tests.test_torch_inference import CFG, SSD_RUN, TWO_STAGE_RUN\n"
        "h = init_detector(CFG, device='cpu')\n"
        "inference_detector(h, np.zeros((40, 60, 3), np.uint8))\n"
        "exec(TWO_STAGE_RUN)\n"
        "exec(SSD_RUN)\n"
        "bad = [m for m in ('jax', 'flax', 'cv2', 'PIL') if m in sys.modules]\n"
        "ours = [m for m in sys.modules if m == 'ioudet' or m.startswith('ioudet.')]\n"
        "print(bad, ours)\n"
        "sys.exit(1 if bad or ours else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_config_path_loads_without_the_jax_package():
    """init_detector on a config *path* reads the file with the port's own
    loader: afterwards sys.modules holds no ioudet / jax module, and the dict
    is the one ioudet's loader gives."""
    path = os.path.join(ROOT, "configs", "iou_aware_retinanet_r50_fpn_1x.py")
    code = (
        "import sys\n"
        "from ioudet_torch.apis.inference import init_detector\n"
        "from ioudet_torch.utils.config import Config\n"
        f"h = init_detector({path!r}, device='cpu')\n"
        "assert h.model.bbox_head.cls_out_channels == 80\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('ioudet', 'jax', 'flax')]\n"
        f"print(repr(Config.fromfile({path!r}).todict()))\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    from ioudet.utils.config import Config
    assert proc.stdout.strip() == repr(Config.fromfile(path).todict())
