"""Port parity of Faster R-CNN and the RPN on the CPU: the tiny model of
tests/test_detectors.py (R-18, FPN and heads 64 wide, 5 classes, 64x96
canvases, batch 2) with the config's RPN loss (sigmoid cross-entropy and
anchor subsampling), built in both packages on the same weights (bridged
by ``ioudet``'s ``convert_torch_faster_rcnn`` and back by the port's
``state_dict_from_flax``) and held against ``ioudet`` on the same seeded
inputs: the RPN head's outputs, the box head's (cls, reg) on the same
proposals, ``simple_test`` of FasterRCNN and of the RPN detector, and the
proposal recall hook (AR exact).  On the CPU both NMS stages run the plain version of
K1 (the card's kernels are held against it by ``chip_smoke.py``).

Tolerances: head outputs within 1e-4 of each output's largest |value| (f32
sums over some 30 layers in another order; the weights keep activations
O(1)); ``simple_test`` labels exact and dets within 1e-4 abs and rtol 1e-5
(a decode of those outputs, then exact selections); the RPN's proposals
alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.apis.checkpoint import convert_torch_faster_rcnn
from ioudet.apis.test import make_proposal_recall_hook as jax_proposal_recall_hook
from ioudet.models import build_detector as jax_build_detector
from ioudet.models.detectors.two_stage import RPN as JaxRPN
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.apis.test import make_proposal_recall_hook
from ioudet_torch.models import build_detector
from ioudet_torch.models.utils.layers import FrozenBatchNorm
from tests._torch_mp_worker import faster_rcnn_cfgs
from tests.mp_common import TinyDataset
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

MODEL, TRAIN_CFG, TEST_CFG = faster_rcnn_cfgs()
RPN_MODEL = dict(MODEL, type="RPN", bbox_roi_extractor=None, bbox_head=None)
RPN_TEST_CFG = dict(nms_pre=200, max_num=64, nms_thr=0.7)
SHAPES = np.array([[64, 96], [50, 80]], np.int32)
PAD = np.array([[64, 96], [64, 96]], np.int32)
FACTORS = np.array([1.0, 0.625], np.float32)


def randomize(model, seed: int):
    """Seeded weights that keep activations O(1) (random FrozenBN
    statistics, halved backbone convs) and spread the heads' outputs, so
    that ranks and labels sit far apart compared with the two libraries'
    f32 roundoff."""
    g = torch.Generator().manual_seed(seed)
    model.init_weights(g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.5, 0.5, generator=g)
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
        for p in model.backbone.parameters():
            if p.dim() == 4:
                p.mul_(0.5)
        model.rpn_head.rpn_cls.weight.normal_(0.0, 0.3, generator=g)
        model.rpn_head.rpn_reg.weight.normal_(0.0, 0.05, generator=g)
        if hasattr(model, "bbox_head"):
            model.bbox_head.fc_cls.weight.normal_(0.0, 0.3, generator=g)
            model.bbox_head.fc_reg.weight.normal_(0.0, 0.02, generator=g)
    return model


def bridge(model) -> dict:
    """ioudet's parameter tree of the port's weights, as copies (numpy views
    of torch parameters would alias them)."""
    tree = convert_torch_faster_rcnn(model.state_dict(), depth=18, num_laterals=4,
                                     head_in_channels=64)
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def images(seed=0, batch=2):
    return np.random.default_rng(seed).normal(0, 1, (batch, 64, 96, 3)).astype(np.float32)


def assert_scaled(got: torch.Tensor, want, rel: float = 1e-4) -> None:
    """Within ``rel`` of the largest |value| of ``want``."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def tiny():
    """The port's FasterRCNN and RPN on the same weights, and one compiled
    ioudet program ``ref(x)`` that returns, for images x at SHAPES /
    FACTORS / PAD, what the tests compare: the RPN head's outputs, the rois
    of ioudet's proposals, the box head's (cls, reg) on them, FasterRCNN's
    and the RPN detector's ``simple_test``."""
    model = randomize(build_detector(MODEL, TRAIN_CFG, TEST_CFG), seed=0).eval()
    det = jax_build_detector(dict(MODEL), TRAIN_CFG, TEST_CFG)
    rpn = build_detector(RPN_MODEL, TRAIN_CFG["rpn"], RPN_TEST_CFG).eval()
    rpn.load_state_dict({k: v for k, v in model.state_dict().items()
                         if not k.startswith("bbox_head.")})
    rpn_det = jax_build_detector(dict(RPN_MODEL), TRAIN_CFG["rpn"], RPN_TEST_CFG)
    params = bridge(model)
    rpn_params = {k: v for k, v in params.items() if k != "bbox_head"}

    def heads(m, img, shapes, pads):
        feats = m.extract_feat(img)
        rois = m._to_rois(m.extract_proposals(img, shapes, pads)[..., :4])
        return m.rpn_head(feats), rois, m.bbox_head(m._roi_forward(feats, rois))

    @jax.jit
    def ref(x):
        meta = (jnp.asarray(SHAPES), jnp.asarray(FACTORS), jnp.asarray(PAD))
        outs = det.apply({"params": params}, x, meta[0], meta[2], method=heads)
        return outs + (det.apply({"params": params}, x, *meta, method=det.simple_test),
                       rpn_det.apply({"params": rpn_params}, x, *meta,
                                     method=rpn_det.simple_test))

    return model, rpn, params, ref


def test_bridge_round_trip_is_identity(tiny):
    model, _, params, _ = tiny
    sd = model.state_dict()
    back = state_dict_from_flax(params)
    assert sorted(back) == sorted(sd)
    assert any(k.startswith("rpn_head.rpn_conv") for k in back)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_rpn_and_box_head_outputs(tiny):
    """The RPN head per level, then the box head on ioudet's proposals."""
    model, _, _, ref = tiny
    x = images(seed=1)
    (jcls, jreg), rois, want, _, _ = ref(jnp.asarray(x))
    with torch.no_grad():
        feats = model.extract_feat(torch.from_numpy(x))
        cls, reg = model.rpn_head(feats)
        got = model.roi_head(feats, torch.from_numpy(np.array(rois)))
    for ours, theirs in ((cls, jcls), (reg, jreg)):
        assert len(ours) == len(theirs) == 5
        for o, r in zip(ours, theirs):
            assert_scaled(o, r)
    assert int((np.asarray(rois)[:, 3] > 0).sum()) > 60
    assert_scaled(got[0], want[0])
    assert_scaled(got[1], want[1])


@pytest.mark.parametrize("seed", [2, 3])
def test_simple_test_matches_ioudet(tiny, seed):
    model, _, _, ref = tiny
    x = images(seed)
    want_d, want_l = ref(jnp.asarray(x))[3]
    with torch.no_grad():
        dets, labels = model.simple_test(torch.from_numpy(x),
                                         *map(torch.from_numpy, (SHAPES, FACTORS, PAD)))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    assert int((labels >= 0).sum()) >= 10
    np.testing.assert_allclose(dets.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)


def test_rpn_detector_proposals_match_ioudet(tiny):
    """The proposal-only detector on the Faster R-CNN's backbone, neck and
    RPN weights."""
    _, rpn, _, ref = tiny
    x = images(seed=4)
    want_d, want_l = ref(jnp.asarray(x))[4]
    with torch.no_grad():
        dets, labels = rpn.simple_test(torch.from_numpy(x),
                                       *map(torch.from_numpy, (SHAPES, FACTORS, PAD)))
    assert tuple(dets.shape) == (2, 64, 5)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    assert set(labels.unique().tolist()) <= {-1, 0} and int((labels == 0).sum()) > 40
    np.testing.assert_allclose(dets.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)


class Annotated(TinyDataset):
    def get_ann_info(self, idx):
        return dict(bboxes=self.boxes[idx])


class ServedRPN(JaxRPN):
    """``ioudet``'s RPN as its ``single_device_test`` reads it: that loop
    takes the result classes from ``detector.bbox_head``, which ``ioudet``'s
    RPN lacks (its recall hook fails on its own RPN), so the RPN head stands
    in for it."""

    @property
    def bbox_head(self):
        return self.rpn_head


def test_proposal_recall_hook(tiny):
    """AR@N of the RPN's proposals over a dataset against ``ioudet``'s
    ``make_proposal_recall_hook`` on the same weights.  At IoU 0.5 no
    proposal of the random RPN covers the 20x20 boxes (both hooks give 0),
    so the recall is taken at 0.3."""
    _, rpn, params, _ = tiny
    dataset = Annotated(4)
    got = make_proposal_recall_hook(dataset, proposal_nums=(10, 64), iou_thrs=(0.3,),
                                    imgs_per_batch=2)(rpn)
    j = jax_build_detector(dict(RPN_MODEL), TRAIN_CFG["rpn"], RPN_TEST_CFG)
    rpn_det = ServedRPN(backbone=j.backbone, rpn_head=j.rpn_head, neck=j.neck,
                        train_cfg=j.train_cfg, test_cfg=j.test_cfg)
    rpn_params = {k: v for k, v in params.items() if k != "bbox_head"}
    want = jax_proposal_recall_hook(dataset, (10, 64), (0.3,), imgs_per_batch=2)(
        rpn_det, rpn_params)
    assert got == want
    assert 0.0 < got["AR@10"] < got["AR@64"] <= 1.0
