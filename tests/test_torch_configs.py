"""The configs the port builds, at full width: every config of ``configs/``
in ``BUILDS`` builds on the ``meta`` device (no weight allocated), every
other one raises ``NotImplementedError`` or a "not ported" ``KeyError``,
and the paper's family (the 11 ``configs/*iou_aware_*.py``,
``retinanet_x101_64x4d_fpn_1x.py``) and the two-stage configs
(``faster_rcnn_r50_fpn_1x.py``, ``rpn_r50_fpn_1x.py``,
``mask_rcnn_r50_fpn_1x.py``, ``htc_r50_fpn_1x.py``,
``faster_rcnn_r50_fpn_gn_ws_1x.py``, ``fast_rcnn_r50_fpn_1x.py``,
``double_head_rcnn_r50_fpn_1x.py``, ``ms_rcnn_r50_fpn_1x.py``,
``grid_rcnn_r50_fpn_2x.py``, ``ssd300_coco.py``,
``fcos_r50_caffe_fpn_gn_1x_4gpu.py``, ``fovea_align_gn_r50_fpn_4gpu_2x.py``,
``retinanet_free_anchor_r50_fpn_1x.py``, the three Libra R-50 configs,
whose FPN -> BFP chain crosses as flax's ``necks_<i>``, and
``ga_retinanet_r50_fpn_1x.py``, ``ga_faster_rcnn_r50_fpn_1x.py`` and
``ga_rpn_r50_fpn_1x.py``, whose guided-anchoring heads cross where
``module_types`` names them)
also go through the weight bridge: ``ioudet``
builds under ``jax.eval_shape``, its parameter tree (of ``simple_test`` for
a two-stage detector, whose ``__call__`` runs the RPN alone) goes through
``state_dict_from_flax`` as meta tensors, and the bridged names and shapes
must be the port's state_dict, one for one.  ``ioudet`` cannot build the
Double-Head config's BN head (flax raises at its first call: the mode is
passed to ``nn.BatchNorm`` twice), so that config crosses with GN on both
sides."""

import glob
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from ioudet.models import build_detector as jax_build_detector
from ioudet.utils.config import Config as JaxConfig
from ioudet_torch.apis.checkpoint import module_types, state_dict_from_flax
from ioudet_torch.models import build_detector
from ioudet_torch.utils.config import Config
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = sorted(os.path.basename(f) for f in glob.glob(
    os.path.join(ROOT, "configs", "*iou_aware_*.py")))


# every config the port builds (99 of 109); what stops the rest is in
# ROADMAP.md ("Configs")
BUILDS = FAMILY + [
    "retinanet_r50_fpn_1x.py", "retinanet_r50_fpn_2x.py", "retinanet_r101_fpn_1x.py",
    "retinanet_r50_fpn_bf16_1x.py", "retinanet_x101_64x4d_fpn_1x.py",
    "faster_rcnn_r50_fpn_1x.py", "faster_rcnn_r50_fpn_2x.py", "faster_rcnn_r101_fpn_1x.py",
    "faster_rcnn_x101_32x4d_fpn_1x.py", "faster_rcnn_x101_64x4d_fpn_1x.py",
    "faster_rcnn_r50_fpn_1x_cityscapes.py", "faster_rcnn_r50_fpn_voc0712.py",
    "ohem_faster_rcnn_r50_fpn_1x.py", "dcn_faster_rcnn_dconv_c3-c5_r50_fpn_1x.py",
    "dcn_faster_rcnn_mdconv_c3-c5_r50_fpn_1x.py",
    "dcn_faster_rcnn_dconv_c3-c5_x101_32x4d_fpn_1x.py",
    "rpn_r50_fpn_1x.py", "rpn_r101_fpn_1x.py", "rpn_x101_64x4d_fpn_1x.py",
    "mask_rcnn_r50_fpn_1x.py", "mask_rcnn_r50_fpn_2x.py", "mask_rcnn_r101_fpn_1x.py",
    "mask_rcnn_x101_32x4d_fpn_1x.py", "mask_rcnn_x101_64x4d_fpn_1x.py",
    "mask_rcnn_r50_fpn_1x_cityscapes.py", "dcn_mask_rcnn_dconv_c3-c5_r50_fpn_1x.py",
    "cascade_rcnn_r50_fpn_1x.py", "cascade_rcnn_r50_fpn_20e.py", "cascade_rcnn_r101_fpn_1x.py",
    "cascade_rcnn_x101_64x4d_fpn_1x.py", "dcn_cascade_rcnn_dconv_c3-c5_r50_fpn_1x.py",
    "cascade_mask_rcnn_r50_fpn_1x.py", "cascade_mask_rcnn_r101_fpn_1x.py",
    "cascade_mask_rcnn_x101_64x4d_fpn_1x.py",
    "htc_r50_fpn_1x.py", "htc_without_semantic_r50_fpn_1x.py", "htc_r101_fpn_20e.py",
    "htc_x101_64x4d_fpn_20e.py",
    "faster_rcnn_r50_fpn_gn_ws_1x.py", "faster_rcnn_x101_32x4d_fpn_gn_ws_1x.py",
    "scratch_faster_rcnn_r50_fpn_gn_6x.py", "mask_rcnn_r50_fpn_gn_2x.py",
    "mask_rcnn_r50_fpn_gn_ws_2x.py", "mask_rcnn_r101_fpn_gn_2x.py",
    "scratch_mask_rcnn_r50_fpn_gn_6x.py",
    "fast_rcnn_r50_fpn_1x.py", "fast_rcnn_r101_fpn_1x.py", "fast_mask_rcnn_r50_fpn_1x.py",
    "double_head_rcnn_r50_fpn_1x.py", "faster_rcnn_r50_caffe_c4_1x.py",
    "dpool_faster_rcnn_r50_fpn_1x.py", "dcn_faster_rcnn_mdpool_r50_fpn_1x.py",
    "faster_rcnn_r50_fpn_bf16_1x.py", "mask_rcnn_r50_fpn_bf16_1x.py",
    # Fast R-CNN with a caffe-style backbone: guided anchoring made its
    # proposal file, and the model has nothing of it
    "ga_fast_r50_caffe_fpn_1x.py",
    "ms_rcnn_r50_fpn_1x.py", "ms_rcnn_r101_fpn_1x.py", "ms_rcnn_x101_64x4d_fpn_1x.py",
    "grid_rcnn_r50_fpn_2x.py",
    "ssd300_coco.py", "ssd512_coco.py", "ssd300_voc.py", "ssd512_voc.py",
    "ssd300_wider_face.py",
    "fcos_r50_fpn_1x.py", "fcos_r101_fpn_1x.py", "fcos_r50_caffe_fpn_gn_1x_4gpu.py",
    "fcos_mstrain_640_800_r101_caffe_fpn_gn_2x_4gpu.py",
    "fcos_mstrain_640_800_x101_64x4d_fpn_gn_2x.py",
    "fovea_r50_fpn_4gpu_1x.py", "fovea_align_gn_r50_fpn_4gpu_2x.py",
    "retinanet_ghm_r50_fpn_1x.py", "retinanet_ghm_r101_fpn_1x.py",
    "retinanet_ghm_x101_64x4d_fpn_1x.py",
    "retinanet_free_anchor_r50_fpn_1x.py", "retinanet_free_anchor_r101_fpn_1x.py",
    "retinanet_free_anchor_x101_32x4d_fpn_1x.py",
    "libra_retinanet_r50_fpn_1x.py", "libra_faster_rcnn_r50_fpn_1x.py",
    "libra_faster_rcnn_x101_64x4d_fpn_1x.py", "libra_fast_rcnn_r50_fpn_1x.py",
    "ga_retinanet_r50_fpn_1x.py", "ga_retinanet_r50_caffe_fpn_1x.py",
    "ga_retinanet_x101_32x4d_fpn_1x.py", "ga_faster_rcnn_r50_fpn_1x.py",
    "ga_faster_r50_caffe_fpn_1x.py", "ga_faster_x101_32x4d_fpn_1x.py", "ga_rpn_r50_fpn_1x.py"]
ALL = sorted(os.path.basename(f) for f in glob.glob(os.path.join(ROOT, "configs", "*.py")))
LIBRA = ("libra_fast_rcnn_r50_fpn_1x.py", "libra_faster_rcnn_r50_fpn_1x.py",
         "libra_faster_rcnn_x101_64x4d_fpn_1x.py", "libra_retinanet_r50_fpn_1x.py")


def gn_double_head(cfg: dict) -> dict:
    """A Double-Head config's head with GN in place of its BN."""
    if cfg["model"]["type"] == "DoubleHeadRCNN":
        cfg["model"]["bbox_head"]["norm_cfg"] = dict(type="GN", num_groups=32)
    return cfg


def build(name: str, gn: bool = False):
    cfg = Config.fromfile(os.path.join(ROOT, "configs", name)).todict()
    if gn:
        cfg = gn_double_head(cfg)
    with torch.device("meta"):
        return build_detector(cfg["model"], cfg.get("train_cfg"), cfg.get("test_cfg"))


@pytest.mark.parametrize("name", BUILDS)
def test_config_builds_on_meta(name):
    model = build(name)
    assert sum(p.numel() for p in model.parameters()) > 1e6
    assert all(p.device.type == "meta" for p in model.parameters())


@pytest.mark.parametrize("name", [n for n in ALL if n not in BUILDS])
def test_other_configs_raise_not_ported(name):
    """A config outside BUILDS stops with NotImplementedError or a KeyError
    that says what is not ported, and with nothing else."""
    try:
        build(name)
    except NotImplementedError:
        return
    except KeyError as e:
        assert "not ported" in str(e), e
        return
    pytest.fail(f"{name} builds: add it to BUILDS")


@pytest.mark.parametrize("name", LIBRA)
def test_libra_configs_build_fpn_then_bfp(name):
    """A ``neck`` list builds the chain in its order: FPN, then the
    non-local BFP at the config's refine level."""
    neck = build(name).neck
    assert type(neck).__name__ == "NeckSequence"
    assert [type(n).__name__ for n in neck] == ["FPN", "BFP"]
    assert neck[1].refine_type == "non_local" and neck[1].refine_level == 2
    assert type(neck[1].refine).__name__ == "NonLocal2D"


def test_the_family_is_all_there():
    assert len(FAMILY) == 11
    assert {"dcn_iou_aware_retinanet_r50_fpn_1x.py", "gcb_iou_aware_retinanet_r50_fpn_1x.py",
            "iou_aware_retinanet_x101_64x4d_fpn_1x.py"} <= set(FAMILY)


@pytest.mark.parametrize("name", FAMILY + ["retinanet_x101_64x4d_fpn_1x.py",
                                  "faster_rcnn_r50_fpn_1x.py", "rpn_r50_fpn_1x.py",
                                  "mask_rcnn_r50_fpn_1x.py", "htc_r50_fpn_1x.py",
                                  "faster_rcnn_r50_fpn_gn_ws_1x.py", "fast_rcnn_r50_fpn_1x.py",
                                  "double_head_rcnn_r50_fpn_1x.py", "ms_rcnn_r50_fpn_1x.py",
                                  "grid_rcnn_r50_fpn_2x.py", "ssd300_coco.py",
                                  "fcos_r50_caffe_fpn_gn_1x_4gpu.py",
                                  "fovea_align_gn_r50_fpn_4gpu_2x.py",
                                  "retinanet_free_anchor_r50_fpn_1x.py",
                                  "libra_retinanet_r50_fpn_1x.py",
                                  "libra_faster_rcnn_r50_fpn_1x.py",
                                  "libra_fast_rcnn_r50_fpn_1x.py",
                                  "ga_retinanet_r50_fpn_1x.py", "ga_faster_rcnn_r50_fpn_1x.py",
                                  "ga_rpn_r50_fpn_1x.py"])
def test_config_builds_and_bridges_one_for_one(name):
    model = build(name, gn=True)
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}

    jcfg = gn_double_head(JaxConfig.fromfile(os.path.join(ROOT, "configs", name)).todict())
    det = jax_build_detector(jcfg["model"], jcfg.get("train_cfg"), jcfg.get("test_cfg"))
    # SSD's extra convs need its own input size; the rest take any canvas
    size = jcfg["model"]["backbone"].get("input_size", 64)
    img = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    if jcfg["model"]["type"] in ("FasterRCNN", "MaskRCNN", "HybridTaskCascade",
                                 "DoubleHeadRCNN", "FastRCNN", "MaskScoringRCNN", "GridRCNN"):
        meta = (jax.ShapeDtypeStruct((1, 2), jnp.int32), jax.ShapeDtypeStruct((1,), jnp.float32),
                jax.ShapeDtypeStruct((1, 2), jnp.int32))
        if jcfg["model"]["type"] == "FastRCNN":
            meta += (jax.ShapeDtypeStruct((1, 8, 4), jnp.float32),
                     jax.ShapeDtypeStruct((1, 8), jnp.bool_))
        shapes = jax.eval_shape(lambda x, *m: det.init(jax.random.PRNGKey(0), x, *m,
                                                       method=det.simple_test), img, *meta)
    else:
        shapes = jax.eval_shape(lambda x: det.init(jax.random.PRNGKey(0), x), img)
    shapes = shapes["params"]
    meta = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    bridged = {k: tuple(v.shape) for k, v in state_dict_from_flax(meta, module_types(model)).items()}
    assert bridged == ours


def test_the_configs_count():
    """99 of the 109 configs build; every other one raises its named
    not-ported error (``test_other_configs_raise_not_ported``)."""
    assert len(ALL) == 109 and len(set(BUILDS)) == len(BUILDS) == 99
    assert set(BUILDS) <= set(ALL)
