"""The paper's config family builds in the port at full width: each of the
11 ``configs/*iou_aware_*.py`` and ``retinanet_x101_64x4d_fpn_1x.py``.  The
port builds on the ``meta`` device and ``ioudet`` under ``jax.eval_shape``,
so no weight is allocated; ``ioudet``'s parameter tree goes through the
weight bridge (``state_dict_from_flax``) as meta tensors, and the bridged
names and shapes must be the port's state_dict, one for one."""

import glob
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from ioudet.models import build_detector as jax_build_detector
from ioudet.utils.config import Config as JaxConfig
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.models import build_detector
from ioudet_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = sorted(os.path.basename(f) for f in glob.glob(
    os.path.join(ROOT, "configs", "*iou_aware_*.py")))


def test_the_family_is_all_there():
    assert len(FAMILY) == 11
    assert {"dcn_iou_aware_retinanet_r50_fpn_1x.py", "gcb_iou_aware_retinanet_r50_fpn_1x.py",
            "iou_aware_retinanet_x101_64x4d_fpn_1x.py"} <= set(FAMILY)


@pytest.mark.parametrize("name", FAMILY + ["retinanet_x101_64x4d_fpn_1x.py"])
def test_config_builds_and_bridges_one_for_one(name):
    path = os.path.join(ROOT, "configs", name)
    cfg = Config.fromfile(path).todict()
    with torch.device("meta"):
        model = build_detector(cfg["model"], cfg.get("train_cfg"), cfg.get("test_cfg"))
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}

    jcfg = JaxConfig.fromfile(path).todict()
    det = jax_build_detector(jcfg["model"], jcfg.get("train_cfg"), jcfg.get("test_cfg"))
    img = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda x: det.init(jax.random.PRNGKey(0), x), img)["params"]
    meta = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    bridged = {k: tuple(v.shape) for k, v in state_dict_from_flax(meta).items()}
    assert bridged == ours
