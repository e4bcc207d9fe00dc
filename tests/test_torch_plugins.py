"""The port's ``ContextBlock`` (``ioudet_torch/models/plugins.py``) against
``ioudet.models.plugins.ContextBlock`` on the same seeded weights, bridged by
``state_dict_from_flax``, and inputs: both poolings, both fusions and both
together in either order.  Tolerance: 1e-5 of the largest |output| (f32;
the LayerNorm's statistics and the attention sum in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.models.plugins import ContextBlock as JaxContextBlock
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.models.plugins import ContextBlock
from tests.torch_twins import one_thread  # noqa: F401 (autouse)


def seeded(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.5, a.shape).astype(np.float32), tree)


@pytest.mark.parametrize("pooling,fusions", [
    ("att", ("channel_add",)), ("att", ("channel_mul",)), ("avg", ("channel_add",)),
    ("avg", ("channel_mul",)), ("att", ("channel_add", "channel_mul")),
    ("avg", ("channel_mul", "channel_add"))])
def test_context_block_matches_ioudet(pooling, fusions):
    x = np.random.default_rng(1).normal(0, 1, (2, 5, 7, 48)).astype(np.float32)
    ref_mod = JaxContextBlock(ratio=1.0 / 4, pooling_type=pooling, fusion_types=fusions)
    params = seeded(ref_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    ref = np.asarray(ref_mod.apply({"params": params}, jnp.asarray(x)))

    ours = ContextBlock(48, ratio=1.0 / 4, pooling_type=pooling, fusion_types=fusions)
    sd = state_dict_from_flax({"backbone": {"layer1_0": {"context_block": params}},
                               "bbox_head": {}})
    ours.load_state_dict({k[len("backbone.layer1.0.context_block."):]: v
                          for k, v in sd.items()})
    with torch.no_grad():
        out = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_layer_norm_keeps_flax_eps_and_mmdet_shapes():
    """The LayerNorm is flax's (eps 1e-6), its affine mmdet's (planes, 1, 1)."""
    block = ContextBlock(64, fusion_types=("channel_add", "channel_mul"))
    sd = block.state_dict()
    assert sorted(sd) == sorted(
        ["conv_mask.weight", "conv_mask.bias"] +
        [f"channel_{f}_conv.{i}.{p}" for f in ("add", "mul") for i in (0, 1, 3)
         for p in ("weight", "bias")])
    assert sd["channel_add_conv.1.weight"].shape == (4, 1, 1)
    assert block.channel_mul_conv[1].eps == 1e-6
    with pytest.raises(ValueError):
        ContextBlock(64, pooling_type="max")
    with pytest.raises(ValueError):
        ContextBlock(64, fusion_types=("channel_sub",))
