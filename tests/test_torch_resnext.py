"""The new bottleneck options of the port's backbone against ``ioudet``'s on
the same seeded weights, bridged by ``state_dict_from_flax``, and a seeded
64x96 input: ResNeXt-50 (4 groups of base width 4: only conv2 grouped, the
grouped kernel through the bridge's transpose), deformable 3x3s (v1 in
stages 3-4 as the DCN config, v2 in stages 2-4) and global-context blocks
in stages 3-4 (the GCB config).  Tolerance: the detector test's rtol = atol =
2e-3 on every stage output (f32 sums over 50 layers in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.models.backbones.resnet import ResNet as JaxResNet
from ioudet.models.backbones.resnext import ResNeXt as JaxResNeXt
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.models.backbones.resnet import Bottleneck, ResNet
from ioudet_torch.models.backbones.resnext import ResNeXt
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

CASES = {
    "resnext50_4x4d": (ResNeXt, JaxResNeXt, dict(groups=4, base_width=4)),
    "dcn_c3-c5": (ResNet, JaxResNet, dict(stage_with_dcn=(False, False, True, True))),
    "mdcn_c2-c5": (ResNet, JaxResNet, dict(stage_with_dcn=(False, True, True, True),
                                           dcn_modulated=True)),
    "gcb_c3-c5": (ResNet, JaxResNet, dict(stage_with_gcb=(False, False, True, True))),
}


def seeded_params(tree, seed):
    """Weights that keep activations O(1) over 50 layers: He-scaled kernels
    at 0.7, offset convs small enough for offsets of a few pixels, random
    FrozenBN statistics and LayerNorm affines."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        names = [getattr(p, "key", "") for p in path]
        if a.ndim == 4:
            fan_in = a.shape[0] * a.shape[1] * a.shape[2]
            std = (0.3 if "conv2_offset" in names else 0.7 * np.sqrt(2.0)) / np.sqrt(fan_in)
            return rng.normal(0, std, a.shape).astype(np.float32)
        if names[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.uniform(-0.3, 0.3, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.mark.parametrize("name", list(CASES))
def test_backbone_matches_ioudet(name):
    ours_cls, ref_cls, kw = CASES[name]
    x = np.random.default_rng(1).normal(0, 1, (2, 64, 96, 3)).astype(np.float32)
    ref_mod = ref_cls(depth=50, **kw)
    shapes = jax.eval_shape(lambda a: ref_mod.init(jax.random.PRNGKey(0), a),
                            jax.ShapeDtypeStruct(x.shape, jnp.float32))["params"]
    params = seeded_params(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                  shapes), seed=2)
    refs = jax.jit(lambda p, a: ref_mod.apply({"params": p}, a))(params, jnp.asarray(x))

    ours = ours_cls(depth=50, **kw).eval()
    sd = state_dict_from_flax({"backbone": params, "bbox_head": {}})
    ours.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    with torch.no_grad():
        outs = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(outs) == len(refs) == 4
    for out, ref in zip(outs, refs):
        ref = np.asarray(ref).transpose(0, 3, 1, 2)
        assert np.abs(ref).max() > 1e-2
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3, atol=2e-3)


def test_blocks_carry_the_options():
    """Widths of the ResNeXt rule int(planes * base_width / 64 * groups),
    the grouped conv2 only; the DCN and GCB modules where the stages say."""
    x101 = ResNeXt(depth=101, groups=32, base_width=4)
    first = x101.layer1[0]
    assert (first.conv1.out_channels, first.conv2.groups, first.conv3.in_channels) == (128, 32, 128)
    assert first.conv1.groups == first.conv3.groups == 1
    dcn = ResNet(depth=50, stage_with_dcn=(False, False, True, True), dcn_modulated=True,
                 stage_with_gcb=(False, True, False, False))
    blocks = [(i, b) for i in range(1, 5) for b in getattr(dcn, f"layer{i}")]
    assert all(isinstance(b, Bottleneck) for _, b in blocks)
    assert [i for i, b in blocks if b.with_dcn] == [3] * 6 + [4] * 3
    assert [i for i, b in blocks if b.context_block is not None] == [2] * 4
    dcn.init_weights(torch.Generator().manual_seed(0))
    offset = dcn.layer3[0].conv2_offset
    assert offset.out_channels == 27 and offset.stride == (2, 2) and dcn.layer3[0].conv2.stride == 2
    assert not offset.weight.any() and not offset.bias.any()
    assert dcn.layer3[0].conv2.weight.std() > 0
    # seeded init is reproducible, the context blocks' conv biases included
    twin = ResNet(depth=50, stage_with_dcn=(False, False, True, True), dcn_modulated=True,
                  stage_with_gcb=(False, True, False, False))
    twin.init_weights(torch.Generator().manual_seed(0))
    for (name, a), b in zip(dcn.state_dict().items(), twin.state_dict().values()):
        assert torch.equal(a, b), name
