"""Twin models for the port's parity tests: ``ioudet``'s parameter tree of a
detector or module from ``jax.eval_shape`` (no initializer runs, nothing is
compiled), filled with seeded numpy values that keep activations O(1) and
spread the heads' outputs, and bridged to the port by
``state_dict_from_flax``.  So a twin needs no torch -> flax converter, and
every test of a twin also holds the bridge one for one (``strict`` load).

``one_thread`` runs a test module on one intra-op thread: the port's tests
run beside five other test workers, and an OpenMP pool as wide as the
machine then spends its time waiting for cores (a tiny model's train step
takes over ten times as long as alone).  A module takes it with ``from
tests.torch_twins import one_thread``."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# (path fragment, leaf) -> std of a normal draw, checked in order
HEAD_STDS = (
    ("rpn_cls", 0.3), ("rpn_reg", 0.05), ("fc_cls", 0.3), ("fc_reg", 0.02),
    ("upsample", 0.15), ("conv_logits", 0.3), ("conv_res", 0.08),
)


def param_shapes(module, *args, method=None, **kwargs) -> dict:
    """The ``params`` tree of ``module.init(key, *args)`` as shapes."""
    import jax   # here: a module that takes one_thread alone runs without JAX

    def init(*a):
        return module.init(jax.random.PRNGKey(0), *a, method=method, **kwargs)
    return jax.eval_shape(init, *args)["params"]


def _leaf(path: tuple, shape: tuple, rng) -> np.ndarray:
    name, parent = path[-1], "/".join(path[:-1])
    norm = len(path) > 1 and path[-2].startswith(("bn", "norm", "downsample_bn"))
    if name == "mean":
        return rng.uniform(-0.5, 0.5, shape)
    if name == "var":
        return rng.uniform(0.5, 2.0, shape)
    if name == "scale":
        return rng.uniform(0.5, 1.5, shape)
    if name == "bias":
        return rng.uniform(-0.5, 0.5, shape) if norm else rng.uniform(-0.1, 0.1, shape)
    for frag, std in HEAD_STDS:
        if frag in parent:
            return rng.normal(0.0, std, shape)
    fan_in = int(np.prod(shape[:-1]))
    std = np.sqrt((2.0 if len(shape) == 4 else 1.0) / fan_in)
    if path[0] == "backbone":
        std *= 0.5
    return rng.normal(0.0, std, shape)


def random_params(shapes: dict, seed: int) -> dict:
    """Seeded values for a tree of shapes (leaves visited in sorted path
    order): random FrozenBN statistics and norm affines, He-normal convs
    (halved in the backbone), LeCun-normal dense layers, the heads' output
    layers drawn wide (``HEAD_STDS``), small random biases."""
    import jax

    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    out = {}
    for path, leaf in sorted(flat, key=lambda kv: jax.tree_util.keystr(kv[0])):
        keys = tuple(p.key for p in path)
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _leaf(keys, tuple(leaf.shape), rng).astype(np.float32)
    return out
