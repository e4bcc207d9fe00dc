"""ioudet's checkpoint directories read by the port (ioudet_torch/utils/
flax_msgpack.py, ioudet_torch/apis/checkpoint.py), on the CPU:

  * the port's msgpack reader against flax's ``msgpack_restore`` on random
    trees of ``to_bytes`` (hypothesis): every dtype ioudet writes (f32,
    bf16, f16, i32, i64, u8, bool), 0-d arrays, numpy and Python scalars of
    every msgpack width, strings, bytes, None, empty dicts and lists, and the
    chunked form of a large array (flax's chunk size shrunk in the test);
  * ioudet's ``save_checkpoint`` of a train state after two steps of SGD
    and of Adam (the optax state nested in ``multi_transform`` / ``chain``
    with ``MaskedNode`` for the frozen stages, as flax writes it), read by
    the port's ``load_checkpoint`` into the model and the optimizer, then
    one more step: the port's equals ioudet's from the same directory;
  * ``train_detector`` resuming from such a directory at its step;
  * ``load_from`` with a partial tree (the backbone alone) over the seeded
    weights, and a ``model_state`` collection that the port cannot carry
    refused (GHM's 'ghm' crosses into the heads' buffers).

Tolerances: the msgpack trees bit for bit; the step after the load,
tests/test_torch_train.py's: losses rtol 1e-4, parameters rtol 1e-4, atol
2e-6."""

import json
import os

import hypothesis.extra.numpy as hnp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from ioudet.apis import checkpoint as jckpt
from ioudet.apis import train as jtrain
from ioudet_torch.apis import train as ttrain
from ioudet_torch.apis.checkpoint import (load_checkpoint, merge_weights, read_flax_checkpoint,
                                          state_dict_from_flax)
from ioudet_torch.utils.flax_msgpack import MsgpackError, msgpack_restore
from ioudet.models import build_detector as jax_build_detector
from tests.test_torch_train import (LR_CONFIG, MODEL, TRAIN_CFG, bridge, make_batch, new_model,
                                    tbatch)
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

DTYPES = [np.float32, np.float16, np.int32, np.int64, np.uint8, np.bool_]


def same_tree(a, b, path="") -> None:
    """a (the port's) equals b (flax's) leaf for leaf, dtype and bits."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        for k in b:
            same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, np.ndarray) and b.dtype == jnp.bfloat16:
        assert isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16, path
        assert tuple(a.shape) == b.shape, path
        np.testing.assert_array_equal(a.view(torch.int16).numpy(), b.view(np.int16), path)
    elif isinstance(b, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, path)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), path


arrays = st.one_of(
    st.sampled_from(DTYPES).flatmap(lambda dt: hnp.arrays(
        dt, hnp.array_shapes(min_dims=0, max_dims=4, min_side=0, max_side=5))),
    hnp.arrays(np.float32, hnp.array_shapes(min_dims=0, max_dims=3, max_side=4),
               elements=st.floats(-1e4, 1e4, width=32)).map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))))
scalars = st.one_of(
    st.integers(-2 ** 63, 2 ** 64 - 1), st.floats(allow_nan=True), st.booleans(), st.none(),
    st.text(max_size=40), st.binary(max_size=300),
    st.sampled_from(DTYPES[:-1]).map(lambda dt: dt(3)), st.just(np.bool_(True)))
trees = st.recursive(
    st.one_of(arrays, scalars),
    lambda children: st.one_of(
        st.dictionaries(st.text(min_size=1, max_size=12), children, max_size=6),
        st.lists(children, max_size=4)),
    max_leaves=25)


@settings(max_examples=150, deadline=None)
@given(tree=st.dictionaries(st.text(min_size=1, max_size=12), trees, max_size=6))
def test_reader_equals_flax_on_random_trees(tree):
    data = serialization.to_bytes(tree)
    same_tree(msgpack_restore(data), serialization.msgpack_restore(data))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, "bfloat16"])
def test_chunked_arrays(monkeypatch, dtype):
    """flax writes an array larger than MAX_CHUNK_SIZE bytes as chunks."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = np.arange(3 * 7 * 11).reshape(3, 7, 11)
    big = np.asarray(jnp.asarray(big, jnp.bfloat16)) if dtype == "bfloat16" else big.astype(dtype)
    data = serialization.to_bytes({"w": big, "small": np.ones(3, np.float32),
                                   "deep": {"v": big[0]}})
    assert b"__msgpack_chunked_array__" in data
    same_tree(msgpack_restore(data), serialization.msgpack_restore(data))


def test_malformed_bytes_raise():
    data = serialization.to_bytes({"a": np.ones(4, np.float32)})
    with pytest.raises(MsgpackError):
        msgpack_restore(data[:-3])
    with pytest.raises(MsgpackError):
        msgpack_restore(data + b"\x00")
    with pytest.raises(MsgpackError):
        msgpack_restore(b"\xc1")


OPTIMIZERS = {"SGD": dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=0.0001),
              "Adam": dict(type="Adam", lr=1e-3, weight_decay=0.0001, beta1=0.85, beta2=0.99)}
GRAD_CLIP = dict(max_norm=35)
IPE = 10   # iterations an epoch, for both schedules


def port_step(model, opt_cfg):
    ttrain.make_trainable_mask(model)
    opt = ttrain.build_optimizer(model, opt_cfg)
    sched = ttrain.make_lr_schedule(opt_cfg["lr"], LR_CONFIG, IPE, 12)
    return opt, ttrain.make_train_step(model, opt, sched, GRAD_CLIP)


@pytest.fixture(scope="module")
def ioudet_dirs(tmp_path_factory):
    """For each optimizer: ioudet's checkpoint directory after two steps of
    ``make_train_step`` from the port's seeded weights (``iter_2``), and
    ioudet's third step from it: (dir, its log, its parameters)."""
    root = tmp_path_factory.mktemp("ioudet")
    batch = make_batch(seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for name, opt_cfg in OPTIMIZERS.items():
        params = bridge(new_model(seed=0))
        det = jax_build_detector(dict(MODEL), TRAIN_CFG, None)
        sched = jtrain.make_lr_schedule(opt_cfg["lr"], dict(LR_CONFIG), IPE, 12)
        tx = jtrain.build_optimizer(dict(opt_cfg), sched,
                                    jtrain.make_trainable_mask(params, frozen_stages=1),
                                    grad_clip=GRAD_CLIP)
        state = dict(params=jax.tree.map(jnp.asarray, params), step=jnp.zeros((), jnp.int32),
                     model_state={})
        state["opt_state"] = tx.init(state["params"])
        step = jtrain.make_train_step(det, tx)
        for _ in range(2):
            state, _ = step(state, jbatch)
        work = str(root / name)
        jckpt.save_checkpoint(work, "iter_2", jax.device_get(state),
                              dict(epoch=1, step=2, CLASSES=None))
        state, logs = step(state, jbatch)
        out[name] = (os.path.join(work, "iter_2"), {k: float(v) for k, v in logs.items()},
                     state_dict_from_flax(jax.device_get(state["params"])))
    return out


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_resume_from_an_ioudet_directory_then_step(ioudet_dirs, name):
    path, jlogs, ref = ioudet_dirs[name]
    raw, meta = read_flax_checkpoint(path)
    assert meta == dict(epoch=1, step=2, CLASSES=None) and int(raw["step"]) == 2

    model = new_model(seed=5)   # other weights and an empty optimizer state
    opt, step = port_step(model, OPTIMIZERS[name])
    got = load_checkpoint(model, path, optimizer=opt)
    assert got["step"] == 2 and got["epoch"] == 1
    assert len(opt.state) == len(opt.param_groups[0]["params"])
    if name == "Adam":
        assert all(float(s["step"]) == 2.0 for s in opt.state.values())
    logs = step(tbatch(make_batch(seed=2)), got["step"])
    for k in ("loss_cls", "loss_bbox", "loss_iou", "loss"):
        np.testing.assert_allclose(float(logs[k]), jlogs[k], rtol=1e-4, err_msg=k)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=2e-6, err_msg=k)


def test_train_detector_resumes_an_ioudet_run(ioudet_dirs, tmp_path):
    """A ``resume_from`` that names ioudet's directory: the port's runner
    resumes there, at its step and epoch, and goes on with .pth files."""
    path = ioudet_dirs["SGD"][0]
    cfg = dict(model=MODEL, train_cfg=TRAIN_CFG, optimizer=OPTIMIZERS["SGD"],
               lr_config=LR_CONFIG, optimizer_config=dict(grad_clip=GRAD_CLIP),
               total_epochs=2, log_config=dict(interval=1), checkpoint_config=dict(interval=1))
    batch = make_batch(seed=2)
    runner = ttrain.train_detector(new_model(seed=5), [batch, batch], cfg, str(tmp_path),
                                   device="cpu", resume_from=path)
    assert runner.step == 4 and runner.epoch == 1
    with open(tmp_path / "log.json") as f:
        assert [json.loads(line)["step"] for line in f] == [3, 4]
    assert (tmp_path / "epoch_2.pth").is_file()
    assert (tmp_path / "latest").read_text() == "epoch_2.pth"


def test_load_from_a_partial_tree(tmp_path):
    model = new_model(seed=0)
    twin = new_model(seed=3)
    before = {k: v.clone() for k, v in twin.state_dict().items()}
    params = bridge(model)
    jckpt.save_checkpoint(str(tmp_path), "backbone", {"params": {"backbone": params["backbone"]}})
    names = merge_weights(twin, str(tmp_path / "backbone"))
    assert names and all(n.startswith("backbone.") for n in names)
    src = model.state_dict()
    for k, v in twin.state_dict().items():
        want = src[k] if k.startswith("backbone.") else before[k]
        assert torch.equal(v, want), k
    # through train_detector's load_from: the same weights, then training
    cfg = dict(model=MODEL, train_cfg=TRAIN_CFG, optimizer=OPTIMIZERS["SGD"],
               lr_config=LR_CONFIG, total_epochs=1, log_config=dict(interval=1),
               checkpoint_config=dict(interval=1))
    third = new_model(seed=3)
    frozen = {k: v.clone() for k, v in src.items() if k.startswith("backbone.layer1.")}
    ttrain.train_detector(third, [make_batch()], cfg, str(tmp_path / "work"), device="cpu",
                          load_from=str(tmp_path / "backbone"))
    for k, v in frozen.items():
        assert torch.equal(third.state_dict()[k], v), k


def test_unknown_names_and_model_state_refused(tmp_path):
    params = bridge(new_model(seed=0))
    bad = {"params": {"bbox_head": dict(params["bbox_head"],
                                        retina_cls={"kernel": np.zeros((3, 3, 32, 7),
                                                                       np.float32)})}}
    jckpt.save_checkpoint(str(tmp_path), "bad", bad)
    with pytest.raises(ValueError, match="shape"):
        merge_weights(new_model(), str(tmp_path / "bad"))
    # GHM's 'ghm' collection crosses into the heads' buffers (a model
    # without them refuses its names); any other collection is not ported
    jckpt.save_checkpoint(str(tmp_path), "ghm", dict(params=params,
                                                    model_state={"ghm": {"acc": np.zeros(3)}}))
    with pytest.raises(RuntimeError, match="acc"):
        load_checkpoint(new_model(), str(tmp_path / "ghm"))
    jckpt.save_checkpoint(str(tmp_path), "bn", dict(
        params=params, model_state={"batch_stats": {"mean": np.zeros(3)}}))
    with pytest.raises(NotImplementedError, match="model_state.*batch_stats"):
        load_checkpoint(new_model(), str(tmp_path / "bn"))


def test_dir_checkpoint_has_the_layout_the_reader_assumes(ioudet_dirs):
    """The Adam state as flax writes it: multi_transform's inner_states,
    'train' / 'freeze', chain entries '0'.., MaskedNode as {} (frozen)."""
    path = ioudet_dirs["Adam"][0]
    raw, _ = read_flax_checkpoint(path)
    inner = raw["opt_state"]["inner_states"]["train"]["inner_state"]
    adam = inner["1"]   # clip, adam, decay, lr
    assert set(adam) == {"count", "mu", "nu"} and int(adam["count"]) == 2
    assert set(raw["opt_state"]["inner_states"]) == {"train", "freeze"}
    assert adam["mu"]["backbone"]["conv1"] == {"kernel": {}}
    assert adam["mu"]["backbone"]["layer2_0"]["bn1"]["mean"] == {}
    assert adam["mu"]["bbox_head"]["retina_cls"]["kernel"].shape == (3, 3, 32, 36)
    assert os.path.isfile(os.path.join(path, "meta.json"))
