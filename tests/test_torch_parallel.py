"""The port's data parallel on the CPU (ioudet_torch/parallel, the sharded
loader, DDP in the train step, multi_host_test), held against ioudet.

  * ``GroupedBatchSampler`` with 1-4 shards, shuffled and not, gives
    ioudet's batches shard for shard (numpy only);
  * ``init_dist`` joins nothing in a single process, refuses a CUDA device
    without a card, and raises where a world of 2 cannot form (ioudet's
    swallows every exception);
  * a real two-process job over gloo (tests/_torch_mp_worker.py, no JAX in
    the workers): after 3 steps at 2 images a rank, both ranks' parameters
    and logged losses equal a one-process port run at the global batch of 4,
    and that run equals ioudet's one-device ``make_train_step``; the eval
    merge equals ``single_device_test`` bit for bit, also on an uneven shard;
    the eval hook sees the whole dataset on both ranks; rank 0 alone writes;
    both ranks resume from its checkpoint and go on bit-equal to an unbroken
    run; ``allgather_pytrees`` on ragged and empty shards.

Tolerances.  Ranks against the one-process run: the same arithmetic, but
the convolutions' weight gradients sum two images a rank and then the two
ranks, against four images at once: losses rtol 1e-5, parameters rtol 1e-5,
atol 1e-7 (an LR of 3.3e-3 times a gradient that differs in its last bits).
The one-process run against ioudet: tests/test_torch_train.py's, losses rtol
1e-4, parameters rtol 1e-4, atol 2e-6."""

import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.apis import train as jtrain
from ioudet.apis.checkpoint import convert_torch_retinanet
from ioudet.data.loader import GroupedBatchSampler as JaxSampler
from ioudet.models import build_detector as jax_build_detector
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.apis.test import single_device_test
from ioudet_torch.apis.train import train_detector
from ioudet_torch.data import build_dataloader
from ioudet_torch.data.loader import GroupedBatchSampler
from ioudet_torch.models import build_detector
from ioudet_torch.parallel import allgather_pytrees, init_dist, world_size
from tests._torch_mp_worker import (GRAD_CLIP, IMGS_PER_GPU, LR_CONFIG, OPTIMIZER,
                                    eval_dataset, train_cfg)
from tests.mp_common import TRAIN_KEYS, TinyDataset
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD = 2
STEPS = 12 // (IMGS_PER_GPU * WORLD)

# 13 landscape, 6 portrait: ragged at batch 2 and 5 in both groups
FLAGS = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1], np.uint8)


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("batch", [2, 5])
def test_sharded_sampler_equals_ioudet(shards, shuffle, drop_last, batch):
    seen = []
    for shard in range(shards):
        ours = GroupedBatchSampler(FLAGS, batch, shuffle, seed=3, drop_last=drop_last,
                                   num_shards=shards, shard_index=shard)
        ref = JaxSampler(FLAGS, batch, shuffle, seed=3, num_shards=shards, shard_index=shard,
                         drop_last=drop_last)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got = list(ours)
            assert got == list(ref), (shard, epoch)
            assert len(ours) == len(ref) == len(got)
            if epoch == 0:
                seen.append(got)
    assert len({len(s) for s in seen}) == 1   # every rank takes as many steps
    if not drop_last:
        assert {i for s in seen for b in s for i in b} == set(range(len(FLAGS)))


def test_sampler_shards_default_to_the_world():
    s = GroupedBatchSampler(FLAGS, 2)
    assert (s.num_shards, s.shard_index) == (1, 0) and world_size() == 1
    with pytest.raises(ValueError):
        GroupedBatchSampler(FLAGS, 2, num_shards=2, shard_index=2)


def test_init_dist_alone_and_refusals(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_dist(device="cpu") == torch.device("cpu")
    assert world_size() == 1 and allgather_pytrees({"a": np.ones(2)})[0]["a"].sum() == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_dist(device="cuda")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="not set"):
        init_dist(device="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_dist_raises_where_the_world_cannot_form():
    """Rank 1 of 2 with no rank 0 listening: the join times out and raises
    in the rank, which exits non-zero (it does not train on alone)."""
    code = ("import os, sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from ioudet_torch.parallel import init_dist, mesh\n"
            "mesh.TIMEOUT_S = 1\n"
            "init_dist(device='cpu')\n"
            "print('joined')\n")
    env = dict(os.environ, RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "joined" not in proc.stdout, proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def init_weights(tmp_path_factory):
    """The seeded starting weights, as a .pth the workers load."""
    cfg = train_cfg(1)
    model = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"])
    model.init_weights(torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("init") / "init.pth")
    torch.save(model.state_dict(), path)
    return path


@pytest.fixture(scope="module")
def ranks(init_weights, tmp_path_factory):
    """Run the two-process job once; every test below reads its outputs."""
    tmp = tmp_path_factory.mktemp("ranks")
    port = str(_free_port())
    outs = [str(tmp / f"rank{r}.pkl") for r in range(WORLD)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_mp_worker.py"), port, str(r), str(WORLD),
         init_weights, str(tmp / "work"), outs[r]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed (exit {p.returncode}):\n{logs[r][-6000:]}"
    outputs = []
    for o in outs:
        with open(o, "rb") as f:
            outputs.append(pickle.load(f))
    return outputs, str(tmp / "work")


def new_model(init_path):
    cfg = train_cfg(1)
    model = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"])
    model.load_state_dict(torch.load(init_path, weights_only=True))
    return model


@pytest.fixture(scope="module")
def one_process(init_weights, tmp_path_factory):
    """The same 3 steps in this process at the global batch of 4."""
    model = new_model(init_weights)
    losses = []
    loader = build_dataloader(TinyDataset(), IMGS_PER_GPU * WORLD, 1, shuffle=False,
                              drop_last=False)
    train_detector(model, loader, train_cfg(1), str(tmp_path_factory.mktemp("one")),
                   device="cpu", auto_resume=False,
                   step_hook=lambda s, logs: losses.append({k: float(v) for k, v in logs.items()}))
    return model, losses


def test_ranks_equal_one_process_at_the_global_batch(ranks, one_process):
    outputs, _ = ranks
    model, losses = one_process
    ref = {k: v.numpy() for k, v in model.state_dict().items()}
    for r, out in enumerate(outputs):
        assert out["steps"] == STEPS and len(out["losses"]) == STEPS
        for got, want in zip(out["losses"], losses):
            assert sorted(got) == sorted(want) == ["loss", "loss_bbox", "loss_cls", "loss_iou"]
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"rank {r} {k}")
        for k, v in ref.items():
            np.testing.assert_allclose(out["params"][k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"rank {r} {k}")
    a, b = outputs
    assert a["losses"] == b["losses"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])


def test_one_process_equals_ioudet(init_weights, one_process):
    model, losses = one_process
    cfg = train_cfg(1)
    det = jax_build_detector(dict(cfg["model"]), cfg["train_cfg"], cfg["test_cfg"])
    start = new_model(init_weights).state_dict()
    params = jax.tree.map(lambda a: np.array(a, copy=True), convert_torch_retinanet(
        start, depth=18, num_laterals=3, stacked_convs=1))
    loader = build_dataloader(TinyDataset(), IMGS_PER_GPU * WORLD, 1, shuffle=False,
                              drop_last=False)
    sched = jtrain.make_lr_schedule(OPTIMIZER["lr"], dict(LR_CONFIG), len(loader), 1)
    tx = jtrain.build_optimizer(dict(OPTIMIZER), sched,
                                jtrain.make_trainable_mask(params, frozen_stages=1),
                                grad_clip=GRAD_CLIP)
    state = dict(params=jax.tree.map(jnp.asarray, params), step=jnp.zeros((), jnp.int32))
    state["opt_state"] = tx.init(state["params"])
    step = jtrain.make_train_step(det, tx)
    for i, batch in enumerate(loader):
        state, logs = step(state, {k: jnp.asarray(batch[k]) for k in TRAIN_KEYS})
        for k in losses[i]:
            np.testing.assert_allclose(losses[i][k], float(logs[k]), rtol=1e-4, err_msg=k)
    assert i + 1 == STEPS
    ref = state_dict_from_flax(jax.device_get(state["params"]))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=2e-6, err_msg=k)


def assert_same_results(got, want):
    assert len(got) == len(want)
    for per_got, per_want in zip(got, want):
        assert len(per_got) == len(per_want)
        for x, y in zip(per_got, per_want):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", [12, 11])
def test_eval_merge_equals_single_device_test(ranks, n):
    """12 images: both shards full; 11: the loader repeats image 0 in the
    last batch, and the merge keeps the first copy."""
    outputs, _ = ranks
    model = new_model_from(outputs[0]["params"])
    want = single_device_test(model, TinyDataset(n), imgs_per_batch=2, workers=1,
                              progress=False)
    for out in outputs:
        assert_same_results(out["results" if n == 12 else "uneven"], want)


def new_model_from(params: dict):
    cfg = train_cfg(1)
    model = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return model.eval()


def test_rank0_alone_writes_and_the_hook_sees_every_image(ranks):
    outputs, work = ranks
    assert [o["is_writer"] for o in outputs] == [True, False]
    import json
    with open(os.path.join(work, "run", "log.json")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["mode"] == "train"]
    val = [r for r in records if r["mode"] == "val"]
    # one record a step (not one a rank), each the global batch's losses;
    # the resumed epoch 2 appends its own
    assert [r["step"] for r in train] == list(range(1, 2 * STEPS + 1))
    for rec, seen in zip(train, outputs[0]["losses"]):
        assert rec["loss"] == pytest.approx(seen["loss"], rel=1e-6)
    assert val[0]["n_results"] == 12.0
    model = new_model_from(outputs[0]["params"])
    want = eval_dataset(12).evaluate(single_device_test(model, TinyDataset(), 2, 1,
                                                        progress=False))
    assert val[0]["score_sum"] == pytest.approx(want["score_sum"], rel=1e-6)
    assert sorted(os.listdir(os.path.join(work, "run"))) == \
        ["epoch_1.pth", "epoch_2.pth", "latest", "log.json"]


def test_both_ranks_resume_and_go_on_as_an_unbroken_run(ranks):
    outputs, _ = ranks
    for out in outputs:
        assert out["resumed_steps"] == 2 * STEPS
        for k, v in out["params_unbroken"].items():
            np.testing.assert_array_equal(out["params_resumed"][k], v, err_msg=k)
    for k, v in outputs[0]["params_resumed"].items():
        np.testing.assert_array_equal(outputs[1]["params_resumed"][k], v, err_msg=k)


def test_allgather_ragged_and_empty_shards(ranks):
    outputs, _ = ranks
    from tests._torch_mp_worker import ragged_tree
    for out in outputs:
        gathered = out["gathered"]
        assert len(gathered) == WORLD
        for r, tree in enumerate(gathered):
            want = ragged_tree(r)
            np.testing.assert_array_equal(tree["a"], want["a"])
            assert tree["a"].dtype == np.float32 and tree["c"] == want["c"]
            assert tree["b"].dtype == np.int64 and tree["d"][1].dtype == np.float16
            assert isinstance(tree["d"], tuple)
            np.testing.assert_array_equal(tree["d"][0], want["d"][0])
        # the empty shards come back with their peers' trailing shapes
        assert gathered[0]["b"].shape == (0, 5)
        assert gathered[1]["d"][1].shape == (0, 2, 3)
        np.testing.assert_array_equal(gathered[1]["b"], ragged_tree(1)["b"])
        np.testing.assert_array_equal(gathered[0]["d"][1], ragged_tree(0)["d"][1])
