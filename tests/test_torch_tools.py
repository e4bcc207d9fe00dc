"""The port's command-line tools' training options on the CPU
(``ioudet_torch/tools/{train,test}.py``, ``tools/launch.py``), on a planted
COCO-style dataset and the tiny detector of tests/test_torch_eval_loop.py:

  * ``--autoscale-lr``: ioudet's rule, lr x imgs_per_gpu x world size / 16;
  * ``--dtype bfloat16``: the model computes in bf16 with f32 parameters,
    trains, writes ``log.json`` and a ``.pth``, and a second call resumes
    from it;
  * ``--n-devices``: more than the host's cards raises, and so does a CUDA
    device without a card; ``--n-devices 2 --device cpu`` starts two ranks
    over gloo from one command (train: one log and one checkpoint, written
    by rank 0; test: the merged results equal ``single_device_test``'s);
  * the runner's ``tensorboard`` option writes through ``SummaryWriter``,
    and warns where the package is missing;
  * ``apis/env.py`` (seeding, the environment report), ``utils/debug.py``
    (the finite check, the dtype policy) and ``utils/profiling.py`` (a
    trace, a timer)."""

import json
import logging
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from ioudet_torch.apis.inference import init_detector
from ioudet_torch.apis.test import single_device_test
from ioudet_torch.apis.train import Runner
from ioudet_torch.data import build_dataset
from ioudet_torch.tools import launch
from ioudet_torch.tools import test as test_tool
from ioudet_torch.tools import train as train_tool
from tests.test_torch_data_pipeline import plant_coco
from tests.test_torch_eval_loop import (TEST_CFG, TEST_PIPELINE, TRAIN_CFG, TRAIN_MODEL,
                                        TRAIN_PIPELINE)
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

SIZES = [(48, 80), (56, 90), (50, 84), (44, 72)]   # one group: 2 batches of 2
LR = 0.004


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    ann_file, img_dir = plant_coco(str(root), SIZES, seed=9, crowd=False)
    data = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir)
    cfg = dict(model=TRAIN_MODEL, train_cfg=TRAIN_CFG, test_cfg=TEST_CFG,
               data=dict(imgs_per_gpu=2, workers_per_gpu=1,
                         train=dict(data, pipeline=TRAIN_PIPELINE),
                         test=dict(data, pipeline=TEST_PIPELINE, test_mode=True)),
               optimizer=dict(type="SGD", lr=LR, momentum=0.9, weight_decay=0.0001),
               optimizer_config=dict(grad_clip=dict(max_norm=35)),
               lr_config=dict(policy="step", step=[8]), total_epochs=1,
               log_config=dict(interval=1), checkpoint_config=dict(interval=1))
    path = root / "cfg.py"
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    return str(path)


@pytest.mark.parametrize("autoscale", [False, True])
def test_autoscale_lr(config, tmp_path, autoscale):
    args = [config, "--work_dir", str(tmp_path), "--device", "cpu"]
    runner = train_tool.main(args + ["--autoscale-lr"] if autoscale else args)
    want = LR * 2 * 1 / 16.0 if autoscale else LR   # imgs_per_gpu 2, one rank
    assert runner.lr_schedule(runner.step) == pytest.approx(want, rel=1e-12)
    assert runner.optimizer.param_groups[0]["lr"] == pytest.approx(want, rel=1e-12)


def test_dtype_bfloat16_trains_writes_and_resumes(config, tmp_path):
    args = [config, "--work_dir", str(tmp_path), "--device", "cpu", "--dtype", "bfloat16"]
    runner = train_tool.main(args)
    model = runner.model
    assert model.backbone.conv1.compute_dtype == torch.bfloat16
    assert model.bbox_head.retina_cls.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert runner.step == 2
    with open(tmp_path / "log.json") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[k]) for r in records for k in ("loss", "loss_cls", "loss_bbox"))
    assert (tmp_path / "epoch_1.pth").is_file()
    # again, one epoch more: it resumes from epoch_1.pth at step 2
    again = train_tool.main(args + ["--resume_from", str(tmp_path / "epoch_1.pth")])
    assert again.step == 2 and again.epoch == 1
    twin = init_detector(config, str(tmp_path / "epoch_1.pth"), device="cpu").model
    for k, v in twin.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_n_devices_beyond_the_cards_raise(config, tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_tool.main([config, "--work_dir", str(tmp_path), "--n-devices", "2"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    count = torch.cuda.device_count()
    for tool in (train_tool, test_tool):
        with pytest.raises(ValueError, match="CUDA device"):
            tool.main([config, "--n-devices", str(count + 1)])
    assert not launch.needs_spawn(1) and not launch.needs_spawn(None)


def test_n_devices_two_ranks_on_the_cpu(config, tmp_path, monkeypatch):
    """Two spawned ranks over gloo from one command: each loads one batch
    of 2 an epoch, rank 0 alone writes; then the test tool merges the two
    ranks' shards into single_device_test's list."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # the spawned ranks import the test's modules from the repository root
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(sys.path))
    work = tmp_path / "work"
    assert train_tool.main([config, "--work_dir", str(work), "--device", "cpu",
                            "--n-devices", "2"]) is None
    with open(work / "log.json") as f:
        assert [json.loads(line)["step"] for line in f] == [1]
    assert sorted(os.listdir(work)) == ["config.py", "epoch_1.pth", "latest", "log.json",
                                        "train.log"]
    out = tmp_path / "res.pkl"
    assert test_tool.main([config, str(work / "epoch_1.pth"), "--device", "cpu",
                           "--n-devices", "2", "--batch", "1", "--out", str(out)]) is None
    with open(out, "rb") as f:
        merged = pickle.load(f)
    handle = init_detector(config, str(work / "epoch_1.pth"), device="cpu")
    want = single_device_test(handle, build_dataset(handle.cfg["data"]["test"]),
                              imgs_per_batch=1, workers=1, progress=False)
    assert len(merged) == len(want) == len(SIZES)
    for a, b in zip(merged, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


class FakeWriter:
    """``torch.utils.tensorboard.SummaryWriter``'s calls the runner makes."""
    made: list = []

    def __init__(self, log_dir):
        self.log_dir, self.scalars, self.closed = log_dir, [], False
        FakeWriter.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def flush(self):
        pass

    def close(self):
        self.closed = True


def test_tensorboard_option(tmp_path, monkeypatch, caplog):
    """Where the package is there (a stand-in module here: the real one
    imports for seconds), rank 0's records go to ``<work_dir>/tf_logs``;
    where it is not, a warning says so and training goes on."""
    model = torch.nn.Conv2d(1, 1, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = FakeWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    runner = Runner(model, opt, lambda batch, step: dict(loss=torch.tensor(0.5)),
                    str(tmp_path), log_interval=1, tensorboard=True)
    runner.run([{}, {}], total_epochs=1)
    writer = FakeWriter.made[-1]
    assert writer.log_dir == str(tmp_path / "tf_logs") and writer.closed
    assert [(t, s) for t, _, s in writer.scalars if t == "train/loss"] == [("train/loss", 1),
                                                                          ("train/loss", 2)]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = logging.getLogger("ioudet_torch")   # the Runner's, which does not propagate
    monkeypatch.setattr(logger, "handlers", logger.handlers + [caplog.handler])
    with caplog.at_level(logging.WARNING, logger="ioudet_torch"):
        bare = Runner(model, opt, lambda batch, step: {}, str(tmp_path / "bare"),
                      tensorboard=True)
    assert bare.tb_writer is None
    assert any("tensorboard is not installed" in r.message for r in caplog.records)


def test_env_debug_and_profiling_helpers(tmp_path):
    """apis/env.py, utils/debug.py and utils/profiling.py on the CPU."""
    from ioudet_torch.apis.env import collect_env, set_random_seed
    from ioudet_torch.utils.debug import assert_dtype_policy, check_finite, grads_of
    from ioudet_torch.utils.profiling import time_fn, trace

    g = set_random_seed(5)
    first = np.random.rand()
    set_random_seed(5)
    assert np.random.rand() == first
    assert isinstance(g, torch.Generator) and g.initial_seed() == 5
    env = collect_env()
    assert env["torch"] == torch.__version__ and env["world_size"] == 1
    assert {"cuda", "cudnn", "nvcc", "devices"} <= set(env)

    model = torch.nn.Linear(3, 2)
    model(torch.ones(4, 3)).sum().backward()
    assert check_finite(grads_of(model)) == {}
    with torch.no_grad():
        model.bias[0] = float("nan")
    assert check_finite(dict(model.named_parameters())) == {"bias": False}
    assert_dtype_policy(model)
    with pytest.raises(TypeError):
        assert_dtype_policy(model.to(torch.bfloat16))

    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(8).sum()
    assert os.path.isfile(tmp_path / "prof" / "trace.json") and prof.key_averages()
    timing = time_fn(lambda: torch.ones(8).sum(), iters=3, warmup=1, device="cpu")
    assert timing["median_s"] > 0 and timing["per_sec"] > 0
