"""The port's checkpoints and runner on the CPU, at the tiny size of
tests/test_torch_train.py: a save / resume round trip that continues bit for
bit, ``train_detector``'s steps, log, checkpoints and resume, and its refusal
of a missing card.  Kept apart from the parity tests so that the two halves
run on two test workers.  The batches here are 32x32 canvases (the parity
tests' are 64x64): what these tests check does not depend on the size."""

import json
import os

import numpy as np
import pytest
import torch

from ioudet_torch.apis import train as ttrain
from ioudet_torch.apis.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from tests.test_torch_train import CFG, LR_CONFIG, OPTIMIZER, make_batch, new_model, tbatch
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

CANVAS = (32, 32)


def test_save_and_resume_continue_bit_exact(tmp_path):
    batch = tbatch(make_batch(seed=1, canvas=CANVAS))
    sched = ttrain.make_lr_schedule(0.01, LR_CONFIG, 10, 12)

    def setup(seed):
        model = new_model(seed)
        ttrain.make_trainable_mask(model)
        opt = ttrain.build_optimizer(model, OPTIMIZER)
        return model, opt, ttrain.make_train_step(model, opt, sched, dict(max_norm=35))

    model, opt, step = setup(0)
    step(batch, 0)
    step(batch, 1)
    path = save_checkpoint(str(tmp_path), "iter_2", model, opt, dict(epoch=0, step=2))
    assert latest_checkpoint(str(tmp_path)) == path and os.path.isfile(path)
    step(batch, 2)

    twin, twin_opt, twin_step = setup(5)   # other weights, empty momentum
    meta = load_checkpoint(twin, path, optimizer=twin_opt)
    assert meta == dict(epoch=0, step=2)
    twin_step(batch, meta["step"])
    for (k, a), b in zip(model.state_dict().items(), twin.state_dict().values()):
        assert torch.equal(a, b), k
    assert latest_checkpoint(str(tmp_path / "none")) is None


def test_train_detector_runs_logs_and_resumes(tmp_path):
    batches = [make_batch(seed=s, canvas=CANVAS) for s in (0, 1)]   # numpy: the runner moves them
    model = new_model()
    seen = []
    runner = ttrain.train_detector(model, batches, CFG, str(tmp_path), device="cpu",
                                   step_hook=lambda s, logs: seen.append((s, float(logs["loss"]))))
    assert runner.step == 4 and [s for s, _ in seen] == [1, 2, 3, 4]
    assert all(np.isfinite(v) for _, v in seen)
    with open(tmp_path / "log.json") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    assert [r["epoch"] for r in records] == [1, 1, 2, 2]
    assert {"loss", "loss_cls", "loss_bbox", "loss_iou", "lr", "time"} <= set(records[0])
    assert records[0]["loss"] == pytest.approx(seen[0][1])
    assert sorted(os.listdir(tmp_path)) == ["epoch_1.pth", "epoch_2.pth", "latest", "log.json"]

    # a second call finds the last checkpoint and goes on from epoch 3
    again = ttrain.train_detector(new_model(seed=9), batches, dict(CFG, total_epochs=3),
                                  str(tmp_path), device="cpu")
    assert again.step == 6 and again.epoch == 2
    meta = load_checkpoint(new_model(), latest_checkpoint(str(tmp_path)))
    assert meta["epoch"] == 3 and meta["step"] == 6
    # without auto_resume the run starts from the model it was given
    fresh = ttrain.train_detector(new_model(), batches[:1], dict(CFG, total_epochs=1),
                                  str(tmp_path / "fresh"), auto_resume=False, device="cpu")
    assert fresh.step == 1


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        ttrain.train_detector(new_model(), [make_batch()], CFG, str(tmp_path))
