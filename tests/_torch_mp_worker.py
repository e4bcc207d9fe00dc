"""One rank of the port's two-process data-parallel job
(tests/test_torch_parallel.py): ranks joined over gloo on the CPU by
``ioudet_torch.parallel.init_dist``, the tiny detector and dataset of
tests/mp_common.py.  No JAX here: the worker imports torch and ioudet_torch
only.

    python tests/_torch_mp_worker.py PORT RANK WORLD INIT_PTH WORK_DIR OUT_PKL

The rank trains 3 steps at ``imgs_per_gpu`` = 2 through ``train_detector``
with a validation hook, evaluates through ``multi_host_test`` (12 images, and
11 for an uneven shard), resumes a second epoch from the checkpoint rank 0
wrote, runs the same two epochs unbroken, and gathers a ragged tree through
``allgather_pytrees``; what it saw goes to OUT_PKL."""

import os
import pickle
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

IMGS_PER_GPU = 2
OPTIMIZER = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=0.0001)
LR_CONFIG = dict(policy="step", warmup="linear", warmup_iters=500, warmup_ratio=1.0 / 3,
                 step=[8, 11])
GRAD_CLIP = dict(max_norm=35)


def train_cfg(total_epochs: int) -> dict:
    from mp_common import small_detector_cfgs
    model, train_cfg, test_cfg = small_detector_cfgs()
    return dict(model=model, train_cfg=train_cfg, test_cfg=test_cfg, optimizer=OPTIMIZER,
                lr_config=LR_CONFIG, optimizer_config=dict(grad_clip=GRAD_CLIP),
                total_epochs=total_epochs, log_config=dict(interval=1),
                checkpoint_config=dict(interval=1))


def eval_dataset(n: int):
    """TinyDataset with an ``evaluate`` that counts and sums what it got."""
    from mp_common import TinyDataset

    class Counted(TinyDataset):
        def evaluate(self, results):
            return dict(n_results=float(len(results)),
                        score_sum=float(sum(float(r[:, 4].sum()) for per in results
                                            for r in per)))

    return Counted(n)


def new_model(init_path: str):
    from ioudet_torch.models import build_detector
    cfg = train_cfg(1)
    model = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"])
    model.load_state_dict(torch.load(init_path, weights_only=True))
    return model


def state(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def ragged_tree(rank: int) -> dict:
    if rank == 0:
        return {"a": np.arange(6, dtype=np.float32).reshape(3, 2), "b": np.zeros((0,), np.int64),
                "c": np.int32(7), "d": (np.array([True]), np.ones((2, 2, 3), np.float16))}
    return {"a": np.arange(2, dtype=np.float32).reshape(1, 2) + 10,
            "b": np.arange(10, dtype=np.int64).reshape(2, 5), "c": np.int32(8),
            "d": (np.array([False, True, False]), np.zeros((0,), np.float16))}


def main(port: str, rank: int, world: int, init_path: str, work: str, out: str) -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    from mp_common import TinyDataset
    from ioudet_torch.apis.test import multi_host_test
    from ioudet_torch.apis.train import train_detector
    from ioudet_torch.data import build_dataloader
    from ioudet_torch.parallel import allgather_pytrees, init_dist

    device = init_dist(device="cpu")

    def loader():   # this rank's shard of the batches, in dataset order
        return build_dataloader(TinyDataset(), IMGS_PER_GPU, 1, shuffle=False, drop_last=False)

    losses = []
    model = new_model(init_path)
    runner = train_detector(model, loader(), train_cfg(1), os.path.join(work, "run"),
                            device=device, n_devices=world, validate=True,
                            val_dataset=eval_dataset(12),
                            step_hook=lambda s, logs: losses.append(
                                {k: float(v) for k, v in logs.items()}))
    params = state(model)
    results = multi_host_test(model, TinyDataset(), imgs_per_batch=2, workers=1, progress=False)
    uneven = multi_host_test(model, TinyDataset(11), imgs_per_batch=2, workers=1,
                             progress=False)

    resumed = train_detector(new_model(init_path), loader(), train_cfg(2),
                             os.path.join(work, "run"), device=device)
    unbroken = train_detector(new_model(init_path), loader(), train_cfg(2),
                              os.path.join(work, "unbroken"), device=device)
    with open(out, "wb") as f:
        pickle.dump(dict(losses=losses, params=params, steps=runner.step,
                         is_writer=runner.is_writer, results=results, uneven=uneven,
                         resumed_steps=resumed.step,
                         params_resumed=state(resumed.model),
                         params_unbroken=state(unbroken.model),
                         gathered=allgather_pytrees(ragged_tree(rank))), f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
