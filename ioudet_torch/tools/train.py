"""Train a detector on a config's train dataset (counterpart of the repo's
``tools/train.py``).

    python -m ioudet_torch.tools.train CONFIG [--work_dir D] \\
        [--resume_from CKPT] [--load_from CKPT] [--validate] [--seed N] \\
        [--device cuda] [--n-devices N] [--autoscale-lr] \\
        [--dtype {bfloat16,float32}]

``--device`` defaults to ``cuda`` and raises where there is no card.  The
weights start from ``--seed``, with ``--load_from``'s (a ``.pth`` or an
``ioudet`` checkpoint directory) merged over them; the run resumes from
``--resume_from`` or from ``work_dir/latest`` (either kind).

Data parallel, one process a device: under ``torchrun --nproc_per_node N``
(``tools/dist_train.sh``) the world comes from the launcher; without one,
``--n-devices N`` starts N ranks on ``cuda:0..N-1`` itself (more than the
host's cards raises; with ``--device cpu`` the ranks join over gloo).  Each
rank loads ``imgs_per_gpu`` images a step.  ``--autoscale-lr`` scales the LR
by ``imgs_per_gpu * world size / 16`` (``ioudet``'s rule); ``--dtype``
overrides the model's compute dtype (parameters stay f32).
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a detector (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--work_dir", default=None)
    p.add_argument("--resume_from", default=None)
    p.add_argument("--load_from", default=None, help="load weights only")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel ranks, one a device")
    p.add_argument("--autoscale-lr", action="store_true",
                   help="lr x imgs_per_gpu x world size / 16")
    p.add_argument("--dtype", default=None, choices=["bfloat16", "float32"])
    return p.parse_args(argv)


def main(argv=None):
    """Returns the Runner (None in the process that spawned the ranks)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    from ioudet_torch.tools import launch
    if launch.needs_spawn(args.n_devices):
        launch.check_devices(args.n_devices, args.device)
        launch.spawn(__name__, argv, args.n_devices)
        return None
    from ioudet_torch.apis.env import collect_env
    from ioudet_torch.apis.inference import init_detector
    from ioudet_torch.apis.train import train_detector
    from ioudet_torch.data import build_dataset
    from ioudet_torch.parallel import init_dist, rank, world_size
    from ioudet_torch.utils.config import Config
    from ioudet_torch.utils.logging import get_root_logger

    device = init_dist(device=args.device)
    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    if rank() == 0:
        with open(os.path.join(work_dir, "config.py"), "w") as f:
            f.write(cfg.text)
    logger = get_root_logger(log_file=os.path.join(work_dir, "train.log") if rank() == 0
                             else None)
    logger.info(f"environment: {collect_env()}")
    if args.dtype:
        cfg.model["dtype"] = args.dtype
    if args.autoscale_lr:
        cfg.optimizer["lr"] = cfg.optimizer["lr"] * cfg.data["imgs_per_gpu"] * world_size() / 16.0
    handle = init_detector(cfg, None, device=device, seed=args.seed)
    dataset = build_dataset(cfg.data["train"])
    val_dataset = build_dataset(cfg.data["val"]) if args.validate and "val" in cfg.data else None
    return train_detector(handle, dataset, cfg, work_dir,
                          resume_from=args.resume_from or cfg.get("resume_from"),
                          load_from=args.load_from, device=device, seed=args.seed,
                          validate=args.validate, val_dataset=val_dataset,
                          n_devices=args.n_devices)


if __name__ == "__main__":
    main()
