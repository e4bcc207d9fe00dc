"""Train a detector on a config's train dataset (counterpart of the repo's
``tools/train.py``).

    python -m ioudet_torch.tools.train CONFIG [--work_dir D] \\
        [--resume_from CKPT] [--load_from CKPT] [--validate] [--seed N] \\
        [--device cuda]

One device; ``--device`` defaults to ``cuda`` and raises where there is no
card.  The weights start from ``--seed`` (or ``--load_from``'s); the run
resumes from ``work_dir/latest`` when there is one.  Data parallel
(``--n-devices``), ``--autoscale-lr`` and bf16 training are not ported yet.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a detector (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--work_dir", default=None)
    p.add_argument("--resume_from", default=None)
    p.add_argument("--load_from", default=None, help="load weights only")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the Runner."""
    args = parse_args(argv)
    from ioudet_torch.apis.inference import init_detector
    from ioudet_torch.apis.train import train_detector
    from ioudet_torch.data import build_dataset
    from ioudet_torch.utils.config import Config

    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "config.py"), "w") as f:
        f.write(cfg.text)
    handle = init_detector(cfg, args.load_from or cfg.get("load_from"),
                           device=args.device, seed=args.seed)
    dataset = build_dataset(cfg.data["train"])
    val_dataset = build_dataset(cfg.data["val"]) if args.validate and "val" in cfg.data else None
    return train_detector(handle, dataset, cfg, work_dir,
                          resume_from=args.resume_from or cfg.get("resume_from"),
                          device=args.device, seed=args.seed,
                          validate=args.validate, val_dataset=val_dataset)


if __name__ == "__main__":
    main()
