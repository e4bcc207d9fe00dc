"""Evaluate a detector on a config's test dataset (counterpart of the
repo's ``tools/test.py``).

    python -m ioudet_torch.tools.test CONFIG [CHECKPOINT] --eval bbox [segm] \\
        [--out results.pkl] [--json_out results.json] [--batch 8] \\
        [--device-preprocess] [--device cuda] [--n-devices N]

Without a checkpoint the weights are seeded random ones; a checkpoint is a
``.pth`` or an ``ioudet`` checkpoint directory.  ``--device`` defaults to
``cuda`` and raises where there is no card.  Data parallel, one process a
device: under ``torchrun`` (``tools/dist_test.sh``) or with ``--n-devices
N`` (N ranks on ``cuda:0..N-1``), each rank evaluates its shard and
``multi_host_test`` merges them; rank 0 writes ``--out`` / ``--json_out``
and prints the metrics.  A test pipeline
that holds ``MultiScaleFlipAug`` runs through ``tta_test`` (one image at a
time, ``--batch`` and ``--device-preprocess`` unused).  ``--eval bbox`` is
COCO's box metric, ``--eval segm`` its mask metric (a mask detector's
results), ``--eval mAP`` VOC's.  Drawing results (``--show``) is not
ported yet.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a detector (PyTorch port)")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--out", default=None, help="pickle of the per-image results")
    p.add_argument("--json_out", default=None, help="COCO result records as JSON")
    p.add_argument("--eval", nargs="*", default=[], help="metrics: bbox, segm (COCO) / mAP (VOC)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device-preprocess", action="store_true",
                   help="decode on the host; resize, normalize and pad on the device")
    p.add_argument("--device", default="cuda")
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel ranks, one a device")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {metric: metrics dict} for the metrics of ``--eval`` (None in
    the process that spawned the ranks)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    from ioudet_torch.tools import launch
    if launch.needs_spawn(args.n_devices):
        launch.check_devices(args.n_devices, args.device)
        launch.spawn(__name__, argv, args.n_devices)
        return None
    from ioudet_torch.apis.inference import init_detector
    from ioudet_torch.apis.test import multi_host_test, tta_test
    from ioudet_torch.data import build_dataset
    from ioudet_torch.parallel import init_dist, rank, world_size
    from ioudet_torch.utils.config import Config

    device = init_dist(device=args.device)
    if args.n_devices is not None and args.n_devices != world_size():
        raise ValueError(f"--n-devices {args.n_devices}, but the launcher started "
                         f"{world_size()} rank(s)")
    cfg = Config.fromfile(args.config)
    handle = init_detector(cfg, args.checkpoint, device=device)
    dataset = build_dataset(cfg.data["test"])
    if any(s.get("type") == "MultiScaleFlipAug" for s in cfg.data["test"]["pipeline"]):
        if world_size() > 1:
            raise NotImplementedError("tta_test runs on one device; the multi-device TTA "
                                      "merge is not ported")
        results = tta_test(handle, dataset, cfg.get("test_cfg", {}))
    else:
        results = multi_host_test(handle, dataset, imgs_per_batch=args.batch,
                                  device_preprocess=args.device_preprocess)
    if rank() != 0:
        return {}
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(dataset.results2json(results), f)
    metrics = {}
    for metric in args.eval:
        metrics[metric] = dataset.evaluate(results, **({} if metric == "mAP"
                                                        else dict(metric=metric)))
        print(metrics[metric])
    return metrics


if __name__ == "__main__":
    main()
