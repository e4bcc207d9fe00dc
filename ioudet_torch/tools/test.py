"""Evaluate a detector on a config's test dataset (counterpart of the
repo's ``tools/test.py``).

    python -m ioudet_torch.tools.test CONFIG [CHECKPOINT] --eval bbox \\
        [--out results.pkl] [--json_out results.json] [--batch 8] \\
        [--device-preprocess] [--device cuda]

Without a checkpoint the weights are seeded random ones.  ``--device``
defaults to ``cuda`` and raises where there is no card.  A test pipeline
that holds ``MultiScaleFlipAug`` runs through ``tta_test`` (one image at a
time, ``--batch`` and ``--device-preprocess`` unused).  ``--eval bbox`` is
COCO's metric, ``--eval mAP`` VOC's.  Drawing results (``--show``) is not
ported yet.
"""

from __future__ import annotations

import argparse
import json
import pickle


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a detector (PyTorch port)")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--out", default=None, help="pickle of the per-image results")
    p.add_argument("--json_out", default=None, help="COCO result records as JSON")
    p.add_argument("--eval", nargs="*", default=[], help="metrics: bbox (COCO) / mAP (VOC)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device-preprocess", action="store_true",
                   help="decode on the host; resize, normalize and pad on the device")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {metric: metrics dict} for the metrics of ``--eval``."""
    args = parse_args(argv)
    from ioudet_torch.apis.inference import init_detector
    from ioudet_torch.apis.test import single_device_test, tta_test
    from ioudet_torch.data import build_dataset
    from ioudet_torch.utils.config import Config

    cfg = Config.fromfile(args.config)
    handle = init_detector(cfg, args.checkpoint, device=args.device)
    dataset = build_dataset(cfg.data["test"])
    if any(s.get("type") == "MultiScaleFlipAug" for s in cfg.data["test"]["pipeline"]):
        results = tta_test(handle, dataset, cfg.get("test_cfg", {}))
    else:
        results = single_device_test(handle, dataset, imgs_per_batch=args.batch,
                                     device_preprocess=args.device_preprocess)
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
