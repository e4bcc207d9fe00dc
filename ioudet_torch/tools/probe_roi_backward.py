"""Two-stage train steps with the backward of RoIAlign's row gather in its
two forms, on one NVIDIA GPU.

    python -m ioudet_torch.tools.probe_roi_backward [--steps 8] [--models c4 faster ...]

Each model is a config of ``configs/`` at full width and depth, seeded
random weights, TF32 off, batch 2 with 100 gt slots (the models, batches
and train steps of ``chip_smoke.py`` phases 9b, 10b, 11b, 12d and 12f, two
steps through ``train_detector`` first): ``c4``
(``faster_rcnn_r50_caffe_c4_1x``), ``faster``, ``faster_bf16``, ``mask``,
``mask_bf16`` (box-frame gt masks) and ``htc`` (masks and semantic maps).
Each form trains its own model from the same seed, in turns (port,
autograd, autograd, port):

  * ``port``: ``ops/roi_align._RowGather``, the gather's backward an
    ``index_add_`` into an f32 gradient;
  * ``autograd``: the plain ``table[idx]``, whose backward is autograd's
    ``index_put_`` with ``accumulate``.

Each run prints its steps' host-clock ms one by one (synchronized) and
their median, then ``torch.profiler``'s device time of one more step by
kernel.  RoIAlign's C4 path pools 512 rois an image at 14x14 with 2x2
samples a bin from a 1024-channel map: ~3.2M gathered rows of 1024 floats
a corner; the FPN paths pool 7x7 (box) and 14x14 (mask) from 256 channels.
Run it from the root of the repo: the models and batches come from
``chip_smoke.py`` there.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ioudet_torch.ops import roi_align  # noqa: E402

PORT_ROWS = roi_align._corner_rows


def autograd_rows(table, base, w, yi, xi):
    """The gather as plain advanced indexing (autograd's own backward)."""
    return table[base[:, None, None] + yi * w[:, None, None] + xi]


def models() -> dict:
    """name: (config, train batch or None for ``train_batch``'s, gradient
    names of the step-1 replay)."""
    bf16_faster, bf16_mask = (name for name, _, _ in cs.BF16_CONFIGS)
    masks = cs.mask_train_batch(cs.TWO_STAGE_TRAIN_BATCH, cs.NUM_GTS)
    return {"c4": (cs.C4, None, cs.C4_NAMES),
            "faster": (cs.TWO_STAGE, None, cs.TWO_STAGE_NAMES),
            "faster_bf16": (bf16_faster, None, cs.TWO_STAGE_NAMES),
            "mask": (cs.MASK_RCNN, masks, cs.MASK_NAMES),
            "mask_bf16": (bf16_mask, masks, cs.MASK_NAMES),
            "htc": (cs.HTC, cs.htc_train_batch(cs.TWO_STAGE_TRAIN_BATCH, cs.NUM_GTS),
                    cs.HTC_NAMES)}


def run(model: str, form: str, steps: int, card: str) -> None:
    from ioudet_torch.apis.inference import init_detector
    from ioudet_torch.ops import _build as B, nms_cuda as K

    config, batch, names = models()[model]
    roi_align._corner_rows = PORT_ROWS if form == "port" else autograd_rows
    try:
        cfg = cs.two_stage_cfg(config)
        handle = init_detector(cfg, device="cuda", seed=0)
        _, runner, batch = cs.two_stage_training(B, K, handle, cfg, batch, names,
                                                 f"{model} ({form} gather backward)", "probe", 2)
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            runner.train_step(batch, cs.TWO_STAGE_STEPS)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        print(f"{model} train step batch {cs.TWO_STAGE_TRAIN_BATCH}, {form} gather backward, "
              f"steps 3-{steps + 2} one by one, ms: " + " ".join(f"{ms:.1f}" for ms in times) +
              f"; median {statistics.median(times):.3f} [{card}; {config}, TF32 off]",
              flush=True)
        cs.profile_train_step(runner, batch, cs.TWO_STAGE_STEPS,
                              f"[{model}, {form} gather backward; {card}", steps=1)
    finally:
        roi_align._corner_rows = PORT_ROWS
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--models", nargs="+", default=list(models()), choices=list(models()))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from ioudet_torch.ops import _build as B, nms_cuda as K

    B.build_all([K.LIBRARY])
    cs.set_tf32(False)
    card = cs.card_line()
    for model in args.models:
        for form in ("port", "autograd", "autograd", "port"):
            run(model, form, args.steps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
