"""Where the time of the anchor-assignment kernels (K2a, K2b) goes, on one
NVIDIA GPU.

    python -m ioudet_torch.tools.probe_assign_parts [--baseline other_version.cu ...]

``assign_gtmax_kernel`` and ``assign_targets_kernel`` of
``ioudet_torch/csrc/assign_kernel.cu`` compute an IoU only for the gts that
meet the hull of a warp's valid anchors (64 anchors a warp in pass 1, 32 in
pass 2).  This probe builds copies of the
source with one part replaced (by text, each line found exactly once) and
times every copy beside the whole kernels at the flagship's shape: its
209,538 anchors on a 832x1344 canvas, batch 8, 100 gt slots an image:

  * ``hull_only``: every IoU replaced by +0 (wrong results): what is left is
    the loads, the gt table, the hull tests, the walk over the candidates and
    the stores;
  * ``no_cull``: every valid gt a candidate of every warp: all the IoUs of
    the valid pairs;
  * ``block_64``, ``block_256``: blocks of 64 and 256 threads (128);
  * ``items_1``, ``items_4``: one or four anchors a thread in pass 1 (two),
    so that its warps own 32 or 128 anchors;
  * ``in_order``: blocks started in anchor order, images one after another
    (the kernels start the last anchors, the coarsest levels, first).

``--baseline`` names other versions of the source with the same C interface
(an earlier commit's, say), built and timed in the same turns under their
file names.  Each version is timed on two sets of gts from
``chip_smoke.gt_boxes``: ``culling`` (boxes of 16-600 px inside the canvas,
~60% of the slots valid, as ``chip_smoke.train_batch`` makes them) and
``dense`` (valid gts as many, each covering the canvas but for up to 32 px at
each edge: nothing can be culled).  The whole kernels and every baseline are first held to the plain
versions (bit for bit, dw/dh to 1e-6).  With each set come the pairs that
each pass computes (``assign_cuda.pair_counts``) beside the pairs that
intersect.  The result is one JSON object of times in ms with the card's
name and power limit.  Run it from the root of the repo: the anchors and
gts come from ``chip_smoke.py`` there.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Sequence

import torch

from ..ops import _build, assign_cuda
from .probe_parts import build_cut_variants, event_ms
from .probe_tensor_cores import card_line

BATCH, NUM_GTS = 8, 100
ARGS = (0.5, 0.4, 0.0, 1.0, (0.0,) * 4, (1.0,) * 4)   # the flagship's train_cfg
REPS = 20

BLOCK_LINE = "constexpr int kBlock = 128;           // threads a block\n"
ITEMS_LINE = "constexpr int kItems = 2;             // anchors a thread in pass 1 (pass 2: one)\n"
MEETS_LINE = "    if (g < num_gts && (t.valid[w] >> lane & 1u)) hit = meets(h, t.box[g]);\n"
GTMAX_IOU = "        const float iou = anchor_iou(a[k], area[k], box, area_g);\n"
TARGETS_IOU = "        const float iou = anchor_iou(a, area_a, t.box[g], t.area[g]);\n"
PLACE_LINE = "  return make_int2(blockIdx.x % batch, blocks - 1 - blockIdx.x / batch);\n"
# name -> (line, its replacement) pairs
CUTS = {"hull_only": ((GTMAX_IOU, "        const float iou = 0.0f;\n"),
                      (TARGETS_IOU, "        const float iou = 0.0f;\n")),
        "no_cull": ((MEETS_LINE, MEETS_LINE.replace("meets(h, t.box[g])", "true")),),
        "block_64": ((BLOCK_LINE, BLOCK_LINE.replace("128", "64")),),
        "block_256": ((BLOCK_LINE, BLOCK_LINE.replace("128", "256")),),
        "items_1": ((ITEMS_LINE, ITEMS_LINE.replace("= 2;", "= 1;")),),
        "items_4": ((ITEMS_LINE, ITEMS_LINE.replace("= 2;", "= 4;")),),
        "in_order": ((PLACE_LINE, PLACE_LINE.replace("blocks - 1 - blockIdx.x", "blockIdx.x")),)}


def variants(baselines: Sequence[str] = ()) -> dict:
    """name -> KernelLibrary: the whole source, the source with each of CUTS
    made, and each of the ``baselines`` as it is."""
    return build_cut_variants(assign_cuda.LIBRARY, CUTS, baselines, "assign_probe")


def launchers(lib, anchors, valid, table, gtmax) -> tuple:
    """(pass 1, pass 2) as fn() -> outputs through ``lib``; pass 2 on the
    given gtmax."""
    b, n = valid.shape
    g = table.shape[1]
    dev = anchors.device
    out1 = torch.empty(b, g, dtype=torch.float32, device=dev)
    outs = (torch.empty(b, n, dtype=torch.int32, device=dev),
            *(torch.empty(b, n, dtype=torch.float32, device=dev) for _ in range(2)),
            *(torch.empty(b, n, 4, dtype=torch.float32, device=dev) for _ in range(2)))
    pos_iou, neg_iou, min_pos, pos_weight, means, stds = ARGS
    stream = _build.PTR(torch.cuda.current_stream().cuda_stream)

    def check(err):
        if err != 0:
            raise RuntimeError(f"assignment: launch failed: {err}")

    def gtmax_fn():
        out1.fill_(-2.0)
        check(lib.ioudet_assign_gtmax(anchors.data_ptr(), valid.data_ptr(), table.data_ptr(),
                                      out1.data_ptr(), b, n, g, stream))
        return out1

    def targets_fn():
        check(lib.ioudet_assign_targets(anchors.data_ptr(), valid.data_ptr(), table.data_ptr(),
                                        gtmax.data_ptr(), *(o.data_ptr() for o in outs), b, n, g,
                                        pos_iou, neg_iou, min_pos, pos_weight, *means, *stds,
                                        stream))
        return outs

    return gtmax_fn, targets_fn


def check_outputs(name: str, mix: str, got_max, got, want_max, want) -> None:
    exact = torch.equal(got_max, want_max) and all(
        torch.equal(o, q) for o, q in zip(got[:3] + got[4:], want[:3] + want[4:]))
    exact = exact and torch.equal(got[3][..., :2], want[3][..., :2])
    dwh = float((got[3][..., 2:] - want[3][..., 2:]).abs().max())
    if not (exact and dwh <= 1e-6):
        raise RuntimeError(f"{name} ({mix}): not equal to the plain versions (dw/dh {dwh:.1e})")


def main(argv=()) -> int:
    baselines = list(argv[argv.index("--baseline") + 1:]) if "--baseline" in argv else []
    if not torch.cuda.is_available():
        print("probe_assign_parts: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke   # the flagship's anchors and the gts, from the script at the repo's root
    libs = {name: lib.build() for name, lib in variants(baselines).items()}
    dev = torch.device("cuda")
    anchors = chip_smoke.flagship_anchors().to(dev).contiguous()
    valid = torch.ones(BATCH, anchors.shape[0], dtype=torch.bool, device=dev)
    out = {"card": card_line(), "device": torch.cuda.get_device_name(0),
           "shape": [BATCH, anchors.shape[0], NUM_GTS]}
    for mix in ("culling", "dense"):
        boxes, gvalid, labels = (torch.from_numpy(x).to(dev)
                                 for x in chip_smoke.gt_boxes(BATCH, NUM_GTS, mix == "dense"))
        table = assign_cuda.gt_table(boxes, labels, gvalid)
        want_max = assign_cuda.assign_gtmax_plain(anchors, valid, table)
        want = assign_cuda.assign_targets_plain(anchors, valid, table, want_max, *ARGS)
        fns = {name: launchers(lib, anchors, valid, table, want_max) for name, lib in libs.items()}
        for name in ["whole"] + [Path(p).stem for p in baselines]:
            got_max = fns[name][0]().clone()
            check_outputs(name, mix, got_max, [o.clone() for o in fns[name][1]()], want_max, want)
        times = {v: ([], []) for v in fns}
        for v in list(fns) + list(fns)[::-1]:
            for k in range(2):
                times[v][k].append(event_ms(fns[v][k], REPS))
        out[mix] = {"pairs": assign_cuda.pair_counts(anchors, valid, table, want_max),
                    **{v: {"gtmax": sum(t1) / len(t1), "targets": sum(t2) / len(t2)}
                       for v, (t1, t2) in times.items()}}
        del fns, want, want_max
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
