"""Where the time of the greedy NMS kernels (K1a, K1b) goes, on one NVIDIA GPU.

    python -m ioudet_torch.tools.probe_nms_parts [--baseline other_version.cu ...]

``nms_mask_kernel`` (K1a) and ``nms_reduce_kernel`` (K1b) of
``ioudet_torch/csrc/nms_kernel.cu``.  This probe builds copies of the source
with parts replaced (by text, each line found exactly once) and times every
copy beside the whole kernels, in turns (each version, then again in reverse
order), at N = 2000:

  K1b (the reduce, on the mask words of the whole K1a):
  * ``loads_only``: the walk cut (no row is kept, so nothing is ORed): the
    valid pass, the slab copies, the barriers and the keep row;
  * ``or_only``: the walk cut but every candidate kept: the copies and the
    OR of all of them;
  * ``walk_only``: the slab copies made plain stores of zero and the OR cut:
    the walker keeps every valid row, one dependent step each;
  * ``skeleton``: copies made zero stores, walk and OR cut.
  The walker's latency a step is (walk_only - skeleton) / the valid rows of
  the longest image; K1b's chain floor is that latency times the steps the
  data needs (the kept rows of the longest image, plus one barrier a row
  block).

  K1a (the mask):
  * ``division``: the IEEE f32 quotient against thr in place of the exact
    division-free test (same bits);
  * ``tile_8``, ``tile_16``: tiles of 8 or 16 column blocks (4): two or four
    words a thread (one);
  * ``stores_only``: no IoU (every word 0): the column staging and the
    stores;
  * ``lower_only``: no IoU and only the zero words under the diagonal
    stored.
  K1a's instructions a pair are read from ``cuobjdump -sass``: a copy's
  count less ``stores_only``'s, over the 64 pairs of the unrolled loop (the
  division's slow path, a subroutine, is counted in once); its issue floor
  is the pairs the data needs times that count, over 132 SMs x 4 schedulers
  issuing one warp instruction a cycle at the card's top SM clock.

Each version runs on two data mixes, at batch 16 and batch 1: ``random``
(``chip_smoke.nms_cases(2000, b, seed=7)``'s first case, as phase 5 of
``chip_smoke.py`` times it) and ``flagship`` (the candidates that
``multiclass_nms`` hands ``greedy_keep`` in one ``predict`` of the flagship
R-50-FPN with random weights, its classification bias zeroed as in
``chip_smoke.py`` phase 3).  ``--baseline`` names other versions of the
source with the same C interface (an earlier commit's, say), held to the
plain versions and timed in the same turns under their file names.  The
result is one JSON object of times in ms with the card's name and power
limit.  Run it from the root of the repo: the cases come from
``chip_smoke.py`` there.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, nms_cuda
from .probe_parts import build_cut_variants, event_ms
from .probe_tensor_cores import card_line

N, THR, REPS = 2000, 0.5, 50
SMS, SCHEDULERS = 132, 4

STAGE_LINE = "    if (x < nw) cp_async<V>(buf + r * kWin + x, src + r * words + x);\n"
ZERO_STAGE = ("    if (x < nw) {\n      buf[r * kWin + x] = 0ULL;\n"
              "      if (V == 2) buf[r * kWin + x + 1] = 0ULL;\n    }\n")
LO_LINE = "  const unsigned lo = __brev(walk_half(lo_live, __brev((unsigned)lo_row)));\n"
HI_LINE = "  const unsigned hi = __brev(walk_half(hi_live, hi_word));\n"
NO_WALK = ((LO_LINE, "  const unsigned lo = 0u;\n"), (HI_LINE, "  const unsigned hi = 0u;\n"))
OR_LINE = "    if (bits) {\n"
DIVISION_LINE = "  return (double)inter > mid * (double)denom;\n"
TILE_LINE = "constexpr int kTileCols = 4;        // column blocks a mask tile\n"
IOU_LINE = ("    if (row < n && cb < words && cb >= rb) {"
            "   // uniform within a warp but for row < n\n")
STORE_LINE = "    out[(size_t)r * words + w] = w < wfirst ? 0ULL : tile_words[r][w - wfirst];\n"
# name -> (line, its replacement) pairs
CUTS = {"loads_only": NO_WALK,
        "or_only": ((LO_LINE, "  const unsigned lo = (unsigned)live;\n"),
                    (HI_LINE, "  const unsigned hi = (unsigned)(live >> 32);\n")),
        "walk_only": ((STAGE_LINE, ZERO_STAGE), (OR_LINE, "    if (false) {\n")),
        "skeleton": ((STAGE_LINE, ZERO_STAGE), *NO_WALK, (OR_LINE, "    if (false) {\n")),
        "division": ((DIVISION_LINE, "  return __fdiv_rn(inter, denom) > thr;\n"),),
        "tile_8": ((TILE_LINE, TILE_LINE.replace("= 4;", "= 8;")),),
        "tile_16": ((TILE_LINE, TILE_LINE.replace("= 4;", "= 16;")),),
        "stores_only": ((IOU_LINE, "    if (false) {\n"),),
        "lower_only": ((IOU_LINE, "    if (false) {\n"),
                       (STORE_LINE, "    if (w < wfirst) out[(size_t)r * words + w] = 0ULL;\n"))}
REDUCE_CUTS = ("loads_only", "or_only", "walk_only", "skeleton")
MASK_CUTS = ("division", "tile_8", "tile_16", "stores_only", "lower_only")


def variants(baselines=()) -> dict:
    """name -> KernelLibrary: the whole source, the source with each of CUTS
    made, and each of the ``baselines`` as it is."""
    return build_cut_variants(nms_cuda.LIBRARY, CUTS, baselines, "nms_probe")


def chain_steps(keep: torch.Tensor) -> int:
    """The reduce's dependent steps on this data: the kept rows of the
    longest image, plus one barrier a row block."""
    return int(keep.sum(dim=1).max()) + nms_cuda.num_words(keep.shape[1])


def chain_floor_ms(keep: torch.Tensor, step_ms: float) -> float:
    return chain_steps(keep) * step_ms


def launchers(lib, boxes, valid, words) -> tuple:
    """(mask, reduce) as fn() -> output through ``lib``; reduce on ``words``."""
    b, n, _ = boxes.shape
    mask = torch.empty(b, n, nms_cuda.num_words(n), dtype=torch.int64, device=boxes.device)
    keep = torch.empty(b, n, dtype=torch.bool, device=boxes.device)
    stream = _build.PTR(torch.cuda.current_stream().cuda_stream)

    def check(err):
        if err != 0:
            raise RuntimeError(f"nms probe: launch failed: cudaError {err}")

    def mask_fn():
        check(lib.ioudet_nms_mask(boxes.data_ptr(), mask.data_ptr(), b, n, THR, stream))
        return mask

    def reduce_fn():
        check(lib.ioudet_nms_reduce(words.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                                    b, n, stream))
        return keep

    return mask_fn, reduce_fn


def flagship_candidates(batches) -> dict:
    """batch -> (boxes, valid): what ``multiclass_nms`` hands ``greedy_keep``
    in one ``predict`` of the flagship on seeded canvases."""
    import chip_smoke
    from ioudet_torch.apis.inference import init_detector

    handle = init_detector(chip_smoke.flagship_cfg(), device="cuda", seed=0)
    with torch.no_grad():
        handle.model.bbox_head.retina_cls.bias.zero_()
    rng = np.random.default_rng(0)
    out = {}
    for bsz in batches:
        out[bsz] = chip_smoke.nms_inputs(nms_cuda, handle, chip_smoke.canvases(bsz, rng))
    del handle
    torch.cuda.empty_cache()
    return out


def sass_count(lib: _build.KernelLibrary, kernel: str) -> int:
    """SASS instructions of ``kernel`` in a built library, by cuobjdump."""
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(lib.path())], capture_output=True,
                          text=True, check=True).stdout
    count, inside = 0, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.match(r"\s+/\*[0-9a-f]{4}\*/\s+\S", line):
            count += 1
    return count


def top_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def main(argv=()) -> int:
    baselines = list(argv[argv.index("--baseline") + 1:]) if "--baseline" in argv else []
    if not torch.cuda.is_available():
        print("probe_nms_parts: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke   # the cases, from the script at the repo's root
    built = variants(baselines)
    libs = {name: lib.build() for name, lib in built.items()}
    names = ["whole"] + [Path(p).stem for p in baselines]
    clock = top_sm_clock_hz()
    stores = sass_count(built["stores_only"], "nms_mask_kernel")
    ipp = {name: (sass_count(built[name], "nms_mask_kernel") - stores) / 64
           for name in ("whole", "division")}
    out = {"card": card_line(), "device": torch.cuda.get_device_name(0), "n": N,
           "top_sm_clock_mhz": clock / 1e6, "mask_sass_per_pair": ipp}
    mixes = {}
    for bsz in (16, 1):
        _, b, v = chip_smoke.nms_cases(N, bsz, seed=7)[0]
        mixes[f"random_b{bsz}"] = tuple(torch.from_numpy(x).cuda() for x in (b, v))
    for bsz, (b, v) in flagship_candidates((16, 1)).items():
        mixes[f"flagship_b{bsz}"] = (b, v)
    for mix, (boxes, valid) in mixes.items():
        words = nms_cuda.nms_mask_plain(boxes, THR)
        keep = nms_cuda.nms_reduce_plain(words, valid)
        fns = {name: launchers(lib, boxes, valid, words) for name, lib in libs.items()}
        for name in names + ["division", "tile_8", "tile_16"]:
            got = fns[name][0]().clone(), fns[name][1]().clone()
            torch.cuda.synchronize()
            if not (torch.equal(got[0], words) and torch.equal(got[1], keep)):
                raise RuntimeError(f"{name} ({mix}): not equal to the plain versions")
        twice = fns["whole"][0]().clone(), fns["whole"][1]().clone()
        if not (torch.equal(twice[0], words) and torch.equal(twice[1], keep)):
            raise RuntimeError(f"whole ({mix}): a second run gave other bits")
        order = list(fns)
        times = {name: ([], []) for name in order}
        for name in order + order[::-1]:
            times[name][0].append(event_ms(fns[name][0], REPS))
            times[name][1].append(event_ms(fns[name][1], REPS))
        mean = {name: (sum(m) / len(m), sum(r) / len(r)) for name, (m, r) in times.items()}
        bsz, n = valid.shape
        step_ms = (mean["walk_only"][1] - mean["skeleton"][1]) / int(valid.sum(dim=1).max())
        pairs = bsz * n * (n - 1) / 2
        out[mix] = {
            "batch": bsz, "kept_max": int(keep.sum(dim=1).max()),
            "valid_max": int(valid.sum(dim=1).max()), "chain_steps": chain_steps(keep),
            "walk_step_ms": step_ms, "chain_floor_ms": chain_floor_ms(keep, step_ms),
            "mask_issue_floor_ms": {name: pairs * k / 32 / (SMS * SCHEDULERS * clock) * 1e3
                                    for name, k in ipp.items()},
            "nms_mask_kernel": {name: mean[name][0] for name in names + list(MASK_CUTS)},
            "nms_reduce_kernel": {name: mean[name][1] for name in names + list(REDUCE_CUTS)}}
        del fns, words, keep
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
