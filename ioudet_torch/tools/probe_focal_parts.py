"""Where the time of the focal sum kernel (K3a) goes, on one NVIDIA GPU.

    python -m ioudet_torch.tools.probe_focal_parts [--baseline other_version.cu ...]

``focal_sum_kernel`` of ``ioudet_torch/csrc/focal_kernel.cu`` streams a
level's logits once and runs the focal chain on every element.  This probe
builds copies of the source with one part replaced (by text, each line found
exactly once) and times every copy beside the whole kernel at the flagship's
P3 level, batch 8, f32, as the permuted NCHW view the heads return, on the
same grid:

  * ``loads_only``: the chain replaced by the raw logit, so that what is left
    is the loads, the skip of each position's target and the f32 adds;
  * ``no_double``: each thread's sum of its units kept in f32, not double
    (the block and last-block reductions stay in double);
  * ``no_skip``: the target's element added like the others (a wrong sum);
  * ``no_log1p``: log1p(e) replaced by e (a wrong sum);
  * ``libm_log1p``, ``ieee_div``: the math library's ``log1pf`` and the IEEE
    division in place of the kernel's branch-free forms of them;
  * ``fast_div``, ``fast_exp``: ``__fdividef`` and ``__expf``, the
    approximate forms (sums off by a few ulp an element).

``--baseline`` names other versions of the source (an earlier commit's,
say), built and timed in the same turns under their file names; a source
without ``ioudet_focal_sum_fit`` is taken to be the form whose sum kernel
takes the dx kernel's tiles and channel split.  Each version is timed on two
label mixes: ``sparse`` (1% of (position, anchor) pairs foreground, as a
training batch gives) and ``dense`` (every label uniform in 0..C, so 80 of
81 pairs take the general chain once).  The whole kernel and every baseline
are first held to the plain version (rtol 1e-6).  The whole kernel is also
timed on each chunk of CHUNKS classes a unit.  The result is one JSON
object of times in ms with the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Sequence

import torch

from ..ops import _build, focal_cuda
from .probe_parts import build_cut_variants, event_ms
from .probe_tensor_cores import card_line

CHAIN_LINE = "        const float loss = background_loss<kGamma2>(xv[v], wa, lv.gamma);\n"
SUM_TYPE = "using Sum = double;   // a thread's sum of its units' weighted terms\n"
EXP_LINE = "  const float e = expf(-fabsf(x));                               // in [0, 1]\n"
DIV_LINE = "  const float p = div_unit(x >= 0.0f ? 1.0f : e, 1.0f + e);      // sigmoid(x)\n"
LOG_LINE = ("  return wa * (kGamma2 ? p * p : powf(p, gamma)) * "
            "(fmaxf(x, 0.0f) + log1p_unit(e));\n")
SKIP_LINE = "        if (l != lab[v]) acc[v] += loss;\n"
# name -> (line, its replacement) pairs
CUTS = {"loads_only": ((CHAIN_LINE, "        const float loss = xv[v];\n"),),
        "no_double": ((SUM_TYPE, SUM_TYPE.replace("double", "float", 1)),),
        "no_skip": ((SKIP_LINE, "        acc[v] += loss;\n"),),
        "no_log1p": ((LOG_LINE, LOG_LINE.replace("log1p_unit(e)", "e")),),
        "libm_log1p": ((LOG_LINE, LOG_LINE.replace("log1p_unit(e)", "log1pf(e)")),),
        "ieee_div": ((DIV_LINE, DIV_LINE.replace("div_unit(x >= 0.0f ? 1.0f : e, 1.0f + e)",
                                                 "(x >= 0.0f ? 1.0f : e) / (1.0f + e)")),),
        "fast_div": ((DIV_LINE, DIV_LINE.replace("div_unit", "__fdividef")),),
        "fast_exp": ((EXP_LINE, EXP_LINE.replace("expf", "__expf")),)}
SHAPE = (8, 104, 168, 9, 80)   # (B, H, W, A, C): P3 of the flagship at batch 8
GAMMA, ALPHA = 2.0, 0.25
FOREGROUND = 0.01   # share of foreground (position, anchor) pairs in the sparse mix
REPS = 20
CHUNKS = (80, 40, 27, 20, 16, 10, 8)   # classes a unit, for the whole kernel's sweep
# the C interface of a source whose sum kernel takes the dx kernel's tiles
_TILED_SUM = {"ioudet_focal_sum": [_build.PTR, _build.I32] + [_build.PTR] * 5 + [_build.I32] * 6
              + [_build.I64] * 6 + [_build.F32] * 2}


def variants(baselines: Sequence[str] = ()) -> dict:
    """name -> (KernelLibrary, tiled): the source with each of CUTS made, the
    whole source, and each of the ``baselines`` as it is; ``tiled`` for a
    source of the earlier interface."""
    def tiled(text: str) -> bool:
        return "ioudet_focal_sum_fit" not in text

    libs = build_cut_variants(
        focal_cuda.LIBRARY, CUTS, baselines, "focal_probe",
        lambda text: _TILED_SUM if tiled(text) else focal_cuda.LIBRARY.functions)
    return {name: (lib, tiled(lib.source.read_text())) for name, lib in libs.items()}


def level_inputs(dense: bool, gen: torch.Generator) -> tuple:
    """Seeded P3 logits (sd 3) as the permuted NCHW view, labels and weights
    (1 where the pair counts, 0 on ~2% ignored pairs) as slices of wider
    rows, like the train step's."""
    b, h, w, a, c = SHAPE
    dev = torch.device("cuda")
    n = h * w * a
    x = (torch.randn(b, a * c, h, w, device=dev, generator=gen) * 3).permute(0, 2, 3, 1)
    labels = torch.randint(0, c + 1, (b, n + 13), device=dev, generator=gen, dtype=torch.int32)
    if not dense:
        keep = torch.rand(b, n + 13, device=dev, generator=gen) < FOREGROUND
        labels = torch.where(keep, labels.clamp(min=1), torch.zeros_like(labels))
    lw = (torch.rand(b, n + 13, device=dev, generator=gen) > 0.02).float()
    return x, labels[:, 5:5 + n], lw[:, 5:5 + n]


def launcher(lib, tiled: bool, x, labels, lw, plan: dict):
    """fn() -> the level's sum through ``lib``, on the wrapper's plan (or, for
    the earlier interface, on its tiles and channel split)."""
    b, h, w, a, c = SHAPE
    dims = (b, h, w, a, c)
    if tiled:
        split = focal_cuda.channel_split(dims, x.stride(3))
        blocks = b * -(-h * w // focal_cuda.TILE) * split
        shape_args = (*dims, split)
    else:
        blocks = plan["blocks"]
        shape_args = (*dims, plan["vec"], plan["chunk"], blocks)
    partials = torch.empty(blocks, dtype=torch.float64, device=x.device)
    counter = torch.zeros(1, dtype=torch.int32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    stream = _build.PTR(torch.cuda.current_stream().cuda_stream)

    def fn():
        counter.zero_()
        err = lib.ioudet_focal_sum(x.data_ptr(), 0, labels.data_ptr(), lw.data_ptr(),
                                   partials.data_ptr(), counter.data_ptr(), out.data_ptr(),
                                   *shape_args, *x.stride(), labels.stride(0), lw.stride(0),
                                   GAMMA, ALPHA, stream)
        if err != 0:
            raise RuntimeError(f"focal sum: launch failed: {err}")
        return out

    return fn


def main(argv=()) -> int:
    baselines = list(argv[argv.index("--baseline") + 1:]) if "--baseline" in argv else []
    if not torch.cuda.is_available():
        print("probe_focal_parts: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    libs = variants(baselines)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card_line(), "device": torch.cuda.get_device_name(0),
           "shape": list(SHAPE), "dtype": "float32"}
    for mix in ("sparse", "dense"):
        x, labels, lw = level_inputs(mix == "dense", gen)
        plan = focal_cuda.sum_launch_plan(x, SHAPE[3], GAMMA)
        fns = {name: launcher(lib.build(), tiled, x, labels, lw, plan)
               for name, (lib, tiled) in libs.items()}
        want = float(focal_cuda.focal_level_sum_plain(x, labels, lw, GAMMA, ALPHA, SHAPE[3]))
        for name in ["whole"] + [Path(p).stem for p in baselines]:
            got = float(fns[name]())
            if abs(got - want) > 1e-6 * abs(want):
                raise RuntimeError(f"{name} ({mix}): sum {got} against plain {want}")
        times = {v: [] for v in fns}
        for v in list(fns) + list(fns)[::-1]:
            times[v].append(event_ms(fns[v], REPS))
        # the whole kernel on every chunk of CHUNKS, each on the blocks the
        # planner gives it
        whole = libs["whole"][0].build()
        units = SHAPE[0] * SHAPE[3] * (SHAPE[1] * SHAPE[2] // plan["vec"])
        chunks = {}
        for chunk in CHUNKS:
            blocks = min(plan["sms"] * plan["resident"],
                         -(-units * -(-SHAPE[4] // chunk) // focal_cuda.SUM_THREADS))
            fn = launcher(whole, False, x, labels, lw, dict(plan, chunk=chunk, blocks=blocks))
            chunks[str(chunk)] = event_ms(fn, REPS)
        out[mix] = dict({v: sum(t) / len(t) for v, t in times.items()}, plan=plan, chunks=chunks)
        del x, labels, lw, fns
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
