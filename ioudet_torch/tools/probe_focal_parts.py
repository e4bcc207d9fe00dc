"""Where the time of the focal kernels goes, on one NVIDIA GPU.

    python -m ioudet_torch.tools.probe_focal_parts [--baseline other_version.cu ...]
    python -m ioudet_torch.tools.probe_focal_parts --dx [--baseline other_version.cu ...]

Both kernels of ``ioudet_torch/csrc/focal_kernel.cu`` stream a level's logits
and run the focal chain on every element.  This probe builds copies of the
source with one part replaced (by text, each line found exactly once) and
times every copy beside the whole kernel at the flagship's P3 level, batch
8, as the permuted NCHW view the heads return, on the same grid.

The sum (K3a, ``focal_sum_kernel``; the default), f32, cuts ``CUTS``:

  * ``loads_only``: the chain replaced by the raw logit, so that what is left
    is the loads, the skip of each position's target and the f32 adds;
  * ``no_double``: each thread's sum of its units kept in f32, not double
    (the block and last-block reductions stay in double);
  * ``no_skip``: the target's element added like the others (a wrong sum);
  * ``no_log1p``: log1p(e) replaced by e (a wrong sum);
  * ``libm_log1p``, ``ieee_div``: the math library's ``log1pf`` and the IEEE
    division in place of the kernel's branch-free forms of them;
  * ``fast_div``, ``fast_exp``: ``__fdividef`` and ``__expf``, the
    approximate forms (sums off by a few ulp an element);

and the whole kernel on each chunk of CHUNKS classes a unit.

The gradient (K3b, ``focal_dx_kernel``; ``--dx``), cuts ``DX_CUTS``:

  * ``loads_stores_only``: the chain replaced by the raw logit, so that what
    is left is the loads, the stores and the patch;
  * ``no_patch``: the targets' elements left at their background value (a
    wrong dx);
  * ``libm_log1p``, ``ieee_div``: as for the sum;
  * ``stream_hints``: the runs loaded and stored with the streaming cache
    hints (``__ldcs``, ``__stcs``) in place of ``__ldg`` and a plain store;
  * ``unroll_2``, ``unroll_8``: the class loop unrolled 2 or 8 times, not 4;

and ``vec_1``, the whole kernel on runs of one position (its plan for
V = 1), and ``copy``, ``Tensor.copy_`` of the logits into a tensor of
their strides (a yardstick of what a read and a write of the level take);
then the five levels P3-P7 (sparse mix, f32), the whole kernel beside the
baselines, and its chunk sweep at each.  The blocks an SM holds are printed
with each plan.

``--baseline`` names other versions of the source (an earlier commit's,
say), built and timed in the same turns under their file names.  In the dx
mode a source without ``ioudet_focal_dx_fit`` is taken to be the earlier
tiled form, whose dx kernel takes tiles of 128 positions and a channel
split (``old_split``, the probe's own copy of that rule); in the sum mode a
baseline must have the sum's unit interface (``ioudet_focal_sum_fit``).  Label mixes: ``sparse``
(1% of (position, anchor) pairs foreground, as a training batch gives) and
``dense`` (every label uniform in 0..C, so 80 of 81 pairs take the general
chain once); the dx mode also times the sparse mix in bf16 and on
contiguous (NHWC) f32 logits, where runs are one position.  The whole
kernel and every baseline are first held to the plain version (sum rtol
1e-6; dx rtol 1e-5 / atol 1e-6 in f32, 2e-2 in bf16).  The result is one
JSON object of times in ms with the card's name and power limit.
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
DIV_LINE = "  return div_unit(x >= 0.0f ? 1.0f : e, 1.0f + e);               // sigmoid(x)\n"
LOG_LINE = ("  return wa * (kGamma2 ? p * p : powf(p, gamma)) * "
            "(fmaxf(x, 0.0f) + log1p_unit(e));\n")
SKIP_LINE = "        if (l != lab[v]) acc[v] += loss;\n"
DX_CHAIN_LINE = ("        dv[v] = scale * background_dx<kGamma2>(xv[v], wa, wag, lv.gamma)"
                 " * wt[v];\n")
DX_LOG_LINE = "  const float bce = fmaxf(x, 0.0f) + log1p_unit(e);\n"
PATCH_LINE = "        from_float(dx_out + off, scale * dx * wt[v]);\n"
LOAD_LINE = "  const W word = __ldg(reinterpret_cast<const W*>(p));\n"
STORE_LINE = "  *reinterpret_cast<W*>(p) = word;\n"
DX_LOOP = ("#pragma unroll 4\n"
           "    for (int c = t.c0; c < t.c1; ++c, p += lv.sc, q += lv.sc) {\n")
IEEE_DIV = ((DIV_LINE, DIV_LINE.replace("div_unit(x >= 0.0f ? 1.0f : e, 1.0f + e)",
                                        "(x >= 0.0f ? 1.0f : e) / (1.0f + e)")),)
# name -> (line, its replacement) pairs
CUTS = {"loads_only": ((CHAIN_LINE, "        const float loss = xv[v];\n"),),
        "no_double": ((SUM_TYPE, SUM_TYPE.replace("double", "float", 1)),),
        "no_skip": ((SKIP_LINE, "        acc[v] += loss;\n"),),
        "no_log1p": ((LOG_LINE, LOG_LINE.replace("log1p_unit(e)", "e")),),
        "libm_log1p": ((LOG_LINE, LOG_LINE.replace("log1p_unit(e)", "log1pf(e)")),),
        "ieee_div": IEEE_DIV,
        "fast_div": ((DIV_LINE, DIV_LINE.replace("div_unit", "__fdividef")),),
        "fast_exp": ((EXP_LINE, EXP_LINE.replace("expf", "__expf")),)}
DX_CUTS = {"loads_stores_only": ((DX_CHAIN_LINE, "        dv[v] = xv[v];\n"),),
           "no_patch": ((PATCH_LINE, ""),),
           "libm_log1p": ((DX_LOG_LINE, DX_LOG_LINE.replace("log1p_unit", "log1pf")),),
           "ieee_div": IEEE_DIV,
           "stream_hints": ((LOAD_LINE, LOAD_LINE.replace("__ldg", "__ldcs")),
                            (STORE_LINE, "  __stcs(reinterpret_cast<W*>(p), word);\n")),
           "unroll_2": ((DX_LOOP, DX_LOOP.replace("unroll 4", "unroll 2")),),
           "unroll_8": ((DX_LOOP, DX_LOOP.replace("unroll 4", "unroll 8")),)}
SHAPE = (8, 104, 168, 9, 80)   # (B, H, W, A, C): P3 of the flagship at batch 8
LEVELS = ((104, 168), (52, 84), (26, 42), (13, 21), (7, 11))   # P3-P7 at 832x1344
GAMMA, ALPHA = 2.0, 0.25
FOREGROUND = 0.01   # share of foreground (position, anchor) pairs in the sparse mix
REPS = 20
CHUNKS = (80, 40, 27, 20, 16, 10, 8)   # classes a unit, for the whole kernel's sweep
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# the C interface of the tiled dx kernel: B H W A C split, strides, gamma alpha
_TILED_DX = ([_build.PTR, _build.PTR, _build.I32] + [_build.PTR] * 3 + [_build.I32] * 6
             + [_build.I64] * 6 + [_build.F32] * 2)


def old_split(dims, channel_stride: int) -> int:
    """Into how many chunks the tiled dx kernel split a level's A*C
    channels: enough blocks of 128 positions for about 8 an SM on 132 SMs,
    at least 8 channels a chunk; 1 for a unit channel stride."""
    b, h, w, a, c = dims
    if channel_stride == 1:
        return 1
    tiles = b * -(-h * w // 128)
    return max(1, min(-(-8 * 132 // max(tiles, 1)), a * c // 8))


def variants(cuts: dict, baselines: Sequence[str] = ()) -> dict:
    """name -> (KernelLibrary, old): the source with each of ``cuts`` made,
    the whole source, and each of the ``baselines`` as it is; ``old`` for a
    source whose dx kernel has the tiled interface."""
    def old(text: str) -> bool:
        return "ioudet_focal_dx_fit" not in text

    def functions(text: str) -> dict:
        if not old(text):
            return focal_cuda.LIBRARY.functions
        return {"ioudet_focal_sum": focal_cuda.LIBRARY.functions["ioudet_focal_sum"],
                "ioudet_focal_dx": _TILED_DX}

    libs = build_cut_variants(focal_cuda.LIBRARY, cuts, baselines, "focal_probe", functions)
    return {name: (lib, old(lib.source.read_text())) for name, lib in libs.items()}


def level_inputs(shape, dense: bool, dtype, gen: torch.Generator,
                 contiguous: bool = False) -> tuple:
    """Seeded logits (sd 3) of ``shape`` as the permuted NCHW view (or a
    contiguous copy), labels and weights (1 where the pair counts, 0 on ~2%
    ignored pairs) as slices of wider rows, like the train step's."""
    b, h, w, a, c = shape
    dev = torch.device("cuda")
    n = h * w * a
    x = (torch.randn(b, a * c, h, w, device=dev, generator=gen) * 3).to(dtype).permute(0, 2, 3, 1)
    labels = torch.randint(0, c + 1, (b, n + 13), device=dev, generator=gen, dtype=torch.int32)
    if not dense:
        keep = torch.rand(b, n + 13, device=dev, generator=gen) < FOREGROUND
        labels = torch.where(keep, labels.clamp(min=1), torch.zeros_like(labels))
    lw = (torch.rand(b, n + 13, device=dev, generator=gen) > 0.02).float()
    return x.contiguous() if contiguous else x, labels[:, 5:5 + n], lw[:, 5:5 + n]


def _dims(x, num_anchors: int) -> tuple:
    b, h, w, ac = x.shape
    return b, h, w, num_anchors, ac // num_anchors


def sum_launcher(lib, x, labels, lw, plan: dict):
    """fn() -> the level's sum through ``lib`` on ``plan``."""
    partials = torch.empty(plan["blocks"], dtype=torch.float64, device=x.device)
    counter = torch.zeros(1, dtype=torch.int32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    stream = _build.PTR(torch.cuda.current_stream().cuda_stream)
    shape_args = (*_dims(x, SHAPE[3]), plan["vec"], plan["chunk"], plan["blocks"])

    def fn():
        counter.zero_()
        err = lib.ioudet_focal_sum(x.data_ptr(), int(x.dtype == torch.bfloat16),
                                   labels.data_ptr(), lw.data_ptr(), partials.data_ptr(),
                                   counter.data_ptr(), out.data_ptr(), *shape_args, *x.stride(),
                                   labels.stride(0), lw.stride(0), GAMMA, ALPHA, stream)
        if err != 0:
            raise RuntimeError(f"focal sum: launch failed: {err}")
        return out

    return fn


def dx_launcher(lib, old: bool, x, labels, lw, plan: dict):
    """fn() -> the level's dx (g = 1) through ``lib``, on ``plan`` or, for
    the tiled interface, on its tiles and ``old_split``."""
    dims = _dims(x, SHAPE[3])
    dx = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
    g = torch.ones((), device=x.device)
    stream = _build.PTR(torch.cuda.current_stream().cuda_stream)
    shape_args = ((*dims, old_split(dims, x.stride(3))) if old
                  else (*dims, plan["vec"], plan["chunk"], plan["blocks"]))

    def fn():
        err = lib.ioudet_focal_dx(g.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
                                  labels.data_ptr(), lw.data_ptr(), dx.data_ptr(), *shape_args,
                                  *x.stride(), labels.stride(0), lw.stride(0), GAMMA, ALPHA,
                                  stream)
        if err != 0:
            raise RuntimeError(f"focal dx: launch failed: {err}")
        return dx

    return fn


def in_turns(fns: dict) -> dict:
    """name -> mean ms of fns[name], timed forward and then in reverse order."""
    times = {v: [] for v in fns}
    for v in list(fns) + list(fns)[::-1]:
        times[v].append(event_ms(fns[v], REPS))
    return {v: sum(t) / len(t) for v, t in times.items()}


def dx_plan(x, vec: int) -> dict:
    """The dx kernel's plan for ``x`` at run length ``vec``."""
    return focal_cuda.launch_plan("dx", x, SHAPE[3], GAMMA, vec)


def bytes_bound_ms(x) -> float:
    """Logits read once, dx written once, labels and weights read once."""
    pairs = x.shape[0] * x.shape[1] * x.shape[2] * SHAPE[3]
    return (2 * x.numel() * x.element_size() + 8 * pairs + 4) / HBM_BYTES_PER_S * 1e3


def probe_sum(libs: dict, baselines: Sequence[str], gen) -> dict:
    out = {"shape": list(SHAPE), "dtype": "float32"}
    for mix in ("sparse", "dense"):
        x, labels, lw = level_inputs(SHAPE, mix == "dense", torch.float32, gen)
        plan = focal_cuda.sum_launch_plan(x, SHAPE[3], GAMMA)
        fns = {name: sum_launcher(lib.build(), x, labels, lw, plan)
               for name, (lib, _) in libs.items()}
        want = float(focal_cuda.focal_level_sum_plain(x, labels, lw, GAMMA, ALPHA, SHAPE[3]))
        for name in ["whole"] + [Path(p).stem for p in baselines]:
            got = float(fns[name]())
            if abs(got - want) > 1e-6 * abs(want):
                raise RuntimeError(f"{name} ({mix}): sum {got} against plain {want}")
        # the whole kernel on every chunk of CHUNKS, each on the blocks the
        # planner gives it
        whole = libs["whole"][0].build()
        units = SHAPE[0] * SHAPE[3] * (SHAPE[1] * SHAPE[2] // plan["vec"])
        chunks = {}
        for chunk in CHUNKS:
            blocks = min(plan["sms"] * plan["resident"],
                         -(-units * -(-SHAPE[4] // chunk) // focal_cuda.SUM_THREADS))
            fn = sum_launcher(whole, x, labels, lw, dict(plan, chunk=chunk, blocks=blocks))
            chunks[str(chunk)] = event_ms(fn, REPS)
        out[mix] = dict(in_turns(fns), plan=plan, chunks=chunks)
        del x, labels, lw, fns
    return out


def probe_dx(libs: dict, baselines: Sequence[str], gen) -> dict:
    checked = ["whole"] + [Path(p).stem for p in baselines]
    out = {"shape": list(SHAPE)}
    for mix, dtype in (("sparse", torch.float32), ("dense", torch.float32),
                       ("sparse_bf16", torch.bfloat16), ("sparse_nhwc", torch.float32)):
        x, labels, lw = level_inputs(SHAPE, mix == "dense", dtype, gen, mix.endswith("nhwc"))
        plan = dx_plan(x, focal_cuda.dx_vector(_dims(x, SHAPE[3]), x.stride(),
                                               x.element_size(), x.data_ptr(), 0))
        fns = {name: dx_launcher(lib.build(), old, x, labels, lw, plan)
               for name, (lib, old) in libs.items()}
        fns["vec_1"] = dx_launcher(libs["whole"][0].build(), False, x, labels, lw,
                                   dx_plan(x, 1))
        copy = torch.empty_like(x)
        fns["copy"] = lambda copy=copy, x=x: copy.copy_(x)
        want = focal_cuda.focal_level_dx_plain(1.0, x, labels, lw, GAMMA, ALPHA, SHAPE[3])
        tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=2e-2, atol=1e-6)
        for name in checked + ["vec_1"]:
            torch.testing.assert_close(fns[name]().float(), want.float(), **tol,
                                       msg=lambda m, name=name: f"{name} ({mix}): {m}")
        del want
        out[mix] = dict(in_turns(fns), plan=plan, vec_1_plan=dx_plan(x, 1),
                        bound_ms=bytes_bound_ms(x))
        del x, labels, lw, fns, copy
    # the five levels at batch 8, sparse, f32: the whole kernel and the baselines
    levels = {}
    for i, (h, w) in enumerate(LEVELS):
        x, labels, lw = level_inputs((SHAPE[0], h, w, *SHAPE[3:]), False, torch.float32, gen)
        plan = dx_plan(x, focal_cuda.dx_vector(_dims(x, SHAPE[3]), x.stride(),
                                               x.element_size(), x.data_ptr(), 0))
        fns = {name: dx_launcher(libs[name][0].build(), libs[name][1], x, labels, lw, plan)
               for name in checked}
        # the whole kernel on every chunk of CHUNKS, each on the blocks the
        # planner gives it
        units = SHAPE[0] * SHAPE[3] * (h * w // plan["vec"])
        chunks = {}
        for chunk in CHUNKS:
            blocks = min(plan["sms"] * plan["resident"],
                         -(-units * -(-SHAPE[4] // chunk) // focal_cuda.SUM_THREADS))
            fn = dx_launcher(libs["whole"][0].build(), False, x, labels, lw,
                             dict(plan, chunk=chunk, blocks=blocks))
            chunks[str(chunk)] = event_ms(fn, REPS)
        levels[f"P{i + 3}"] = dict(in_turns(fns), plan=plan, bound_ms=bytes_bound_ms(x),
                                   chunks=chunks)
    out["levels"] = levels
    out["levels_total"] = {name: sum(lv[name] for lv in levels.values()) for name in checked}
    return out


def main(argv=()) -> int:
    argv = list(argv)
    baselines = argv[argv.index("--baseline") + 1:] if "--baseline" in argv else []
    dx = "--dx" in argv
    baselines = [p for p in baselines if p != "--dx"]
    if not torch.cuda.is_available():
        print("probe_focal_parts: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    libs = variants(DX_CUTS if dx else CUTS, baselines)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card_line(), "device": torch.cuda.get_device_name(0),
           "kernel": "focal_dx_kernel" if dx else "focal_sum_kernel"}
    out.update(probe_dx(libs, baselines, gen) if dx else probe_sum(libs, baselines, gen))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
