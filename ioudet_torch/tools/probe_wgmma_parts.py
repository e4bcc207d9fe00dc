"""Where the time of the ``wgmma`` kernels goes, on one NVIDIA GPU.

    python -m ioudet_torch.tools.probe_wgmma_parts [--baseline other_version.cu ...]

The tiled kernel of ``ioudet_torch/csrc/wgmma_kernel.cu`` has three parts
that run side by side in a block: the producer's loads (TMA, or through
registers for operands off the 16-byte grid), the consumers' ``wgmma`` steps
and their epilogue.  This probe builds copies of the source with the
epilogue's store, the ``wgmma`` steps or both cut out (by replacing the one
line that calls them; their results are wrong and are not read), and times
every copy beside the whole kernel on the same operands, in turns: the
probe's 4096^3 in int8 and bf16, its unaligned (1024, 1023) x (1023, 1023),
and the dequantized int8 product of the flagship's stem, of layer1's 1x1
convs and of a tower conv at P3.  What a copy without a part still takes is
the floor the other parts set: "loads only" is what the ring, the barriers
and the path from L2 or device memory to shared memory allow.  The
unaligned shapes are also timed the other way they could be served: both
operands copied into rows zero-padded to a 16-byte pitch, then the TMA-fed
kernel ("pad_then_tma"; "pad_only" is the copies alone).

The chain kernel (P1, 64 dependent steps at (512, 2048)) gets its own cuts:
without its ``wgmma`` steps, without the pushes of y's slabs to the peers
through distributed shared memory (and the bytes the stages wait for, and the
pusher's wait for free stages), without
the pusher's wait for its own consumers' next y at each step, and with all
three cut ("b only": the TMA stream of the block's slice of b and the
handshake that frees the stages).  The accumulate kernel (P2, 64 perturbed
products at (512, 2048) x (2048, 2048)) is timed whole, without its
``wgmma`` steps, without its perturbation (each product reuses the copy of
A), without the exchange of the partial sums between the blocks of a
cluster (each block stores its own), and with the loads only (no
``ldmatrix``, products, exchange or stores: the TMA stream of each block's
share of K and the handshake), and whole at every (tile width, cluster
size) the card fits.  The wrapper's plan is also timed in alternating pairs
against ``ACCUM_RIVAL``, the unsplit plan its cost model ties with at the
probe's shape (plan, rival, rival, plan; ``ACCUM_PAIRS`` times), so that a
difference between them can be told from the noise.  ``--baseline`` names other versions of the source with
the same C interface (an earlier commit's, say), which are built and timed in
the same turns under their file names.  The result is one JSON object of times in ms
with the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Sequence

import torch

from ..ops import _build, mma_cuda
from .probe_parts import build_cut_variants, event_ms
from .probe_tensor_cores import card_line

STORE_CALL = ("      store_tile<BN, EPI>(acc, stage_out + warp * kWarpOutBytes, &map_out, out, "
              "scale, bias,\n"
              "                          static_cast<long long>(m0) + warp * 16, n0, M, N, "
              "tma_out != 0, stores);\n")
MMA_LINE = ("        for (int ks = 0; ks < kSlab / 32; ++ks) "
            "wgmma_step(acc, da + 2 * ks, db + 2 * ks);\n")
CHAIN_MMA = ("        for (int kk = 0; kk < kSlab / 32; ++kk) "
             "wgmma_step(acc, da + 2 * kk, db + 2 * kk);\n")
# the pushes, the bytes the stages wait for and the pusher's wait for free
# stages (which, without the pushes to pace the blocks, could miss a phase)
CHAIN_PUSH = ("        mbar_add_tx(bar, kYSlab);   // y's slab, which its owner pushes\n",
              "            bulk_push(yring + x * kYSlab, src, kYSlab, yfull + x * 8, p);\n",
              "          mbar_wait(yvacant + x * 8, (vacant_phase >> x) & 1u);   "
              "// every block's stage x is free\n")
CHAIN_WAIT = ("        if (s > 0) mbar_wait(written, (s - 1) & 1);   "
              "// y of step s is in this block's slice\n")
ACCUM_MMA = ("  for (int ks = 0; ks < kSlab / 32; ++ks) "
             "wgmma_step_rs(acc, p + 4 * ks, db + 2 * ks);\n")
ACCUM_PERTURB = "  perturb_frags<INT8>(p, fa, i);\n"
ACCUM_EXCHANGE = ("      stage_partial(acc, ring_ptr, threadIdx.x);\n",
                  "      if (owner) reduce_partials<INT8>(acc, ring, threadIdx.x, ks);\n")
ACCUM_LDMATRIX = ("        ldmatrix_x4(fa + 4 * k, base + lrow * kSlab + "
                  "(((2 * k + half) ^ (lrow & 7)) << 4));\n")
ACCUM_STORE = ("      store_tile<BN, EPI_RAW>(acc, stage_out + warp * kWarpOutBytes, &map_out, out, "
               "nullptr,\n"
               "                              nullptr, static_cast<long long>(m0) + warp * 16, "
               "n0, M, N,\n"
               "                              tma_out != 0, stores);\n")
CUTS = {"whole": (), "no_store": (STORE_CALL,), "no_mma": (MMA_LINE,),
        "loads_only": (STORE_CALL, MMA_LINE)}
CHAIN_CUTS = {"chain_no_mma": (CHAIN_MMA,), "chain_no_push": CHAIN_PUSH,
              "chain_no_wait": (CHAIN_WAIT,), "chain_b_only": (CHAIN_MMA, *CHAIN_PUSH, CHAIN_WAIT)}
ACCUM_CUTS = {"accum_no_mma": (ACCUM_MMA,), "accum_no_perturb": (ACCUM_PERTURB,),
              "accum_no_exchange": ACCUM_EXCHANGE,
              "accum_loads_only": (ACCUM_MMA, ACCUM_PERTURB, *ACCUM_EXCHANGE, ACCUM_LDMATRIX,
                                   ACCUM_STORE)}
# (name, M, K, N, operand type, dequantize to bf16)
SHAPES = (("4096^3 int8", 4096, 4096, 4096, torch.int8, False),
          ("4096^3 bf16", 4096, 4096, 4096, torch.bfloat16, False),
          ("unaligned int8", 1024, 1023, 1023, torch.int8, False),
          ("unaligned bf16", 1024, 1023, 1023, torch.bfloat16, False),
          ("stem, dequantized", 4472832, 160, 64, torch.int8, True),
          ("layer1 1x1, dequantized", 1118208, 64, 256, torch.int8, True),
          ("tower conv at P3, dequantized", 279552, 2304, 256, torch.int8, True))
REPS = 10
ACCUM_RIVAL = (64, 1)   # (tile width, cluster size): no split of K, 128 tiles
ACCUM_PAIRS = 8
ACCUM_PAIR_REPS = 50


def variants(baselines: Sequence[str] = ()) -> dict:
    """name -> KernelLibrary of the source with that variant's lines cut, and
    of each of the ``baselines`` as it is."""
    cuts = {name: tuple((line, "") for line in lines)
            for name, lines in {**CUTS, **CHAIN_CUTS, **ACCUM_CUTS}.items()}
    return build_cut_variants(mma_cuda.WGMMA_LIBRARY, cuts, baselines, "wgmma_probe")


def main(argv=()) -> int:
    baselines = list(argv[argv.index("--baseline") + 1:]) if "--baseline" in argv else []
    if not torch.cuda.is_available():
        print("probe_wgmma_parts: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    sms = mma_cuda.num_sms(dev)
    libs = variants(baselines)
    stream = _build.PTR(torch.cuda.current_stream().cuda_stream)
    out = {"card": card_line(), "device": torch.cuda.get_device_name(0), "sms": sms}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, m, k, n, dtype, dequant in SHAPES:
        int8 = dtype == torch.int8
        if int8:
            a = torch.randint(-127, 128, (m, k), dtype=dtype, device=dev, generator=gen)
            b_t = torch.randint(-127, 128, (n, k), dtype=dtype, device=dev, generator=gen)
        else:
            a = torch.randn(m, k, device=dev, generator=gen).to(dtype)
            b_t = (torch.randn(n, k, device=dev, generator=gen) * 0.02).to(dtype)
        scale = torch.rand(n, device=dev, generator=gen) * 1e-3
        bias = torch.randn(n, device=dev, generator=gen)
        res = torch.empty(m, n, device=dev, dtype=torch.bfloat16 if dequant else
                          (torch.int32 if int8 else torch.float32))
        bn = mma_cuda.tile_width(m, n, sms)
        aligned = k * a.element_size() % 16 == 0
        if not aligned:
            bn = min(bn, mma_cuda.UNALIGNED_MAX_TILE)

        def call(lib):
            if not aligned:
                err = lib.ioudet_wgmma_matmul_unaligned(a.data_ptr(), b_t.data_ptr(),
                                                        res.data_ptr(), int(int8), m, n, k, bn,
                                                        sms, stream)
            elif dequant:
                err = lib.ioudet_wgmma_matmul_dequant(
                    a.data_ptr(), b_t.data_ptr(), res.data_ptr(), scale.data_ptr(),
                    bias.data_ptr(), 1, m, n, k, bn, sms, stream)
            else:
                err = lib.ioudet_wgmma_matmul(a.data_ptr(), b_t.data_ptr(), res.data_ptr(),
                                              int(int8), m, n, k, bn, sms, stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed: {err}")

        tiled = [v for v in libs if v not in CHAIN_CUTS and v not in ACCUM_CUTS]
        out[name] = dict(in_turns(libs, tiled, lambda lib: call(lib)), tile_width=bn)
        if not aligned:
            out[name].update(padded_parts(libs["whole"].build(), a, b_t, res, sms, stream))
        del a, b_t, res
    out.update(chain_parts(libs, sms, stream, gen, [Path(b).stem for b in baselines]))
    out.update(accum_parts(libs, sms, stream, gen))
    print(json.dumps(out, indent=1))
    return 0


def padded_parts(lib, a: torch.Tensor, b_t: torch.Tensor, res: torch.Tensor, sms: int,
                 stream) -> dict:
    """The other way to serve operands off the 16-byte grid: copy both into
    buffers whose rows are zero-padded to a 16-byte pitch, then run the
    TMA-fed kernel on them (the zero columns add nothing to the product).
    Times the copies alone and copies plus kernel, timed in turns with the
    register-fed kernel's result ``res`` held equal (int8) or within 1e-5 of
    the largest sum of |a||b| (bf16)."""
    m, k = a.shape
    n = b_t.shape[0]
    step = 16 // a.element_size()
    kp = -(-k // step) * step
    int8 = a.dtype == torch.int8
    out = torch.empty_like(res)
    bn = mma_cuda.tile_width(m, n, sms)

    def pad():
        return (torch.nn.functional.pad(a, (0, kp - k)),
                torch.nn.functional.pad(b_t, (0, kp - k)))

    def pad_then_tma():
        ap, bp = pad()
        err = lib.ioudet_wgmma_matmul(ap.data_ptr(), bp.data_ptr(), out.data_ptr(), int(int8),
                                      m, n, kp, bn, sms, stream)
        if err != 0:
            raise RuntimeError(f"pad then TMA: launch failed: {err}")

    pad_then_tma()
    torch.cuda.synchronize()
    diff = float((out.double() - res.double()).abs().max())
    limit = 0.0 if int8 else 1e-5 * float(torch.matmul(a.float().abs(), b_t.float().abs().t()).max())
    if diff > limit:
        raise RuntimeError(f"pad then TMA differs from the register-fed kernel by {diff}")
    times = {"pad_only": [], "pad_then_tma": []}
    for v in ("pad_only", "pad_then_tma", "pad_then_tma", "pad_only"):
        times[v].append(event_ms(pad if v == "pad_only" else pad_then_tma, REPS))
    return dict({v: sum(t) / len(t) for v, t in times.items()}, padded_tile_width=bn)


def in_turns(libs: dict, names, fn) -> dict:
    """fn(library) timed for each of ``names``, forwards then backwards: the
    mean of the two turns of each."""
    times = {v: [] for v in names}
    for v in list(names) + list(names)[::-1]:
        lib = libs[v].build()
        times[v].append(event_ms(lambda: fn(lib), REPS))
    return {v: sum(t) / len(t) for v, t in times.items()}


def chain_parts(libs: dict, sms: int, stream, gen, baselines: Sequence[str] = ()) -> dict:
    """The chain kernel at the probe's (512, 2048), loop 64, whole, with each
    of CHAIN_CUTS and as each of the baselines, in int8 and bf16, at the plan
    the wrapper takes."""
    from .probe_tensor_cores import LOOP, PROBE_K, PROBE_M
    dev = torch.device("cuda")
    out = {}
    names = ["whole"] + list(CHAIN_CUTS) + list(baselines)
    for dtype in (torch.int8, torch.bfloat16):
        int8 = dtype == torch.int8
        if int8:
            a = torch.randint(-127, 128, (PROBE_M, PROBE_K), dtype=dtype, device=dev, generator=gen)
            b_t = torch.randint(-127, 128, (PROBE_K, PROBE_K), dtype=dtype, device=dev,
                                generator=gen)
        else:
            a = torch.randn(PROBE_M, PROBE_K, device=dev, generator=gen).to(dtype)
            b_t = (torch.randn(PROBE_K, PROBE_K, device=dev, generator=gen) * 0.02).to(dtype)
        res = torch.empty_like(a)
        fits = mma_cuda.chain_fits(dev, dtype, PROBE_K)
        cs, ns = mma_cuda.chain_plan(PROBE_M, PROBE_K, fits)

        def call(lib, cs=cs, ns=ns):
            err = lib.ioudet_wgmma_chain(a.data_ptr(), b_t.data_ptr(), res.data_ptr(), int(int8),
                                         PROBE_M, ns, cs, LOOP, 0.01, stream)
            if err != 0:
                raise RuntimeError(f"chain: launch failed: {err}")

        key = f"chain {'int8' if int8 else 'bf16'} ({PROBE_M}, {PROBE_K}) loop {LOOP}"
        whole = libs["whole"].build()
        # every split the card runs, whole, beside the plan's
        plans = {f"{c} x {n}": event_ms(lambda c=c, n=n: call(whole, c, n), REPS)
                 for c, n in mma_cuda.chain_options(PROBE_K) if fits.get(c, 0) > 0}
        out[key] = dict(in_turns(libs, names, call), cluster=cs, slice=ns, plans=plans,
                        fits={str(c): f for c, f in fits.items()}, sms=sms)
        del a, b_t, res
    return out


def accum_parts(libs: dict, sms: int, stream, gen) -> dict:
    """The accumulate kernel at the probe's (512, 2048) x (2048, 2048), loop
    64, whole and with each of ACCUM_CUTS, in int8 and bf16, at the plan the
    wrapper takes; then whole at every plan the card fits, and the plan
    against ACCUM_RIVAL in alternating pairs (``pairs``: the times of each in
    order, and how many pairs the plan won)."""
    from .probe_tensor_cores import LOOP, PROBE_K, PROBE_M, PROBE_N
    dev = torch.device("cuda")
    out = {}
    names = ["whole"] + list(ACCUM_CUTS)
    for dtype in (torch.int8, torch.bfloat16):
        int8 = dtype == torch.int8
        if int8:
            a = torch.randint(-127, 128, (PROBE_M, PROBE_K), dtype=dtype, device=dev, generator=gen)
            b_t = torch.randint(-127, 128, (PROBE_N, PROBE_K), dtype=dtype, device=dev,
                                generator=gen)
        else:
            a = torch.randn(PROBE_M, PROBE_K, device=dev, generator=gen).to(dtype)
            b_t = (torch.randn(PROBE_N, PROBE_K, device=dev, generator=gen) * 0.02).to(dtype)
        res = torch.empty(PROBE_M, PROBE_N, device=dev,
                          dtype=torch.int32 if int8 else torch.float32)
        fits = mma_cuda.accum_fits(dev, dtype)
        plan = mma_cuda.accum_plan(PROBE_M, PROBE_N, PROBE_K * a.element_size(), sms, fits)

        def call(lib, plan=plan):
            err = lib.ioudet_wgmma_accum(a.data_ptr(), b_t.data_ptr(), res.data_ptr(), int(int8),
                                         PROBE_M, PROBE_N, PROBE_K, LOOP, *plan, stream)
            if err != 0:
                raise RuntimeError(f"accumulate: launch failed: {err}")

        key = (f"accum {'int8' if int8 else 'bf16'} ({PROBE_M}, {PROBE_K}) x ({PROBE_K}, "
               f"{PROBE_N}) loop {LOOP}")
        whole = libs["whole"].build()
        plans = {f"{bn} x {ks}": event_ms(lambda p=(bn, ks): call(whole, p), REPS)
                 for (bn, ks), f in fits.items() if f > 0}
        runs = {plan: [], ACCUM_RIVAL: []}
        for _ in range(ACCUM_PAIRS):
            for p in (plan, ACCUM_RIVAL, ACCUM_RIVAL, plan):
                runs[p].append(event_ms(lambda p=p: call(whole, p), ACCUM_PAIR_REPS))
        mine, rival = runs[plan], runs[ACCUM_RIVAL]
        won = sum(mine[j] + mine[j + 1] < rival[j] + rival[j + 1] for j in range(0, len(mine), 2))
        pairs = {f"{bn} x {ks}": t for (bn, ks), t in runs.items()}
        out[key] = dict(in_turns(libs, names, call), tile_width=plan[0], cluster=plan[1],
                        pairs=dict(pairs, plan_won=won, of=ACCUM_PAIRS),
                        sms_used=mma_cuda.accum_sms(PROBE_M, PROBE_N, plan, fits, sms),
                        plans=plans, fits={f"{bn} x {ks}": f for (bn, ks), f in fits.items()})
        del a, b_t, res
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
