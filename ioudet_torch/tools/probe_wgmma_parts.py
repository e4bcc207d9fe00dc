"""Where the time of the ``wgmma`` tiled product goes, on one NVIDIA GPU.

    python -m ioudet_torch.tools.probe_wgmma_parts [--baseline other_version.cu ...]

The kernel of ``ioudet_torch/csrc/wgmma_kernel.cu`` has three parts that run
side by side in a block: the producer's TMA loads, the consumers' ``wgmma``
steps and their epilogue.  This probe builds copies of the source with the
epilogue's store, the ``wgmma`` steps or both cut out (by replacing the one
line that calls them; their results are wrong and are not read), and times
every copy beside the whole kernel on the same operands, in turns: the
probe's 4096^3 in int8 and bf16, and the dequantized int8 product of the
flagship's stem, of layer1's 1x1 convs and of a tower conv at P3.  What a
copy without a part still takes is the floor the other parts set: "loads
only" is what the ring, the barriers and the path from L2 or device memory to
shared memory allow.  ``--baseline`` names other versions of the source with
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
from .probe_tensor_cores import card_line

STORE_CALL = ("      store_tile<BN, EPI>(acc, stage_out + warp * kWarpOutBytes, &map_out, out, "
              "scale, bias,\n"
              "                          static_cast<long long>(m0) + warp * 16, n0, M, N, "
              "tma_out != 0, stores);\n")
MMA_LINE = ("        for (int ks = 0; ks < kSlab / 32; ++ks) "
            "wgmma_step(acc, da + 2 * ks, db + 2 * ks);\n")
CUTS = {"whole": (), "no_store": (STORE_CALL,), "no_mma": (MMA_LINE,),
        "loads_only": (STORE_CALL, MMA_LINE)}
# (name, M, K, N, operand type, dequantize to bf16)
SHAPES = (("4096^3 int8", 4096, 4096, 4096, torch.int8, False),
          ("4096^3 bf16", 4096, 4096, 4096, torch.bfloat16, False),
          ("stem, dequantized", 4472832, 160, 64, torch.int8, True),
          ("layer1 1x1, dequantized", 1118208, 64, 256, torch.int8, True),
          ("tower conv at P3, dequantized", 279552, 2304, 256, torch.int8, True))
REPS = 10


def variants(baselines: Sequence[str] = ()) -> dict:
    """name -> KernelLibrary of the source with that variant's lines cut, and
    of each of the ``baselines`` as it is."""
    source = mma_cuda.WGMMA_LIBRARY.source.read_text()
    texts = {}
    for name, cuts in CUTS.items():
        text = source
        for cut in cuts:
            if text.count(cut) != 1:
                raise RuntimeError(f"{name}: the line to cut is not in the source once:\n{cut}")
            text = text.replace(cut, "")
        texts[name] = text
    for path in baselines:
        texts[Path(path).stem] = Path(path).read_text()
    libs = {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, text in texts.items():
        path = _build.BUILD_DIR / f"wgmma_probe_{name}.cu"
        path.write_text(text)
        libs[name] = _build.KernelLibrary(str(path), mma_cuda.WGMMA_LIBRARY.extra_flags,
                                          mma_cuda.WGMMA_LIBRARY.functions, kernels=())
    _build.build_all(list(libs.values()))
    return libs


def event_ms(fn, reps: int = REPS) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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

        def call(lib):
            if dequant:
                err = lib.ioudet_wgmma_matmul_dequant(
                    a.data_ptr(), b_t.data_ptr(), res.data_ptr(), scale.data_ptr(),
                    bias.data_ptr(), 1, m, n, k, bn, sms, stream)
            else:
                err = lib.ioudet_wgmma_matmul(a.data_ptr(), b_t.data_ptr(), res.data_ptr(),
                                              int(int8), m, n, k, bn, sms, stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed: {err}")

        order = list(libs) + list(libs)[::-1]   # in turns: forwards, then backwards
        times = {v: [] for v in libs}
        for v in order:
            lib = libs[v].build()
            times[v].append(event_ms(lambda: call(lib)))
        out[name] = dict({v: sum(t) / len(t) for v, t in times.items()}, tile_width=bn)
        del a, b_t, res
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
