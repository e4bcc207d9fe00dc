"""Tensor-core rate probes on one NVIDIA GPU (counterpart of ``ioudet``'s
``tools/probe_mxu_rate.py``, ``probe_mxu_rate2.py`` and
``probe_pallas_int8_matmul.py``, at their shapes).

    python -m ioudet_torch.tools.probe_tensor_cores

Four questions, each asked in int8 (-> int32) and in bf16 (-> f32) of the
hand-written ``wgmma`` kernels of ``ioudet_torch/csrc/wgmma_kernel.cu`` (the
``mma.sync`` kernels of ``ioudet_torch/csrc/mma_kernel.cu`` that they
replaced are not launched here):

  * ``chain``: 64 dependent products (512, 2048) x (2048, 2048) with the
    requant inside the kernel, 8 kernels chained: the rate of a latency
    chain that never leaves fast memory.  It runs on the ``wgmma`` cluster
    kernel: a cluster a band of 64 rows, its blocks on slices of the columns,
    y passed between them through distributed shared memory;
  * ``accum``: 64 independent products of that shape summed in the kernel,
    8 kernels: the sustainable rate.  It runs on the ``wgmma`` accumulate
    kernel: each staged slab of K feeds all 64 products, A perturbed in
    registers, K split over clusters of blocks that add their partial sums
    through distributed shared memory;
  * ``tiled``: one 4096^3 product, 16 chained through a requantization in
    plain torch (``// 512`` and clip for int8, ``* 0.01`` for bf16), which
    is inside the timed region as it is in ``ioudet``'s program.  Its row
    pitch is a multiple of 16 bytes, so it runs on the ``wgmma`` kernel;
  * ``unaligned``: the same program on (1024, 1023) x (1023, 1023), 4
    chained: a row pitch that TMA does not take, so the product runs on the
    ``wgmma`` kernel whose producer loads through registers: what an
    unaligned operand costs.

Each is timed with CUDA events over 4 repeats after a warm-up, on fresh
seeded inputs; the result is one JSON object of rates in T(FL)OP/s (2 M K N
operations a product) with the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops import mma_cuda

PROBE_M, PROBE_K, PROBE_N = 512, 2048, 2048
LOOP = 64
KERNEL_REPEAT = 8
TILED = 4096
TILED_REPEAT = 16
UNALIGNED_MKN = (1024, 1023, 1023)
UNALIGNED_REPEAT = 4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def event_ms(fn, inputs) -> float:
    """Median over the inputs of the time of fn(x) by CUDA events, after one
    warm-up call."""
    fn(inputs[-1])
    torch.cuda.synchronize()
    times = []
    for x in inputs:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def operands(m: int, k: int, n: int, device, seed: int = 0):
    """Four (m, k) inputs and the (n, k) second operand, as the probes make
    them: int8 and bf16 forms of the same seeded normal draws."""
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(device)
          for _ in range(4)]
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(device)
    w_t = w.t().contiguous()   # (n, k), K contiguous: transposed once, outside the timing
    wq = (w_t / w_t.abs().max() * 127).round().clamp(-127, 127).to(torch.int8)
    wb = (w_t * 0.02).to(torch.bfloat16)
    xq = [x.round().clamp(-127, 127).to(torch.int8) for x in xs]
    xb = [x.to(torch.bfloat16) for x in xs]
    return xq, xb, wq, wb


def chain_program(w_t):
    def run(y):
        for _ in range(KERNEL_REPEAT):
            y = mma_cuda.chain_matmul(y, w_t, LOOP, 0.01)
        return y
    return run


def accum_program(w_t):
    def run(a):
        total = torch.zeros((), dtype=torch.float32, device=a.device)
        for r in range(KERNEL_REPEAT):
            y = mma_cuda.accum_matmul(mma_cuda._perturbed(a, r), w_t, LOOP)
            total = total + y[0, 0].float() * 1e-30
        return total
    return run


def tiled_program(w_t, repeat=TILED_REPEAT):
    def run(y):
        for _ in range(repeat):
            acc = mma_cuda.tiled_matmul(y, w_t)
            if y.dtype == torch.int8:
                y = (acc // 512).clamp(-127, 127).to(torch.int8)
            else:
                y = (acc * 0.01).to(torch.bfloat16)
        return y
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_tensor_cores: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    xq, xb, wq, wb = operands(PROBE_M, PROBE_K, PROBE_N, dev)
    cs, ns = mma_cuda.chain_plan(PROBE_M, PROBE_K,
                                 mma_cuda.chain_fits(dev, torch.int8, PROBE_K))
    out = {"card": card_line(), "device": torch.cuda.get_device_name(0),
           "chain_clusters": -(-PROBE_M // mma_cuda.WGMMA_BAND), "chain_cluster_size": cs,
           "chain_slice": ns}
    ops = 2 * PROBE_M * PROBE_K * PROBE_N * LOOP * KERNEL_REPEAT
    for name, program in (("chain", chain_program), ("accum", accum_program)):
        for tag, xs, w_t in (("bf16", xb, wb), ("int8", xq, wq)):
            out[f"{name}_{tag}_tops"] = ops / event_ms(program(w_t), xs) / 1e9
        out[f"{name}_int8_speedup"] = out[f"{name}_int8_tops"] / out[f"{name}_bf16_tops"]
    del xq, xb, wq, wb
    xq, xb, wq, wb = operands(TILED, TILED, TILED, dev, seed=1)
    ops = 2 * TILED ** 3 * TILED_REPEAT
    for tag, xs, w_t in (("bf16", xb, wb), ("int8", xq, wq)):
        out[f"tiled_{tag}_tops"] = ops / event_ms(tiled_program(w_t), xs) / 1e9
    out["tiled_int8_speedup"] = out["tiled_int8_tops"] / out["tiled_bf16_tops"]
    del xq, xb, wq, wb
    um, uk, un = UNALIGNED_MKN
    xq, xb, wq, wb = operands(um, uk, un, dev, seed=2)
    ops = 2 * um * uk * un * UNALIGNED_REPEAT
    for tag, xs, w_t in (("bf16", xb, wb), ("int8", xq, wq)):
        out[f"unaligned_{tag}_tops"] = \
            ops / event_ms(tiled_program(w_t, UNALIGNED_REPEAT), xs) / 1e9
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
