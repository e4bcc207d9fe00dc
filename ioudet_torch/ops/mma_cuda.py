"""Tensor-core matrix products: wrappers, plain versions and launch counts.

The CUDA kernels of ``ioudet_torch/csrc/wgmma_kernel.cu`` and
``ioudet_torch/csrc/mma_kernel.cu`` take the place of the three TPU
tensor-core probes of ``ioudet``'s ``tools/``:

  * ``tiled_matmul`` (P3, ``probe_pallas_int8_matmul.pallas_matmul``): one
    product (M, K) x (K, N), int8 -> int32 or bf16 -> f32, any M, N, K, on
    the ``wgmma`` kernel of ``wgmma_kernel.cu``: TMA-fed where the row pitch
    and base addresses are multiples of 16 bytes, fed through the producer's
    registers where they are not (``tiled_route`` decides, from the operands
    alone, before anything is launched).  ``tiled_matmul_mma_sync`` runs the
    ``mma.sync`` kernel of ``mma_kernel.cu`` on any operands;
  * ``tiled_matmul_dequant``: the int8 product with the dequantization in the
    kernel's epilogue, ``cast(float(acc) * scale[n] + bias[n])`` written as
    bf16 or f32; no int32 tensor reaches device memory.  It is the product of
    every quantized convolution (``ioudet_torch/ops/quant.py``);
  * ``chain_matmul`` (P1, ``probe_mxu_rate._call``): ``loop`` dependent
    products with the requant between them, ``y <- clip((y @ b) >> 9, -127,
    127)`` in int8 or ``y <- bf16((y @ b) * scale)`` in bf16, on the
    ``wgmma`` cluster kernel of ``wgmma_kernel.cu`` (``chain_plan`` picks the
    cluster size and slice width from M, K and what the card fits);
    ``chain_matmul_mma_sync`` runs the ``mma.sync`` kernel;
  * ``accum_matmul`` (P2, ``probe_mxu_rate2._call``): ``loop`` independent
    products summed, ``acc += (a XOR int8(i)) @ b`` or
    ``acc += bf16(a + bf16(i)) @ b``, on the ``wgmma`` accumulate kernel of
    ``wgmma_kernel.cu``: each staged slab of K feeds all ``loop`` products,
    A perturbed in registers, K split over a cluster where the tiles alone
    would leave SMs idle (``accum_plan`` decides from the shape and what the
    card fits; ``accum_operands`` pads K to a 16-byte pitch first).
    ``accum_matmul_mma_sync`` runs the ``mma.sync`` kernel of
    ``mma_kernel.cu``.

Every function takes the second operand as ``b_t`` of shape (N, K), K
contiguous, which is what the tensor-core mma wants and what a
convolution weight reshaped to (O, kh*kw*I) is; a (K, N) operand is
transposed once by the caller (``b.t().contiguous()``).

Each wrapper launches its kernel for CUDA tensors and runs its plain torch
version (``*_plain``) only for CPU tensors; any other device raises.  The
plain int8 versions are exact on both devices: int32 ``matmul`` on the CPU and,
on the card, where integer ``matmul`` does not exist, float64 (K * 127^2 <
2^53) cast back.  The plain bf16 versions upcast the operands to f32 and
multiply with TF32 off, rounding where the kernels round.  Launches are
counted per kernel, operand type and epilogue in ``_build.launches``:
``wgmma_matmul_*`` and ``wgmma_dequant_s8`` for the TMA-fed ``wgmma``
kernel, ``wgmma_unaligned_*`` for its form fed through registers,
``wgmma_chain_*`` for the cluster chain, ``wgmma_accum_*`` for the
accumulate kernel, and ``tiled_matmul_*``, ``chain_matmul_*``,
``accum_matmul_*`` for the ``mma.sync`` kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._build import F32, I32, PTR

LIBRARY = _build.KernelLibrary(
    "mma_kernel.cu", (),
    {"ioudet_tiled_matmul": [PTR, PTR, PTR] + [I32] * 7,
     "ioudet_chain_matmul": [PTR, PTR, PTR] + [I32] * 4 + [F32]},
    kernels=("tiled_matmul_s8", "tiled_matmul_bf16", "chain_matmul_s8",
             "chain_matmul_bf16", "accum_matmul_s8", "accum_matmul_bf16"))

WGMMA_LIBRARY = _build.KernelLibrary(
    "wgmma_kernel.cu", ("-ldl",),
    {"ioudet_wgmma_matmul": [PTR, PTR, PTR] + [I32] * 6,
     "ioudet_wgmma_matmul_dequant": [PTR] * 5 + [I32] * 6,
     "ioudet_wgmma_matmul_unaligned": [PTR, PTR, PTR] + [I32] * 6,
     "ioudet_chain_fit": [I32] * 3 + [PTR],
     "ioudet_wgmma_chain": [PTR, PTR, PTR] + [I32] * 5 + [F32],
     "ioudet_accum_fit": [I32] * 3 + [PTR],
     "ioudet_wgmma_accum": [PTR, PTR, PTR] + [I32] * 7},
    kernels=("wgmma_matmul_s8", "wgmma_matmul_bf16", "wgmma_dequant_s8",
             "wgmma_unaligned_s8", "wgmma_unaligned_bf16", "wgmma_chain_s8",
             "wgmma_chain_bf16", "wgmma_accum_s8", "wgmma_accum_bf16"))

H100_SMS = 132                # the default of the pure tile rules below
TILE_M = 128                  # kBM in both sources
TMA_ALIGN = 16                # bytes: TMA's unit for a row pitch and a base address
UNALIGNED_MAX_TILE = 128      # the unaligned wgmma kernel's widest tile
CHAIN_BAND = 16               # kBand of mma_kernel.cu: rows of y one mma.sync chain block owns
CHAIN_MAX_SMEM = 227 * 1024   # dynamic shared memory a block can opt into
WGMMA_BAND = 64               # kBand of wgmma_kernel.cu: rows of y one cluster owns
WGMMA_SLICES = (128, 256)     # columns of y a block of the cluster owns
MAX_CLUSTER = 16              # blocks of a cluster, with the non-portable size allowed
PLAIN_ROWS = 1 << 18          # rows per float64 product of the plain int8 form
SLAB = 128                    # kSlab of wgmma_kernel.cu: bytes of K a stage holds
ACCUM_TILES = (128, 64)       # tile widths of the accumulate kernel, widest first
ACCUM_SPLITS = (1, 2, 4, 8)   # blocks of its clusters, each on a share of K's slabs
ACCUM_MIN_SLABS = 4           # slabs a block keeps at least where K is split


def _suffix(dtype: torch.dtype) -> str:
    return "s8" if dtype == torch.int8 else "bf16"


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.int32 if dtype == torch.int8 else torch.float32


# ---------------------------------------------------------------- plain forms

def tiled_matmul_plain(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (M, K) x b_t (N, K)^T -> (M, N): int8 -> int32 exactly, bf16 -> f32
    (f32 operands, TF32 off)."""
    if a.dtype == torch.int8:
        if a.device.type == "cpu":
            return torch.matmul(a.int(), b_t.int().t())
        b64 = b_t.double().t()
        out = torch.empty(a.shape[0], b_t.shape[0], dtype=torch.int32, device=a.device)
        for r in range(0, a.shape[0], PLAIN_ROWS):   # bounds the float64 copies
            out[r:r + PLAIN_ROWS] = torch.matmul(a[r:r + PLAIN_ROWS].double(), b64)
        return out
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a.float(), b_t.float().t())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def tiled_matmul_dequant_plain(a: torch.Tensor, b_t: torch.Tensor, scale: torch.Tensor,
                               bias: Optional[torch.Tensor] = None,
                               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 a (M, K) x b_t (N, K)^T, dequantized: the exact int32 product
    times ``scale`` (N,) in f32, plus ``bias`` (N,) f32 if given, cast to
    ``out_dtype``: three passes, each rounded on its own."""
    acc = tiled_matmul_plain(a, b_t)
    y = acc * scale                                   # f32: int32 -> f32, times scale
    del acc
    if bias is not None:
        y += bias
    return y.to(out_dtype)


def chain_matmul_plain(a: torch.Tensor, b_t: torch.Tensor, loop: int,
                       scale: float = 0.01) -> torch.Tensor:
    y = a
    for _ in range(loop):
        acc = tiled_matmul_plain(y, b_t)
        if a.dtype == torch.int8:
            y = torch.bitwise_right_shift(acc, 9).clamp(-127, 127).to(torch.int8)
        else:
            y = (acc * scale).to(torch.bfloat16)
    return y.clone() if loop == 0 else y


def _perturbed(a: torch.Tensor, i: int) -> torch.Tensor:
    """The probe's change to ``a`` before product ``i``."""
    if a.dtype == torch.int8:
        return torch.bitwise_xor(a, (i + 128) % 256 - 128)   # int8(i), wrapped
    step = torch.full((), float(i), dtype=torch.bfloat16, device=a.device)
    return a + step   # the f32 sum rounded to bf16


def accum_matmul_plain(a: torch.Tensor, b_t: torch.Tensor, loop: int) -> torch.Tensor:
    acc = torch.zeros(a.shape[0], b_t.shape[0], dtype=_acc_dtype(a.dtype), device=a.device)
    for i in range(loop):
        acc += tiled_matmul_plain(_perturbed(a, i), b_t)
    return acc


# ------------------------------------------------------------------- wrappers

def _check_operands(a: torch.Tensor, b_t: torch.Tensor) -> None:
    _build.check_tensor(a, "a", (torch.int8, torch.bfloat16), 2)
    _build.check_tensor(b_t, "b_t", a.dtype, 2)
    if a.shape[1] != b_t.shape[1]:
        raise ValueError(f"a {tuple(a.shape)} and b_t {tuple(b_t.shape)} must share K "
                         "(b_t is the second operand as (N, K))")
    if a.device != b_t.device:
        raise ValueError(f"a on {a.device}, b_t on {b_t.device}")
    if 0 in a.shape or 0 in b_t.shape:
        raise ValueError(f"empty operand: a {tuple(a.shape)}, b_t {tuple(b_t.shape)}")
    if a.device.type == "cuda" and not (a.is_contiguous() and b_t.is_contiguous()):
        raise ValueError("a and b_t must be contiguous")


def num_sms(device) -> int:
    """Streaming multiprocessors of a CUDA device, from its properties."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def tiled_route(row_bytes: int, a_ptr: int = 0, b_ptr: int = 0) -> str:
    """Which kernel a tiled product of CUDA operands takes: "wgmma" (TMA
    loads) if the row pitch of a and b_t (K in bytes) and both base addresses
    are multiples of 16 bytes, as TMA needs, else "wgmma_unaligned" (the
    same kernel with a producer that loads through registers)."""
    aligned = row_bytes % TMA_ALIGN == 0 and a_ptr % TMA_ALIGN == 0 and b_ptr % TMA_ALIGN == 0
    return "wgmma" if aligned else "wgmma_unaligned"


def tile_width(m: int, n: int, sms: int = H100_SMS) -> int:
    """Width of the wgmma kernel's 128-row output tile: the widest of 256 and
    128 that N fills more than half of and that still gives every SM a tile,
    else 64."""
    for bn in (256, 128):
        if n > bn // 2 and -(-m // TILE_M) * -(-n // bn) >= sms:
            return bn
    return 64


def mma_sync_tile_width(m: int, n: int, sms: int = H100_SMS) -> int:
    """Width of the mma.sync kernels' 128-row tile: 128, or 64 where N is
    narrow or the wide tiles would be fewer than the card's SMs."""
    wide = -(-m // TILE_M) * -(-n // 128)
    return 64 if n <= 64 or wide < sms else 128


def _launch_tiled(name: str, a, b_t, loop: int, accum: int) -> torch.Tensor:
    m, k = a.shape
    n = b_t.shape[0]
    out = torch.empty(m, n, dtype=_acc_dtype(a.dtype), device=a.device)
    _build.launch(LIBRARY.build().ioudet_tiled_matmul, f"{name}_{_suffix(a.dtype)}",
                  a.data_ptr(), b_t.data_ptr(), out.data_ptr(),
                  int(a.dtype == torch.int8), m, n, k,
                  mma_sync_tile_width(m, n, num_sms(a.device)), loop, accum)
    return out


def tiled_matmul_mma_sync(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``tiled_matmul`` through the mma.sync kernel whatever the alignment:
    CUDA operands only."""
    _check_operands(a, b_t)
    if a.device.type != "cuda":
        raise ValueError(f"the mma.sync kernel needs CUDA operands, got {a.device}")
    return _launch_tiled("tiled_matmul", a, b_t, 1, 0)


def tiled_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (M, K) x b_t (N, K)^T -> (M, N); int8 operands give int32, bf16
    operands f32."""
    _check_operands(a, b_t)
    if a.device.type == "cpu":
        return tiled_matmul_plain(a, b_t)
    m, k = a.shape
    n = b_t.shape[0]
    sms = num_sms(a.device)
    out = torch.empty(m, n, dtype=_acc_dtype(a.dtype), device=a.device)
    lib = WGMMA_LIBRARY.build()
    if tiled_route(k * a.element_size(), a.data_ptr(), b_t.data_ptr()) == "wgmma":
        fn, name, bn = lib.ioudet_wgmma_matmul, "wgmma_matmul", tile_width(m, n, sms)
    else:
        fn, name = lib.ioudet_wgmma_matmul_unaligned, "wgmma_unaligned"
        bn = min(tile_width(m, n, sms), UNALIGNED_MAX_TILE)
    _build.launch(fn, f"{name}_{_suffix(a.dtype)}", a.data_ptr(), b_t.data_ptr(),
                  out.data_ptr(), int(a.dtype == torch.int8), m, n, k, bn, sms)
    return out


def tiled_matmul_dequant(a: torch.Tensor, b_t: torch.Tensor, scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 a (M, K) x b_t (N, K)^T -> (M, N) in ``out_dtype`` (bf16 or f32):
    ``cast(float(acc) * scale[n] + bias[n])`` with ``scale`` (N,) f32 and
    ``bias`` (N,) f32 or None, multiply and add rounded separately.  CUDA
    operands need a row pitch and bases that are multiples of 16 bytes (the
    wgmma kernel has the only dequantize epilogue)."""
    _check_operands(a, b_t)
    n = b_t.shape[0]
    if a.dtype != torch.int8:
        raise ValueError(f"the dequantized product takes int8 operands, got {a.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    for name, t in (("scale", scale),) + ((("bias", bias),) if bias is not None else ()):
        _build.check_tensor(t, name, torch.float32, 1)
        if t.shape[0] != n or t.device != a.device:
            raise ValueError(f"{name}: expected ({n},) on {a.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if a.device.type == "cpu":
        return tiled_matmul_dequant_plain(a, b_t, scale, bias, out_dtype)
    m, k = a.shape
    if tiled_route(k, a.data_ptr(), b_t.data_ptr()) != "wgmma":
        raise ValueError(f"K={k} int8 at {a.data_ptr():#x}, {b_t.data_ptr():#x}: the kernel "
                         f"needs a row pitch and bases that are multiples of {TMA_ALIGN} bytes")
    scale = scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    sms = num_sms(a.device)
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    _build.launch(WGMMA_LIBRARY.build().ioudet_wgmma_matmul_dequant, "wgmma_dequant_s8",
                  a.data_ptr(), b_t.data_ptr(), out.data_ptr(), scale.data_ptr(),
                  None if bias is None else bias.data_ptr(),
                  int(out_dtype == torch.bfloat16), m, n, k, tile_width(m, n, sms), sms)
    return out


def accum_operands(a: torch.Tensor, b_t: torch.Tensor) -> tuple:
    """a and b_t as the accumulate kernel takes them: K zero-padded to a row
    pitch that is a multiple of 16 bytes, on fresh 16-byte aligned storage
    (one ``F.pad`` copy each), or the operands themselves where both already
    are so.  A padded column of a becomes ``int8(i)`` or ``bf16(i)`` after
    the perturbation, but meets a zero column of b_t: the sum is unchanged."""
    pad = -a.shape[1] % (TMA_ALIGN // a.element_size())
    if pad == 0 and a.data_ptr() % TMA_ALIGN == 0 and b_t.data_ptr() % TMA_ALIGN == 0:
        return a, b_t
    return torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b_t, (0, pad))


def accum_plan(m: int, n: int, row_bytes: int, sms: int, fits: dict) -> tuple:
    """(tile width, cluster size) of the accumulate kernel for a (m, K) x
    b_t (n, K)^T whose row pitch is ``row_bytes`` (a multiple of 16).

    A cluster of ks blocks owns a 128 x bn tile, each block a ks-th of K's
    slabs, all ``loop`` products of them.  ``fits`` maps (bn, ks) to how
    many such clusters the card runs at once (at most sms / ks); tiles
    beyond that run in further waves.  A block's time goes as bn x its
    slabs, so the plan takes the least waves x bn x ceil(slabs / ks), then
    the widest tile, then the smallest cluster (ties are common: 64 tiles x 2 of 128 columns and 128
    tiles of 64 do the same work a block).  K is split only where each block
    keeps ACCUM_MIN_SLABS slabs, so that the exchange of the partial sums
    stays small against the products: small shapes get ks = 1.  Raises
    ValueError on a bad shape or if nothing fits the card."""
    if m < 1 or n < 1 or row_bytes < 1 or row_bytes % TMA_ALIGN:
        raise ValueError(f"({m}, {n}) with rows of {row_bytes} bytes: the accumulate kernel "
                         f"needs a positive shape and a row pitch that is a multiple of "
                         f"{TMA_ALIGN} bytes")
    kslabs = -(-row_bytes // SLAB)
    options = []
    for bn in ACCUM_TILES:
        tiles = -(-m // TILE_M) * -(-n // bn)
        for ks in ACCUM_SPLITS:
            at_once = min(fits.get((bn, ks), 0), sms // ks)
            if (ks == 1 or kslabs >= ks * ACCUM_MIN_SLABS) and at_once > 0:
                waves = -(-tiles // at_once)
                options.append(((waves * bn * -(-kslabs // ks), -bn, ks), (bn, ks)))
    if not options:
        raise ValueError(f"no cluster of the accumulate kernel fits the card (fits {fits})")
    return min(options)[1]


def accum_sms(m: int, n: int, plan: tuple, fits: dict, sms: int = H100_SMS) -> int:
    """SMs the accumulate kernel's first wave takes under ``plan``."""
    bn, ks = plan
    tiles = -(-m // TILE_M) * -(-n // bn)
    return min(tiles, fits[plan], sms // ks) * ks


_ACCUM_FITS: dict = {}


def accum_fits(device, dtype: torch.dtype) -> dict:
    """(tile width, cluster size) -> clusters of the accumulate kernel the
    device runs at once, asked of the card once per (device, type, option)."""
    lib = WGMMA_LIBRARY.build()
    fits = {}
    for bn in ACCUM_TILES:
        for ks in ACCUM_SPLITS:
            key = (torch.device(device).index, dtype, bn, ks)
            if key not in _ACCUM_FITS:
                count = ctypes.c_int(0)
                err = lib.ioudet_accum_fit(int(dtype == torch.int8), bn, ks,
                                           ctypes.addressof(count), None)
                _ACCUM_FITS[key] = count.value if err == 0 else 0
            fits[(bn, ks)] = _ACCUM_FITS[key]
    return fits


def _check_accum(a: torch.Tensor, b_t: torch.Tensor, loop: int) -> None:
    _check_operands(a, b_t)
    if loop < 1:
        raise ValueError(f"loop must be at least 1, got {loop}")


def accum_matmul(a: torch.Tensor, b_t: torch.Tensor, loop: int) -> torch.Tensor:
    """sum over i < loop of perturbed_i(a) (M, K) x b_t (N, K)^T -> (M, N)
    int32 / f32, every product computed.  CUDA operands go to the wgmma
    accumulate kernel (K padded to a 16-byte pitch where it is not one)."""
    _check_accum(a, b_t, loop)
    if a.device.type == "cpu":
        return accum_matmul_plain(a, b_t, loop)
    m, n = a.shape[0], b_t.shape[0]
    a, b_t = accum_operands(a, b_t)
    k = a.shape[1]
    sms = num_sms(a.device)
    bn, ks = accum_plan(m, n, k * a.element_size(), sms, accum_fits(a.device, a.dtype))
    out = torch.empty(m, n, dtype=_acc_dtype(a.dtype), device=a.device)
    _build.launch(WGMMA_LIBRARY.build().ioudet_wgmma_accum, f"wgmma_accum_{_suffix(a.dtype)}",
                  a.data_ptr(), b_t.data_ptr(), out.data_ptr(), int(a.dtype == torch.int8),
                  m, n, k, loop, bn, ks)
    return out


def accum_matmul_mma_sync(a: torch.Tensor, b_t: torch.Tensor, loop: int) -> torch.Tensor:
    """``accum_matmul`` through the mma.sync kernel of mma_kernel.cu (every
    product streams its tile's rows of A and B again): CUDA operands only."""
    _check_accum(a, b_t, loop)
    if a.device.type != "cuda":
        raise ValueError(f"the mma.sync kernel needs CUDA operands, got {a.device}")
    return _launch_tiled("accum_matmul", a, b_t, loop, 1)


def chain_blocks(m: int) -> int:
    """Blocks (and so SMs at most) a launch of the mma.sync chain kernel uses."""
    return -(-m // CHAIN_BAND)


def chain_options(k: int) -> list:
    """(cluster size, slice width) pairs the wgmma chain kernel can split K
    (== N) into: slices of 128 or 256 columns, at most 16 blocks, largest
    cluster first."""
    return [(cs, k // cs) for cs in range(MAX_CLUSTER, 0, -1)
            if k % cs == 0 and k // cs in WGMMA_SLICES]


def chain_plan(m: int, k: int, fits: dict) -> tuple:
    """(cluster size, slice width) of the wgmma chain kernel for y (m, k).

    ``fits`` maps a cluster size to how many such clusters the card runs at
    once.  The bands of 64 rows (one cluster each) then run in
    ceil(bands / fits) waves, and a block streams its slice of b once a step,
    so the time goes as waves x slice width: the plan takes the least, then
    the fewest waves, then the largest cluster.  Raises ValueError if K has
    no split or no cluster of a split fits."""
    bands = -(-m // WGMMA_BAND)
    options = [(cs, ns) for cs, ns in chain_options(k) if fits.get(cs, 0) > 0]
    if not options:
        raise ValueError(f"K={k}: the wgmma chain kernel needs K = cs x 128 or cs x 256 "
                         f"with cs <= {MAX_CLUSTER} clusters that fit the card "
                         f"(splits {chain_options(k)}, fits {fits})")

    def cost(option):
        waves = -(-bands // fits[option[0]])
        return waves * option[1], waves, -option[0]
    return min(options, key=cost)


_CHAIN_FITS: dict = {}


def chain_fits(device, dtype: torch.dtype, k: int) -> dict:
    """Cluster size -> clusters of the chain kernel the device runs at once,
    for every split of K, asked of the card once per (device, type, split)."""
    lib = WGMMA_LIBRARY.build()
    fits = {}
    for cs, ns in chain_options(k):
        key = (torch.device(device).index, dtype, cs, ns)
        if key not in _CHAIN_FITS:
            count = ctypes.c_int(0)
            err = lib.ioudet_chain_fit(int(dtype == torch.int8), ns, cs,
                                       ctypes.addressof(count), None)
            # a cluster size the card refuses outright is one that does not fit
            _CHAIN_FITS[key] = count.value if err == 0 else 0
        fits[cs] = _CHAIN_FITS[key]
    return fits


def _check_chain(a: torch.Tensor, b_t: torch.Tensor, loop: int) -> None:
    _check_operands(a, b_t)
    if b_t.shape[0] != a.shape[1]:
        raise ValueError(f"b_t must be square to chain, got {tuple(b_t.shape)}")
    if loop < 0:
        raise ValueError(f"loop must not be negative, got {loop}")


def chain_matmul(a: torch.Tensor, b_t: torch.Tensor, loop: int,
                 scale: float = 0.01) -> torch.Tensor:
    """y after ``loop`` steps of y <- requant(y (M, K) x b_t (K, K)^T), y = a
    at the start, in a's type.  ``scale`` is the bf16 form's factor; the int8
    form shifts by 9 and clips to +-127.  CUDA operands go to the wgmma
    cluster kernel, which takes K = cs x 128 or cs x 256 (cs <= 16) and raises
    on any other K."""
    _check_chain(a, b_t, loop)
    if a.device.type == "cpu":
        return chain_matmul_plain(a, b_t, loop, scale)
    m, k = a.shape
    cs, ns = chain_plan(m, k, chain_fits(a.device, a.dtype, k))
    out = torch.empty_like(a)
    _build.launch(WGMMA_LIBRARY.build().ioudet_wgmma_chain, f"wgmma_chain_{_suffix(a.dtype)}",
                  a.data_ptr(), b_t.data_ptr(), out.data_ptr(), int(a.dtype == torch.int8),
                  m, ns, cs, loop, float(scale))
    return out


def chain_matmul_mma_sync(a: torch.Tensor, b_t: torch.Tensor, loop: int,
                          scale: float = 0.01) -> torch.Tensor:
    """``chain_matmul`` through the mma.sync kernel of mma_kernel.cu (bands of
    16 rows, b read from L2 by every block): CUDA operands only, K a multiple
    of 64 bytes."""
    _check_chain(a, b_t, loop)
    if a.device.type != "cuda":
        raise ValueError(f"the mma.sync kernel needs CUDA operands, got {a.device}")
    k = a.shape[1]
    row_bytes = k * a.element_size()
    pitch = row_bytes + (64 - row_bytes % 128) % 128   # chain_pitch in the source
    smem = 2 * CHAIN_BAND * pitch
    if row_bytes % 64 or smem > CHAIN_MAX_SMEM:
        raise ValueError(f"K={k} {a.dtype}: the kernel needs K a multiple of "
                         f"{64 // a.element_size()} and {smem} B of shared memory "
                         f"(limit {CHAIN_MAX_SMEM})")
    out = torch.empty_like(a)
    _build.launch(LIBRARY.build().ioudet_chain_matmul, f"chain_matmul_{_suffix(a.dtype)}",
                  a.data_ptr(), b_t.data_ptr(), out.data_ptr(),
                  int(a.dtype == torch.int8), a.shape[0], k, loop, float(scale))
    return out
