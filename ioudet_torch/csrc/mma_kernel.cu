// Tensor-core matrix products for Hopper (sm_90a), written with warp-level
// mma.sync operations, behind a plain C interface loaded with ctypes by
// ioudet_torch/ops/mma_cuda.py.  Built there with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
//
// Each kernel comes in two forms: int8 x int8 -> int32
// (mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32) and bf16 x bf16 -> f32
// (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32).  Both forms
// consume 32 bytes of K per step and lay their A, B and C fragments out the
// same way when K is counted in bytes, so one template serves both: the code
// below measures K in bytes and only the mma form and the accumulator
// type differ.  The second operand is always given as (N, K) with K
// contiguous ("col" for the mma): ldmatrix.trans moves 16-bit
// elements only, so an int8 (K, N) operand could not be transposed on the
// way in.  A convolution's weight reshaped to (O, kh*kw*I) has that layout
// already.
//
// tiled_kernel<.., ACCUM=false>  replaces pallas_matmul / _mm_kernel of
//   tools/probe_pallas_int8_matmul.py (P3): one product (M, K) x (K, N) for
//   any M, N, K.  Its int8 form carries every quantized convolution of the
//   serving path (ioudet_torch/ops/quant.py).
//   Bound: operations for the probe's 4096^3 (137 GOP against 50 MB of
//   operands: far above the card's 295 op/byte line); bytes for most
//   convolution shapes, where N is 64..256 and the int32 output is four times
//   the size of an int8 operand row.  Design: a block owns a 128 x 128 (or
//   128 x 64 for narrow N) output tile, 8 warps of 64 x 32 (32 x 32)
//   accumulators in registers; 64-byte slabs of A and B go through a
//   two-stage cp.async ring in shared memory, from which a lane takes its
//   fragments of two mma steps with one conflict-free 16-byte load (see
//   mma_first); blocks that share rows of A are neighbours in the grid, so the
//   large operand is read from device memory once and the small one stays in
//   L2.  Ragged M and N are masked, K is
//   zero-filled to the slab; a row pitch that is not a multiple of 16 bytes
//   takes a slow byte-wise staging path.
//   wgmma_kernel.cu holds the wgmma version of this product, which now takes
//   every operand of the main paths: TMA-fed where the row pitch and bases
//   are multiples of 16 bytes, fed through the producer warpgroup's
//   registers (aligned words shifted into place) where they are not.  This
//   kernel stays reachable through mma_cuda.tiled_matmul_mma_sync, checked
//   and timed beside the wgmma one.
//
// tiled_kernel<.., ACCUM=true>  replaces _call / _int8_kernel, _bf16_kernel of
//   tools/probe_mxu_rate2.py (P2): `loop` independent products summed,
//   acc += (a XOR int8(i)) @ b  or  acc += bf16(a + bf16(i)) @ b.
//   Bound: operations (loop x the product over the same 3-7 MB of operands).
//   Design: the tile's accumulators stay in registers over all `loop`
//   products, every one of which is executed; the change to A is applied once
//   per element while the slab is staged (A goes through registers here, B
//   through cp.async), so it is off the tensor cores' path as in the TPU
//   kernel.  At 512 x 2048 outputs the 128 x 64 tile gives 128 blocks for 132
//   SMs.  Every product streams the tile's rows of A and B from the L2 again.
//   accum_wgmma_kernel of wgmma_kernel.cu replaced it on the main paths (each
//   staged slab feeds all `loop` products, A perturbed in registers for
//   register-A wgmma, K split over a cluster); this kernel stays reachable
//   through mma_cuda.accum_matmul_mma_sync, checked and timed beside it.
//
// chain_kernel  replaces _call / _int8_kernel, _bf16_kernel of
//   tools/probe_mxu_rate.py (P1): `loop` dependent products with the requant
//   between them, y <- clip((y @ b) >> 9, -127, 127) or
//   y <- bf16((y @ b) * scale); needs N == K.
//   Bound: operations by the count, but each step depends on the one before,
//   so what limits it is the latency of a step and the L2's rate.  Design:
//   rows of y do not depend on each other, so a block owns a band of 16 rows
//   and keeps two copies of it (this step's and the next one's) in shared
//   memory for all `loop` steps; b (4-8 MB) is read from the L2, which holds
//   it whole, straight into fragments, 16 bytes a lane (whole sectors, no
//   reliance on L1): with one 16-row tile a block uses each element of b once
//   a step, so staging it in shared memory would gain nothing.  Nothing goes
//   to device memory inside the loop, which is the point of the TPU kernel.
//   The requant runs on the accumulators between steps.  A launch has
//   ceil(M / 16) blocks: 32 of the 132 SMs at the probe's 512 rows, each
//   reading all of b from the L2 at every step.  chain_wgmma_kernel of
//   wgmma_kernel.cu replaced it on the main paths (64-row bands on clusters
//   whose blocks own slices of b's rows and pass y through distributed
//   shared memory); this kernel stays reachable through
//   mma_cuda.chain_matmul_mma_sync, checked and timed beside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kBM = 128;             // rows of a block's output tile
constexpr int kSlab = 64;            // bytes of K staged at a time: two mma steps
constexpr int kPitch = kSlab;        // shared-memory row pitch: the 16-byte
                                     // fragment loads of 8 neighbouring lanes
                                     // (2 rows x 4 lanes) cover 128 contiguous
                                     // bytes, so they are conflict-free unpadded
constexpr int kBand = 16;            // rows of y a chain block owns
constexpr int kChunk = 64;           // columns a chain warp accumulates at a time

template <typename AccT> struct Elem;
template <> struct Elem<int> { static constexpr int size = 1; };     // int8
template <> struct Elem<float> { static constexpr int size = 2; };   // bf16

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments.  An mma gives lane (g, t) = (lane / 4, lane % 4) the K
// bytes 4t..4t+3 and 16+4t..16+4t+3 of rows g and g+8 of A and of row g of B.
// Which element of K sits in which slot does not matter to the product as
// long as A and B agree, so a lane takes the 16 contiguous bytes 16t..16t+15
// of a 64-byte slab with one load (x, y, z, w) and feeds (x, y) to one mma
// (mma_first) and (z, w) to another (mma_second): a quarter of the
// loads, whole sectors used.  Callers run all first steps of their
// accumulators before the second steps, so that no mma waits on the one just
// before it.
template <typename AccT>
__device__ __forceinline__ void mma_first(AccT (&c)[4], const uint4& a_lo, const uint4& a_hi,
                                          const uint4& b) {
  const uint32_t a0[4] = {a_lo.x, a_hi.x, a_lo.y, a_hi.y}, b0[2] = {b.x, b.y};
  mma(c, a0, b0);
}

template <typename AccT>
__device__ __forceinline__ void mma_second(AccT (&c)[4], const uint4& a_lo, const uint4& a_hi,
                                           const uint4& b) {
  const uint32_t a1[4] = {a_lo.z, a_hi.z, a_lo.w, a_hi.w}, b1[2] = {b.z, b.w};
  mma(c, a1, b1);
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The 16 bytes at byte offset kb of row `row` of a (rows, row_bytes) matrix,
// zero where they lie outside it.  `aligned`: every such chunk is whole and
// 16-byte aligned; otherwise the bytes are read one by one.
__device__ __forceinline__ uint4 fetch16(const uint8_t* __restrict__ base, long long row,
                                         int rows, long long kb, long long row_bytes,
                                         bool aligned) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row < rows && kb < row_bytes) {
    const uint8_t* p = base + row * row_bytes + kb;
    if (aligned) return *reinterpret_cast<const uint4*>(p);
    const long long left = row_bytes - kb;
    const int n = left < 16 ? static_cast<int>(left) : 16;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < n) w[j >> 2] |= static_cast<uint32_t>(p[j]) << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ROWS x kSlab bytes of a matrix into shared memory (pitch kPitch), zero
// filled outside the matrix: cp.async where the chunks are aligned.
template <int ROWS>
__device__ __forceinline__ void stage(uint8_t* smem, const uint8_t* __restrict__ base,
                                      long long row0, int rows, long long k0,
                                      long long row_bytes, bool aligned) {
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * (kSlab / 16); c += kThreads) {
    const int r = c / (kSlab / 16), q = c % (kSlab / 16);
    uint8_t* dst = smem + r * kPitch + q * 16;
    const long long row = row0 + r, kb = k0 + q * 16;
    if (aligned) {
      const bool in = row < rows && kb < row_bytes;
      cp_async16(dst, in ? base + row * row_bytes + kb : base, in ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(dst) = fetch16(base, row, rows, kb, row_bytes, false);
    }
  }
}

// The probe's change to A before product i: a XOR int8(i) ...
__device__ __forceinline__ uint32_t perturb(uint32_t w, int i, int /*int8*/) {
  return w ^ (static_cast<uint32_t>(i & 0xff) * 0x01010101u);
}

// ... or bf16(a + bf16(i)): the f32 sum of the two bf16 values, rounded to
// nearest even, as XLA and PyTorch compute a bf16 addition
__device__ __forceinline__ uint32_t perturb(uint32_t w, int i, float /*bf16*/) {
  const float fi = __bfloat162float(__float2bfloat16_rn(static_cast<float>(i)));
  const __nv_bfloat16 lo = __float2bfloat16_rn(
      __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w & 0xffffu))) + fi);
  const __nv_bfloat16 hi = __float2bfloat16_rn(
      __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w >> 16))) + fi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// C (M, N) = sum over i < loop of A_i (M, K) x Bt (N, K)^T, where A_i is A
// (ACCUM false, loop 1) or the probe's perturbed A (ACCUM true).  row_bytes
// is K in bytes.  Block b owns tile (b / n_tiles, b % n_tiles).
template <typename AccT, int BN, int WM, int WN, bool ACCUM>
__global__ void __launch_bounds__(kThreads, 2)   // 128 registers: two blocks an SM
tiled_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ Bt,
             AccT* __restrict__ C, int M, int N, long long row_bytes, int loop,
             int aligned_i) {
  static_assert((kBM / WM) * (BN / WN) == kThreads / 32, "8 warps cover the tile");
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int A_CHUNKS = kBM * (kSlab / 16) / kThreads;   // per thread
  __shared__ __align__(16) uint8_t sA[2][kBM * kPitch];
  __shared__ __align__(16) uint8_t sB[2][BN * kPitch];

  const bool aligned = aligned_i != 0;
  const int n_tiles = (N + BN - 1) / BN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;

  AccT acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int kslabs = static_cast<int>((row_bytes + kSlab - 1) / kSlab);
  const long long total = static_cast<long long>(kslabs) * loop;
  uint4 ra[A_CHUNKS];   // ACCUM: the next slab of A on its way through registers

  auto fetch_a = [&](long long s) {
    const long long k0 = (s % kslabs) * kSlab;
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j) {
      const int c = threadIdx.x + j * kThreads;
      ra[j] = fetch16(A, m0 + c / (kSlab / 16), M, k0 + (c % (kSlab / 16)) * 16,
                      row_bytes, aligned);
    }
  };
  auto store_a = [&](long long s, int buf) {
    const int i = static_cast<int>(s / kslabs);
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j) {
      const int c = threadIdx.x + j * kThreads;
      uint4 v = ra[j];
      v.x = perturb(v.x, i, AccT());
      v.y = perturb(v.y, i, AccT());
      v.z = perturb(v.z, i, AccT());
      v.w = perturb(v.w, i, AccT());
      *reinterpret_cast<uint4*>(sA[buf] + (c / (kSlab / 16)) * kPitch +
                                (c % (kSlab / 16)) * 16) = v;
    }
  };

  // slab 0
  stage<BN>(sB[0], Bt, n0, N, 0, row_bytes, aligned);
  if (ACCUM) {
    fetch_a(0);
    store_a(0, 0);
  } else {
    stage<kBM>(sA[0], A, m0, M, 0, row_bytes, aligned);
  }
  cp_async_commit();

  for (long long s = 0; s < total; ++s) {
    const int cur = static_cast<int>(s & 1);
    const bool more = s + 1 < total;
    if (more) {
      const long long k1 = ((s + 1) % kslabs) * kSlab;
      stage<BN>(sB[cur ^ 1], Bt, n0, N, k1, row_bytes, aligned);
      if (ACCUM) fetch_a(s + 1);
      else stage<kBM>(sA[cur ^ 1], A, m0, M, k1, row_bytes, aligned);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    {
      uint4 a_lo[MT], a_hi[MT], b[NT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint8_t* p = sA[cur] + (wm + i * 16 + g) * kPitch + 16 * t;
        a_lo[i] = *reinterpret_cast<const uint4*>(p);
        a_hi[i] = *reinterpret_cast<const uint4*>(p + 8 * kPitch);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        b[j] = *reinterpret_cast<const uint4*>(sB[cur] + (wn + j * 8 + g) * kPitch + 16 * t);
      // step-major: an accumulator's two mmas are a whole tile sweep apart
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_first(acc[i][j], a_lo[i], a_hi[i], b[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_second(acc[i][j], a_lo[i], a_hi[i], b[j]);
    }
    if (ACCUM && more) store_a(s + 1, cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm + i * 16 + g + 8 * h;
        if (row < M) {
          AccT* out = C + row * N + col;
          if (col < N) out[0] = acc[i][j][2 * h];
          if (col + 1 < N) out[1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
}

// The requant between two steps of the chain, two neighbouring columns at a
// time: int8 clip(v >> 9, -127, 127) ...
__device__ __forceinline__ void requant_store(uint8_t* row, int col, int v0, int v1, float) {
  v0 = max(-127, min(127, v0 >> 9));
  v1 = max(-127, min(127, v1 >> 9));
  *reinterpret_cast<uint16_t*>(row + col) = static_cast<uint16_t>(
      (static_cast<uint32_t>(v0) & 0xffu) | ((static_cast<uint32_t>(v1) & 0xffu) << 8));
}

// ... or bf16(v * scale), rounded to nearest even
__device__ __forceinline__ void requant_store(uint8_t* row, int col, float v0, float v1,
                                              float scale) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(v0, scale)));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(v1, scale)));
  *reinterpret_cast<uint32_t*>(row + 2 * col) = lo | (hi << 16);
}

// Shared-memory pitch of the chain's rows: row_bytes padded so that the pitch
// is 64 modulo 128, which keeps the 16-byte fragment loads conflict-free.
__host__ __device__ inline int chain_pitch(int row_bytes) {
  return row_bytes + (64 - row_bytes % 128 + 128) % 128;
}

// Out (M, N) = y after `loop` steps of y <- requant(y (M, K) x Bt (N, K)^T),
// N == K, row_bytes (K in bytes) a multiple of 64.  Block b owns rows
// 16 b .. 16 b + 15.  Dynamic shared memory: 2 * kBand * chain_pitch(row_bytes).
template <typename AccT>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ Bt,
             uint8_t* __restrict__ Out, int M, int N, int row_bytes, int loop,
             float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int pitch = chain_pitch(row_bytes);
  uint8_t* cur = smem;
  uint8_t* nxt = smem + kBand * pitch;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBand;
  const int chunks = row_bytes / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  for (int c = threadIdx.x; c < kBand * chunks; c += kThreads) {
    const int r = c / chunks, q = c % chunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M)
      v = *reinterpret_cast<const uint4*>(A + (m0 + r) * row_bytes + q * 16);
    *reinterpret_cast<uint4*>(cur + r * pitch + q * 16) = v;
  }
  __syncthreads();

  for (int step = 0; step < loop; ++step) {
    for (int n0 = warp * kChunk; n0 < N; n0 += (kThreads / 32) * kChunk) {
      AccT acc[kChunk / 8][4];
      const uint8_t* pb[kChunk / 8];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;
        // a column past N reads the last row of Bt; its result is dropped
        const int n = min(n0 + j * 8 + g, N - 1);
        pb[j] = Bt + static_cast<long long>(n) * row_bytes + 16 * t;
      }
      const uint8_t* pa = cur + g * pitch + 16 * t;
#pragma unroll 2
      for (int kb = 0; kb < row_bytes; kb += kSlab) {
        const uint4 a_lo = *reinterpret_cast<const uint4*>(pa + kb);
        const uint4 a_hi = *reinterpret_cast<const uint4*>(pa + 8 * pitch + kb);
        uint4 b[kChunk / 8];
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j)
          b[j] = __ldg(reinterpret_cast<const uint4*>(pb[j] + kb));
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) mma_first(acc[j], a_lo, a_hi, b[j]);
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) mma_second(acc[j], a_lo, a_hi, b[j]);
      }
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        const int col = n0 + j * 8 + 2 * t;
        if (n0 + j * 8 < N) {   // N is a multiple of 8: a tile is in or out whole
          requant_store(nxt + g * pitch, col, acc[j][0], acc[j][1], scale);
          requant_store(nxt + (g + 8) * pitch, col, acc[j][2], acc[j][3], scale);
        }
      }
    }
    __syncthreads();
    uint8_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int c = threadIdx.x; c < kBand * chunks; c += kThreads) {
    const int r = c / chunks, q = c % chunks;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(Out + (m0 + r) * row_bytes + q * 16) =
          *reinterpret_cast<const uint4*>(cur + r * pitch + q * 16);
  }
}

template <typename AccT, int BN, int WM, int WN>
cudaError_t launch_tiled(const void* a, const void* bt, void* c, int m, int n, int k,
                         int loop, int accum, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(k) * Elem<AccT>::size;
  const long long tiles = static_cast<long long>((m + kBM - 1) / kBM) * ((n + BN - 1) / BN);
  if (tiles <= 0 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int aligned = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(bt) % 16 == 0;
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(bt);
  const unsigned grid = static_cast<unsigned>(tiles);
  if (accum)
    tiled_kernel<AccT, BN, WM, WN, true><<<grid, kThreads, 0, stream>>>(
        pa, pb, static_cast<AccT*>(c), m, n, row_bytes, loop, aligned);
  else
    tiled_kernel<AccT, BN, WM, WN, false><<<grid, kThreads, 0, stream>>>(
        pa, pb, static_cast<AccT*>(c), m, n, row_bytes, 1, aligned);
  return cudaGetLastError();
}

template <typename AccT>
cudaError_t launch_chain(const void* a, const void* bt, void* out, int m, int n,
                         int loop, float scale, cudaStream_t stream) {
  const int row_bytes = n * Elem<AccT>::size;
  const size_t smem = 2 * static_cast<size_t>(kBand) * chain_pitch(row_bytes);
  if (row_bytes % kSlab != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bt) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<AccT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  chain_kernel<AccT><<<(m + kBand - 1) / kBand, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt),
      static_cast<uint8_t*>(out), m, n, row_bytes, loop, scale);
  return cudaGetLastError();
}

}  // namespace

// c (m, n) int32 / f32 = sum over i < loop of a_i (m, k) x bt (n, k)^T; int8
// operands if is_int8 else bf16; bn is the tile width, 64 or 128; accum 0 is
// the plain product (loop ignored), 1 the probe's perturbed sum.
extern "C" int ioudet_tiled_matmul(const void* a, const void* bt, void* c, int is_int8,
                                   int m, int n, int k, int bn, int loop, int accum,
                                   cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0 || loop <= 0 || (bn != 64 && bn != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (is_int8)
    err = bn == 128 ? launch_tiled<int, 128, 64, 32>(a, bt, c, m, n, k, loop, accum, stream)
                    : launch_tiled<int, 64, 32, 32>(a, bt, c, m, n, k, loop, accum, stream);
  else
    err = bn == 128 ? launch_tiled<float, 128, 64, 32>(a, bt, c, m, n, k, loop, accum, stream)
                    : launch_tiled<float, 64, 32, 32>(a, bt, c, m, n, k, loop, accum, stream);
  return static_cast<int>(err);
}

// out (m, n) = y after `loop` steps of y <- requant(y x bt (n, n)^T), y = a
// (m, n) at the start; int8 (scale ignored) if is_int8 else bf16.
extern "C" int ioudet_chain_matmul(const void* a, const void* bt, void* out, int is_int8,
                                   int m, int n, int loop, float scale,
                                   cudaStream_t stream) {
  if (m <= 0 || n <= 0 || loop < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      is_int8 ? launch_chain<int>(a, bt, out, m, n, loop, scale, stream)
              : launch_chain<float>(a, bt, out, m, n, loop, scale, stream);
  return static_cast<int>(err);
}
