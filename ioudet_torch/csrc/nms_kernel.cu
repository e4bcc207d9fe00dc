// Exact greedy NMS for Hopper (sm_90a): a suppression bitmask pass and an
// on-device greedy reduce, behind a plain C interface loaded with ctypes by
// ioudet_torch/ops/nms_cuda.py.  Built there with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 --fmad=false
//        -shared -Xcompiler -fPIC
//
// Replaces the TPU kernels of ioudet/ops/nms_pallas.py:
//   nms_mask_kernel   <- _supp_kernel / suppression_matrix (K1a): bit j of
//                        word (i, c) is IoU(i, 64c + j) > thr and 64c + j > i.
//   nms_reduce_kernel <- _greedy_kernel / greedy_keep_pallas (K1b): the exact
//                        greedy keep mask, walked in score order on the device.
// The layout is the reference CUDA kernel's (mmdet/ops/nms/src/nms_kernel.cu:
// a 64-bit mask per (row, column block)), except that the reduce, which the
// reference ran on the host after a copy, runs here on the device, so the
// serving path has no host loop and no sync.
//
// What bounds them on this card, and what the design does about it.
//
// The mask pass computes N(N-1)/2 IoUs an image (2M at N = 2000, ~20 f32
// operations each) and writes B*N*ceil(N/64) words (8 MB at B = 16): it is
// bound by the instructions it issues.  So it launches only the tiles on and
// above the diagonal, on a triangular index (tile_of): a tile is one row block
// (64 rows) by four column blocks, 256 threads, each thread one row against
// one column block (one word).  The tile's 256 column boxes and their +1
// areas are staged once in shared memory.  The test IoU > thr takes no
// division (above): the IEEE quotient's slow path took every pair that does
// not intersect.  The words are staged too and written row by row as
// contiguous runs; the tile on the diagonal also writes its rows' zero words
// under it, so the mask needs no memset.
//
// The reduce is the greedy recurrence: a chain of dependent decisions, one an
// image, so latency bounds it (its bytes bound is ~1 us).  One block an image:
//   * the block folds the valid flags into removed[] (a row that is invalid
//     counts as removed), one ballot per 32 rows, before anything else;
//   * the slab of row block c (its 64 rows, words c..W-1) is staged in shared
//     memory with cp.async, one tile ahead and double-buffered, so it lands
//     while the previous one is walked; where W is wider than a window of
//     kWin words, the later words come in further windows of the same block;
//   * warp 0 walks from candidate to candidate (cand = ~removed[c]), rows
//     0-31 then 32-63, on 32-bit bit-reversed words held one row a lane:
//     each dependent step is a kept row (find-last-set, shuffle, and-not),
//     while warps 1-7 issue the next tile's copies;
//   * warp g ORs the kept rows 8g..8g+7 into the later words of the window
//     from shared memory, merged by shared atomicOr;
//   * at the end keep = ~removed, written as a coalesced byte row.
//
// Numerics: the IoU must equal ioudet_torch.core.bbox.geometry.bbox_overlaps
// and ioudet's _supp_kernel bit for bit (+1 areas, 1e-10 denominator floor,
// same operation order), or a box at the threshold is kept by one and
// suppressed by the other.  Every step is an explicitly rounded intrinsic
// (__fadd_rn and friends are never contracted into FMAs) and the build also
// passes --fmad=false.

#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;          // boxes per column block = bits per mask word
constexpr int kTileCols = 4;        // column blocks a mask tile
constexpr int kMaskThreads = 256;   // threads a mask tile: one row against kTileCols / 4 column blocks each
constexpr int kWordsPerThread = kTileCols * kBlock / kMaskThreads;
constexpr int kReduceThreads = 256; // threads a reduce block: 8 warps, one a group of 8 rows in the OR
constexpr int kWarps = kReduceThreads / 32;
constexpr int kWin = 64;            // words of a slab window (the slab's row pitch)

// (row block, column tile) of upper tile t, for ``tiles`` = ceil(W / T)
// column tiles of T = kTileCols blocks: row group R (row blocks T R .. T R +
// T - 1) has tiles - R tiles a row, so S(R) = T (R tiles - R (R - 1) / 2)
// tiles come before it
__device__ __forceinline__ long long tiles_before(long long r, long long tiles) {
  return kTileCols * (r * tiles - r * (r - 1) / 2);
}

__device__ __forceinline__ int2 tile_of(long long t, int tiles) {
  const double b = 2.0 * tiles + 1.0;
  long long r = (long long)((b - sqrt(fmax(b * b - 8.0 * (double)t / kTileCols, 0.0))) * 0.5);
  r = max(0LL, min(r, (long long)tiles - 1));
  while (r > 0 && tiles_before(r, tiles) > t) --r;
  while (r + 1 < tiles && tiles_before(r + 1, tiles) <= t) ++r;
  const long long local = t - tiles_before(r, tiles);
  const long long per = tiles - r;
  return make_int2((int)(kTileCols * r + local / per), (int)(r + local % per));
}

// fl32(inter / denom) > thr, without the division (the IEEE quotient's slow
// path takes every pair with inter = 0): mid, halfway between thr and the
// next float up, has 25 significant bits and denom 24, so mid * denom is
// exact in double, and inter / denom (24-bit operands) never equals mid; so
// the quotient rounds above thr exactly when inter > mid * denom.
__device__ __forceinline__ bool above(float inter, float denom, float thr, double mid) {
  return (double)inter > mid * (double)denom;
}

// grid (upper tiles, image), kMaskThreads threads.  Thread t owns row
// 64 r + (t % 64) of the tile and its column blocks t / 64 + 4 k.
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes, u64* __restrict__ mask,
                int n, int words, float thr) {
  __shared__ float4 cols[kTileCols * kBlock];
  __shared__ float col_area[kTileCols * kBlock];
  __shared__ u64 tile_words[kBlock][kTileCols + 1];
  const int tiles = (words + kTileCols - 1) / kTileCols;
  const int2 ro = tile_of(blockIdx.x, tiles);
  const int rb = ro.x, oc = ro.y;
  const int t = threadIdx.x;
  const float4* img = reinterpret_cast<const float4*>(boxes) + (size_t)blockIdx.y * n;
  const int col0 = oc * kTileCols * kBlock;
  for (int k = t; k < kTileCols * kBlock; k += kMaskThreads) {
    if (col0 + k < n) {
      const float4 b = img[col0 + k];
      cols[k] = b;
      col_area[k] = __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                              __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
    }
  }
  const int i = t % kBlock;
  const int row = rb * kBlock + i;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < n) a = img[row];
  const float area_a = __fmul_rn(__fadd_rn(__fsub_rn(a.z, a.x), 1.0f),
                                 __fadd_rn(__fsub_rn(a.w, a.y), 1.0f));
  const double mid = 0.5 * ((double)thr + (double)nextafterf(thr, INFINITY));
  __syncthreads();
#pragma unroll 1
  for (int part = 0; part < kWordsPerThread; ++part) {
    const int sub = t / kBlock + part * (kMaskThreads / kBlock);
    const int cb = oc * kTileCols + sub;
    u64 word = 0ULL;
    if (row < n && cb < words && cb >= rb) {   // uniform within a warp but for row < n
      const float4* c = cols + sub * kBlock;
      const float* ca = col_area + sub * kBlock;
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        const float4 b = c[j];
        const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f), 0.0f);
        const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f), 0.0f);
        const float inter = __fmul_rn(iw, ih);
        const float denom = fmaxf(__fsub_rn(__fadd_rn(area_a, ca[j]), inter), 1e-10f);
        if (above(inter, denom, thr, mid)) word |= 1ULL << j;
      }
      const int ncols = n - cb * kBlock;
      if (ncols < kBlock) word &= (1ULL << ncols) - 1ULL;
      if (cb == rb) word &= (~0ULL << i) << 1;   // strictly above the diagonal
    }
    tile_words[i][sub] = word;
  }
  __syncthreads();
  // each row's run of words, contiguous: from word 0 on the diagonal tile
  // (the words under the diagonal are zero), else from the tile's first
  const int wfirst = oc * kTileCols;
  const int wstart = (oc == rb / kTileCols) ? 0 : wfirst;
  const int wend = min(wfirst + kTileCols, words);
  const int run = wend - wstart;
  const int nrows = min(kBlock, n - rb * kBlock);
  u64* out = mask + ((size_t)blockIdx.y * n + (size_t)rb * kBlock) * words;
  for (int k = t; k < nrows * run; k += kMaskThreads) {
    const int r = k / run;
    const int w = wstart + (k - r * run);
    out[(size_t)r * words + w] = w < wfirst ? 0ULL : tile_words[r][w - wfirst];
  }
}

template <int V>
__device__ __forceinline__ void cp_async(u64* dst, const u64* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (V == 2) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(s), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The window of block c that starts at word w0: its first word is c rounded
// down to the copy's width V (words), the next ones follow kWin words apart.
template <int V>
__device__ __forceinline__ int first_window(int c) { return c & ~(V - 1); }

// Stage rows 64 c.. of the window [w0, min(w0 + kWin, W)) into buf (pitch
// kWin), by the block's threads from ``first`` on: copy k is row k >> sh, V
// words at (k & (2^sh - 1)) V, 2^sh the copies a row rounded up to a power
// of two; every thread commits.
template <int V>
__device__ __forceinline__ void stage_slab(u64* buf, const u64* m, int c, int w0,
                                           int n, int words, int first) {
  const int nrows = min(kBlock, n - c * kBlock);
  const int nw = min(w0 + kWin, words) - w0;
  const int sh = 32 - __clz(max(nw / V - 1, 0));
  const u64* src = m + (size_t)c * kBlock * words + w0;
  for (int k = (int)threadIdx.x - first; k < (nrows << sh); k += kReduceThreads - first) {
    if (k < 0) break;
    const int r = k >> sh, x = (k & ((1 << sh) - 1)) * V;
    if (x < nw) cp_async<V>(buf + r * kWin + x, src + r * words + x);
  }
  cp_async_commit();
}

// The greedy walk over one half (32 rows) of a row block, by a warp in
// lockstep.  Bit p of cand and of the result is row 31 - p of the half, so
// that the next candidate, the lowest row, is the highest set bit (one FLO);
// lane p holds that row's mask word over the half, bit-reversed the same way,
// and hands it over by a shuffle.  A kept row removes its later candidates,
// so each step jumps to the next candidate: the dependent steps are the rows
// kept (find-last-set, shuffle, and-not).
__device__ __forceinline__ unsigned walk_half(unsigned cand, unsigned word) {
  unsigned kept = 0u;
  while (cand) {
    const int p = 31 - __clz(cand);
    const unsigned d = __shfl_sync(0xffffffffu, word, p);
    kept |= 1u << p;
    cand = (cand ^ (1u << p)) & ~d;
  }
  return kept;
}

// The kept rows of a row block: live = its valid rows not suppressed by
// earlier blocks, diag + r * kWin = row r's word over the block.  Lane l
// holds rows 31 - l and 63 - l.  Rows 0-31 first; the high halves of the
// kept ones then remove rows of 32-63 before those are walked.
__device__ __forceinline__ u64 walk_block(u64 live, const u64* diag) {
  const int lane = threadIdx.x % 32;
  const u64 lo_row = diag[(31 - lane) * kWin], hi_row = diag[(63 - lane) * kWin];
  const unsigned lo_live = __brev((unsigned)live), hi_word = __brev((unsigned)(hi_row >> 32));
  const unsigned lo = __brev(walk_half(lo_live, __brev((unsigned)lo_row)));
  const unsigned sup = __reduce_or_sync(
      0xffffffffu, (lo >> (31 - lane) & 1u) ? (unsigned)(lo_row >> 32) : 0u);
  const unsigned hi_live = __brev((unsigned)(live >> 32) & ~sup);
  const unsigned hi = __brev(walk_half(hi_live, hi_word));
  return ((u64)hi << 32) | lo;
}

// grid (image), kReduceThreads threads; V = 2 (16-byte copies) where W is
// even, else 1.  removed[w] holds the rows of word w that are invalid or
// suppressed by a kept row so far.
template <int V>
__global__ void __launch_bounds__(kReduceThreads)
nms_reduce_kernel(const u64* __restrict__ mask, const unsigned char* __restrict__ valid,
                  unsigned char* __restrict__ keep, int n, int words) {
  extern __shared__ __align__(16) u64 smem[];
  u64* slab = smem;                                  // [2][kBlock][kWin]
  u64* removed = smem + 2 * kBlock * kWin;           // [words]
  __shared__ u64 kept_s;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const u64* m = mask + (size_t)blockIdx.x * n * words;
  const unsigned char* v = valid + (size_t)blockIdx.x * n;

  int c = 0, w0 = 0, buf = 0;
  stage_slab<V>(slab, m, 0, 0, n, words, 0);
  // removed[] starts as the rows that are not valid: eight loads a lane in
  // flight, then one ballot each
  unsigned* removed32 = reinterpret_cast<unsigned*>(removed);
  for (int h0 = warp; h0 < 2 * words; h0 += 8 * kWarps) {
    bool live[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int row = (h0 + k * kWarps) * 32 + lane;
      live[k] = row < n && v[row];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned bits = __ballot_sync(0xffffffffu, live[k]);
      if (lane == 0 && h0 + k * kWarps < 2 * words) removed32[h0 + k * kWarps] = ~bits;
    }
  }
  while (c < words) {
    cp_async_wait_all();
    __syncthreads();   // this tile has landed; removed[] is final up to it; the other buffer is free
    int nc = c, nw0 = w0 + kWin;
    if (nw0 >= words) { nc = c + 1; nw0 = first_window<V>(nc); }
    // warp 0 walks: the other warps issue the next tile's copies
    if (nc < words) stage_slab<V>(slab + (buf ^ 1) * kBlock * kWin, m, nc, nw0, n, words, 32);
    const u64* s = slab + buf * kBlock * kWin;
    if (w0 == first_window<V>(c)) {
      if (warp == 0) {
        const u64 kept = walk_block(~removed[c], s + (c - w0));
        if (lane == 0) {
          kept_s = kept;
          removed[c] = ~kept;
        }
      }
      __syncthreads();
    }
    const u64 kept = kept_s;
    // warp g ORs its 8 kept rows' words into the later words of the window
    const unsigned bits = (unsigned)(kept >> (8 * warp)) & 0xffu;
    if (bits) {
      const u64* rows = s + 8 * warp * kWin;
      for (int w = max(c + 1, w0) + lane; w < min(w0 + kWin, words); w += 32) {
        u64 acc = 0ULL;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (bits >> r & 1u) acc |= rows[r * kWin + w - w0];
        }
        const unsigned lo = (unsigned)acc, hi = (unsigned)(acc >> 32);
        if (lo) atomicOr(removed32 + 2 * w, lo);
        if (hi) atomicOr(removed32 + 2 * w + 1, hi);
      }
    }
    c = nc;
    w0 = nw0;
    buf ^= 1;
  }
  __syncthreads();
  unsigned char* k = keep + (size_t)blockIdx.x * n;
  for (int i = t; i < n; i += kReduceThreads) {
    k[i] = (unsigned char)(~(removed[i / kBlock] >> (i % kBlock)) & 1ULL);
  }
}

template <int V>
int launch_reduce(const u64* mask, const unsigned char* valid, unsigned char* keep,
                  int batch, int n, int words, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * kBlock * kWin + words) * sizeof(u64);
  static size_t opted = 48 * 1024;   // dynamic shared memory the kernel may take
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_reduce_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  nms_reduce_kernel<V><<<batch, kReduceThreads, smem, stream>>>(mask, valid, keep, n, words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// boxes (batch, n, 4) f32 in score order -> mask (batch, n, ceil(n/64)) u64.
int ioudet_nms_mask(const float* boxes, unsigned long long* mask, int batch,
                    int n, float thr, cudaStream_t stream) {
  const long long words = (n + kBlock - 1) / kBlock;
  const long long q = (words + kTileCols - 1) / kTileCols;
  // every row block of row group R has q - R tiles; the last group may be short
  const long long tiles = kTileCols * ((q - 1) * q - (q - 1) * (q - 2) / 2) +
                          (words - kTileCols * (q - 1));
  nms_mask_kernel<<<dim3((unsigned)tiles, batch), kMaskThreads, 0, stream>>>(
      boxes, mask, n, (int)words, thr);
  return (int)cudaGetLastError();
}

// mask from ioudet_nms_mask, valid (batch, n) bool -> keep (batch, n) bool.
int ioudet_nms_reduce(const unsigned long long* mask, const unsigned char* valid,
                      unsigned char* keep, int batch, int n, cudaStream_t stream) {
  const int words = (n + kBlock - 1) / kBlock;
  return words % 2 == 0 ? launch_reduce<2>(mask, valid, keep, batch, n, words, stream)
                        : launch_reduce<1>(mask, valid, keep, batch, n, words, stream);
}

}  // extern "C"
