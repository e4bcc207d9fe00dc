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
// The design is the reference CUDA kernel's (mmdet/ops/nms/src/nms_kernel.cu:
// a 64-bit mask per (row, column block)), except that the reduce, which the
// reference ran on the host after a copy, runs here on the device, so the
// serving path has no host loop and no sync.
//
// What bounds them on this card.  The mask pass computes about N^2/2 IoUs
// (2M at N = 2000 per image, ~20 flops each) and writes B*N*ceil(N/64)
// words (8 MB at B = 16): light in both flops and bytes, so it is bound by
// launch latency and occupancy; each block stages its 64 column boxes in
// shared memory and skips the all-zero blocks under the diagonal.  The
// reduce is a chain of N dependent decisions, the same latency-bound walk the
// TPU docstring describes (nms_pallas.py:147-152).  To keep that chain short
// it runs in registers: for each block of 64 rows one lane resolves the 64
// decisions from the current removed word and the 64 diagonal words (staged
// in shared memory), then the warp ORs the kept rows into the later words in
// parallel.  One warp per image; the serial part is N register steps plus
// N/64 warp-wide passes.
//
// Numerics: the IoU must equal ioudet_torch.core.bbox.geometry.bbox_overlaps
// and ioudet's _supp_kernel bit for bit (+1 areas, 1e-10 denominator floor,
// same operation order), or a box at the threshold is kept by one and
// suppressed by the other.  Every step is an explicitly rounded intrinsic
// (__fadd_rn and friends are never contracted into FMAs) and the build also
// passes --fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;  // boxes per column block = bits per mask word
constexpr int kWarp = 32;

__device__ __forceinline__ float iou_plus1(float ax1, float ay1, float ax2,
                                           float ay2, const float* b) {
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(ax2, b[2]), fmaxf(ax1, b[0])), 1.0f), 0.0f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(ay2, b[3]), fmaxf(ay1, b[1])), 1.0f), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float area_a = __fmul_rn(__fadd_rn(__fsub_rn(ax2, ax1), 1.0f),
                                 __fadd_rn(__fsub_rn(ay2, ay1), 1.0f));
  const float area_b = __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), 1.0f),
                                 __fadd_rn(__fsub_rn(b[3], b[1]), 1.0f));
  return __fdiv_rn(inter, fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-10f));
}

// grid (row block, column block, image), kBlock threads; thread t owns row
// 64 * blockIdx.x + t and writes its one word for this column block.
__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                unsigned long long* __restrict__ mask,
                                int n, int words, float thr) {
  __shared__ float cols[kBlock][4];
  const int col0 = blockIdx.y * kBlock;
  const int ncols = min(kBlock, n - col0);
  const float* img_boxes = boxes + (size_t)blockIdx.z * n * 4;
  const int t = threadIdx.x;
  if (t < ncols) {
    for (int k = 0; k < 4; ++k) cols[t][k] = img_boxes[(size_t)(col0 + t) * 4 + k];
  }
  __syncthreads();
  const int row = blockIdx.x * kBlock + t;
  if (row >= n) return;
  unsigned long long word = 0ULL;
  if (col0 + ncols - 1 > row) {  // some column of this block lies above the diagonal
    const float* r = img_boxes + (size_t)row * 4;
    const float x1 = r[0], y1 = r[1], x2 = r[2], y2 = r[3];
    for (int j = max(0, row - col0 + 1); j < ncols; ++j) {
      if (iou_plus1(x1, y1, x2, y2, cols[j]) > thr) word |= 1ULL << j;
    }
  }
  mask[((size_t)blockIdx.z * n + row) * words + blockIdx.y] = word;
}

// grid (image), one warp.  removed[w] holds the rows of word w suppressed by
// a kept row so far.
__global__ void nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                                  const unsigned char* __restrict__ valid,
                                  unsigned char* __restrict__ keep,
                                  int n, int words) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;        // [words]
  unsigned long long* diag = smem + words;   // [kBlock]
  const int lane = threadIdx.x;
  const unsigned long long* m = mask + (size_t)blockIdx.x * n * words;
  const unsigned char* v = valid + (size_t)blockIdx.x * n;
  unsigned char* k = keep + (size_t)blockIdx.x * n;

  for (int w = lane; w < words; w += kWarp) removed[w] = 0ULL;
  for (int c = 0; c < words; ++c) {
    const int row0 = c * kBlock;
    const int nrows = min(kBlock, n - row0);
    for (int j = lane; j < nrows; j += kWarp) diag[j] = m[(size_t)(row0 + j) * words + c];
    const unsigned lo = __ballot_sync(0xffffffffu, lane < nrows && v[row0 + lane]);
    const unsigned hi = __ballot_sync(0xffffffffu, lane + kWarp < nrows && v[row0 + kWarp + lane]);
    __syncwarp();
    unsigned long long kept = 0ULL;
    if (lane == 0) {
      const unsigned long long valid_bits = ((unsigned long long)hi << 32) | lo;
      unsigned long long cur = removed[c];
      for (int j = 0; j < nrows; ++j) {
        if (((valid_bits & ~cur) >> j) & 1ULL) {
          kept |= 1ULL << j;
          cur |= diag[j];
        }
      }
    }
    kept = __shfl_sync(0xffffffffu, kept, 0);
    for (int j = lane; j < nrows; j += kWarp) k[row0 + j] = (unsigned char)((kept >> j) & 1ULL);
    for (int w = c + 1 + lane; w < words; w += kWarp) {
      unsigned long long acc = 0ULL;
      for (unsigned long long bits = kept; bits; bits &= bits - 1) {
        acc |= m[(size_t)(row0 + __ffsll((long long)bits) - 1) * words + w];
      }
      removed[w] |= acc;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// boxes (batch, n, 4) f32 in score order -> mask (batch, n, ceil(n/64)) u64.
int ioudet_nms_mask(const float* boxes, unsigned long long* mask, int batch,
                    int n, float thr, cudaStream_t stream) {
  const int words = (n + kBlock - 1) / kBlock;
  nms_mask_kernel<<<dim3(words, words, batch), kBlock, 0, stream>>>(boxes, mask, n, words, thr);
  return (int)cudaGetLastError();
}

// mask from ioudet_nms_mask, valid (batch, n) bool -> keep (batch, n) bool.
int ioudet_nms_reduce(const unsigned long long* mask, const unsigned char* valid,
                      unsigned char* keep, int batch, int n, cudaStream_t stream) {
  const int words = (n + kBlock - 1) / kBlock;
  const size_t smem = (size_t)(words + kBlock) * sizeof(unsigned long long);
  nms_reduce_kernel<<<batch, kWarp, smem, stream>>>(mask, valid, keep, n, words);
  return (int)cudaGetLastError();
}

}  // extern "C"
