// Fused anchor-target assignment for Hopper (sm_90a): MaxIoU assignment,
// labels, weights and bbox2delta targets for every anchor of a batch in two
// passes, behind a plain C interface loaded with ctypes by
// ioudet_torch/ops/assign_cuda.py.  Built there with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 --fmad=false
//        -shared -Xcompiler -fPIC
//
// Replaces the TPU kernels of ioudet/ops/assign_pallas.py (fused_anchor_assign):
//   assign_gtmax_kernel   <- _gtmax_kernel (K2a): gtmax[b, g] = max over the
//                            image's anchors of the masked IoU with gt g.
//   assign_targets_kernel <- _assign_kernel (K2b): per anchor a loop over the
//                            gts with a running max, the first argmax and the
//                            last forced positive; then labels, label weights,
//                            the positive mask, bbox2delta targets and the
//                            matched gt box.
// Two passes because the rule "every anchor tying a gt's best IoU is forced
// positive" needs each gt's maximum over all anchors before any anchor can
// be finished.
//
// What bounds them on this card.  Nothing of size G x A touches device
// memory: the anchors (16 B each) and the valid flags are read once per pass
// and the per-anchor outputs (44 B) written once, about 75 MB at the flagship
// shape (A = 209,538, B = 8), some 25 us of traffic.  The work is the B*G*A
// IoUs (1.7e8 at G = 100, ~30 flops and one IEEE division each), so both
// passes are bound by operations, not bytes.  The design keeps each anchor in
// registers for the whole loop over g and the image's gt table (boxes, areas,
// maxima) in shared memory, where every thread of a warp reads the same word
// (a broadcast).  The TPU kernel's accumulation over a sequential grid has no
// counterpart here: blocks run in no order, so pass 1 reduces a block's
// maxima by warp shuffles and shared memory and merges blocks with an atomic
// max (a max is the same in any order: the result is deterministic).  The
// (rows, 128) planes and the 8-sublane redundancy of the TPU kernel are its
// tiling and are not carried over; outputs are (B, A) and (B, A, 4).
//
// Numerics.  The tie test iou == gtmax needs the IoU of the two passes to be
// the same bits, and both equal to ioudet_torch.core.bbox.geometry
// .bbox_overlaps so that the kernels equal their plain versions: one
// __device__ function serves both passes, every step is an explicitly rounded
// intrinsic in bbox_overlaps' order (+1 areas, 1e-10 denominator floor), the
// division is __fdiv_rn, and the build passes --fmad=false and no fast-math.
// dx/dy follow bbox2delta step by step; dw/dh go through logf, which may
// differ from torch.log in the last place.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;      // anchors per thread in pass 1
constexpr int kMaxGts = 128;
constexpr float kNeg = -2.0f;  // below the masked value (-1)

// shared copy of one image's gt table: x1 y1 x2 y2 label valid area
struct GtTable {
  float v[kMaxGts][7];
};

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f), __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

__device__ __forceinline__ void load_gts(GtTable& t, const float* __restrict__ gt, int num_gts) {
  for (int g = threadIdx.x; g < num_gts; g += kThreads) {
    const float* src = gt + (size_t)g * 6;
    for (int k = 0; k < 6; ++k) t.v[g][k] = src[k];
    t.v[g][6] = box_area(src[0], src[1], src[2], src[3]);
  }
}

// IoU of anchor a with gt g, -1 where the gt is padding or the anchor is
// left out.  The same machine code in both passes.
__device__ __forceinline__ float masked_iou(const float4 a, float area_a, bool a_valid,
                                            const float* g) {
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, g[2]), fmaxf(a.x, g[0])), 1.0f), 0.0f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, g[3]), fmaxf(a.y, g[1])), 1.0f), 0.0f);
  const float overlap = __fmul_rn(iw, ih);
  const float iou = __fdiv_rn(overlap, fmaxf(__fsub_rn(__fadd_rn(g[6], area_a), overlap), 1e-10f));
  return (g[5] > 0.0f && a_valid) ? iou : -1.0f;
}

// max of floats of either sign through the integer atomics
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.0f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// grid (anchor blocks of kThreads * kItems, image); gtmax holds kNeg on entry.
__global__ void assign_gtmax_kernel(const float4* __restrict__ anchors,
                                    const unsigned char* __restrict__ valid,
                                    const float* __restrict__ gt_table,
                                    float* __restrict__ gtmax, int num_anchors, int num_gts) {
  __shared__ GtTable gts;
  __shared__ float warp_max[kWarps][kMaxGts];
  const int b = blockIdx.y;
  load_gts(gts, gt_table + (size_t)b * num_gts * 6, num_gts);

  float4 a[kItems];
  float area[kItems];
  bool av[kItems];
  const int base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = base + k * kThreads;
    const bool in = idx < num_anchors;  // the ragged edge counts as left out
    a[k] = in ? anchors[idx] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    av[k] = in && valid[(size_t)b * num_anchors + idx] != 0;
    area[k] = box_area(a[k].x, a[k].y, a[k].z, a[k].w);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = 0; g < num_gts; ++g) {
    float m = kNeg;
#pragma unroll
    for (int k = 0; k < kItems; ++k) m = fmaxf(m, masked_iou(a[k], area[k], av[k], gts.v[g]));
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) warp_max[warp][g] = m;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < num_gts; g += kThreads) {
    float m = warp_max[0][g];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w][g]);
    atomic_max_float(gtmax + (size_t)b * num_gts + g, m);
  }
}

struct AssignParams {
  float pos_iou_thr, neg_iou_thr, min_pos_iou, pos_weight;
  float mean[4], std[4];
};

// grid (anchor blocks of kThreads, image); one thread per anchor.
__global__ void assign_targets_kernel(const float4* __restrict__ anchors,
                                      const unsigned char* __restrict__ valid,
                                      const float* __restrict__ gt_table,
                                      const float* __restrict__ gtmax,
                                      int* __restrict__ labels, float* __restrict__ label_weights,
                                      float* __restrict__ pos_mask,
                                      float4* __restrict__ bbox_targets,
                                      float4* __restrict__ pos_gt_boxes, int num_anchors,
                                      int num_gts, AssignParams p) {
  __shared__ GtTable gts;
  __shared__ float gmax[kMaxGts];
  __shared__ unsigned char gt_ok[kMaxGts];
  const int b = blockIdx.y;
  load_gts(gts, gt_table + (size_t)b * num_gts * 6, num_gts);
  for (int g = threadIdx.x; g < num_gts; g += kThreads) {
    const float m = gtmax[(size_t)b * num_gts + g];
    gmax[g] = m;
    gt_ok[g] = gt_table[((size_t)b * num_gts + g) * 6 + 5] > 0.0f && m >= p.min_pos_iou;
  }
  __syncthreads();
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= num_anchors) return;

  const float4 a = anchors[idx];
  const bool av = valid[(size_t)b * num_anchors + idx] != 0;
  const float area_a = box_area(a.x, a.y, a.z, a.w);
  float max_ov = kNeg;
  int best = 0, forced = 0;
  for (int g = 0; g < num_gts; ++g) {
    const float iou = masked_iou(a, area_a, av, gts.v[g]);
    if (iou > max_ov) {  // strict: the first maximum stays
      max_ov = iou;
      best = g;
    }
    // anchors tying this gt's maximum are forced positive; the last gt wins
    if (iou == gmax[g] && gt_ok[g] && av) forced = g + 1;
  }
  int assigned = -1;
  if (max_ov >= 0.0f && max_ov < p.neg_iou_thr) assigned = 0;
  if (max_ov >= p.pos_iou_thr) assigned = best + 1;
  if (forced > 0) assigned = forced;

  const bool pos = assigned > 0;
  float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // w = h = 1: the logs stay finite
  int label = 0;
  if (pos) {
    const float* g = gts.v[assigned - 1];
    m = make_float4(g[0], g[1], g[2], g[3]);
    label = (int)g[4];
  }
  const size_t out = (size_t)b * num_anchors + idx;
  labels[out] = label;
  label_weights[out] = pos ? p.pos_weight : (assigned == 0 ? 1.0f : 0.0f);
  pos_mask[out] = pos ? 1.0f : 0.0f;
  pos_gt_boxes[out] = m;

  // bbox2delta, step by step
  const float px = __fmul_rn(__fadd_rn(a.x, a.z), 0.5f);
  const float py = __fmul_rn(__fadd_rn(a.y, a.w), 0.5f);
  const float pw = __fadd_rn(__fsub_rn(a.z, a.x), 1.0f);
  const float ph = __fadd_rn(__fsub_rn(a.w, a.y), 1.0f);
  const float gx = __fmul_rn(__fadd_rn(m.x, m.z), 0.5f);
  const float gy = __fmul_rn(__fadd_rn(m.y, m.w), 0.5f);
  const float gw = __fadd_rn(__fsub_rn(m.z, m.x), 1.0f);
  const float gh = __fadd_rn(__fsub_rn(m.w, m.y), 1.0f);
  float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (pos) {
    d.x = __fdiv_rn(__fsub_rn(__fdiv_rn(__fsub_rn(gx, px), pw), p.mean[0]), p.std[0]);
    d.y = __fdiv_rn(__fsub_rn(__fdiv_rn(__fsub_rn(gy, py), ph), p.mean[1]), p.std[1]);
    d.z = __fdiv_rn(__fsub_rn(logf(__fdiv_rn(gw, pw)), p.mean[2]), p.std[2]);
    d.w = __fdiv_rn(__fsub_rn(logf(__fdiv_rn(gh, ph)), p.mean[3]), p.std[3]);
  }
  bbox_targets[out] = d;
}

}  // namespace

extern "C" {

// anchors (A, 4) f32, valid (batch, A) bool, gt_table (batch, G, 6) f32
// [x1 y1 x2 y2 label valid], gtmax (batch, G) f32 filled with -2 -> gtmax.
int ioudet_assign_gtmax(const float* anchors, const unsigned char* valid, const float* gt_table,
                        float* gtmax, int batch, int num_anchors, int num_gts,
                        cudaStream_t stream) {
  const int blocks = (num_anchors + kThreads * kItems - 1) / (kThreads * kItems);
  assign_gtmax_kernel<<<dim3(blocks, batch), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(anchors), valid, gt_table, gtmax, num_anchors, num_gts);
  return (int)cudaGetLastError();
}

// inputs as above plus gtmax from pass 1 -> labels (batch, A) i32,
// label_weights, pos_mask (batch, A) f32, bbox_targets, pos_gt_boxes
// (batch, A, 4) f32.
int ioudet_assign_targets(const float* anchors, const unsigned char* valid, const float* gt_table,
                          const float* gtmax, int* labels, float* label_weights, float* pos_mask,
                          float* bbox_targets, float* pos_gt_boxes, int batch, int num_anchors,
                          int num_gts, float pos_iou_thr, float neg_iou_thr, float min_pos_iou,
                          float pos_weight, float mean0, float mean1, float mean2, float mean3,
                          float std0, float std1, float std2, float std3, cudaStream_t stream) {
  AssignParams p;
  p.pos_iou_thr = pos_iou_thr;
  p.neg_iou_thr = neg_iou_thr;
  p.min_pos_iou = min_pos_iou;
  p.pos_weight = pos_weight;
  p.mean[0] = mean0; p.mean[1] = mean1; p.mean[2] = mean2; p.mean[3] = mean3;
  p.std[0] = std0; p.std[1] = std1; p.std[2] = std2; p.std[3] = std3;
  const int blocks = (num_anchors + kThreads - 1) / kThreads;
  assign_targets_kernel<<<dim3(blocks, batch), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(anchors), valid, gt_table, gtmax, labels, label_weights,
      pos_mask, reinterpret_cast<float4*>(bbox_targets), reinterpret_cast<float4*>(pos_gt_boxes),
      num_anchors, num_gts, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
