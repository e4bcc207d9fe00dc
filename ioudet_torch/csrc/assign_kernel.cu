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
//   assign_targets_kernel <- _assign_kernel (K2b): per anchor a walk over the
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
// and the per-anchor outputs (44 B) written once, about 79 MB at the flagship
// shape (A = 209,538, B = 8, G = 100).  Computing every (gt, anchor) IoU, as
// the TPU kernel does, is 1.7e8 IoUs a pass of ~30 issued instructions each
// (one IEEE division): that, not the bytes, bound the first port.  But an
// anchor and a gt whose boxes do not meet have an IoU of exactly +0, and on a
// training batch only ~8% of the pairs meet.  So each warp reduces the hull
// (min x1, min y1, max x2, max y2) of its valid anchors, tests every valid gt
// against it with the IoU's own rounded steps, and computes IoUs only for the
// gts that pass (its candidates), in increasing g; the rest are +0 without
// arithmetic.  The test is exact: min/max and the rounded subtraction and +1
// are monotone, so a hull width <= 0 means every anchor's width is <= 0,
// i.e. an intersection of +0 and an IoU of +0.  A warp of pass 1 owns 64
// consecutive anchors, two a thread, so that a gt's box and the warp-wide
// max (one redux) serve two IoUs that run side by side; a warp of pass 2
// owns 32, one a thread, whose outputs it stores.  The coarsest levels' large
// anchors meet the most gts, so their blocks start first.
//
// What the culled pairs give, so that the result equals the full walk's bits:
//   pass 1: a culled valid gt gets +0 from every image with a valid anchor.
//           Block 0 of each image writes that floor once (0, or -1 for a
//           padding gt or an image without a valid anchor); the other blocks
//           merge only IoUs above +0 (integer atomics on the float's bits:
//           a max is the same in any order, the result is deterministic).
//   pass 2: (a) a valid anchor of an image with a valid gt starts at
//           max_ov = +0 and best = the first valid gt (what the full walk
//           holds after the culled gts), else at max_ov = -1 and best = 0;
//           the candidates follow in increasing g with a strict >.
//           (b) a valid gt whose gtmax is exactly 0 ties every anchor that
//           misses it, so it joins every warp's candidates.
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

constexpr int kBlock = 128;           // threads a block
constexpr int kItems = 2;             // anchors a thread in pass 1 (pass 2: one)
constexpr int kMaxGts = 128;
constexpr int kWords = kMaxGts / 32;  // bit masks over the gt slots
constexpr int kScan = 16;             // valid flags a thread reads between syncs

// shared copy of one image's gt table
struct GtTable {
  float4 box[kMaxGts];    // x1 y1 x2 y2
  float area[kMaxGts];
  float label[kMaxGts];
  float gmax[kMaxGts];    // pass 2: gtmax from pass 1
  unsigned valid[kWords]; // bit g: gt g is valid
  unsigned ok[kWords];    // pass 2: valid and gmax >= min_pos_iou
  unsigned zero[kWords];  // pass 2: valid and gmax == 0, rule (b)
};

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f), __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

// the image's gt table into shared memory; with gtmax also its maxima and the
// ok / zero masks of pass 2.  Every thread of a warp runs the same trip count.
__device__ __forceinline__ void load_gts(GtTable& t, const float* __restrict__ gt, int num_gts,
                                         const float* __restrict__ gtmax, float min_pos_iou) {
  for (int g = threadIdx.x; g < kMaxGts; g += kBlock) {
    bool valid = false;
    float m = 0.0f;
    if (g < num_gts) {
      const float* src = gt + (size_t)g * 6;
      const float4 b = make_float4(src[0], src[1], src[2], src[3]);
      t.box[g] = b;
      t.area[g] = box_area(b.x, b.y, b.z, b.w);
      t.label[g] = src[4];
      valid = src[5] > 0.0f;
      if (gtmax != nullptr) m = t.gmax[g] = gtmax[g];
    }
    const unsigned bits = __ballot_sync(0xffffffffu, valid);
    const unsigned ok = __ballot_sync(0xffffffffu, valid && m >= min_pos_iou);
    const unsigned zero = __ballot_sync(0xffffffffu, valid && m == 0.0f);
    if ((threadIdx.x & 31) == 0) {
      t.valid[g >> 5] = bits;
      t.ok[g >> 5] = ok;
      t.zero[g >> 5] = zero;
    }
  }
}

// IoU of anchor a with a gt, as bbox_overlaps computes it.  The same machine
// code in both passes.
__device__ __forceinline__ float anchor_iou(const float4 a, float area_a, const float4 g,
                                            float area_g) {
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, g.z), fmaxf(a.x, g.x)), 1.0f), 0.0f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, g.w), fmaxf(a.y, g.y)), 1.0f), 0.0f);
  const float overlap = __fmul_rn(iw, ih);
  return __fdiv_rn(overlap, fmaxf(__fsub_rn(__fadd_rn(area_g, area_a), overlap), 1e-10f));
}

// a float's order as a signed integer's (and back: the map is its own inverse)
__device__ __forceinline__ int order_bits(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float order_float(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

struct Hull {
  float x1, y1, x2, y2;
};

// the hull of the valid anchors of the warp's threads, N anchors a thread;
// without one, (+inf, +inf, -inf, -inf), which meets no box.  All threads of
// the warp call it.
template <int N>
__device__ __forceinline__ Hull warp_hull(const float4 (&a)[N], const bool (&av)[N]) {
  const float inf = __int_as_float(0x7f800000);
  int x1 = order_bits(inf), y1 = x1, x2 = order_bits(-inf), y2 = x2;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (!av[k]) continue;
    x1 = min(x1, order_bits(a[k].x));
    y1 = min(y1, order_bits(a[k].y));
    x2 = max(x2, order_bits(a[k].z));
    y2 = max(y2, order_bits(a[k].w));
  }
  x1 = __reduce_min_sync(0xffffffffu, x1);
  y1 = __reduce_min_sync(0xffffffffu, y1);
  x2 = __reduce_max_sync(0xffffffffu, x2);
  y2 = __reduce_max_sync(0xffffffffu, y2);
  return Hull{order_float(x1), order_float(y1), order_float(x2), order_float(y2)};
}

// true unless the gt's box and the hull cannot overlap, by the IoU's own
// rounded steps (exact: see the head of the file)
__device__ __forceinline__ bool meets(const Hull& h, const float4 g) {
  return __fadd_rn(__fsub_rn(fminf(h.x2, g.z), fmaxf(h.x1, g.x)), 1.0f) > 0.0f &&
         __fadd_rn(__fsub_rn(fminf(h.y2, g.w), fmaxf(h.y1, g.y)), 1.0f) > 0.0f;
}

// the warp's candidates: bit g of word g / 32 set for each valid gt g that
// meets the hull; lane l tests gts l, l + 32, ...
__device__ __forceinline__ void candidates(const GtTable& t, const Hull& h, int num_gts,
                                           unsigned (&cand)[kWords]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int g = w * 32 + lane;
    bool hit = false;
    if (g < num_gts && (t.valid[w] >> lane & 1u)) hit = meets(h, t.box[g]);
    cand[w] = w * 32 < num_gts ? __ballot_sync(0xffffffffu, hit) : 0u;
  }
}

// the block's (image, anchor block) on a grid of batch x blocks: the last
// anchor blocks (the coarsest levels, whose large anchors meet the most gts)
// start first, the images side by side, so that the longest blocks do not
// trail the grid
__device__ __forceinline__ int2 block_place(int batch) {
  const int blocks = gridDim.x / batch;
  return make_int2(blockIdx.x % batch, blocks - 1 - blockIdx.x / batch);
}

// max of floats of either sign through the integer atomics
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.0f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// block 0 of an image: each gt's value before any overlap is counted, 0 for
// a valid gt of an image with a valid anchor, -1 for the rest.  ``any``
// tells whether this block's anchors (the first kBlock * kItems) hold a
// valid one; if not, the block reads the image's other flags until it finds
// one.
__device__ void image_floor(const unsigned char* __restrict__ row, int num_anchors, bool any,
                            const GtTable& t, float* __restrict__ gtmax, int num_gts) {
  for (int base = kBlock * kItems; !any && base < num_anchors; base += kBlock * kScan) {
    bool found = false;
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      const int i = base + k * kBlock + threadIdx.x;
      found |= i < num_anchors && row[i] != 0;
    }
    any = __syncthreads_or(found);
  }
  for (int g = threadIdx.x; g < num_gts; g += kBlock)
    atomic_max_float(gtmax + g, any && (t.valid[g >> 5] >> (g & 31) & 1u) ? 0.0f : -1.0f);
}

// grid batch x (anchor blocks of kBlock * kItems); a warp owns 32 * kItems
// consecutive anchors, lane l the anchors l, l + 32, ... of them; gtmax
// holds -2 on entry.
__global__ void __launch_bounds__(kBlock)
assign_gtmax_kernel(const float4* __restrict__ anchors, const unsigned char* __restrict__ valid,
                    const float* __restrict__ gt_table, float* __restrict__ gtmax, int batch,
                    int num_anchors, int num_gts) {
  __shared__ GtTable t;
  __shared__ unsigned block_max[kMaxGts];  // bits of the block's largest IoU (>= +0) a gt
  const int2 place = block_place(batch);
  const int b = place.x;
  const int base = place.y * (kBlock * kItems) + (threadIdx.x >> 5) * (32 * kItems) +
                   (threadIdx.x & 31);
  const unsigned char* row = valid + (size_t)b * num_anchors;
  float4 a[kItems];
  float area[kItems];
  bool av[kItems];
  bool mine = false;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = base + 32 * k;
    const bool in = idx < num_anchors;  // the ragged edge counts as left out
    a[k] = in ? anchors[idx] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    av[k] = in && row[idx] != 0;
    area[k] = box_area(a[k].x, a[k].y, a[k].z, a[k].w);
    mine |= av[k];
  }
  float* out = gtmax + (size_t)b * num_gts;
  load_gts(t, gt_table + (size_t)b * num_gts * 6, num_gts, nullptr, 0.0f);
  for (int g = threadIdx.x; g < kMaxGts; g += kBlock) block_max[g] = 0u;
  const bool any = __syncthreads_or(mine);
  if (place.y == 0) image_floor(row, num_anchors, any, t, out, num_gts);
  if (!any) return;

  const Hull h = warp_hull(a, av);
  unsigned cand[kWords];
  candidates(t, h, num_gts, cand);
  const bool lead = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    for (unsigned m = cand[w]; m != 0u; m &= m - 1u) {
      const int g = w * 32 + __ffs(m) - 1;
      const float4 box = t.box[g];
      const float area_g = t.area[g];
      float v = 0.0f;  // IoUs are >= +0: the max of the thread's anchors as bits
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const float iou = anchor_iou(a[k], area[k], box, area_g);
        v = fmaxf(v, av[k] ? iou : 0.0f);
      }
      const unsigned top = __reduce_max_sync(0xffffffffu, __float_as_uint(v));
      if (lead && top != 0u) atomicMax(&block_max[g], top);
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < num_gts; g += kBlock)
    if (block_max[g] != 0u) atomicMax(reinterpret_cast<int*>(out + g), (int)block_max[g]);
}

struct AssignParams {
  float pos_iou_thr, neg_iou_thr, min_pos_iou, pos_weight;
  float mean[4], std[4];
};

// grid batch x (anchor blocks of kBlock); one thread per anchor.
__global__ void __launch_bounds__(kBlock)
assign_targets_kernel(const float4* __restrict__ anchors, const unsigned char* __restrict__ valid,
                      const float* __restrict__ gt_table, const float* __restrict__ gtmax,
                      int* __restrict__ labels, float* __restrict__ label_weights,
                      float* __restrict__ pos_mask, float4* __restrict__ bbox_targets,
                      float4* __restrict__ pos_gt_boxes, int batch, int num_anchors,
                      int num_gts, AssignParams p) {
  __shared__ GtTable t;
  const int2 place = block_place(batch);
  const int b = place.x;
  const int idx = place.y * kBlock + threadIdx.x;
  const bool in = idx < num_anchors;
  const float4 a = in ? anchors[idx] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const bool av = in && valid[(size_t)b * num_anchors + idx] != 0;
  load_gts(t, gt_table + (size_t)b * num_gts * 6, num_gts, gtmax + (size_t)b * num_gts,
           p.min_pos_iou);
  __syncthreads();

  const float4 a1[1] = {a};
  const bool av1[1] = {av};
  const Hull h = warp_hull(a1, av1);
  unsigned cand[kWords];
  candidates(t, h, num_gts, cand);
  int first = kMaxGts;  // the image's first valid gt
#pragma unroll
  for (int w = kWords - 1; w >= 0; --w)
    if (t.valid[w] != 0u) first = w * 32 + __ffs(t.valid[w]) - 1;
  // rule (a): the state after the culled gts
  const bool live = av && first < kMaxGts;
  float max_ov = live ? 0.0f : -1.0f;
  int best = live ? first : 0, forced = 0;
  if (live) {
    const float area_a = box_area(a.x, a.y, a.z, a.w);
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      for (unsigned m = cand[w] | t.zero[w]; m != 0u; m &= m - 1u) {
        const int g = w * 32 + __ffs(m) - 1;
        const float iou = anchor_iou(a, area_a, t.box[g], t.area[g]);
        if (iou > max_ov) {  // strict: the first maximum stays
          max_ov = iou;
          best = g;
        }
        // anchors tying this gt's maximum are forced positive; the last gt wins
        if (iou == t.gmax[g] && (t.ok[w] >> (g & 31) & 1u)) forced = g + 1;
      }
    }
  }
  if (!in) return;
  int assigned = -1;
  if (max_ov >= 0.0f && max_ov < p.neg_iou_thr) assigned = 0;
  if (max_ov >= p.pos_iou_thr) assigned = best + 1;
  if (forced > 0) assigned = forced;

  const bool pos = assigned > 0;
  float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // w = h = 1: the logs stay finite
  int label = 0;
  if (pos) {
    m = t.box[assigned - 1];
    label = (int)t.label[assigned - 1];
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
  const int blocks = (num_anchors + kBlock * kItems - 1) / (kBlock * kItems);
  assign_gtmax_kernel<<<blocks * batch, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(anchors), valid, gt_table, gtmax, batch, num_anchors,
      num_gts);
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
  const int blocks = (num_anchors + kBlock - 1) / kBlock;
  assign_targets_kernel<<<blocks * batch, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(anchors), valid, gt_table, gtmax, labels, label_weights,
      pos_mask, reinterpret_cast<float4*>(bbox_targets), reinterpret_cast<float4*>(pos_gt_boxes),
      batch, num_anchors, num_gts, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
