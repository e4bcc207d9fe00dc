// The tiled tensor-core product for Hopper (sm_90a) on warpgroup mma: TMA
// loads into a ring of shared-memory stages, wgmma.mma_async from shared
// memory, persistent blocks, and an epilogue that either hands back the raw
// accumulators or dequantizes them; the same product for operands off TMA's
// 16-byte grid; the chain of dependent products on clusters that pass
// their rows through distributed shared memory; and the sum of independent
// perturbed products, A perturbed in registers, K split over a cluster.
// Behind a plain C interface loaded with ctypes by
// ioudet_torch/ops/mma_cuda.py.  Built there with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -ldl
//
// wgmma_kernel  replaces pallas_matmul / _mm_kernel of
//   tools/probe_pallas_int8_matmul.py (P3), as tiled_kernel<.., ACCUM=false> of
//   mma_kernel.cu did before it: C (M, N) = A (M, K) x Bt (N, K)^T, int8 ->
//   int32 or bf16 -> f32, for any M and N and any K whose row pitch is a
//   multiple of 16 bytes with 16-byte aligned bases (what TMA asks of a
//   tensor; other operands go to its unaligned form, below).  Its int8 form with
//   the dequantize epilogue carries every quantized convolution of the serving
//   path (ioudet_torch/ops/quant.py):
//     out[m, n] = cast(float(acc[m, n]) * scale[n] + bias[n])
//   in two rounded steps (no fused multiply-add), bit for bit what the three
//   torch passes it replaces gave.
//   Bound: operations for the probe's 4096^3 (137 GOP over 50 MB of operands);
//   bytes for most convolution shapes, where N is 64..256, K is 64..2304 and A
//   has up to 4.5 million rows.  There the int32 output was 60% of the bytes;
//   written as bf16 by this kernel it is half of them, and the passes that
//   read the int32 tensor again are gone.
//   Design: a block is three warpgroups.  One lane of the third (the
//   producer, its registers cut to 40 by setmaxnreg) issues TMA loads of a 128
//   x 128-byte box of A and half of a BN x 128-byte box of Bt per slab of K
//   into a ring of 4 (BN 256), 6 (BN 128) or 8 (BN 64) stages of 192 KB in
//   all, with the 128-byte swizzle; TMA fills what lies past M, N or K with
//   zeros, so no thread masks a load or computes an address (a box that lies
//   wholly past M or N is not loaded at all: what it would feed is never
//   stored).  Each of the two
//   consumer warpgroups (232 registers) owns 64 rows of the tile and runs four
//   m64nBNk32.s8 (or k16.bf16) steps per slab straight from the swizzled
//   stage through shared-memory descriptors, keeping one slab's group in
//   flight while the next is issued; full and empty mbarriers, whose stage
//   and parity run on across tiles, pass the stages back and forth.  Blocks
//   are persistent, one per SM at most, and run as clusters of two on
//   neighbouring row tiles of one column tile: each block loads its own box of
//   A and half of the box of Bt, which TMA multicasts into both blocks, so a
//   slab costs a block 32 KB from the L2 and not 48 (at 48 the loads, not the
//   products, bounded the kernel at 4096^3); a stage goes back to the
//   producers when the consumers of both blocks have arrived on its empty
//   barrier (a plain arrive through mapa: with .release.cluster on it the
//   kernel ran 1.5 times as long).  Clusters walk the tile pairs n fastest,
//   so the blocks running together share rows of A through the L2 and the
//   small Bt stays there; the producer runs ahead into the next tile's slabs
//   while the consumers are in their epilogue.  The epilogue goes through
//   shared memory in chunks of 16 rows x 128 bytes of output per warp.  Where
//   the output's row pitch is a multiple of 16 bytes a warp writes the chunk,
//   swizzled so that the fragment stores stay off each other's banks, into
//   one of its two buffers, and lane 0 hands it to a TMA store, which drains
//   it (and clips it at M and N) while the warp converts its next chunk or
//   runs the next tile's products.  Any other N stages the chunk on a padded
//   pitch, reads it back and writes it with masked element stores.  A wait
//   that outlasts a watchdog of some seconds traps instead of hanging the
//   card.
//
// wgmma_kernel<.., TMA=false>  replaces the same P3 for operands whose row
//   pitch or base is off the 16-byte grid (tiled_kernel<.., ACCUM=false> of
//   mma_kernel.cu took them before, its 16 one-byte loads a chunk issued by
//   the threads that ran the products).  Bound: bytes by the count (2 us at
//   the probe's (1024, 1023) x (1023, 1023)); what holds it is the path that
//   feeds the stages, since TMA cannot.  Design: the consumers, the ring, the
//   barriers, persistence and the epilogue are the aligned kernel's; the
//   producer is a whole warpgroup that reads each stage through registers
//   (aligned 16-byte words shifted into place, see "loads off the 16-byte
//   grid"), fences its writes for the async proxy and arrives, 128 threads,
//   on the stage's full barrier.  Clusters are of one block (multicast needs
//   TMA) and tiles at most 128 wide, so no thread's registers move.
//
// chain_wgmma_kernel  replaces _call / _int8_kernel, _bf16_kernel of
//   tools/probe_mxu_rate.py (P1), as chain_kernel of mma_kernel.cu did before
//   it: `loop` dependent products y <- requant(y @ b) inside one kernel,
//   clip((acc >> 9), -127, 127) or bf16(acc * scale), N == K, nothing to
//   device memory inside the loop.  Bound: operations by the count, but each
//   step depends on the last, and b (4-8 MB) does not fit in one SM: every
//   step streams it again.  The mma.sync kernel gave each 16-row band a block,
//   so 32 blocks read all of b from the L2 at every step.  Design: a cluster
//   owns a band of 64 rows (one wgmma M) and each of its cs blocks a slice of
//   N columns (128 or 256; cs up to 16, asked of the card by occupancy), so
//   the L2 traffic a step falls to one b per cluster, spread over cs SMs:
//   the block's TMA thread streams its slice of b through a ring.  A block
//   keeps only its own slice of y, twice (this step's and the next); after a
//   step its consumers requantize their accumulators into the other buffer,
//   and its pusher sends each of its slabs of y (64 rows x 128 bytes) to
//   every block of the cluster with cp.async.bulk through distributed shared
//   memory, into a ring of y stages of their own, counted on the receiving
//   block's barrier.  A stage of that ring is handed to the block that owns
//   its next slab once this block's consumers are done with it (a remote
//   arrive per slab), so the pushes of the next step's first slabs start as
//   soon as their owner has written them and run ahead of the products.
//
// accum_wgmma_kernel  replaces _call / _int8_kernel, _bf16_kernel of
//   tools/probe_mxu_rate2.py (P2), as tiled_kernel<.., ACCUM=true> of
//   mma_kernel.cu did before it: `loop` independent products summed,
//   acc += (a XOR int8(i)) @ b  or  acc += bf16(a + bf16(i)) @ b, every one
//   of them run on the tensor cores.  Bound: operations (loop x the product
//   over the same 3-6 MB of operands).  The mma.sync kernel ran its slabs
//   product by product, so every product streamed the tile's rows of A and
//   B from the L2 again (3.2 GB a launch in int8 at the probe's shape) and
//   the feed, not the tensor cores, set its pace.  Design: slab-major.  A
//   stage of A (128 rows x 128 bytes) and Bt (BN rows) arrives once by TMA,
//   and the consumers run all `loop` products on it before they hand it
//   back, so the loads fall by the factor `loop`.  A is perturbed in
//   registers for the register-A form of wgmma: each consumer warp takes its
//   16 rows of the stage with ldmatrix and for each i makes a perturbed copy
//   (xor.b32 with int8(i) in every byte, or add.rn.bf16x2 with bf16(i): the
//   bf16 sum rounded once, as the f32 sum rounded to bf16 is), into one of
//   two sets of registers in turn, so that the next copy is made while the
//   last group runs; B stays behind a shared-memory descriptor.  At the
//   probe's 512 x 2048 outputs there are only 64 tiles of 128 x 128, so K is
//   split over a cluster of ks blocks (mma_cuda.accum_plan): each sums its
//   share of the slabs, stages its accumulators in its idle ring, and block
//   r adds the ks partials of its rows through distributed shared memory,
//   block 0 first (the same bits on every run), and stores them with the
//   raw epilogue.  Tiles are at most 128 wide: at 256 the accumulators and
//   the three sets of A need more registers than a thread of this block has.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 384;          // two consumer warpgroups and the producer's
constexpr int kBM = 128;               // rows of a tile: 64 per consumer warpgroup
constexpr int kSlab = 128;             // bytes of K per stage: the swizzle's width
constexpr int kABytes = kBM * kSlab;   // one stage of A
constexpr int kRingBytes = 192 * 1024;
constexpr int kChunkBytes = 16 * 128;              // a warp's chunk of output: 16 rows x 128 bytes
constexpr int kWarpOutBytes = 2 * kChunkBytes;     // two buffers (or one on a padded pitch)
constexpr int kStageOutBytes = 8 * kWarpOutBytes;  // 8 consumer warps
constexpr long long kWatchdogCycles = 4000000000LL;

constexpr int EPI_RAW = 0, EPI_BF16 = 1, EPI_F32 = 2;

// Operand lists of the wgmma instructions: the accumulator registers of a
// thread, 32 for a tile 64 wide, 64 for 128, 128 for 256.
#define WGMMA_D32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"

#define WGMMA_O32(C, d) \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), \
  C(d[6]), C(d[7]), C(d[8]), C(d[9]), C(d[10]), C(d[11]), \
  C(d[12]), C(d[13]), C(d[14]), C(d[15]), C(d[16]), C(d[17]), \
  C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]), \
  C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]), C(d[29]), \
  C(d[30]), C(d[31])

#define WGMMA_D64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

#define WGMMA_O64(C, d) \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), \
  C(d[6]), C(d[7]), C(d[8]), C(d[9]), C(d[10]), C(d[11]), \
  C(d[12]), C(d[13]), C(d[14]), C(d[15]), C(d[16]), C(d[17]), \
  C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]), \
  C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]), C(d[29]), \
  C(d[30]), C(d[31]), C(d[32]), C(d[33]), C(d[34]), C(d[35]), \
  C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]), \
  C(d[42]), C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), \
  C(d[48]), C(d[49]), C(d[50]), C(d[51]), C(d[52]), C(d[53]), \
  C(d[54]), C(d[55]), C(d[56]), C(d[57]), C(d[58]), C(d[59]), \
  C(d[60]), C(d[61]), C(d[62]), C(d[63])

#define WGMMA_D128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

#define WGMMA_O128(C, d) \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), \
  C(d[6]), C(d[7]), C(d[8]), C(d[9]), C(d[10]), C(d[11]), \
  C(d[12]), C(d[13]), C(d[14]), C(d[15]), C(d[16]), C(d[17]), \
  C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]), \
  C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]), C(d[29]), \
  C(d[30]), C(d[31]), C(d[32]), C(d[33]), C(d[34]), C(d[35]), \
  C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]), \
  C(d[42]), C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), \
  C(d[48]), C(d[49]), C(d[50]), C(d[51]), C(d[52]), C(d[53]), \
  C(d[54]), C(d[55]), C(d[56]), C(d[57]), C(d[58]), C(d[59]), \
  C(d[60]), C(d[61]), C(d[62]), C(d[63]), C(d[64]), C(d[65]), \
  C(d[66]), C(d[67]), C(d[68]), C(d[69]), C(d[70]), C(d[71]), \
  C(d[72]), C(d[73]), C(d[74]), C(d[75]), C(d[76]), C(d[77]), \
  C(d[78]), C(d[79]), C(d[80]), C(d[81]), C(d[82]), C(d[83]), \
  C(d[84]), C(d[85]), C(d[86]), C(d[87]), C(d[88]), C(d[89]), \
  C(d[90]), C(d[91]), C(d[92]), C(d[93]), C(d[94]), C(d[95]), \
  C(d[96]), C(d[97]), C(d[98]), C(d[99]), C(d[100]), C(d[101]), \
  C(d[102]), C(d[103]), C(d[104]), C(d[105]), C(d[106]), C(d[107]), \
  C(d[108]), C(d[109]), C(d[110]), C(d[111]), C(d[112]), C(d[113]), \
  C(d[114]), C(d[115]), C(d[116]), C(d[117]), C(d[118]), C(d[119]), \
  C(d[120]), C(d[121]), C(d[122]), C(d[123]), C(d[124]), C(d[125]), \
  C(d[126]), C(d[127])

// One m64nNk32.s8 / m64nNk16.bf16 step: d += A (64 rows x 32 bytes of K) x B
// (N rows x 32 bytes of K)^T, both K-major in shared memory behind
// descriptors, into int (s32) or float accumulators.  The predicate is
// scale-d: 1 keeps what d holds.
#define WGMMA_STEP(INSTR, DLIST, DA, DB, P, TAIL, OLIST)                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n" INSTR " {" DLIST \
               "}, " DA ", " DB ", p" TAIL ";\n}\n"                              \
               : OLIST                                                          \
               : "l"(da), "l"(db), "r"(1))

__device__ __forceinline__ void wgmma_step(int (&d)[32], uint64_t da, uint64_t db) {
  WGMMA_STEP("wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8", WGMMA_D32, "%32", "%33", "%34",
             "", WGMMA_O32("+r", d));
}

__device__ __forceinline__ void wgmma_step(float (&d)[32], uint64_t da, uint64_t db) {
  WGMMA_STEP("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16", WGMMA_D32, "%32", "%33",
             "%34", ", 1, 1, 0, 0", WGMMA_O32("+f", d));
}

__device__ __forceinline__ void wgmma_step(int (&d)[64], uint64_t da, uint64_t db) {
  WGMMA_STEP("wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8", WGMMA_D64, "%64", "%65",
             "%66", "", WGMMA_O64("+r", d));
}

__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da, uint64_t db) {
  WGMMA_STEP("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16", WGMMA_D64, "%64", "%65",
             "%66", ", 1, 1, 0, 0", WGMMA_O64("+f", d));
}

__device__ __forceinline__ void wgmma_step(int (&d)[128], uint64_t da, uint64_t db) {
  WGMMA_STEP("wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8", WGMMA_D128, "%128", "%129",
             "%130", "", WGMMA_O128("+r", d));
}

__device__ __forceinline__ void wgmma_step(float (&d)[128], uint64_t da, uint64_t db) {
  WGMMA_STEP("wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16", WGMMA_D128, "%128",
             "%129", "%130", ", 1, 1, 0, 0", WGMMA_O128("+f", d));
}

// The same step with A (this warp's 16 rows x 32 bytes of K) from four
// registers of the thread (the fragment of an m16n8k16 / m16n8k32 mma.sync:
// rows g and g + 8, bytes 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3) and only
// B behind a descriptor.
#define WGMMA_STEP_RS(INSTR, DLIST, A4, DB, P, TAIL, OLIST)                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n" INSTR " {" DLIST "}, {" \
               A4 "}, " DB ", p" TAIL ";\n}\n"                                         \
               : OLIST                                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

__device__ __forceinline__ void wgmma_step_rs(int (&d)[32], const uint32_t* a, uint64_t db) {
  WGMMA_STEP_RS("wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8", WGMMA_D32,
                "%32, %33, %34, %35", "%36", "%37", "", WGMMA_O32("+r", d));
}

__device__ __forceinline__ void wgmma_step_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  WGMMA_STEP_RS("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16", WGMMA_D32,
                "%32, %33, %34, %35", "%36", "%37", ", 1, 1, 0", WGMMA_O32("+f", d));
}

__device__ __forceinline__ void wgmma_step_rs(int (&d)[64], const uint32_t* a, uint64_t db) {
  WGMMA_STEP_RS("wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8", WGMMA_D64,
                "%64, %65, %66, %67", "%68", "%69", "", WGMMA_O64("+r", d));
}

__device__ __forceinline__ void wgmma_step_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  WGMMA_STEP_RS("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16", WGMMA_D64,
                "%64, %65, %66, %67", "%68", "%69", ", 1, 1, 0", WGMMA_O64("+f", d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins the accumulators where they are: the compiler may neither move them
// nor touch them across this point while a wgmma group is still in flight
// (a copy in between would make ptxas serialize the group's instructions).
__device__ __forceinline__ void pin(int& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }

template <typename AccT, int N>
__device__ __forceinline__ void pin(AccT (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(acc[i]);
}

// Shared-memory descriptor of a K-major operand whose rows are 128 bytes,
// swizzled as TMA's SWIZZLE_128B leaves them: start address in 16-byte
// units, leading offset 1 (unused by this layout), 1024 bytes from one group
// of 8 rows to the next, layout type 1 (128-byte swizzle).  A step of 32 bytes
// along K inside the slab adds 2 to the address field.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the barrier has left the phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWatchdogCycles) __trap();
}

// One box of a 2-d tensor (c0 along K in bytes, c1 the row) into shared
// memory; its bytes are counted on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same into both blocks of the cluster, at this offset of each one's
// shared memory; the bytes are counted on each block's own barrier there.
__device__ __forceinline__ void tma_load_pair(uint32_t dst, const CUtensorMap* map, int c0,
                                              int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "h"(static_cast<uint16_t>(3))
      : "memory");
}

// Arrive on the barrier at this offset of block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(bar), "r"(rank) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// All threads of both blocks of the cluster meet.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One box of shared memory (dense rows of 128 bytes, swizzled) to the 2-d
// tensor at (c0 bytes, c1 rows); what lies outside the tensor is not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// Close this thread's group of stores (it may be empty) ...
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// ... and wait until all but the N newest groups have read their shared
// memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------- loads off the 16-byte grid
//
// An operand whose row pitch or base is not a multiple of 16 bytes cannot
// go through TMA.  The producer warpgroup of the unaligned kernel reads it
// instead, half a row of a slab (64 bytes) at a time: the aligned 16-byte
// words that cover those bytes (at most five), shifted into place by the
// span's byte offset mod 16 with funnel shifts, the bytes past the row's end
// zeroed, and written as four 16-byte words into the 128-byte swizzled stage
// row that the wgmma descriptors read.  Over-reads are avoided, not argued:
// a word is loaded whole only if it lies wholly inside the tensor; the first
// word of its first row and the last word of its last row, which may not,
// are read byte by byte, and only the bytes of the span.

struct Span {
  uint4 w[5];     // the aligned words that cover the span, zeros past them
  uint32_t sh;    // the span's byte offset in its first word
  int n;          // bytes of the span inside the row: 0..64
};

// The 16 bytes at p, byte by byte where they reach outside [lo, hi); only
// the bytes of [want_lo, want_hi) are read (the others are zero).
__device__ __forceinline__ uint4 load_word(uintptr_t p, uintptr_t lo, uintptr_t hi,
                                           uintptr_t want_lo, uintptr_t want_hi) {
  if (p >= lo && p + 16 <= hi) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (p + j >= want_lo && p + j < want_hi)
      w[j >> 2] |= static_cast<uint32_t>(*reinterpret_cast<const uint8_t*>(p + j)) << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bytes k .. k + 63 of row `row` of the (rows, row_bytes) matrix at base.
__device__ __forceinline__ void span_load(Span& s, const uint8_t* __restrict__ base,
                                          long long row, int rows, long long k,
                                          long long row_bytes) {
  s.n = 0;
  s.sh = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) s.w[i] = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || k >= row_bytes) return;
  const long long left = row_bytes - k;
  s.n = left < 64 ? static_cast<int>(left) : 64;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(base);
  const uintptr_t hi = lo + static_cast<uintptr_t>(rows) * row_bytes;
  const uintptr_t p = lo + row * row_bytes + k;
  s.sh = static_cast<uint32_t>(p & 15u);
  const uintptr_t first = p - s.sh;
  const int words = static_cast<int>((s.sh + s.n + 15) >> 4);   // 1..5, each holding a byte of the span
#pragma unroll
  for (int i = 0; i < 5; ++i)
    if (i < words) s.w[i] = load_word(first + 16 * i, lo, hi, p, p + s.n);
}

// The span into chunks 4h .. 4h + 3 of a 128-byte swizzled stage row r.
__device__ __forceinline__ void span_store(const Span& s, uint8_t* stage_row, int r, int h) {
  const uint32_t u[20] = {s.w[0].x, s.w[0].y, s.w[0].z, s.w[0].w, s.w[1].x, s.w[1].y, s.w[1].z,
                          s.w[1].w, s.w[2].x, s.w[2].y, s.w[2].z, s.w[2].w, s.w[3].x, s.w[3].y,
                          s.w[3].z, s.w[3].w, s.w[4].x, s.w[4].y, s.w[4].z, s.w[4].w};
  const uint32_t d = s.sh >> 2, shift = 8 * (s.sh & 3u);
  uint32_t v[17];   // u from the span's first 4-byte word on, chosen without indexing
#pragma unroll
  for (int i = 0; i < 17; ++i) {
    const uint32_t u1 = i + 1 < 20 ? u[i + 1] : 0u, u2 = i + 2 < 20 ? u[i + 2] : 0u,
                   u3 = i + 3 < 20 ? u[i + 3] : 0u;
    v[i] = d == 0 ? u[i] : d == 1 ? u1 : d == 2 ? u2 : u3;
  }
  uint32_t o[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    o[j] = __funnelshift_r(v[j], v[j + 1], shift);
    const int keep = s.n - 4 * j;   // bytes of this word inside the row
    if (keep < 4) o[j] &= keep <= 0 ? 0u : (1u << (8 * keep)) - 1u;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int q = 4 * h + c;
    *reinterpret_cast<uint4*>(stage_row + ((q ^ (r & 7)) << 4)) =
        make_uint4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
  }
}

template <int BN> struct Ring {
  static constexpr int stage_bytes = kABytes + BN * kSlab;
  static constexpr int stages = kRingBytes / stage_bytes;   // 8, 6, 4
  static constexpr int smem_bytes = 1024 + kRingBytes + kStageOutBytes + 2 * stages * 8;
};

// One accumulator to the output's type: the raw bits, or
// cast(float(acc) * scale + bias) in separately rounded steps.
template <int EPI, typename AccT>
__device__ __forceinline__ uint32_t finish(AccT v, float scale, float bias, bool has_bias) {
  if constexpr (EPI == EPI_RAW) {
    if constexpr (std::is_same<AccT, float>::value)
      return __float_as_uint(v);
    else
      return static_cast<uint32_t>(v);
  } else {
    float f = __fmul_rn(__int2float_rn(static_cast<int>(v)), scale);
    if (has_bias) f = __fadd_rn(f, bias);
    if constexpr (EPI == EPI_F32)
      return __float_as_uint(f);
    else
      return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
  }
}

// A warp's 16 rows x BN columns of accumulators to global memory, 128 bytes
// of output per row at a time through the warp's own staging buffers.  Lane
// (g, t) = (lane / 4, lane % 4) holds, for each group j of 8 columns,
// acc[4j], acc[4j + 1] at row g and acc[4j + 2], acc[4j + 3] at row g + 8,
// columns 8j + 2t and 8j + 2t + 1.  `stores` counts the warp's TMA stores:
// its parity picks the buffer.
template <int BN, int EPI, typename AccT>
__device__ __forceinline__ void store_tile(const AccT (&acc)[BN / 2], uint8_t* stg,
                                           const CUtensorMap* map_out,
                                           uint8_t* __restrict__ out,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, long long row0,
                                           int n0, int M, int N, bool tma_out,
                                           uint32_t& stores) {
  constexpr int OS = EPI == EPI_BF16 ? 2 : 4;      // bytes of an output element
  constexpr int CH = 128 / OS;                      // columns of a chunk
  constexpr int PITCH = OS == 4 ? 160 : 144;        // of the path without TMA
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool has_bias = bias != nullptr;
#pragma unroll
  for (int c = 0; c < BN / CH; ++c) {
    uint8_t* buf = stg + (tma_out ? (stores & 1u) * kChunkBytes : 0);
    // the buffer is free: its TMA store of two chunks ago, or the read-out of
    // the chunk before, is over
    if (tma_out && lane == 0) tma_store_wait_read<1>();
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < CH / 8; ++jj) {
      const int j = c * (CH / 8) + jj;
      const int col = jj * 8 + 2 * t;
      float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
      if constexpr (EPI != EPI_RAW) {
        const int gc = n0 + c * CH + col;
        if (gc < N) s0 = __ldg(scale + gc);
        if (gc + 1 < N) s1 = __ldg(scale + gc + 1);
        if (has_bias && gc < N) b0 = __ldg(bias + gc);
        if (has_bias && gc + 1 < N) b1 = __ldg(bias + gc + 1);
      }
      const uint32_t v0 = finish<EPI>(acc[4 * j], s0, b0, has_bias);
      const uint32_t v1 = finish<EPI>(acc[4 * j + 1], s1, b1, has_bias);
      const uint32_t v2 = finish<EPI>(acc[4 * j + 2], s0, b0, has_bias);
      const uint32_t v3 = finish<EPI>(acc[4 * j + 3], s1, b1, has_bias);
      // rows g and g + 8; for TMA dense rows of 128 bytes whose 16-byte piece
      // p sits at p ^ (row % 8), else the padded pitch
      const int byte = col * OS;
      uint8_t* lo = buf + (tma_out ? g * 128 + ((((byte >> 4) ^ g) << 4) | (byte & 15))
                                   : g * PITCH + byte);
      uint8_t* hi = lo + 8 * (tma_out ? 128 : PITCH);
      if constexpr (OS == 4) {
        *reinterpret_cast<uint2*>(lo) = make_uint2(v0, v1);
        *reinterpret_cast<uint2*>(hi) = make_uint2(v2, v3);
      } else {
        *reinterpret_cast<uint32_t*>(lo) = v0 | (v1 << 16);
        *reinterpret_cast<uint32_t*>(hi) = v2 | (v3 << 16);
      }
    }
    if (tma_out) {
      // the warp's writes become visible to the TMA unit, then lane 0 issues
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        if (row0 < M && n0 + c * CH < N)   // else the whole box lies outside
          tma_store(map_out, static_cast<uint32_t>(__cvta_generic_to_shared(buf)),
                    (n0 + c * CH) * OS, static_cast<int>(row0));
        tma_store_commit();   // one group a chunk, so that the waits count chunks
      }
      ++stores;
      continue;
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {   // 4 rows of 8 lanes x 16 bytes
      const int r = it * 4 + (lane >> 3), q = lane & 7;
      const uint4 val = *reinterpret_cast<const uint4*>(buf + r * PITCH + q * 16);
      const long long grow = row0 + r;
      const int gcol = n0 + c * CH + q * (16 / OS);
      if (grow < M && gcol < N) {
        uint8_t* dst = out + (grow * N + gcol) * OS;
        const uint32_t w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
        for (int e = 0; e < 16 / OS; ++e) {
          if (gcol + e < N) {
            if constexpr (OS == 4)
              reinterpret_cast<uint32_t*>(dst)[e] = w[e];
            else
              reinterpret_cast<uint16_t*>(dst)[e] =
                  static_cast<uint16_t>(w[e >> 1] >> (16 * (e & 1)));
          }
        }
      }
    }
  }
}

// out (M, N) = A (M, K) x Bt (N, K)^T through the maps of A and Bt (bytes,
// boxes of 128 x 128 and BN / 2 x 128), kslabs slabs of 128 bytes of K;
// map_out (boxes of 16 rows x 128 bytes) is read only if tma_out.  Blocks run
// as clusters of two.  Cluster c takes the tile pairs c, c + gridDim.x / 2,
// ...; pair p is the row tiles 2 (p / n_tiles) and 2 (p / n_tiles) + 1 of
// column tile p % n_tiles, one for each block of the cluster (the second may
// lie past M: its block then loads no A and stores nothing).  Dynamic shared
// memory: Ring<BN>::smem_bytes.
//
// TMA false is the unaligned kernel: a_raw and bt_raw with row pitch
// row_bytes are read by the producer warpgroup as above (the maps of A and
// Bt are not read), clusters are of one block, and unit p is row tile
// p / n_tiles of column tile p % n_tiles.  BN is 64 or 128 there, so that
// every thread keeps the kernel's 168 registers and none is moved.
template <bool INT8, int BN, int EPI, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b,
             const __grid_constant__ CUtensorMap map_out, uint8_t* __restrict__ out,
             const float* __restrict__ scale, const float* __restrict__ bias, int M, int N,
             int kslabs, int n_tiles, int pairs, int tma_out,
             const uint8_t* __restrict__ a_raw, const uint8_t* __restrict__ bt_raw,
             long long row_bytes) {
  constexpr int STAGES = Ring<BN>::stages, STAGE_BYTES = Ring<BN>::stage_bytes;
  constexpr int HALF_BYTES = BN / 2 * kSlab;   // half of a stage of Bt
  constexpr int CL = TMA ? 2 : 1;              // blocks of a cluster
  static_assert(TMA || BN <= 128, "the unaligned kernel keeps its registers unmoved");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023u) & ~1023u;   // the swizzle repeats every 1024 bytes
  uint8_t* stage_out = smem_raw + (ring - raw) + kRingBytes;
  const uint32_t full = ring + kRingBytes + kStageOutBytes;   // STAGES barriers, then
  const uint32_t empty = full + STAGES * 8;                   // STAGES more
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / CL, clusters = gridDim.x / CL;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // the producer's arrive with the byte count, or every producer thread's
      mbar_init(full + s * 8, TMA ? 1 : 128);
      mbar_init(empty + s * 8, 8 * CL);   // lane 0 of each consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();   // the other block's barriers are there before anything reaches them

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!TMA && warp >= 8) {
    // ------------------------------------------- producer through registers
    const int p = threadIdx.x - 256;
    constexpr int UNITS = 2 * (kBM + BN);   // half rows of a stage: A's box, then Bt's
    int stage = 0;
    uint32_t phase = 0;
    for (int unit = cluster; unit < pairs; unit += clusters) {
      const long long m0 = static_cast<long long>(unit / n_tiles) * kBM;
      const long long n0 = static_cast<long long>(unit % n_tiles) * BN;
      for (int k = 0; k < kslabs; ++k) {
        mbar_wait(empty + stage * 8, phase ^ 1u);   // the consumers have read the stage
        uint8_t* dst = smem_raw + (ring - raw) + stage * STAGE_BYTES;
        const long long kb = static_cast<long long>(k) * kSlab;
        // two half rows in flight a thread: ten 16-byte loads
        for (int u0 = p; u0 < UNITS; u0 += 256) {
          Span s0, s1;
          const int u1 = u0 + 128;
          const int r0 = u0 >> 1, r1 = u1 >> 1;
          if (r0 < kBM) span_load(s0, a_raw, m0 + r0, M, kb + 64 * (u0 & 1), row_bytes);
          else span_load(s0, bt_raw, n0 + r0 - kBM, N, kb + 64 * (u0 & 1), row_bytes);
          if (u1 < UNITS) {
            if (r1 < kBM) span_load(s1, a_raw, m0 + r1, M, kb + 64 * (u1 & 1), row_bytes);
            else span_load(s1, bt_raw, n0 + r1 - kBM, N, kb + 64 * (u1 & 1), row_bytes);
          }
          span_store(s0, dst + r0 * kSlab, r0, u0 & 1);
          if (u1 < UNITS) span_store(s1, dst + r1 * kSlab, r1, u1 & 1);
        }
        // the generic-proxy writes become visible to wgmma, then the arrive
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full + stage * 8);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else if (warp >= 8) {
    // ------------------------------------------------------------ producer
    if constexpr (TMA) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int pair = cluster; pair < pairs; pair += clusters) {
        const int m0 = (2 * (pair / n_tiles) + static_cast<int>(rank)) * kBM;
        const int n0 = (pair % n_tiles) * BN;
        // what arrives in this block's stage: its own box of A if the tile
        // has rows, and each half of the B box that has rows (whole boxes,
        // zero fill included), one half from each block
        const int expect = (m0 < M ? kABytes : 0) + HALF_BYTES +
                           (n0 + BN / 2 < N ? HALF_BYTES : 0);
        const int nh = n0 + static_cast<int>(rank) * (BN / 2);
        for (int k = 0; k < kslabs; ++k) {
          // both blocks' consumers have read the stage (at once the first time round)
          mbar_wait(empty + stage * 8, phase ^ 1u);
          const uint32_t bar = full + stage * 8, dst = ring + stage * STAGE_BYTES;
          mbar_expect_tx(bar, expect);
          if (m0 < M) tma_load(dst, &map_a, k * kSlab, m0, bar);
          if (nh < N)
            tma_load_pair(dst + kABytes + rank * HALF_BYTES, &map_b, k * kSlab, nh, bar);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
      // stay until the other block's consumers have arrived here for the last time
      for (int s = 0; s < STAGES; ++s) {
        mbar_wait(empty + stage * 8, phase ^ 1u);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    if constexpr (TMA) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    typename std::conditional<INT8, int, float>::type acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0, stores = 0;
    for (int pair = cluster; pair < pairs; pair += clusters) {
      const int m0 = (CL * (pair / n_tiles) + static_cast<int>(rank)) * kBM;
      const int n0 = (pair % n_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      pin(acc);
      int prev = 0;
      for (int k = 0; k < kslabs; ++k) {
        mbar_wait(full + stage * 8, phase);
        const uint32_t base = ring + stage * STAGE_BYTES;
        const uint64_t da = smem_desc(base + wg * (64 * kSlab));
        const uint64_t db = smem_desc(base + kABytes);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kSlab / 32; ++ks) wgmma_step(acc, da + 2 * ks, db + 2 * ks);
        wgmma_commit();
        if (k > 0) {   // the slab before has been read: hand its stage back to both blocks
          wgmma_wait<1>();
          pin(acc);
          if (lane == 0) mbar_arrive(empty + prev * 8);
          if (CL == 2 && lane == 1) mbar_arrive_at(empty + prev * 8, rank ^ 1u);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
      pin(acc);
      if (lane == 0) mbar_arrive(empty + prev * 8);
      if (CL == 2 && lane == 1) mbar_arrive_at(empty + prev * 8, rank ^ 1u);
      store_tile<BN, EPI>(acc, stage_out + warp * kWarpOutBytes, &map_out, out, scale, bias,
                          static_cast<long long>(m0) + warp * 16, n0, M, N, tma_out != 0, stores);
    }
    // shared memory outlives the stores that still read it
    if (tma_out && lane == 0) tma_store_wait_read<0>();
  }
}

// ------------------------------------------------------------------- chain

constexpr int kBand = 64;                 // rows of y a cluster owns: one wgmma M
constexpr int kYSlab = kBand * kSlab;     // 8 KB: a slab of K of the band
constexpr int kChainB = 96 * 1024;       // the ring of Bt's slabs
constexpr int kSmemMax = 227 * 1024;

template <bool INT8, int NS> struct Chain {
  static constexpr int size = INT8 ? 1 : 2;
  static constexpr int slice = NS * size;               // bytes of a row of a block's slice
  static constexpr int owned = slice / kSlab;           // slabs of the band a block owns
  static constexpr int chunk = kSlab / size;            // columns of y in a slab: 128, 64
  static constexpr int slice_bytes = kBand * slice;
  static constexpr int b_bytes = NS * kSlab;            // Bt's slice of a slab
  static constexpr int b_stages = kChainB / b_bytes;    // 6 (NS 128), 3 (NS 256)
  // y's slabs take the rest: 14, 12 (int8) or 12, 8 (bf16) stages of 8 KB
  static constexpr int y_stages = (kSmemMax - 1024 - kChainB - 2 * slice_bytes - 512) / kYSlab;
  static constexpr int barriers = 3 * y_stages + 2 * b_stages + 1;
  static constexpr int smem_bytes =
      1024 + kChainB + y_stages * kYSlab + 2 * slice_bytes + barriers * 8;
  static_assert(y_stages >= 8 && barriers * 8 <= 512, "the shared memory plan");
};

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Bytes that the barrier's current phase waits for besides those of its own
// arrive.expect_tx: an arrival-free expect_tx.
__device__ __forceinline__ void mbar_add_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// `bytes` of this block's shared memory at src to the same offset dst of
// block `rank`'s, counted there on the barrier at offset bar.
__device__ __forceinline__ void bulk_push(uint32_t dst, uint32_t src, int bytes, uint32_t bar,
                                          uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 rdst, rbar;\n"
      "mapa.shared::cluster.u32 rdst, %0, %3;\n"
      "mapa.shared::cluster.u32 rbar, %2, %3;\n"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[rdst], [%1], %4, [rbar];\n}\n"
      :: "r"(dst), "r"(src), "r"(bar), "r"(rank), "r"(bytes) : "memory");
}

// Offset, in a block's slice of y, of byte `b` of row r of the slice: the
// slice is `owned` slabs of 64 rows x 128 bytes, swizzled as the ring's
// stages are, so that a slab goes to a stage as one 8 KB copy.
__device__ __forceinline__ int slice_offset(int r, int b) {
  return (b >> 7) * kYSlab + r * kSlab + ((((b & 127) >> 4) ^ (r & 7)) << 4) + (b & 15);
}

// The requant of two neighbouring columns: int8 clip(v >> 9, -127, 127) ...
__device__ __forceinline__ void requant_pair(uint8_t* p, int v0, int v1, float) {
  v0 = max(-127, min(127, v0 >> 9));
  v1 = max(-127, min(127, v1 >> 9));
  *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(
      (static_cast<uint32_t>(v0) & 0xffu) | ((static_cast<uint32_t>(v1) & 0xffu) << 8));
}

// ... or bf16(v * scale), rounded to nearest even
__device__ __forceinline__ void requant_pair(uint8_t* p, float v0, float v1, float scale) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(v0, scale)));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(v1, scale)));
  *reinterpret_cast<uint32_t*>(p) = lo | (hi << 16);
}

// Out (M, K) = y after `loop` steps of y <- requant(y (M, K) x Bt (K, K)^T),
// y = A at the start; row_bytes is K in bytes, a multiple of 128.  Blocks run
// as clusters of cs = K / NS, cluster c on rows 64 c .. 64 c + 63 (the band),
// block `rank` of it on NS of the columns (its slice): those of slabs rank,
// rank + cs, ... of K, so that consecutive slabs come from different blocks
// and the blocks push side by side.  Slab i of the run (step i / kslabs,
// slab k = i % kslabs of K) needs Bt's rows for the slice, which the block's
// TMA thread loads into stage i % b_stages of the Bt ring, and y's slab (64
// rows x 128 bytes), which the block that owns those columns (k % cs) pushes,
// once its consumers have written them, into stage i % y_stages of the y
// ring of every block of the cluster.  Warp 10 hands
// the block's y stages back to their next owners as the consumers free them,
// so the pushes run up to y_stages slabs ahead of the products, on a ring of
// their own.  map_b: Bt in boxes of `chunk` rows x 128 bytes.  Dynamic shared
// memory: Chain<INT8, NS>::smem_bytes.
template <bool INT8, int NS>
__global__ void __launch_bounds__(kThreads, 1)
chain_wgmma_kernel(const __grid_constant__ CUtensorMap map_b, const uint8_t* __restrict__ A,
                   uint8_t* __restrict__ Out, int M, int row_bytes, int loop, float scale) {
  using C = Chain<INT8, NS>;
  constexpr int W = NS / 2;   // columns of a consumer warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t bring = (raw + 1023u) & ~1023u;   // the Bt ring, then the y ring
  const uint32_t yring = bring + kChainB;
  const uint32_t ys = yring + C::y_stages * kYSlab;   // two buffers of the block's slice of y
  uint8_t* ys_ptr = smem_raw + (ys - raw);
  const uint32_t bfull = ys + 2 * C::slice_bytes;    // b_stages barriers each of bfull
  const uint32_t bempty = bfull + C::b_stages * 8;   // and bempty, y_stages each of
  const uint32_t yfull = bempty + C::b_stages * 8;   // yfull, yempty and yvacant
  const uint32_t yempty = yfull + C::y_stages * 8;
  const uint32_t yvacant = yempty + C::y_stages * 8;
  const uint32_t written = yvacant + C::y_stages * 8;   // the consumers wrote the next y
  const uint32_t rank = cluster_rank(), cs = cluster_size();
  const long long row0 = static_cast<long long>(blockIdx.x / cs) * kBand;
  const int kslabs = row_bytes / kSlab;
  // byte b of a row of the block's slice is byte gcol(b) of the row of y:
  // its slabs are slabs rank, rank + cs, rank + 2 cs, ... of y
  auto gcol = [&](int b) { return ((b >> 7) * static_cast<int>(cs) + static_cast<int>(rank)) * kSlab + (b & 127); };
  const int slabs = loop * kslabs;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::b_stages; ++s) {
      mbar_init(bfull + s * 8, 1);    // the TMA thread's arrive with the byte count
      mbar_init(bempty + s * 8, 8);   // lane 0 of each consumer warp
    }
    for (int s = 0; s < C::y_stages; ++s) {
      mbar_init(yfull + s * 8, 1);    // warp 10's arrive; the owner's push brings the bytes
      mbar_init(yempty + s * 8, 8);   // lane 0 of each consumer warp
      // warp 10 of every block of the cluster: its stage is free for a slab
      // that this block owns
      mbar_init(yvacant + s * 8, static_cast<int>(cs));
    }
    mbar_init(written, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the block's slice of y at the start (zeros past M) into buffer 0
  for (int c = threadIdx.x; c < kBand * (C::slice / 16); c += kThreads) {
    const int r = c / (C::slice / 16), b = (c % (C::slice / 16)) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < M) v = __ldg(reinterpret_cast<const uint4*>(A + (row0 + r) * row_bytes + gcol(b)));
    *reinterpret_cast<uint4*>(ys_ptr + slice_offset(r, b)) = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // for the bulk copies
  __syncthreads();
  cluster_sync();   // every block's barriers are there before anything reaches them

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 8) {
    // ------------------------------------- TMA thread: Bt's slice of each slab
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < slabs; ++i) {
        mbar_wait(bempty + stage * 8, phase ^ 1u);   // this block's consumers are done with it
        const uint32_t bar = bfull + stage * 8;
        mbar_expect_tx(bar, C::b_bytes);
        for (int kk = 0; kk < C::owned; ++kk)   // Bt's rows for the slice's columns
          tma_load(bring + stage * C::b_bytes + kk * C::chunk * kSlab, &map_b, (i % kslabs) * kSlab,
                   (kk * static_cast<int>(cs) + static_cast<int>(rank)) * C::chunk, bar);
        if (++stage == C::b_stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    __syncwarp();
  } else if (warp == 9) {
    // ------------- pusher: the slabs of y this block owns, to every block
    if (lane == 0) {
      uint32_t vacant_phase = 0;   // bit x: parity of the next wait on yvacant[x]
      for (int s = 0; s < loop; ++s) {
        if (s > 0) mbar_wait(written, (s - 1) & 1);   // y of step s is in this block's slice
        for (int kk = 0; kk < C::owned; ++kk) {
          const int k = kk * static_cast<int>(cs) + static_cast<int>(rank);
          const int x = (s * kslabs + k) % C::y_stages;
          mbar_wait(yvacant + x * 8, (vacant_phase >> x) & 1u);   // every block's stage x is free
          vacant_phase ^= 1u << x;
          const uint32_t src = ys + (s & 1) * C::slice_bytes + kk * kYSlab;
          for (uint32_t p = 0; p < cs; ++p) {
            bulk_push(yring + x * kYSlab, src, kYSlab, yfull + x * 8, p);
          }
        }
      }
    }
    __syncwarp();
  } else if (warp == 10) {
    // ------- the block's y stages, handed to the owners of their next slabs
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < slabs; ++i) {
        mbar_wait(yempty + stage * 8, phase ^ 1u);   // this block's consumers are done with it
        const uint32_t bar = yfull + stage * 8;
        mbar_add_tx(bar, kYSlab);   // y's slab, which its owner pushes
        mbar_arrive(bar);
        mbar_arrive_at(yvacant + stage * 8, static_cast<uint32_t>((i % kslabs) % cs));
        if (++stage == C::y_stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    __syncwarp();
  } else if (warp < 8) {
    // ----------------------------------------------------------- consumers
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    typename std::conditional<INT8, int, float>::type acc[W / 2];
    int bstage = 0, ystage = 0;
    uint32_t bphase = 0, yphase = 0;
    for (int s = 0; s < loop; ++s) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[i] = 0;
      pin(acc);
      int bprev = 0, yprev = 0;
      for (int k = 0; k < kslabs; ++k) {
        mbar_wait(yfull + ystage * 8, yphase);
        mbar_wait(bfull + bstage * 8, bphase);
        const uint64_t da = smem_desc(yring + ystage * kYSlab);
        const uint64_t db = smem_desc(bring + bstage * C::b_bytes + wg * (W * kSlab));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlab / 32; ++kk) wgmma_step(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        if (k > 0) {   // the slab before has been read: hand its stages back
          wgmma_wait<1>();
          pin(acc);
          if (lane == 0) {
            mbar_arrive(bempty + bprev * 8);
            mbar_arrive(yempty + yprev * 8);
          }
        }
        bprev = bstage;
        yprev = ystage;
        if (++bstage == C::b_stages) {
          bstage = 0;
          bphase ^= 1u;
        }
        if (++ystage == C::y_stages) {
          ystage = 0;
          yphase ^= 1u;
        }
      }
      wgmma_wait<0>();
      pin(acc);
      if (lane == 0) {
        mbar_arrive(bempty + bprev * 8);
        mbar_arrive(yempty + yprev * 8);
      }
      // the requant into the other buffer of the block's slice (the pushes
      // of two steps ago that read it have all landed: every block has
      // consumed them, or this block's step would not be done)
      uint8_t* next = ys_ptr + ((s + 1) & 1) * C::slice_bytes;
      const int r = (warp & 3) * 16 + g;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int b = (wg * W + 8 * j + 2 * t) * C::size;
        requant_pair(next + slice_offset(r, b), acc[4 * j], acc[4 * j + 1], scale);
        requant_pair(next + slice_offset(r + 8, b), acc[4 * j + 2], acc[4 * j + 3], scale);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // for the pushes
      asm volatile("bar.sync 1, 256;\n" ::: "memory");   // all consumers have written
      if (threadIdx.x == 0 && s + 1 < loop) mbar_arrive(written);
    }
    // the last y, the block's slice of it, to device memory
    const uint8_t* last = ys_ptr + (loop & 1) * C::slice_bytes;
    for (int c = threadIdx.x; c < kBand * (C::slice / 16); c += 256) {
      const int r = c / (C::slice / 16), b = (c % (C::slice / 16)) * 16;
      if (row0 + r < M)
        *reinterpret_cast<uint4*>(Out + (row0 + r) * row_bytes + gcol(b)) =
            *reinterpret_cast<const uint4*>(last + slice_offset(r, b));
    }
  } else {
    __syncwarp();
  }
  cluster_sync();   // no block leaves while a peer may still push into it
}

// ------------------------------------------------------------- accumulate

// Four 8 x 16-byte matrices of shared memory into registers: lane l gives
// the address of row l % 8 of matrix l / 8, and register j of lane (g, t)
// gets bytes 4t .. 4t + 3 of row g of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// The probe's change to 4 bytes of A before product i: a XOR int8(i) ...
__device__ __forceinline__ uint32_t perturb_word(uint32_t w, uint32_t step, std::true_type) {
  uint32_t r;
  asm volatile("xor.b32 %0, %1, %2;\n" : "=r"(r) : "r"(w), "r"(step));
  return r;
}

// ... or bf16(a + bf16(i)) on both halves, rounded to nearest even from the
// exact sum (what the f32 sum rounded to bf16 gives: 24 >= 2 x 8 + 2 bits)
__device__ __forceinline__ uint32_t perturb_word(uint32_t w, uint32_t step, std::false_type) {
  uint32_t r;
  asm volatile("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(w), "r"(step));
  return r;
}

// What perturb_word takes for product i: the byte int8(i) in all four
// places, or bf16(i) (rounded to nearest even past 256) in both halves.
template <bool INT8>
__device__ __forceinline__ uint32_t perturb_step(int i) {
  if constexpr (INT8) {
    return static_cast<uint32_t>(i & 0xff) * 0x01010101u;
  } else {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(i)));
    return h | (h << 16);
  }
}

template <bool INT8>
__device__ __forceinline__ void perturb_frags(uint32_t (&p)[16], const uint32_t (&fa)[16],
                                              int i) {
  const uint32_t step = perturb_step<INT8>(i);
  const std::integral_constant<bool, INT8> kind{};
#pragma unroll
  for (int j = 0; j < 16; ++j) p[j] = perturb_word(fa[j], step, kind);
}

// One product of the loop on the stage: A's fragments perturbed for product
// i into p (whose last group is over), then four register-A steps against
// the stage's B, committed as one group.
template <bool INT8, typename AccT, int NA>
__device__ __forceinline__ void accum_product(AccT (&acc)[NA], uint32_t (&p)[16],
                                            const uint32_t (&fa)[16], int i, uint64_t db) {
  perturb_frags<INT8>(p, fa, i);
  wgmma_fence();   // the registers of A and the accumulators are written
#pragma unroll
  for (int ks = 0; ks < kSlab / 32; ++ks) wgmma_step_rs(acc, p + 4 * ks, db + 2 * ks);
  wgmma_commit();
}

// Shared memory of block `rank` of the cluster at this offset, 16 bytes.
__device__ __forceinline__ uint4 ld_cluster16(uint32_t addr, uint32_t rank) {
  uint4 v;
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %4, %5;\n"
      "ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [remote];\n}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr), "r"(rank) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t add_bits(uint32_t x, uint32_t y, std::true_type) {
  return x + y;   // int32, exact (two's complement)
}

__device__ __forceinline__ uint32_t add_bits(uint32_t x, uint32_t y, std::false_type) {
  return __float_as_uint(__fadd_rn(__uint_as_float(x), __uint_as_float(y)));
}

__device__ __forceinline__ uint32_t to_bits(int v) { return static_cast<uint32_t>(v); }
__device__ __forceinline__ uint32_t to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ void from_bits(int& v, uint32_t b) { v = static_cast<int>(b); }
__device__ __forceinline__ void from_bits(float& v, uint32_t b) { v = __uint_as_float(b); }

// The consumer thread's accumulators, 16 bytes at a time, into the block's
// ring: word q of every thread side by side.
template <typename AccT, int NA>
__device__ __forceinline__ void stage_partial(const AccT (&acc)[NA], uint8_t* ring_ptr, int tid) {
#pragma unroll
  for (int q = 0; q < NA / 4; ++q)
    *reinterpret_cast<uint4*>(ring_ptr + (q * 256 + tid) * 16) =
        make_uint4(to_bits(acc[4 * q]), to_bits(acc[4 * q + 1]), to_bits(acc[4 * q + 2]),
                   to_bits(acc[4 * q + 3]));
}

// The sum of the ks blocks' staged accumulators of this thread's place in
// the tile, block 0 first, into acc: the same order on every run.
template <bool INT8, typename AccT, int NA>
__device__ __forceinline__ void reduce_partials(AccT (&acc)[NA], uint32_t ring, int tid,
                                                uint32_t ks) {
  const std::integral_constant<bool, INT8> kind{};
#pragma unroll
  for (int q = 0; q < NA / 4; ++q) {
    const uint32_t off = ring + (q * 256 + tid) * 16;
    uint4 v = ld_cluster16(off, 0);
    for (uint32_t r = 1; r < ks; ++r) {
      const uint4 w = ld_cluster16(off, r);
      v = make_uint4(add_bits(v.x, w.x, kind), add_bits(v.y, w.y, kind),
                     add_bits(v.z, w.z, kind), add_bits(v.w, w.w, kind));
    }
    from_bits(acc[4 * q], v.x);
    from_bits(acc[4 * q + 1], v.y);
    from_bits(acc[4 * q + 2], v.z);
    from_bits(acc[4 * q + 3], v.w);
  }
}

// out (M, N) = sum over i < loop of perturb_i(A) (M, K) x Bt (N, K)^T
// through the maps of A and Bt (bytes, boxes of 128 x 128 and BN x 128),
// kslabs slabs of 128 bytes of K; map_out (boxes of 16 rows x 128 bytes) is
// read only if tma_out.  Blocks run as clusters of ks (1, 2, 4 or 8):
// cluster c owns tile c (row tile c / n_tiles, column tile c % n_tiles) and
// block `rank` of it the slabs rank kslabs / ks .. (rank + 1) kslabs / ks - 1.
// A slab's stage arrives once by TMA and feeds all `loop` products before it
// is handed back: each consumer warp takes its 16 rows of A into registers
// with ldmatrix (the 128-byte swizzle applied to the addresses), and for
// each i makes a perturbed copy of them (two copies in turn, so that the
// next is made while the last group runs) and runs four register-A wgmma
// steps on it.  With ks > 1 each block then stages its accumulators in its
// ring, and block `rank` adds the ks blocks' partials (block 0 first) for
// the warps rank 8 / ks .. (rank + 1) 8 / ks - 1, whose rows it stores.
// Dynamic shared memory: Ring<BN>::smem_bytes.
template <bool INT8, int BN>
__global__ void __launch_bounds__(kThreads, 1)
accum_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_out, uint8_t* __restrict__ out,
                   int M, int N, int kslabs, int n_tiles, int loop, int tma_out) {
  constexpr int STAGES = Ring<BN>::stages, STAGE_BYTES = Ring<BN>::stage_bytes;
  static_assert(BN <= 128, "the accumulators, A and its two perturbed copies fit 168 registers");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023u) & ~1023u;   // the swizzle repeats every 1024 bytes
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  uint8_t* stage_out = ring_ptr + kRingBytes;
  const uint32_t full = ring + kRingBytes + kStageOutBytes;   // STAGES barriers, then
  const uint32_t empty = full + STAGES * 8;                   // STAGES more
  const uint32_t rank = cluster_rank(), ks = cluster_size();
  const int tile = blockIdx.x / static_cast<int>(ks);
  const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * BN;
  const int s0 = static_cast<int>(rank * kslabs / ks);
  const int s1 = static_cast<int>((rank + 1) * kslabs / ks);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s * 8, 1);    // the producer's arrive with the byte count
      mbar_init(empty + s * 8, 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int s = s0; s < s1; ++s) {
        mbar_wait(empty + stage * 8, phase ^ 1u);   // the consumers are done with the stage
        const uint32_t bar = full + stage * 8, dst = ring + stage * STAGE_BYTES;
        mbar_expect_tx(bar, STAGE_BYTES);   // whole boxes, zero fill included
        tma_load(dst, &map_a, s * kSlab, m0, bar);
        tma_load(dst + kABytes, &map_b, s * kSlab, n0, bar);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    __syncwarp();
    if (ks > 1) {   // the exchange of the partials: staged, then read
      cluster_sync();
      cluster_sync();
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    typename std::conditional<INT8, int, float>::type acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0;
    pin(acc);
    // the row of the stage and the half of a 32-byte step whose 16 bytes this
    // lane's ldmatrix address names
    const int lrow = wg * 64 + (warp & 3) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int half = lane >> 4;
    uint32_t fa[16], p0[16], p1[16];
    int stage = 0;
    uint32_t phase = 0;
    for (int s = s0; s < s1; ++s) {
      mbar_wait(full + stage * 8, phase);
      const uint32_t base = ring + stage * STAGE_BYTES;
#pragma unroll
      for (int k = 0; k < kSlab / 32; ++k)
        ldmatrix_x4(fa + 4 * k, base + lrow * kSlab + (((2 * k + half) ^ (lrow & 7)) << 4));
#pragma unroll
      for (int j = 0; j < 16; ++j) p0[j] = p1[j] = fa[j];
      const uint64_t db = smem_desc(base + kABytes);
      int i = 0;
      for (; i + 1 < loop; i += 2) {   // at most two groups in flight, one on each copy
        accum_product<INT8>(acc, p0, fa, i, db);
        wgmma_wait<1>();   // the group on p1 is over
        pin(acc);
        accum_product<INT8>(acc, p1, fa, i + 1, db);
        wgmma_wait<1>();   // the group on p0 is over
        pin(acc);
      }
      if (i < loop) accum_product<INT8>(acc, p0, fa, i, db);
      wgmma_wait<0>();
      pin(acc);
      if (lane == 0) mbar_arrive(empty + stage * 8);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1u;
      }
    }
    const int per = 8 / static_cast<int>(ks);   // warps whose rows this block stores
    const bool owner = warp / per == static_cast<int>(rank);
    if (ks > 1) {
      asm volatile("bar.sync 1, 256;\n" ::: "memory");   // no consumer reads the ring any more
      stage_partial(acc, ring_ptr, threadIdx.x);
      cluster_sync();   // every block's partials are staged
      if (owner) reduce_partials<INT8>(acc, ring, threadIdx.x, ks);
      cluster_sync();   // no block's ring is read any more
    }
    if (owner) {
      uint32_t stores = 0;
      store_tile<BN, EPI_RAW>(acc, stage_out + warp * kWarpOutBytes, &map_out, out, nullptr,
                              nullptr, static_cast<long long>(m0) + warp * 16, n0, M, N,
                              tma_out != 0, stores);
      // shared memory outlives the stores that still read it
      if (tma_out && lane == 0) tma_store_wait_read<0>();
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the process has loaded
// already; it is looked up there by name, so nothing links against it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

constexpr int kNoEncoder = 20000;   // returned if the lookup fails
constexpr int kEncodeFailed = 10000;    // plus the CUresult of the encoder

// The map of a (rows, row_bytes) matrix of bytes in boxes of box_rows x 128
// bytes with the 128-byte swizzle; what a box holds outside the matrix reads
// as zeros.
int encode_map(CUtensorMap* map, const void* base, long long rows, long long row_bytes,
               int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kSlab), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(res);
}

template <bool INT8, int BN, int EPI, bool TMA>
int launch(const void* a, const void* bt, void* out, const float* scale, const float* bias,
           int m, int n, long long row_bytes, int num_sms, cudaStream_t stream) {
  constexpr int CL = TMA ? 2 : 1;
  const long long m_tiles = (m + kBM - 1) / kBM, n_tiles = (n + BN - 1) / BN;
  const long long units = (m_tiles + CL - 1) / CL * n_tiles;
  if (units > 0x3fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // the output goes by TMA stores if its row pitch and base allow it
  constexpr int out_size = EPI == EPI_BF16 ? 2 : 4;
  const long long out_row_bytes = static_cast<long long>(n) * out_size;
  const int tma_out = out_row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  CUtensorMap map_a = {}, map_b = {}, map_out = {};   // the unaligned kernel reads no input map
  int err = 0;
  if (TMA) err = encode_map(&map_a, a, m, row_bytes, kBM);
  if (TMA && err == 0) err = encode_map(&map_b, bt, n, row_bytes, BN / 2);
  if (err == 0 && tma_out) err = encode_map(&map_out, out, m, out_row_bytes, 16);
  if (err != 0) return err;
  auto kernel = wgmma_kernel<INT8, BN, EPI, TMA>;
  constexpr int smem = Ring<BN>::smem_bytes;
  cudaError_t cerr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  // clusters of CL blocks, as many as run at once (at most one block an SM)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(num_sms / CL * CL));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  static int fit[64] = {};   // clusters of this kernel that a device runs at once
  int device = 0;
  cerr = cudaGetDevice(&device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  int clusters = device < 64 ? fit[device] : 0;
  if (clusters == 0) {
    cerr = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    if (clusters <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
    if (device < 64) fit[device] = clusters;
  }
  if (clusters > num_sms / CL) clusters = num_sms / CL;
  if (clusters > units) clusters = static_cast<int>(units);
  config.gridDim = dim3(static_cast<unsigned>(CL * clusters));
  cerr = cudaLaunchKernelEx(&config, kernel, map_a, map_b, map_out, static_cast<uint8_t*>(out),
                            scale, bias, m, n,
                            static_cast<int>((row_bytes + kSlab - 1) / kSlab),
                            static_cast<int>(n_tiles), static_cast<int>(units), tma_out,
                            static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt),
                            row_bytes);
  return static_cast<int>(cerr != cudaSuccess ? cerr : cudaGetLastError());
}

template <bool INT8, int EPI, bool TMA = true>
int launch_bn(int bn, const void* a, const void* bt, void* out, const float* scale,
              const float* bias, int m, int n, long long row_bytes, int num_sms,
              cudaStream_t stream) {
  switch (bn) {
    case 64: return launch<INT8, 64, EPI, TMA>(a, bt, out, scale, bias, m, n, row_bytes, num_sms, stream);
    case 128: return launch<INT8, 128, EPI, TMA>(a, bt, out, scale, bias, m, n, row_bytes, num_sms, stream);
    case 256:
      if constexpr (TMA)
        return launch<INT8, 256, EPI, TMA>(a, bt, out, scale, bias, m, n, row_bytes, num_sms, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// chain_wgmma_kernel<INT8, NS> on clusters of cs blocks, one cluster a band
// of 64 rows.  With fit non-null nothing is launched: *fit gets the number
// of such clusters the device runs at once.
template <bool INT8, int NS>
int launch_chain(const void* a, const void* bt, void* out, int m, int cs, int loop,
                 float scale, int* fit, cudaStream_t stream) {
  using C = Chain<INT8, NS>;
  auto kernel = chain_wgmma_kernel<INT8, NS>;
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          C::smem_bytes);
  if (cerr == cudaSuccess)   // clusters of more than 8 blocks
    cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const long long bands = (m + kBand - 1) / kBand;
  if (bands * cs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(fit ? cs : bands * cs));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = C::smem_bytes;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  if (fit) {
    *fit = 0;
    cerr = cudaOccupancyMaxActiveClusters(fit, kernel, &config);
    if (cerr != cudaSuccess) cudaGetLastError();   // a refused size leaves no error behind
    return static_cast<int>(cerr);
  }
  const int row_bytes = cs * C::slice;
  CUtensorMap map_b;
  const int err = encode_map(&map_b, bt, static_cast<long long>(cs) * NS, row_bytes, C::chunk);
  if (err != 0) return err;
  cerr = cudaLaunchKernelEx(&config, kernel, map_b, static_cast<const uint8_t*>(a),
                            static_cast<uint8_t*>(out), m, row_bytes, loop, scale);
  return static_cast<int>(cerr != cudaSuccess ? cerr : cudaGetLastError());
}

int chain_dispatch(const void* a, const void* bt, void* out, int is_int8, int m, int ns, int cs,
                   int loop, float scale, int* fit, cudaStream_t stream) {
  if (cs < 1 || cs > 16 || (ns != 128 && ns != 256) || m <= 0 || loop < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_int8)
    return ns == 128 ? launch_chain<true, 128>(a, bt, out, m, cs, loop, scale, fit, stream)
                     : launch_chain<true, 256>(a, bt, out, m, cs, loop, scale, fit, stream);
  return ns == 128 ? launch_chain<false, 128>(a, bt, out, m, cs, loop, scale, fit, stream)
                   : launch_chain<false, 256>(a, bt, out, m, cs, loop, scale, fit, stream);
}

// accum_wgmma_kernel<INT8, BN> on clusters of ks blocks, one cluster a tile.
// With fit non-null nothing is launched: *fit gets the number of such
// clusters the device runs at once.
template <bool INT8, int BN>
int launch_accum(const void* a, const void* bt, void* out, int m, int n, long long row_bytes,
                 int loop, int ks, int* fit, cudaStream_t stream) {
  auto kernel = accum_wgmma_kernel<INT8, BN>;
  constexpr int smem = Ring<BN>::smem_bytes;
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const long long n_tiles = (n + BN - 1) / BN;
  const long long tiles = (m + kBM - 1) / kBM * n_tiles;
  if (tiles * ks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(fit ? ks : tiles * ks));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  if (fit) {
    *fit = 0;
    cerr = cudaOccupancyMaxActiveClusters(fit, kernel, &config);
    if (cerr != cudaSuccess) cudaGetLastError();   // a refused size leaves no error behind
    return static_cast<int>(cerr);
  }
  const int tma_out = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  CUtensorMap map_a, map_b, map_out = {};
  int err = encode_map(&map_a, a, m, row_bytes, kBM);
  if (err == 0) err = encode_map(&map_b, bt, n, row_bytes, BN);
  if (err == 0 && tma_out) err = encode_map(&map_out, out, m, 4LL * n, 16);
  if (err != 0) return err;
  cerr = cudaLaunchKernelEx(&config, kernel, map_a, map_b, map_out, static_cast<uint8_t*>(out),
                            m, n, static_cast<int>((row_bytes + kSlab - 1) / kSlab),
                            static_cast<int>(n_tiles), loop, tma_out);
  return static_cast<int>(cerr != cudaSuccess ? cerr : cudaGetLastError());
}

template <bool INT8>
int accum_dispatch(const void* a, const void* bt, void* out, int m, int n, long long row_bytes,
                   int loop, int bn, int ks, int* fit, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || loop < 1 || (ks != 1 && ks != 2 && ks != 4 && ks != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bn) {   // 256 would need 176 registers a consumer thread: ptxas has 168
    case 64: return launch_accum<INT8, 64>(a, bt, out, m, n, row_bytes, loop, ks, fit, stream);
    case 128: return launch_accum<INT8, 128>(a, bt, out, m, n, row_bytes, loop, ks, fit, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// c (m, n) int32 / f32 = a (m, k) x bt (n, k)^T; int8 operands if is_int8 else
// bf16; bn is the tile width, 64, 128 or 256; at most num_sms blocks.  Row
// pitch and bases must be multiples of 16 bytes.
extern "C" int ioudet_wgmma_matmul(const void* a, const void* bt, void* c, int is_int8, int m,
                                   int n, int k, int bn, int num_sms, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(k) * (is_int8 ? 1 : 2);
  if (m <= 0 || n <= 0 || k <= 0 || num_sms <= 0 || row_bytes % 16 != 0 || !aligned16(a) ||
      !aligned16(bt))
    return static_cast<int>(cudaErrorInvalidValue);
  return is_int8 ? launch_bn<true, EPI_RAW>(bn, a, bt, c, nullptr, nullptr, m, n, row_bytes,
                                            num_sms, stream)
                 : launch_bn<false, EPI_RAW>(bn, a, bt, c, nullptr, nullptr, m, n, row_bytes,
                                             num_sms, stream);
}

// out (m, n) bf16 (out_bf16) or f32 = cast(float(a x bt^T) * scale[n] + bias[n]), int8
// operands, scale (n,) and bias (n,) f32, bias may be null.
extern "C" int ioudet_wgmma_matmul_dequant(const void* a, const void* bt, void* out,
                                           const void* scale, const void* bias, int out_bf16,
                                           int m, int n, int k, int bn, int num_sms,
                                           cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0 || num_sms <= 0 || k % 16 != 0 || !aligned16(a) ||
      !aligned16(bt) || scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  return out_bf16 ? launch_bn<true, EPI_BF16>(bn, a, bt, out, s, b, m, n, k, num_sms, stream)
                  : launch_bn<true, EPI_F32>(bn, a, bt, out, s, b, m, n, k, num_sms, stream);
}

// c (m, n) int32 / f32 = a (m, k) x bt (n, k)^T as ioudet_wgmma_matmul, for
// any row pitch and any bases (the producer loads through registers); bn is
// 64 or 128.
extern "C" int ioudet_wgmma_matmul_unaligned(const void* a, const void* bt, void* c,
                                             int is_int8, int m, int n, int k, int bn,
                                             int num_sms, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(k) * (is_int8 ? 1 : 2);
  if (m <= 0 || n <= 0 || k <= 0 || num_sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_int8 ? launch_bn<true, EPI_RAW, false>(bn, a, bt, c, nullptr, nullptr, m, n,
                                                   row_bytes, num_sms, stream)
                 : launch_bn<false, EPI_RAW, false>(bn, a, bt, c, nullptr, nullptr, m, n,
                                                    row_bytes, num_sms, stream);
}

// *clusters = how many clusters of cs blocks of the chain kernel (int8 if
// is_int8 else bf16, slices of ns = 128 or 256 columns) the current device
// runs at once; nothing is launched.
extern "C" int ioudet_chain_fit(int is_int8, int ns, int cs, void* clusters,
                                cudaStream_t stream) {
  if (clusters == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return chain_dispatch(nullptr, nullptr, nullptr, is_int8, 1, ns, cs, 0, 0.f,
                        static_cast<int*>(clusters), stream);
}

// out (m, k) = y after `loop` steps of y <- requant(y x bt (k, k)^T), y = a
// (m, k) at the start, k = ns * cs; int8 (scale ignored) if is_int8 else
// bf16; clusters of cs blocks, each on ns columns of a band of 64 rows.
extern "C" int ioudet_wgmma_chain(const void* a, const void* bt, void* out, int is_int8, int m,
                                  int ns, int cs, int loop, float scale, cudaStream_t stream) {
  if (a == nullptr || !aligned16(a) || !aligned16(bt) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  return chain_dispatch(a, bt, out, is_int8, m, ns, cs, loop, scale, nullptr, stream);
}

// *clusters = how many clusters of ks blocks of the accumulate kernel (int8
// if is_int8 else bf16, tiles bn = 64 or 128 wide) the current device
// runs at once; nothing is launched.
extern "C" int ioudet_accum_fit(int is_int8, int bn, int ks, void* clusters,
                                cudaStream_t stream) {
  if (clusters == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int* fit = static_cast<int*>(clusters);
  return is_int8
             ? accum_dispatch<true>(nullptr, nullptr, nullptr, 1, 1, kSlab, 1, bn, ks, fit, stream)
             : accum_dispatch<false>(nullptr, nullptr, nullptr, 1, 1, kSlab, 1, bn, ks, fit, stream);
}

// c (m, n) int32 / f32 = sum over i < loop of perturb_i(a) (m, k) x bt (n, k)^T,
// perturb_i(a) = a XOR int8(i) (int8 operands if is_int8) or bf16(a + bf16(i))
// (bf16); tiles 128 x bn (64 or 128), K split over clusters of ks blocks
// (1, 2, 4 or 8).  Row pitch and bases must be multiples of 16 bytes.
extern "C" int ioudet_wgmma_accum(const void* a, const void* bt, void* c, int is_int8, int m,
                                  int n, int k, int loop, int bn, int ks, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(k) * (is_int8 ? 1 : 2);
  if (k <= 0 || row_bytes % 16 != 0 || !aligned16(a) || !aligned16(bt) || c == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_int8 ? accum_dispatch<true>(a, bt, c, m, n, row_bytes, loop, bn, ks, nullptr, stream)
                 : accum_dispatch<false>(a, bt, c, m, n, row_bytes, loop, bn, ks, nullptr, stream);
}
