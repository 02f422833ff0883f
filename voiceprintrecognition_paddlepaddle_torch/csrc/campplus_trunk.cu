// The whole CAM++ trunk in one kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's models/pallas_campplus.py:
// `_kernel` (unrolled, pallas_call in `_trunk_call`) and `_kernel_looped`
// (pallas_call in `_trunk_call_looped`). Both compute one function; the
// split between them existed only for the TPU compiler's sake, so one
// kernel serves every length up to the 32 s bucket (t_valid <= 1600).
//
// What it computes, per utterance (FCM output x: (T_raw, 320) bf16):
//   stem   k5 stride-2 pad-2 conv 320->128, BN-ReLU, mask
//   52 CAM layers (blocks of 12/24/16, dilation 1/2/2), each:
//          h  = relu(bf16(bf16(xcat * a) + b))      (wide BN, bf16, unmasked)
//          x2 = bf16(mask * relu((h @ W1 + c) * a2 + b2))        (-> 128)
//          y  = sum_k x2[t + (k-1) dil] @ Wk + bias               (-> 32)
//          ctx[s] = bf16(mean_valid(x2) + mean_segment_s(x2))     (100 frames)
//          gate[s] = bf16(sigmoid(bf16(relu(ctx @ Wc1 + b1)) @ Wc2 + b2))
//          xcat[:, c0 + 32 li : +32] = bf16(y * gate[seg(t)] * mask)
//   3 transits: wide BN (bf16), 1x1 conv halving channels, mask
//   out BN-ReLU (fp32), then mean || biased std over the valid frames.
// The host wrapper applies the unbiased correction sqrt(tv / (tv - 1)).
//
// What bounds it on the H100: about 1.8 GFLOP per 3 s utterance (453.7
// GFLOP at b256 x 3 s, 0.46 ms on the bf16 tensor cores), nearly all in
// the 52 1x1 bottlenecks over the growing concat (K = 128..992, N = 128)
// and the transits (K = 512/1024, N = 256/512). The concat lives in a
// global ping-pong workspace that each bottleneck re-reads over its whole
// K (about 3.3 GB per b256 launch, 1.0 ms at 3.35 TB/s), and every block
// streams each layer's bf16 weights (about 12 MB per utterance) from L2.
// On the card what bounds it is the block's serial chain per K slice: the
// A slice's copies from a workspace far larger than L2, then the wide
// BN-ReLU of the staged slice and a proxy fence before the slice's wgmmas
// can start (a warp's wgmmas also wait for its own copies in flight, so
// the warps that issue wgmma issue none), and the 52 layers' CAM work
// between the products (PERF.md has the split). The products' ring
// therefore runs as far ahead as shared memory allows, and no block
// barrier sits in their K loop (below).
//
// Design: a thread-block cluster of cs blocks per utterance
// (trunk_kernel.trunk_split picks cs in {1, 2, 4, 8}). Block rank k owns
// trunk rows [k R, min((k + 1) R, t16)), R a multiple of 16 and at most
// 256 (so cs = 8 covers 1600 rows); a trailing block may own none. A short
// clip or a small batch so spreads over more SMs. The stem, each layer's
// wide BN-ReLU and 1x1 bottleneck, the gated append and the transits are
// row-local: a block runs them over its own rows of the concat (two global
// ping-pong buffers: a transit reads one and writes the other), and only
// over the rows it owns below the utterance's valid count rounded up to 16
// ([r0, r0 + nc) below): its row passes and tiles follow that span, so a
// padded clip runs the tiles of its length and not of the bucket's, and a
// block with no valid rows runs no product and no append (it still meets
// every cluster barrier and serves its zero x2 halo). Rows a block skips
// are never written, in the concat or in x2, and feed no valid row: a
// product's row depends on that row of A alone, the epilogues select zero
// for every row at or past the valid count (a select, so whatever a
// skipped row of the torch.empty workspace holds, NaN included, goes no
// further), x2 starts zero and stays so past the computed rows, and the
// pooling reads valid rows only.
// Launch order: cluster i serves utterance order[i] (TrunkParams.order),
// which the host wrapper sorts by tiles run, most first and stable, so
// the longest utterances start in the first wave and the short ones fill
// the last; outputs still go to their utterance's row. With no valid
// counts the order is the identity (a null pointer).
//
// Products: every product is wgmma.mma_async (bf16 x bf16 -> fp32) with
// both operands in shared memory in the 128-byte swizzle, K-major (a row
// is one 128-byte line of a 64-column K slice). C[rows, n0:n0+128] =
// A[rows, 0:K] @ B[0:K, n0:n0+128] runs in row passes of up to KT 64-row
// tiles, one a warpgroup (the kernel's two builds: KT = 2 with 256 threads
// for R <= 128, KT = 3 with 384 threads above; one block an SM), each
// warpgroup keeping its tile's m64n128 fp32 accumulator in registers. A
// pass of one tile gives two warpgroups 64 columns each instead, so a
// short block does not leave one idle. A ring of stages streams K in
// slices of 64: a stage holds the A slice of all the pass's tiles and one
// packed weight slice, so each staged weight slice serves every row tile
// of the pass (one pass for every block of up to 192 rows). The products
// over the concat fill the ring by TMA: one thread issues the A tiles (a 3-D
// tensor map of the workspace; the hardware writes the swizzle, rows past
// t16 read as zero) and the weight slice (a bulk copy of a slice that
// trunk_kernel.pack_trunk laid out pre-swizzled), all completing on the
// stage's full mbarrier by their bytes. Each stage also has an empty
// mbarrier, which completes once every warpgroup has released the stage:
// one thread a warpgroup arrives once wgmma_wait shows the warpgroup's
// wgmmas on it done (in a pass of one tile both warpgroups that share it;
// warpgroup 0 arrives for those past the pass's tiles, so each slice
// completes its stage's empty phase once). A pass's first kStages slices
// are issued at its start, one by lane 0 of each of the first kStages
// warps; then thread 0 issues slice i + kStages into slice i's stage as
// soon as that stage's empty mbarrier completes, so TMA runs kStages - 1
// slices ahead: 4 in the KT = 2 build (5 stages), 2 in KT = 3 (3 stages;
// Ring has the shared-memory sums). Per slice each thread of a
// warpgroup waits on the full mbarrier, applies the wide BN-ReLU in place
// to its A chunks (once per staged slice; columns past K, in the last
// slice of a cin that is not a multiple of 64, are zeroed, as are the
// packed weights there), fences its writes to the async proxy that wgmma
// reads through (fence.proxy.async) and meets a named barrier of its own
// warpgroup's 128 threads (of the 256 that share a one-tile pass); then
// the warpgroup issues its wgmmas, waits for those of the slice before
// (one slice's stay in flight) and releases that slice. No warpgroup waits
// for another inside the K loop; the block barriers are at a product's
// start and at the end of each of its passes, after which the CAM phase,
// the stem's ring, the next pass's first copies and the transit's kept
// rows reuse shared memory or global columns. No warp that issues wgmma
// has a cp.async in flight.
// A transit has 2 or 4 column passes of 128 over the same A: its first
// pass writes each transformed chunk back over its input rows (a buffer
// nothing reads after the transit), so the later passes load A ready by
// TMA and skip the BN-ReLU. The concat is written with ordinary stores
// (the stem's and the transits' epilogues, the gated appends) and read
// back by TMA, which goes through the async proxy: before the first copy
// of a product's freshly stored columns is issued, every thread fences
// its stores (fence.proxy.async.global) and arrives on the ring's fresh
// mbarrier, which the issuing thread waits on. That fence waits for the
// stores to complete, so it comes as late as it can: a layer's append is
// read in the last K slice of the next product, so the fence comes as the
// loop starts the slice whose release lets that copy go, when the stores
// have long landed; columns read within the first kStages slices (the
// stem's and the transits' outputs, the short products' appends) are
// fenced at the pass's start, and a transit's kept rows at the end of its
// first pass, before its block barrier.
// A pass's epilogue (bias, BN-ReLU and mask, in the accumulator's
// registers) reads its affine before it stores anything, so the loads go
// out together: a store through a generic pointer between them would make
// each wait for the one before (a fifth of block 0's time; PERF.md).
// Counters (TrunkParams.phase, measurement only): thread 0 of each
// warpgroup of block 0 counts the slices it waits for, those whose copies
// had landed at its first test of the full mbarrier (the ring's hit share)
// and the ns it waited; a launch without them reads no clock and makes no
// atomic for them.
// The stem (im2col of every other FCM row, zero outside the clip; 2 % of
// the time) fills its ring with cp.async instead. The layer's wide affine
// comes with the first slice into shared memory; trunk_weights reads the
// packed weights back. Rows past a block's own are never written; the
// computed rows past an utterance's valid count are written as zero.
//
// x2 (the bottleneck's output) stays in shared memory as 16 column chunks
// of (tiles x 64 + 4) rows of 8 channels, so the local k3 conv's A is x2
// itself at a row offset per tap: the conv runs on wgmma m64n32k16 (no
// swizzle), a tile a warpgroup, with its layer's weights (24 KB, packed
// K-major) staged once in the ring. It is issued before the CAM gate MLP
// and waited for after it, so the gate's serial work hides it. The gate
// MLP reads its weights from the ring too.
//
// Across blocks, through distributed shared memory (DSMEM):
//   - the x2 halo: the dilated k3 conv (dilation <= kGuard = 2) reads
//     the two x2 rows on each side that the neighbouring ranks own. Each
//     block copies them into its guard rows after a cluster barrier. At
//     the utterance's edges the guard rows stay zero; rows past the valid
//     count are zero in x2 anyway (written so, or never written).
//   - the CAM context: each block writes its partial per-segment sums of
//     x2 (segs x 128 fp32) to its own shared memory; after the barrier
//     every block adds the partials of all ranks in rank order (so every
//     block gets the same sums) and computes the gate MLP only for the
//     segments its valid rows touch.
//   - the pooling: partial sums -> mean (every block), then partial sums
//     of squared deviations -> biased std (rank 0 writes `out`), the
//     two-pass form of the one-block kernel.
// Safety of the exchange: per layer a block (1) writes x2 and its partial
// sums, (2) arrives at and waits on a cluster barrier (release/acquire),
// (3) reads its neighbours' edge rows and every rank's partial sums,
// (4) arrives at the cluster barrier again and goes on with the local
// conv, the gate and the append, and (5) waits on that second barrier
// only at the start of the next layer, before it writes x2 and the sums
// again. No block can overwrite what a peer still reads in (3), since it
// cannot pass (5) before every peer arrived in (4). Every block reaches
// every barrier, rows or not, and the kernel ends with a barrier so no
// block leaves while rank 0 still reads its shared memory. With cs = 1 the
// barriers are __syncthreads() and the peers' data is the block's own.
// Rounding points follow the TPU kernel so the plain PyTorch version
// (trunk_kernel.trunk_stats_reference) matches closely; the fp32 sums run
// in a fixed order, so a launch gives the same result every time. Block 0
// can time its phases (TrunkParams.phase, for measurement only).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

struct TrunkParams {
  const bf16* x;          // (B, T_raw, 320) FCM output, frequency-major
  const int* tvalid;      // (B,) valid trunk frames, in [1, t_valid]
  const int* order;       // null (the identity), or (B,): cluster i serves utterance order[i]
  float* out;             // (B, 1024) mean || biased std
  bf16* ws;               // (2, B, t16, 1024) concat ping-pong workspace
  const bf16* w_stem;     // 1600 x 128 in wgmma slices (trunk_kernel.pack_trunk)
  const float* stem_aff;  // (3, 128): conv bias, BN a, BN b
  const bf16* w_lin1;     // (sum cin) x 128 in wgmma slices, layer after layer
  const float* lin1_aff;  // (52, 3, 128): conv bias, BN a, BN b
  const bf16* wide_ab;    // (55, 2, 1024): wide BN a, b (layers, transits)
  const bf16* w_local;    // (52, 384 x 32) K-major images, K = tap * 128 + c
  const bf16* w_cam1;     // (52, 128, 64)
  const bf16* w_cam2;     // (52, 64, 32)
  const float* cam_bias;  // (52, 128): local | cam2 | cam1 biases
  const bf16* w_t0;       // 512 x 256 in wgmma slices
  const bf16* w_t1;       // 1024 x 512 in wgmma slices
  const bf16* w_t2;       // 1024 x 512 in wgmma slices
  const float* tbias;     // (3, 512)
  const float* out_aff;   // (2, 512)
  // null, or 2 kPhases + kRingCounts zeroed u64: block 0 adds the
  // %globaltimer ns and then the SM clock cycles of each phase, then the
  // ring's counters (RingCount; trunk_phase_times)
  unsigned long long* phase;
  int B, T_raw, t_valid, t16;
  int cs;                 // blocks of a cluster per utterance: 1, 2, 4 or 8
  int R;                  // trunk rows a block owns: a multiple of 16, <= 256
};

// The kernel's parameters: the tensor map of the concat workspace (TMA
// reads the products' A tiles through it) and TrunkParams.
struct KernelArgs {
  CUtensorMap ws;
  TrunkParams p;
};

namespace {

constexpr int kTile = 64;                     // rows of a wgmma tile
constexpr int kKS = 64;                       // K slice of the ring
constexpr int kNP = 128;                      // columns of a pass
constexpr int kSliceElems = kKS * kNP;        // a packed weight slice
// A stage holds its operands in wgmma's 128-byte swizzle, K-major: a row
// (an A row, or a B column) is one 128-byte line of its slice's 64 K
// values, 8 lines make a 1024-byte atom, and the line's 16-byte chunk q
// lies at chunk q ^ (line & 7), so that the 8 lines of a core matrix fall
// in different banks.
constexpr int kTileBytes = kTile * kKS * 2;   // a tile's A slice
constexpr int kBBytes = kNP * kKS * 2;        // a weight slice
__host__ __device__ constexpr int swz128(int line, int q) {
  return line * 128 + ((q ^ (line & 7)) << 4);
}
__host__ __device__ constexpr int slices_of(int K) { return (K + kKS - 1) / kKS; }
// The kernel comes in two builds by the row tiles KT a pass holds, one
// warpgroup a tile: KT = 2 (blocks of R <= 128 rows, 256 threads, a ring of
// 5 stages) and KT = 3 (R > 128, 384 threads, 3 stages), one block an SM
// either way. A thread holds one m64n128 fp32 accumulator (64 registers).
// A stage holds KT tiles' A slices and one weight slice: 32 KB at KT = 2,
// 40 KB at KT = 3. The depth is what fits beside x2 and the CAM arrays at
// the 32 s bucket: 5 x 32 KB + 4 KB + 33 KB + 22 KB = 224.3 KB at KT = 2,
// 3 x 40 KB + 4 KB + 65 KB + 22 KB = 216.2 KB at KT = 3 (a fourth stage
// would need 256 KB), of the 227 KB a block may have.
constexpr int kSmallTiles = 2, kBigTiles = 3;
constexpr int kMaxStages = 5;
template <int KT>
struct Ring {
  static constexpr int kThreads = 128 * KT;
  static constexpr int kStages = KT == kSmallTiles ? 5 : 3;
  static constexpr int kABytes = KT * kTileBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBytes = kStages * kStageBytes;
  static_assert(kStages <= kMaxStages, "the ring's mbarriers fit");
};
constexpr int kGuard = 2;                     // max dilation
constexpr int kStemIn = 320, kInit = 128, kBn = 128, kGrowth = 32;
constexpr int kHid = 64, kWide = 1024, kFinal = 512, kSeg = 100;
constexpr int kLayers = 52;
constexpr int kLocalK = 3 * kBn;              // the local conv's K: taps x channels
constexpr int kMaxR = 256;                    // rows a block owns at most
constexpr int kMaxT16 = 1600;                 // the 32 s bucket (3198 frames)
constexpr int kMaxCluster = 8;                // the portable cluster size
// the ring during a layer's CAM phase (after the bottleneck, before the
// next product's first copies): the local conv's weights (no swizzle: 4
// groups of 8 output columns, kLocalGroup bytes apart), the gate MLP's
// weights and the segment sums' scratch (a row of 128 floats a warp)
constexpr int kLocalGroup = kLocalK / 8 * 128;
constexpr int kRingLocal = 0;
constexpr int kRingCam1 = kRingLocal + kGrowth / 8 * kLocalGroup;
constexpr int kRingCam2 = kRingCam1 + kBn * kHid * 2;
constexpr int kRingScratch = kRingCam2 + kHid * kGrowth * 2;
static_assert(kRingScratch + Ring<kBigTiles>::kThreads / 32 * kBn * 4 <=
                  Ring<kBigTiles>::kBytes, "the CAM phase fits the ring");
static_assert(kRingScratch + Ring<kSmallTiles>::kThreads / 32 * kBn * 4 <=
                  Ring<kSmallTiles>::kBytes, "the CAM phase fits the ring");
__constant__ int kBlockLayers[3] = {12, 24, 16};
__constant__ int kBlockDil[3] = {1, 2, 2};

__host__ __device__ inline int tiles_of(int R) { return (R + kTile - 1) / kTile; }
// the build a block of R rows runs: its tiles a pass
__host__ __device__ inline int pass_tiles(int R) {
  return tiles_of(R) <= kSmallTiles ? kSmallTiles : kBigTiles;
}
__host__ __device__ inline int ring_bytes(int R) {
  return pass_tiles(R) == kSmallTiles ? Ring<kSmallTiles>::kBytes : Ring<kBigTiles>::kBytes;
}
// x2 rows: every tile's rows and kGuard guard rows on each side
__host__ __device__ inline int x2_rows(int R) { return tiles_of(R) * kTile + 2 * kGuard; }
__host__ __device__ inline size_t x2_bytes(int R) { return (size_t)(kBn / 8) * x2_rows(R) * 16; }
__host__ __device__ inline int seg_cap(int t_valid) { return (t_valid + kSeg - 1) / kSeg; }
__host__ __device__ inline size_t small_bytes(int t_valid) {
  return sizeof(float) * seg_cap(t_valid) * (128 + 128 + kHid + kGrowth);
}
// shared memory of a block: the ring, a product's wide BN affine, x2, the
// CAM segment arrays and the ring's mbarriers (byte offsets: a full and an
// empty one a stage, and the fresh one; wide_pass)
constexpr int kAbBytes = 2 * kWide * 2;
constexpr int kBarFull = 0, kBarEmpty = 8 * kMaxStages, kBarFresh = 16 * kMaxStages;
constexpr int kBarBytes = kBarFresh + 8;
__host__ __device__ inline size_t smem_bytes(int R, int t_valid) {
  return ring_bytes(R) + kAbBytes + x2_bytes(R) + small_bytes(t_valid) + kBarBytes;
}

// Per-phase time of block 0 (TrunkParams.phase), for measurement: thread
// 0 adds the ns and cycles since its previous lap to the phase's slots.
enum Phase { kStem, kBottleneck, kCamSums, kLocalConv, kGateMlp, kAppend, kTransits,
             kPooling, kPhases };
// After the phases, the ring's counters: thread 0 of each warpgroup of
// block 0 adds each slice of a product over the concat that it waits for,
// those whose copies had landed when it first tested the stage's mbarrier,
// and the ns it waited.
enum RingCount { kRingSlices, kRingLanded, kRingWaitNs, kRingCounts };
struct Stamp {
  unsigned long long* acc;  // null unless timing is on and this is block 0's thread 0
  unsigned long long ns, clk;
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ void start(unsigned long long* phase) {
    acc = (phase != nullptr && blockIdx.x == 0 && threadIdx.x == 0) ? phase : nullptr;
    if (acc) {
      ns = now();
      clk = clock64();
    }
  }
  __device__ void lap(int k) {
    if (!acc) return;
    const unsigned long long t = now(), c = clock64();
    atomicAdd(acc + k, t - ns);
    atomicAdd(acc + kPhases + k, c - clk);
    ns = t;
    clk = c;
  }
};

__device__ inline float bfr(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- PTX: asynchronous copies, the proxy fence, wgmma ----------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1 (the concat is written in this
// launch); zero-filled without reading `src` when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's shared-memory writes (stores and landed cp.async copies)
// -> visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the same for global memory: this thread's ordinary stores to the
// concat -> visible to the TMA copies that read them back later in the
// launch. It waits for the stores to complete, so the products issue it
// late: before the barrier that precedes the first copy of those rows.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// mbarriers: one a ring stage, completed by the bytes of its copies
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for a stage's copies. `count` (null unless measuring: block 0,
// thread 0 of a warpgroup) gets the slice, whether its copies had landed
// at the first test, and the ns waited (RingCount).
__device__ __forceinline__ void wait_full(uint32_t bar, uint32_t parity,
                                          unsigned long long* count) {
  if (count == nullptr) {
    mbar_wait(bar, parity);
    return;
  }
  const unsigned long long t0 = Stamp::now();
  const bool landed = mbar_test(bar, parity);
  if (!landed) mbar_wait(bar, parity);
  atomicAdd(count + kRingSlices, 1ull);
  atomicAdd(count + kRingLanded, landed ? 1ull : 0ull);
  atomicAdd(count + kRingWaitNs, Stamp::now() - t0);
}
// a barrier of `threads` threads (whole warps) under id `id` (0 is
// __syncthreads'), ordering their shared-memory accesses as it does
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// TMA: a box of the tensor map at coordinates (c0, c1, c2) into shared
// memory (rows outside the tensor read as zero), completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
// a contiguous bulk copy global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// keep the compiler from moving accumulator accesses across wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Shared-memory matrix descriptor, no swizzle: 8-row x 16-byte core
// matrices, `lbo` bytes apart along K and `sbo` bytes apart along M or N.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// The same in the 128-byte swizzle, K-major (swz128): 1024-byte atoms of
// 8 lines along M or N; `addr` advances by 32 bytes a k16 step within a line.
__device__ __forceinline__ uint64_t gmma_desc_sw128(uint32_t addr) {
  return gmma_desc(addr, 16, 1024) | (1ull << 62);
}
// D[64 x N] += A[64 x 16] B[16 x N], both K-major in shared memory. Thread
// (warp w, lane l) of the warpgroup holds d[4 nb + 2 h + e] = D[16 w + l /
// 4 + 8 h][8 nb + 2 (l % 4) + e].
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// Split cluster barrier (all threads of all blocks of the cluster):
// arrive releases this thread's writes (shared, DSMEM and global), wait
// acquires the writes of every thread that arrived before.
__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// a barrier over the blocks of one utterance
__device__ inline void utt_sync(int cs) {
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}
// `p` (this block's shared memory) as it lies in block `rank` of the
// cluster; the block's own pointer when the cluster is one block
template <class T>
__device__ inline T* peer(T* p, int rank, int cs) {
  return cs > 1 ? cg::this_cluster().map_shared_rank(p, rank) : p;
}

// relu(bf16(bf16(x * a) + b)) on 8 bf16 lanes in bf16x2 arithmetic: the
// product and the sum each rounded once to bf16, as the TPU kernel rounds
// them (inline PTX, so the compiler cannot contract them into one fma)
__device__ inline uint4 wide_relu8(uint4 xv, uint4 av, uint4 bv) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&xv);
  const uint32_t* a = reinterpret_cast<const uint32_t*>(&av);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(&bv);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t p, s;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(p) : "r"(x[i]), "r"(a[i]));
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(s) : "r"(p), "r"(b[i]));
    asm("max.bf16x2 %0, %1, %2;" : "=r"(o[i]) : "r"(s), "r"(0u));
  }
  return out;
}

// ---- A operands of the products ---------------------------------------------
// In a pass of several tiles warpgroup wg's thread t owns chunks u = t +
// 128 j (j < 4) of tile wg's A slice: line u >> 3, columns 8 q.. with q = t
// & 7 (the same for all four); in a pass of one tile, threads tid < 256
// own chunks u = tid + 256 j (j < 2) of it.

// The stem: row g's columns k.. of the implicit im2col (tap = k / 320,
// channel = k % 320) are FCM row 2g + tap - 2 (zero outside the clip).
struct StemA {
  static constexpr bool kWideBn = false;
  const bf16* x;  // this utterance's (T_raw, 320)
  int T_raw;
  __device__ const bf16* src(int g, int k, bool& ok) const {
    const int tap = k / kStemIn, c = k - tap * kStemIn, r = 2 * g + tap - 2;
    ok = ok && r >= 0 && r < T_raw;
    return ok ? x + (size_t)r * kStemIn + c : x;
  }
};

// A 1x1 conv over the concat: tiles of xcat by TMA, then the wide BN-ReLU
// applied in place to this thread's chunks, with the affine staged in
// shared memory for the whole product. A product of several column
// passes (a transit) transforms in its first pass only and writes the
// transformed rows back over its input (which nothing reads after the
// transit), so its later passes read them ready (WideMode).
enum WideMode { kTransform, kTransformKeep, kKept };
// the ring's running counts, which give its mbarriers their phases
struct RingSeq {
  uint32_t slices;  // slices through the ring (a stage's full and empty phases)
  uint32_t fresh;   // waits on the fresh mbarrier
};
struct WideA {
  static constexpr bool kWideBn = true;
  const CUtensorMap* map;  // the concat workspace, (1024, t16, 2 B)
  int z;                   // this utterance's buffer in it: buffer * B + b
  const bf16* ab;          // (2, 1024)
  bf16* X;                 // that buffer's rows: trunk row 0, column 0
  // tile: the tile in the stage; this thread's chunks: lines line0 + step
  // j (j < N), column chunk q; ab_k: the staged affine at its 8 columns of
  // the slice; past_k: those columns lie past K (the last slice of a K
  // that is not a multiple of 64), so the chunks are zeroed; keep: null,
  // or where line0's chunk goes back in the concat, for the lines before
  // `lines` (the block's own rows)
  template <int N>
  __device__ void transform(unsigned char* tile, int line0, int step, int q, const bf16* ab_k,
                            bool past_k, bf16* keep, int lines) const {
    const uint4 a = *reinterpret_cast<const uint4*>(ab_k);
    const uint4 b = *reinterpret_cast<const uint4*>(ab_k + kWide);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint4* c = reinterpret_cast<uint4*>(tile + swz128(line0 + step * j, q));
      const uint4 v = past_k ? make_uint4(0, 0, 0, 0) : wide_relu8(*c, a, b);
      *c = v;
      if (keep != nullptr && !past_k && step * j < lines)
        *reinterpret_cast<uint4*>(keep + (size_t)step * j * kWide) = v;
    }
  }
};

// ---- epilogues: from a warpgroup's accumulator -----------------------------
// A pass of several tiles gives each warpgroup a tile and all 128 columns
// (NW = 128); a pass of one tile gives warpgroups 0 and 1 its columns 64 wg
// .. 64 wg + 63 each (NW = 64). This thread's value pair (nb, h) lies at
// row rp + 64 tile + 16 w + l / 4 + 8 h of the block and column c0 + 8 nb +
// 2 (l % 4) of the pass (w the warp in the warpgroup, l the lane).
struct AccPos {
  int tile, c0, w, lane;
  __device__ explicit AccPos(int nw)
      : tile(nw == 128 ? threadIdx.x >> 7 : 0),
        c0(nw == 128 ? 0 : 64 * (threadIdx.x >> 7)),
        w((threadIdx.x >> 5) & 3),
        lane(threadIdx.x & 31) {}
  __device__ int row(int rp, int h) const {
    return rp + tile * kTile + 16 * w + (lane >> 2) + 8 * h;
  }
  __device__ int col(int nb) const { return c0 + 8 * nb + 2 * (lane & 3); }
};

// Each epilogue first turns the accumulator into its outputs in place,
// reading the affine as float2 pairs, then stores them: no store comes
// between the loads, so they go out together instead of one after each
// store (a store through a generic pointer could alias them), and the
// functor's fields are read once into registers.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// conv bias, BN-ReLU and mask in place: aff is (3, 128) bias, BN a, BN b;
// rows at or past `valid` become zero
static_assert(kInit == kBn, "the stem's affine has the bottlenecks' layout");
template <int NW>
__device__ __forceinline__ void bias_bn_relu(float (&acc)[NW / 2], const AccPos& ps, int rp,
                                             const float* aff, int valid) {
#pragma unroll
  for (int nb = 0; nb < NW / 8; ++nb) {
    const int c = ps.col(nb);
    const float2 bias = ld2(aff + c), scale = ld2(aff + kBn + c), shift = ld2(aff + 2 * kBn + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 4 * nb + 2 * h;
      const bool ok = ps.row(rp, h) < valid;
      acc[k] = ok ? fmaxf((acc[k] + bias.x) * scale.x + shift.x, 0.f) : 0.f;
      acc[k + 1] = ok ? fmaxf((acc[k + 1] + bias.y) * scale.y + shift.y, 0.f) : 0.f;
    }
  }
}
// each value pair below `rows` as a bf16 pair at at(row, column)
template <int NW, class At>
__device__ __forceinline__ void store_pairs(const float (&acc)[NW / 2], const AccPos& ps, int rp,
                                            int rows, At at) {
#pragma unroll
  for (int nb = 0; nb < NW / 8; ++nb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ps.row(rp, h);
      if (row < rows)
        *reinterpret_cast<__nv_bfloat162*>(at(row, ps.col(nb))) =
            __floats2bfloat162_rn(acc[4 * nb + 2 * h], acc[4 * nb + 2 * h + 1]);
    }
  }
}

// the stem: conv bias, BN-ReLU, mask -> concat[:, :128]
struct StemEpi {
  bf16* X;
  const float* aff;  // (3, 128)
  int r0, nr, tv;
  template <int NW>
  __device__ void operator()(float (&acc)[NW / 2], int rp, int) const {
    const AccPos ps(NW);
    bias_bn_relu<NW>(acc, ps, rp, aff, tv - r0);
    bf16* const out = X + (size_t)r0 * kWide;
    store_pairs<NW>(acc, ps, rp, nr, [=](int row, int c) { return out + (size_t)row * kWide + c; });
  }
};

// a bottleneck: conv bias, BN-ReLU, mask -> x2 in shared memory
struct X2Epi {
  bf16* x2;          // row 0 of column chunk 0
  int ldk;           // elements between column chunks
  const float* aff;  // (3, 128)
  int r0, nr, tv;
  template <int NW>
  __device__ void operator()(float (&acc)[NW / 2], int rp, int) const {
    const AccPos ps(NW);
    bias_bn_relu<NW>(acc, ps, rp, aff, tv - r0);
    bf16* const out = x2;
    const int ld = ldk;
    store_pairs<NW>(acc, ps, rp, nr,
                    [=](int row, int c) { return out + (c >> 3) * ld + row * 8 + (c & 7); });
  }
};

// a transit: conv bias, mask -> the other concat buffer, pass np's columns
struct TransitEpi {
  bf16* Y;
  const float* bias;  // (512,)
  int r0, nr, tv;
  template <int NW>
  __device__ void operator()(float (&acc)[NW / 2], int rp, int np) const {
    const AccPos ps(NW);
    const float* const b = bias + np * kNP;
    const int valid = tv - r0;
#pragma unroll
    for (int nb = 0; nb < NW / 8; ++nb) {
      const float2 bb = ld2(b + ps.col(nb));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 4 * nb + 2 * h;
        const bool ok = ps.row(rp, h) < valid;
        acc[k] = ok ? acc[k] + bb.x : 0.f;
        acc[k + 1] = ok ? acc[k + 1] + bb.y : 0.f;
      }
    }
    bf16* const out = Y + (size_t)r0 * kWide + np * kNP;
    store_pairs<NW>(acc, ps, rp, nr, [=](int row, int c) { return out + (size_t)row * kWide + c; });
  }
};

// A slice's wgmmas for a warpgroup: its A tile at sa, its NW columns of
// the weight slice at sb, 4 k16 steps along the 128-byte lines.
template <int NW>
__device__ __forceinline__ void mma_slice(float (&acc)[NW / 2], uint32_t sa, uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < kKS / 16; ++kk) {
    if constexpr (NW == 128)
      wgmma_n128(acc, gmma_desc_sw128(sa + kk * 32), gmma_desc_sw128(sb + kk * 32));
    else
      wgmma_n64(acc, gmma_desc_sw128(sa + kk * 32), gmma_desc_sw128(sb + kk * 32));
  }
}

// One pass of the stem's product: C[rows rp.. of the block, 0:128] over the
// pass's nt tiles, one a warpgroup (warpgroups past nt copy zeros and
// issue no wgmma), K in ks slices of B; `epi` takes each warpgroup's
// accumulator. Its ring is filled by cp.async (the im2col rows are every
// other FCM row; outside the clip they are zero-filled), each thread
// copying its own chunks. Ends with a block barrier, so the ring is free.
template <int KT, int NW, class Epi>
__device__ __noinline__ void stem_pass(const StemA& a, int g0, int rp, int nr, int nt, int ks,
                                       const bf16* __restrict__ B, const Epi& epi,
                                       unsigned char* ring) {
  using RingT = Ring<KT>;
  constexpr int kStages = RingT::kStages, kThreads = RingT::kThreads;
  constexpr int kChunks = NW == 128 ? 4 : 2;  // this thread's A chunks a slice
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const bool active = NW == 128 ? wg < nt : wg < 2;
  const int tile = NW == 128 ? wg : 0;
  const uint32_t ring_s = smem_addr(ring);
  // this thread's A chunks: lines l0 + step j of `tile`, columns 8 q..
  const int l0 = NW == 128 ? t >> 3 : (tid & 255) >> 3, step = NW == 128 ? 16 : 32, q = t & 7;
  const bool stages_a = NW == 128 || tid < 256;
  auto issue = [&](int i) {
    const uint32_t st = ring_s + (i % kStages) * RingT::kStageBytes;
    const int k = i * kKS + q * 8;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int row = rp + tile * kTile + l0 + step * j;
      bool ok = row < nr;
      const bf16* src = a.src(g0 + row, k, ok);
      if (stages_a) cp_async16(st + tile * kTileBytes + swz128(l0 + step * j, q), src, ok);
    }
    const bf16* bs = B + (size_t)i * kSliceElems;
    for (int c = tid; c < kSliceElems / 8; c += kThreads)  // packed pre-swizzled
      cp_async16(st + RingT::kABytes + c * 16, bs + c * 8, true);
  };
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < ks) issue(j);
    cp_async_commit();
  }
  float acc[NW / 2];
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) acc[e] = 0.f;
  for (int i = 0; i < ks; ++i) {
    unsigned char* st = ring + (i % kStages) * RingT::kStageBytes;
    cp_async_wait<kStages - 2>();  // this thread's copies of slice i landed
    fence_proxy_async();
    wgmma_wait<0>();               // this warpgroup's slice i - 1 is done
    __syncthreads();               // slice i is in; slice i - 1's stage is free
    if (i + kStages - 1 < ks) issue(i + kStages - 1);
    cp_async_commit();
    if (active) {
      const uint32_t sa = smem_addr(st) + tile * kTileBytes;
      const uint32_t sb = smem_addr(st) + RingT::kABytes + (NW == 128 ? 0 : wg * kTile * 128);
      fence_regs(acc);
      wgmma_fence();
      mma_slice<NW>(acc, sa, sb);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (active) epi.template operator()<NW>(acc, rp, 0);
  __syncthreads();
}

// One pass of a product over the concat: C[rows rp.. of the block, 128 np
// : 128 np + 128] over the pass's nt tiles, one a warpgroup (warpgroups
// past nt take no part), K in ks slices of B; `epi` takes each
// warpgroup's accumulator. The ring is a producer/consumer ring of full
// and empty mbarriers with no block barrier inside the K loop. A slice is
// issued into its stage by one thread: the A tiles by TMA in the 128-byte
// swizzle, the weight slice (and at the first slice of a product the wide
// affine) by bulk copies, all completing on the stage's full mbarrier, so
// no warp that issues wgmma has a copy of its own in flight. The first
// kStages slices go at the start, slice j by lane 0 of warp j, all at
// once; thread 0 issues slice i + kStages into slice i's stage once its
// empty mbarrier completes, that is once every warpgroup has released
// slice i: a warpgroup's thread t == 0 arrives after wgmma_wait shows its
// wgmmas of slice i done (warpgroup 0 arrives for the warpgroups that take
// no part, so every slice's stage completes its empty phase once with KT
// arrivals). So TMA runs kStages - 1 slices ahead of the slice whose
// wgmmas were issued last. Per slice each thread of a warpgroup waits on
// the full mbarrier, applies the wide BN-ReLU in place to its A chunks,
// fences its writes to the async proxy that wgmma reads through and meets
// its warpgroup's named barrier (the two warpgroups' one in a pass of one
// tile); then the warpgroup issues its wgmmas, waits for those of the
// slice before (one slice's stay in flight) and releases that slice.
// mode: whether the pass transforms A, and keeps it (WideMode). fresh: the
// first K slice holding concat columns stored since the block last fenced
// them (-1: none): every thread fences its stores
// (fence.proxy.async.global) and arrives on the ring's fresh mbarrier,
// which the thread that issues that slice waits on first; a thread does so
// at the start if the slice is one of the first kStages, else as it
// starts slice fresh - kStages + 1 (whose end releases slice fresh -
// kStages and so lets slice fresh go): late, so the stores have long
// landed. seq: the ring's running counts, which give each mbarrier its
// phase; returns them advanced. count: the ring's counters (wait_full).
// Ends with a block barrier, so the ring is free.
template <int KT, int NW, class Epi>
__device__ __noinline__ RingSeq wide_pass(const WideA& a, int g0, int rp, int nr, int nt, int ks,
                                          const bf16* __restrict__ B, int np, const Epi& epi,
                                          unsigned char* ring, uint32_t bars, RingSeq seq,
                                          bf16* ab_s, int K, bool ab_load, WideMode mode,
                                          int fresh, unsigned long long* count) {
  using RingT = Ring<KT>;
  constexpr int kStages = RingT::kStages;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const bool active = NW == 128 ? wg < nt : wg < 2;
  const int tile = NW == 128 ? wg : 0;
  const uint32_t ring_s = smem_addr(ring);
  const uint32_t full = bars + kBarFull, empty = bars + kBarEmpty, fresh_bar = bars + kBarFresh;
  // this thread's A chunks: lines l0 + step j of `tile`, columns 8 q..
  const int l0 = NW == 128 ? t >> 3 : (tid & 255) >> 3, step = NW == 128 ? 16 : 32, q = t & 7;
  auto stage = [&](int i) { return (seq.slices + i) % kStages; };
  auto parity = [&](int i) { return ((seq.slices + i) / kStages) & 1; };
  auto fence_fresh = [&] {
    fence_proxy_async_global();
    mbar_arrive(fresh_bar, 1);
  };
  auto issue = [&](int i) {
    if (i >= kStages) mbar_wait(empty + 8 * stage(i), parity(i - kStages));
    if (i == fresh) mbar_wait(fresh_bar, seq.fresh & 1);
    const uint32_t s = stage(i), bar = full + 8 * s;
    const uint32_t st = ring_s + s * RingT::kStageBytes;
    const bool with_ab = ab_load && i == 0;
    mbar_arrive_expect(bar, nt * kTileBytes + kBBytes + (with_ab ? 4 * K : 0));
    for (int j = 0; j < nt; ++j)
      tma_load_3d(st + j * kTileBytes, a.map, i * kKS, g0 + rp + j * kTile, a.z, bar);
    bulk_load(st + RingT::kABytes, B + (size_t)i * kSliceElems, kBBytes, bar);
    if (with_ab) {
      bulk_load(smem_addr(ab_s), a.ab, 2 * K, bar);
      bulk_load(smem_addr(ab_s + kWide), a.ab + kWide, 2 * K, bar);
    }
  };
  // a warpgroup's release of slice i: warpgroup 0 also for those past nt
  auto release = [&](int i) {
    if (t == 0) mbar_arrive(empty + 8 * stage(i), wg == 0 ? 1 + KT - (NW == 128 ? nt : 2) : 1);
  };
  const bool fresh_first = fresh >= 0 && fresh < kStages;  // fresh is issued at the start
  if (fresh >= 0 && (fresh_first || !active)) fence_fresh();
  // the first kStages slices at once, slice j by lane 0 of warp j
  if ((tid & 31) == 0 && tid >> 5 < min(kStages, ks)) issue(tid >> 5);
  float acc[NW / 2];
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) acc[e] = 0.f;
  fence_regs(acc);
  if (active) {
    for (int i = 0; i < ks; ++i) {
      if (!fresh_first && i == fresh - kStages + 1) fence_fresh();
      const uint32_t s = stage(i);
      unsigned char* st = ring + s * RingT::kStageBytes;
      wait_full(full + 8 * s, parity(i), count);
      if (mode != kKept) {
        const int line = rp + tile * kTile + l0;  // block row of this thread's first chunk
        a.template transform<NW == 128 ? 4 : 2>(
            st + tile * kTileBytes, l0, step, q, ab_s + i * kKS + q * 8, i * kKS + q * 8 >= K,
            mode == kTransformKeep ? a.X + (size_t)(g0 + line) * kWide + i * kKS + q * 8
                                   : nullptr,
            nr - line);
        fence_proxy_async();
        // the warpgroup's (or the tile's two warpgroups') chunks are in
        named_sync(NW == 128 ? 1 + wg : 1 + KT, NW == 128 ? 128 : 256);
      }
      const uint32_t sa = smem_addr(st) + tile * kTileBytes;
      const uint32_t sb = smem_addr(st) + RingT::kABytes + (NW == 128 ? 0 : wg * kTile * 128);
      wgmma_fence();
      mma_slice<NW>(acc, sa, sb);
      wgmma_commit();
      if (i > 0) {
        wgmma_wait<1>();  // this warpgroup's slice i - 1 is done (i may run)
        release(i - 1);
        if (tid == 0 && i - 1 + kStages < ks) issue(i - 1 + kStages);
      }
    }
    wgmma_wait<0>();
    release(ks - 1);
  }
  fence_regs(acc);
  if (active) epi.template operator()<NW>(acc, rp, np);
  fence_proxy_async();  // this thread's ring accesses before the next TMA writes
  if (mode == kTransformKeep) fence_proxy_async_global();  // the kept rows
  __syncthreads();
  return RingSeq{seq.slices + ks, seq.fresh + (fresh >= 0 ? 1u : 0u)};
}

// C[rows, 128 np : 128 np + 128] = A[rows, 0:K] @ B[0:K, same] for each
// of `npass` column passes, over nr rows of the block (trunk rows g0..:
// the rows it computes, nc) in row passes of up to KT tiles (none when nr
// is 0). Bp: the weight's packed slices, [np][K /
// 64, rounded up][16 KB], zero past K. A WideA's affine (its first K of a
// and of b) is staged into ab_s once for all passes; with several column
// passes the first transforms A and keeps it, the others read it kept.
// fresh: as in wide_pass, for the first pass (the later ones come after
// it). Returns the ring's counts advanced.
template <int KT, class A, class Epi>
__device__ RingSeq gemm(const A& a, int g0, int nr, int K, const bf16* __restrict__ Bp,
                        int npass, const Epi& epi, unsigned char* ring, bf16* ab_s, uint32_t bars,
                        RingSeq seq, int fresh = -1, unsigned long long* count = nullptr) {
  const int ks = slices_of(K);
  if constexpr (A::kWideBn) {
    fence_proxy_async();  // the block's accesses of the ring and ab_s before TMA writes them
    __syncthreads();
  }
  bool first = true;
  for (int rp = 0; rp < nr; rp += kTile * KT) {
    const int nt = min(KT, (nr - rp + kTile - 1) / kTile);
    for (int np = 0; np < npass; ++np) {
      const bf16* B = Bp + (size_t)np * ks * kSliceElems;
      const WideMode mode = npass == 1 ? kTransform : (np == 0 ? kTransformKeep : kKept);
      // a pass of one tile splits its columns over two warpgroups
      if constexpr (A::kWideBn)
        seq = nt == 1 ? wide_pass<KT, 64>(a, g0, rp, nr, nt, ks, B, np, epi, ring, bars, seq,
                                          ab_s, K, first, mode, first ? fresh : -1, count)
                      : wide_pass<KT, 128>(a, g0, rp, nr, nt, ks, B, np, epi, ring, bars, seq,
                                           ab_s, K, first, mode, first ? fresh : -1, count);
      else if (nt == 1)
        stem_pass<KT, 64>(a, g0, rp, nr, nt, ks, B, epi, ring);
      else
        stem_pass<KT, 128>(a, g0, rp, nr, nt, ks, B, epi, ring);
      first = false;
    }
  }
  return seq;
}

// The local conv's wgmmas for warpgroup wg's tile of the row pass at rp
// (issued, not waited for): x2 at a row offset per tap (K = tap * 128 +
// channel) against the staged K-major weights at wl_s, all 32 columns.
__device__ __forceinline__ void local_conv(float (&yacc)[16], uint32_t x2_s, int ldk, int rp,
                                           int dil, uint32_t wl_s) {
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int e = 0; e < 16; ++e) yacc[e] = 0.f;
  fence_regs(yacc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kLocalK / 16; ++s) {
    const int tap = s >> 3, c16 = s & 7;
    const uint32_t xa =
        x2_s + 2 * c16 * ldk * 2 + (rp + wg * kTile + (tap - 1) * dil + kGuard) * 16;
    wgmma_n32(yacc, gmma_desc(xa, ldk * 2, 128), gmma_desc(wl_s + s * 256, 128, kLocalGroup));
  }
  wgmma_commit();
}

template <int KT>
__global__ void __launch_bounds__(Ring<KT>::kThreads, 1)
campplus_trunk_kernel(const __grid_constant__ KernelArgs args) {
  const TrunkParams& p = args.p;
  constexpr int kThreads = Ring<KT>::kThreads, kWarps = kThreads / 32;
  constexpr int kPassRows = kTile * KT;
  constexpr int kRingBytes = Ring<KT>::kBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int t16 = p.t16, cs = p.cs, R = p.R;
  const int tid = threadIdx.x;
  const int cluster = blockIdx.x / cs, rank = blockIdx.x % cs;
  const int b = p.order != nullptr ? p.order[cluster] : cluster;
  const int segs = seg_cap(p.t_valid);
  const int ldk = x2_rows(R) * 8;  // x2 elements between column chunks
  unsigned char* ring = smem_raw;
  const uint32_t ring_s = smem_addr(ring);
  bf16* ab_s = reinterpret_cast<bf16*>(smem_raw + kRingBytes);
  bf16* x2_base = reinterpret_cast<bf16*>(smem_raw + kRingBytes + kAbBytes);
  bf16* x2 = x2_base + kGuard * 8;  // row 0 of column chunk 0
  float* segsum =
      reinterpret_cast<float*>(smem_raw + kRingBytes + kAbBytes + x2_bytes(R));
  float* ctx = segsum + segs * 128;   // rank-order segment totals, then bf16 ctx
  float* c1 = ctx + segs * 128;       // (segs, 64), bf16-rounded values
  float* gate = c1 + segs * kHid;     // (segs, 32), bf16-rounded values
  const uint32_t bars = smem_addr(gate + segs * kGrowth);  // the ring's mbarriers
  if (tid == 0) {
    for (int s = 0; s < Ring<KT>::kStages; ++s) {
      mbar_init(bars + kBarFull + 8 * s, 1);    // the issuing thread's expect_tx
      mbar_init(bars + kBarEmpty + 8 * s, KT);  // a release a warpgroup
    }
    mbar_init(bars + kBarFresh, kThreads);      // every thread's fence
    fence_mbar_init();
  }
  __syncthreads();
  RingSeq seq{0, 0};  // the ring's running counts
  Stamp stamp;
  stamp.start(p.phase);
  unsigned long long* const ring_count =
      p.phase != nullptr && blockIdx.x == 0 && (tid & 127) == 0 ? p.phase + 2 * kPhases : nullptr;
  const int tv = min(max(p.tvalid[b], 1), p.t_valid);
  // this block's rows [r0, r1), valid rows [r0, rv) and computed rows
  // [r0, r0 + nc): the valid ones rounded up to 16 (r0 is a multiple of 16)
  const int r0 = min(rank * R, t16), r1 = min(r0 + R, t16), nr = r1 - r0;
  const int rv = max(r0, min(r1, tv));
  const int nc = min(nr, (rv - r0 + 15) / 16 * 16);
  const size_t buf_stride = (size_t)p.B * t16 * kWide;
  bf16* bufs[2] = {p.ws + (size_t)b * t16 * kWide,
                   p.ws + buf_stride + (size_t)b * t16 * kWide};

  // x2 starts zero: rows past nc (and the guard rows no neighbour feeds)
  // stay zero; the halo rewrites the others per layer
  for (int i = tid; i < (int)(x2_bytes(R) / 16); i += kThreads)
    reinterpret_cast<uint4*>(x2_base)[i] = make_uint4(0, 0, 0, 0);

  // ---- stem: k5 s2 conv 320 -> 128, BN-ReLU, mask -> concat[:, :128] ----
  gemm<KT>(StemA{p.x + (size_t)b * p.T_raw * kStemIn, p.T_raw}, r0, nc, 5 * kStemIn, p.w_stem, 1,
           StemEpi{bufs[0], p.stem_aff, r0, nc, tv}, ring, ab_s, bars, seq);
  stamp.lap(kStem);

  int cur = 0, layer = 0, c_in = kInit;
  size_t lin1_off = 0;
  const int nseg = (tv + kSeg - 1) / kSeg;
  // the segments this block's valid rows touch: [sg_lo, sg_lo + nsg_own)
  const int sg_lo = r0 / kSeg;
  const int nsg_own = rv > r0 ? (rv - 1) / kSeg - sg_lo + 1 : 0;
  float* scratch = reinterpret_cast<float*>(ring + kRingScratch);
  const bf16* w1s = reinterpret_cast<const bf16*>(ring + kRingCam1);
  const bf16* w2s = reinterpret_cast<const bf16*>(ring + kRingCam2);
  const uint32_t x2_s = smem_addr(x2_base);
  const AccPos ps(128);  // the local conv: a tile a warpgroup
  for (int blk = 0; blk < 3; ++blk) {
    const int n_layers = kBlockLayers[blk], dil = kBlockDil[blk];
    bf16* X = bufs[cur];
    for (int li = 0; li < n_layers; ++li, ++layer) {
      const int cin = c_in + li * kGrowth;
      const float* cb = p.cam_bias + (size_t)layer * 128;

      // peers have read this block's x2 edges and partial sums of the
      // previous layer (their arrive after the reads, below)
      if (cs > 1 && layer > 0) cluster_wait();

      // 1x1 bottleneck cin -> 128 over the wide BN-ReLU, then BN-ReLU, mask;
      // the rows stored since the last product: the stem's or the transit's
      // (every slice) at a block's first layer, else the previous layer's
      // append (the last slice)
      seq = gemm<KT>(WideA{&args.ws, cur * p.B + b, p.wide_ab + (size_t)layer * 2 * kWide, X}, r0,
                     nc, cin, p.w_lin1 + lin1_off * kBn, 1,
                     X2Epi{x2, ldk, p.lin1_aff + (size_t)layer * 3 * kBn, r0, nc, tv}, ring,
                     ab_s, bars, seq, li == 0 ? 0 : slices_of(cin) - 1, ring_count);
      lin1_off += slices_of(cin) * kKS;

      // the local conv's and the gate MLP's weights into the ring, in
      // flight while the CAM sums and the exchange run
      if (nc > 0) {
        const bf16* wl = p.w_local + (size_t)layer * kLocalK * kGrowth;
        const bf16* w1 = p.w_cam1 + (size_t)layer * kBn * kHid;
        const bf16* w2 = p.w_cam2 + (size_t)layer * kHid * kGrowth;
        for (int c = tid; c < kLocalK * kGrowth / 8; c += kThreads)
          cp_async16(ring_s + kRingLocal + c * 16, wl + c * 8, true);
        for (int c = tid; c < kBn * kHid / 8; c += kThreads)
          cp_async16(ring_s + kRingCam1 + c * 16, w1 + c * 8, true);
        for (int c = tid; c < kHid * kGrowth / 8; c += kThreads)
          cp_async16(ring_s + kRingCam2 + c * 16, w2 + c * 8, true);
        cp_async_commit();
      }
      stamp.lap(kBottleneck);

      // CAM context: this block's partial per-segment sums of x2 over its
      // valid rows (zero for segments it does not touch). A thread sums
      // column chunk tid % 16 over every (kThreads / 16)-th row from tid /
      // 16; then the two row sets of a warp by a shuffle, and the warps in
      // order.
      for (int sg = 0; sg < nseg; ++sg) {
        const int lo = max(sg * kSeg, r0) - r0, hi = min((sg + 1) * kSeg, rv) - r0;
        if (hi <= lo) {
          if (tid < kBn) segsum[sg * kBn + tid] = 0.f;
          continue;
        }
        const int kc = tid & 15;
        float a8[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a8[i] = 0.f;
        for (int r = lo + (tid >> 4); r < hi; r += kThreads / 16) {
          const uint4 v = *reinterpret_cast<const uint4*>(x2 + kc * ldk + r * 8);
          const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
          for (int i = 0; i < 8; ++i) a8[i] += __bfloat162float(e[i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) a8[i] += __shfl_xor_sync(0xffffffffu, a8[i], 16);
        if ((tid & 16) == 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i) scratch[(tid >> 5) * kBn + kc * 8 + i] = a8[i];
        }
        __syncthreads();
        if (tid < kBn) {
          float acc = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) acc += scratch[w * kBn + tid];
          segsum[sg * kBn + tid] = acc;
        }
        __syncthreads();
      }
      utt_sync(cs);  // every block's x2 and partial sums are visible

      // totals of all ranks' partial sums, in rank order; with one block
      // the block's own sums are the totals
      const float* tot_seg = segsum;
      if (cs > 1) {
        // halo: the neighbours' edge rows into this block's guard rows
        if (tid < 64) {
          const int right = tid >> 5, row = (tid >> 4) & 1, kc = tid & 15;
          // rank - 1 owns a full R rows whenever this block owns any;
          // rank + 1 owns >= 16 rows whenever r1 < t16
          if (right ? r1 < t16 : rank > 0 && nr > 0) {
            const int dst = right ? nr + row : row - kGuard;
            const int src = right ? row : R - kGuard + row;
            const bf16* peer_x2 = peer(x2, rank + (right ? 1 : -1), cs);
            *reinterpret_cast<uint4*>(x2 + kc * ldk + dst * 8) =
                *reinterpret_cast<const uint4*>(peer_x2 + kc * ldk + src * 8);
          }
        }
        for (int i = tid; i < nseg * kBn; i += kThreads) {
          float acc = 0.f;
          for (int k = 0; k < cs; ++k) acc += peer(segsum, k, cs)[i];
          ctx[i] = acc;
        }
        cluster_arrive();  // done reading peers; waited on at the next layer
        tot_seg = ctx;
      }
      stamp.lap(kCamSums);

      // local k3 dilated conv 128 -> 32 on wgmma, a tile a warpgroup,
      // issued now and waited for after the gate MLP
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
      float yacc[16];
      const uint32_t wl_s = ring_s + kRingLocal;
      if (ps.tile * kTile < nc) local_conv(yacc, x2_s, ldk, 0, dil, wl_s);
      stamp.lap(kLocalConv);

      // ctx of the segments this block needs (in place over the totals)
      if (tid < kBn) {
        float tot = 0.f;
        for (int sg = 0; sg < nseg; ++sg) tot += tot_seg[sg * kBn + tid];
        const float mean = tot / (float)tv;
        for (int sg = sg_lo; sg < sg_lo + nsg_own; ++sg) {
          const int cnt = min((sg + 1) * kSeg, tv) - sg * kSeg;
          ctx[sg * kBn + tid] = bfr(mean + tot_seg[sg * kBn + tid] / (float)cnt);
        }
      }
      __syncthreads();
      // 128 -> 64, ReLU: four threads an output, 32 terms each
      if (tid < 4 * kHid) {
        for (int sg = sg_lo; sg < sg_lo + nsg_own; ++sg) {
          const int j = tid >> 2, part = tid & 3;
          float acc = 0.f;
#pragma unroll 8
          for (int c = part * 32; c < part * 32 + 32; ++c)
            acc = fmaf(ctx[sg * kBn + c], __bfloat162float(w1s[c * kHid + j]), acc);
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          acc += __shfl_xor_sync(0xffffffffu, acc, 2);
          if (part == 0) c1[sg * kHid + j] = bfr(fmaxf(acc + cb[2 * kGrowth + j], 0.f));
        }
      }
      __syncthreads();
      // 64 -> 32, sigmoid: eight threads an output, 8 terms each
      if (tid < 8 * kGrowth) {
        for (int sg = sg_lo; sg < sg_lo + nsg_own; ++sg) {
          const int j = tid >> 3, part = tid & 7;
          float acc = 0.f;
#pragma unroll
          for (int c = part * 8; c < part * 8 + 8; ++c)
            acc = fmaf(c1[sg * kHid + c], __bfloat162float(w2s[c * kGrowth + j]), acc);
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          acc += __shfl_xor_sync(0xffffffffu, acc, 2);
          acc += __shfl_xor_sync(0xffffffffu, acc, 4);
          if (part == 0) {
            acc += cb[kGrowth + j];
            gate[sg * kGrowth + j] = bfr(1.f / (1.f + expf(-acc)));
          }
        }
      }
      __syncthreads();
      stamp.lap(kGateMlp);

      // gate the local conv, mask, append 32 channels to the concat
      const int c0 = c_in + li * kGrowth;
      for (int rp = 0; rp < nc; rp += kPassRows) {
        const bool mine = rp + ps.tile * kTile < nc;
        if (rp > 0 && mine) local_conv(yacc, x2_s, ldk, rp, dil, wl_s);
        wgmma_wait<0>();
        fence_regs(yacc);
        if (!mine) continue;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = ps.row(rp, h), c = ps.col(nb);
            if (row >= nc) continue;
            const int g = r0 + row;
            float v0 = 0.f, v1 = 0.f;
            if (g < tv) {
              const float* gt = gate + (g / kSeg) * kGrowth;
              v0 = (yacc[4 * nb + 2 * h] + cb[c]) * gt[c];
              v1 = (yacc[4 * nb + 2 * h + 1] + cb[c + 1]) * gt[c + 1];
            }
            *reinterpret_cast<__nv_bfloat162*>(X + (size_t)g * kWide + c0 + c) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
      __syncthreads();
      stamp.lap(kAppend);
    }

    // transit: wide BN-ReLU (bf16), 1x1 conv cw -> cw/2, mask, into the
    // other buffer
    const int cw = c_in + n_layers * kGrowth;
    const bf16* wt = blk == 0 ? p.w_t0 : (blk == 1 ? p.w_t1 : p.w_t2);
    seq = gemm<KT>(WideA{&args.ws, cur * p.B + b, p.wide_ab + (size_t)(kLayers + blk) * 2 * kWide,
                         X},
                   r0, nc, cw, wt, cw / 2 / kNP,
                   TransitEpi{bufs[cur ^ 1], p.tbias + (size_t)blk * kFinal, r0, nc, tv}, ring,
                   ab_s, bars, seq, slices_of(cw) - 1, ring_count);
    cur ^= 1;
    c_in = cw / 2;
    stamp.lap(kTransits);
  }
  if (cs > 1) cluster_wait();  // the last layer's second barrier

  // out BN-ReLU (fp32) + mean || biased std over the valid frames:
  // partial sums -> mean in every block, then partial squared deviations
  // -> std in rank 0
  const bf16* Xf = bufs[cur];
  float* psum = reinterpret_cast<float*>(ring);
  float* psq = psum + kFinal;
  for (int c = tid; c < kFinal; c += kThreads) {
    const float a = p.out_aff[c], bb = p.out_aff[kFinal + c];
    float sum = 0.f;
    for (int r = r0; r < rv; ++r)
      sum += fmaxf(__bfloat162float(Xf[(size_t)r * kWide + c]) * a + bb, 0.f);
    psum[c] = sum;
  }
  utt_sync(cs);
  for (int c = tid; c < kFinal; c += kThreads) {
    const float a = p.out_aff[c], bb = p.out_aff[kFinal + c];
    float sum = 0.f;
    for (int k = 0; k < cs; ++k) sum += peer(psum, k, cs)[c];
    const float mean = sum / (float)tv;
    float sq = 0.f;
    for (int r = r0; r < rv; ++r) {
      const float d =
          fmaxf(__bfloat162float(Xf[(size_t)r * kWide + c]) * a + bb, 0.f) - mean;
      sq += d * d;
    }
    psq[c] = sq;
    if (rank == 0) p.out[(size_t)b * 2 * kFinal + c] = mean;
  }
  utt_sync(cs);
  if (rank == 0) {
    for (int c = tid; c < kFinal; c += kThreads) {
      float sq = 0.f;
      for (int k = 0; k < cs; ++k) sq += peer(psq, k, cs)[c];
      p.out[(size_t)b * 2 * kFinal + kFinal + c] = sqrtf(sq / (float)tv);
    }
  }
  stamp.lap(kPooling);
  // no block leaves while rank 0 still reads its shared memory
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

// the launch configuration of `cs`-block clusters over B utterances
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

// The kernel's dynamic shared-memory limit is one setting per device for
// the whole process. Setting it per launch to that launch's size would let
// a thread lower it between another thread's set and launch (a server
// launches b1 x 398 and b32 x 1598 from many threads), so each device gets
// it once, under a lock, at the largest size any launch asks for. A launch
// still asks for its own size, and occupancy follows that.
constexpr int kMaxDevices = 64;

cudaError_t allow_max_smem() {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(campplus_trunk_kernel<kSmallTiles>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kSmallTiles * kTile, kMaxT16));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(campplus_trunk_kernel<kBigTiles>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxR, kMaxT16));
  done[dev] = err == cudaSuccess;
  return err;
}

cudaError_t configure(Launch& l, int B, int cs, int R, int t_valid, cudaStream_t stream) {
  const size_t smem = smem_bytes(R, t_valid);
  cudaError_t err = allow_max_smem();
  if (err != cudaSuccess) return err;
  l.cfg = cudaLaunchConfig_t{};
  l.cfg.gridDim = dim3(B * cs);
  l.cfg.blockDim = dim3(128 * pass_tiles(R));
  l.cfg.dynamicSmemBytes = smem;
  l.cfg.stream = stream;
  l.attr[0].id = cudaLaunchAttributeClusterDimension;
  l.attr[0].val.clusterDim.x = cs;
  l.attr[0].val.clusterDim.y = 1;
  l.attr[0].val.clusterDim.z = 1;
  l.cfg.attrs = l.attr;
  l.cfg.numAttrs = 1;
  return cudaSuccess;
}

// the build for blocks of R rows
typedef void (*TrunkKernel)(KernelArgs);
TrunkKernel kernel_for(int R) {
  return pass_tiles(R) == kSmallTiles ? campplus_trunk_kernel<kSmallTiles>
                                      : campplus_trunk_kernel<kBigTiles>;
}

// The concat workspace as a TMA tensor map: (1024 columns, t16 rows, 2 B
// utterance buffers) of bf16, boxes of 64 columns x 64 rows in the
// 128-byte swizzle; rows past t16 read as zero. cuTensorMapEncodeTiled comes from
// the driver through the runtime, so the library links no libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_ws_map(CUtensorMap* map, const TrunkParams& p) {
  static EncodeTiled encode = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<EncodeTiled>(fn);
  });
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)kWide, (cuuint64_t)p.t16, 2ull * p.B};
  const cuuint64_t strides[2] = {2ull * kWide, 2ull * kWide * p.t16};
  const cuuint32_t box[3] = {kKS, kTile, 1}, elem[3] = {1, 1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, p.ws, dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool bad_split(int cs, int R, int t_valid) {
  return cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) != 0 || R < 16 || R % 16 != 0 ||
         R > kMaxR || t_valid <= 0 || t_valid > kMaxT16;
}

}  // namespace

// How many clusters of `cs` blocks of R rows can be resident at once
// (cudaOccupancyMaxActiveClusters); 0 means such a launch cannot run.
extern "C" int vpr_campplus_trunk_max_clusters(int cs, int R, int t_valid, int* n) {
  if (bad_split(cs, R, t_valid)) return (int)cudaErrorInvalidValue;
  Launch l;
  cudaError_t err = configure(l, 1, cs, R, t_valid, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(n, (const void*)kernel_for(R), &l.cfg);
}

// The launch a block of R rows takes: its threads and dynamic shared
// memory bytes.
extern "C" int vpr_campplus_trunk_block(int R, int t_valid, int* threads, int* smem) {
  if (bad_split(1, R, t_valid)) return (int)cudaErrorInvalidValue;
  *threads = 128 * pass_tiles(R);
  *smem = (int)smem_bytes(R, t_valid);
  return (int)cudaSuccess;
}

extern "C" int vpr_campplus_trunk(TrunkParams p, void* stream) {
  if (p.B <= 0 || bad_split(p.cs, p.R, p.t_valid) || p.t16 % 16 != 0 ||
      p.t16 < p.t_valid || p.t16 > kMaxT16 || (long long)p.R * p.cs < p.t16)
    return (int)cudaErrorInvalidValue;
  Launch l;
  cudaError_t err = configure(l, p.B, p.cs, p.R, p.t_valid, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  KernelArgs args;
  args.p = p;
  err = encode_ws_map(&args.ws, p);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&l.cfg, kernel_for(p.R), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
