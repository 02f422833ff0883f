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
// What bounds it on the H100: about 1.8 GFLOP per 3 s utterance, nearly
// all in the 52 1x1 products over the growing concat (K up to 992, N 128)
// and the transits. Each utterance needs about 12 MB of bf16 weights,
// which stay in the 50 MB L2 and are shared by all blocks. So it is bound
// by the tensor cores' issue rate and by the per-layer synchronisation
// inside a block, not by device memory; and a block works through its
// rows one 64-row chunk at a time, so its time grows with its rows.
//
// Design: a thread-block cluster of cs blocks (8 warps each) per
// utterance (trunk_kernel.trunk_split picks cs in {1, 2, 4, 8}). Block
// rank k owns trunk rows [k R, min((k + 1) R, t16)), R a multiple of 16
// and at most 400; a trailing block may own none. A short clip or a small
// batch so spreads over more SMs; at cs = 1 (b256 x 3 s) the kernel is
// one block per utterance, as before. The stem, each layer's wide BN-ReLU
// and 1x1 bottleneck, the gated append and the transits are row-local: a
// block runs them over its own rows of the concat, which lives in a
// global workspace of two ping-pong buffers (a transit reads one and
// writes the other), so no block touches another's concat rows. x2 (R x
// 128 bf16) and the local conv's output stay in shared memory. Three
// things cross blocks, through distributed shared memory (DSMEM):
//   - the x2 halo: the dilated k3 conv (dilation <= kGuard = 2) reads
//     the two x2 rows on each side that the neighbouring ranks own. Each
//     block copies them into its guard rows after a cluster barrier, so
//     the conv's wmma loads read only the block's own shared memory. At
//     the utterance's edges the guard rows stay zero; rows past the valid
//     count are zero in x2 anyway.
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
// cannot pass (5) before every peer arrived in (4). That is two barriers
// per layer (about 110), the second one's wait hidden behind the layer's
// own work; double-buffering the edge rows and sums by layer parity would
// save one barrier a layer at the cost of a copy, and is not needed at
// this size. Every block reaches every barrier, rows or not, and the
// kernel ends with a barrier so no block leaves while rank 0 still reads
// its shared memory. With cs = 1 the barriers are __syncthreads() and the
// peers' data is the block's own, so the fp32 sums run in the one-block
// order; with cs > 1 only the order of the fp32 partial sums changes.
// Products use nvcuda::wmma bf16 16x16x16 fragments with fp32
// accumulation: a 64-row x 128-column output chunk at a time, with A
// (after its BN-ReLU transform) and B staged in shared memory in K-slices
// of 64. Rounding points follow the TPU kernel so the plain PyTorch
// version (trunk_kernel.trunk_stats_reference) matches closely. wgmma,
// TMA, double buffering and the concat in shared memory are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;
using namespace nvcuda;
typedef __nv_bfloat16 bf16;

struct TrunkParams {
  const bf16* x;          // (B, T_raw, 320) FCM output, frequency-major
  const int* tvalid;      // (B,) valid trunk frames, in [1, t_valid]
  float* out;             // (B, 1024) mean || biased std
  bf16* ws;               // (2, B, t16, 1024) concat ping-pong workspace
  const bf16* w_stem;     // (5 * 320, 128), tap-major rows
  const float* stem_aff;  // (3, 128): conv bias, BN a, BN b
  const bf16* w_lin1;     // (sum cin, 128)
  const float* lin1_aff;  // (52, 3, 128): conv bias, BN a, BN b
  const bf16* wide_ab;    // (55, 2, 1024): wide BN a, b (layers, transits)
  const bf16* w_local;    // (52, 3 * 128, 32), rows tap * 128 + c
  const bf16* w_cam1;     // (52, 128, 64)
  const bf16* w_cam2;     // (52, 64, 32)
  const float* cam_bias;  // (52, 128): local | cam2 | cam1 biases
  const bf16* w_t0;       // (512, 256)
  const bf16* w_t1;       // (1024, 512)
  const bf16* w_t2;       // (1024, 512)
  const float* tbias;     // (3, 512)
  const float* out_aff;   // (2, 512)
  int B, T_raw, t_valid, t16;
  int cs;                 // blocks of a cluster per utterance: 1, 2, 4 or 8
  int R;                  // trunk rows a block owns: a multiple of 16, <= 400
};

namespace {

constexpr int kThreads = 256, kWarps = 8;
constexpr int kMC = 64, kKC = 64, kNC = 128;   // GEMM chunk
constexpr int kALd = kKC + 8, kBLd = kNC + 8, kCLd = kNC + 4;
constexpr int kX2Ld = 144;                     // 288 B rows: 32 B aligned
constexpr int kYLd = 36;
constexpr int kGuard = 2;                      // max dilation
constexpr int kStemIn = 320, kInit = 128, kBn = 128, kGrowth = 32;
constexpr int kHid = 64, kWide = 1024, kFinal = 512, kSeg = 100;
constexpr int kLayers = 52;
constexpr int kMaxR = 400;        // rows a block holds in shared memory
constexpr int kMaxT16 = 1600;     // the 32 s bucket (3198 frames)
constexpr int kMaxCluster = 8;    // the portable cluster size
__constant__ int kBlockLayers[3] = {12, 24, 16};
__constant__ int kBlockDil[3] = {1, 2, 2};

constexpr size_t kStageBytes =
    sizeof(bf16) * (kMC * kALd + kKC * kBLd) + sizeof(float) * kMC * kCLd;
static_assert(kStageBytes >= sizeof(float) * 2 * kFinal, "pool partials");

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

struct Smem {
  bf16* x2;      // local row 0 = the block's first row; rows -kGuard ..
                 // R + kGuard - 1 exist (the guard rows hold the halo)
  bf16* sA;
  bf16* sB;
  float* sC;
  float* sY;     // aliases sA/sB/sC (used in another phase): the local
                 // conv's (R, kYLd) output; at the end the pooling's
                 // partial sums (512) and squared deviations (512)
  float* segsum; // (segs, 128) this block's partial segment sums
  float* ctx;    // (segs, 128): rank-order segment totals, then bf16 ctx
  float* c1;     // (segs, 64), bf16-rounded values
  float* gate;   // (segs, 32), bf16-rounded values
};

__host__ __device__ inline size_t x2_bytes(int R) {
  return align128(sizeof(bf16) * (size_t)(R + 2 * kGuard) * kX2Ld);
}
__host__ __device__ inline size_t union_bytes(int R) {
  size_t y = sizeof(float) * (size_t)R * kYLd;
  return align128(y > kStageBytes ? y : kStageBytes);
}
__host__ __device__ inline int seg_cap(int t_valid) { return (t_valid + kSeg - 1) / kSeg; }
__host__ __device__ inline size_t small_bytes(int t_valid) {
  return align128(sizeof(float) * seg_cap(t_valid) * (128 + 128 + kHid + kGrowth));
}
// shared memory of a block: x2, the GEMM stage (which the local conv's
// output and the pooling partials alias) and the CAM segment arrays
__host__ __device__ inline size_t smem_bytes(int R, int t_valid) {
  return x2_bytes(R) + union_bytes(R) + small_bytes(t_valid);
}

__device__ inline float bfr(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(v));
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

// relu(bf16(bf16(x * a) + b)) on 8 bf16 lanes
__device__ inline uint4 wide_relu8(uint4 xv, uint4 av, uint4 bv) {
  const bf16* x = reinterpret_cast<const bf16*>(&xv);
  const bf16* a = reinterpret_cast<const bf16*>(&av);
  const bf16* b = reinterpret_cast<const bf16*>(&bv);
  uint4 out;
  bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float p = bfr(__bfloat162float(x[i]) * __bfloat162float(a[i]));
    float s = p + __bfloat162float(b[i]);
    o[i] = __float2bfloat16_rn(fmaxf(s, 0.f));
  }
  return out;
}

// A operand of the stem: row r, columns k..k+7 of the implicit im2col
// (tap = k / 320, channel = k % 320), reading FCM row 2r + tap - 2.
struct StemLoader {
  const bf16* x;  // this utterance's (T_raw, 320)
  int T_raw;
  __device__ uint4 operator()(int r, int k) const {
    const int tap = k / kStemIn, c = k - tap * kStemIn;
    const int src = 2 * r + tap - 2;
    if (src < 0 || src >= T_raw) return make_uint4(0, 0, 0, 0);
    return __ldg(reinterpret_cast<const uint4*>(x + (size_t)src * kStemIn + c));
  }
};

// A operand of a 1x1 conv over the concat: the wide BN-ReLU of xcat.
// xcat is written inside this kernel, so it is read with plain loads; rows
// from `rend` on belong to another block (or to none) and read as zero.
struct WideLoader {
  const bf16* xcat;  // this utterance's (t16, 1024)
  const bf16* a;     // (1024,)
  const bf16* b;     // (1024,)
  int rend;
  __device__ uint4 operator()(int r, int k) const {
    if (r >= rend) return make_uint4(0, 0, 0, 0);
    const uint4 xv = *reinterpret_cast<const uint4*>(xcat + (size_t)r * kWide + k);
    const uint4 av = __ldg(reinterpret_cast<const uint4*>(a + k));
    const uint4 bv = __ldg(reinterpret_cast<const uint4*>(b + k));
    return wide_relu8(xv, av, bv);
  }
};

// sC[0:64, 0:128] = A[m0:m0+64, 0:K] @ B[0:K, n0:n0+128] in fp32. Warp w
// owns output columns 16w..16w+15 and all four 16-row tiles. Ends with a
// __syncthreads(), so sC is ready for the caller's epilogue.
template <class LoadA>
__device__ void gemm_chunk(const LoadA& load_a, int m0, int K,
                           const bf16* __restrict__ B, int ldb, int n0,
                           const Smem& s) {
  const int warp = threadIdx.x >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int k0 = 0; k0 < K; k0 += kKC) {
    for (int v = threadIdx.x; v < kMC * kKC / 8; v += kThreads) {
      const int r = v / (kKC / 8), kk = (v % (kKC / 8)) * 8;
      const uint4 val = (k0 + kk < K) ? load_a(m0 + r, k0 + kk)
                                      : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(s.sA + r * kALd + kk) = val;
    }
    for (int v = threadIdx.x; v < kKC * kNC / 8; v += kThreads) {
      const int r = v / (kNC / 8), c = (v % (kNC / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < K)
        val = __ldg(reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * ldb + n0 + c));
      *reinterpret_cast<uint4*>(s.sB + r * kBLd + c) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
      wmma::load_matrix_sync(bfrag, s.sB + kk * kBLd + warp * 16, kBLd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
        wmma::load_matrix_sync(afrag, s.sA + i * 16 * kALd + kk, kALd);
        wmma::mma_sync(acc[i], afrag, bfrag, acc[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    wmma::store_matrix_sync(s.sC + i * 16 * kCLd + warp * 16, acc[i], kCLd,
                            wmma::mem_row_major);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
campplus_trunk_kernel(TrunkParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int t16 = p.t16, cs = p.cs, R = p.R;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.x / cs, rank = blockIdx.x % cs;
  const int segs = seg_cap(p.t_valid);
  Smem s;
  {
    unsigned char* q = smem_raw;
    s.x2 = reinterpret_cast<bf16*>(q) + kGuard * kX2Ld;
    q += x2_bytes(R);
    s.sA = reinterpret_cast<bf16*>(q);
    s.sB = s.sA + kMC * kALd;
    s.sC = reinterpret_cast<float*>(s.sB + kKC * kBLd);
    s.sY = reinterpret_cast<float*>(q);
    q += union_bytes(R);
    s.segsum = reinterpret_cast<float*>(q);
    s.ctx = s.segsum + segs * 128;
    s.c1 = s.ctx + segs * 128;
    s.gate = s.c1 + segs * kHid;
  }
  const int tv = min(max(p.tvalid[b], 1), p.t_valid);
  // this block's rows [r0, r1) and valid rows [r0, rv)
  const int r0 = min(rank * R, t16), r1 = min(r0 + R, t16), nr = r1 - r0;
  const int rv = max(r0, min(r1, tv));
  const size_t buf_stride = (size_t)p.B * t16 * kWide;
  bf16* bufs[2] = {p.ws + (size_t)b * t16 * kWide,
                   p.ws + buf_stride + (size_t)b * t16 * kWide};

  // zero guard rows of x2 (before row 0 and after row nr - 1); those a
  // neighbour feeds are rewritten per layer
  for (int i = tid; i < kGuard * kX2Ld; i += kThreads) {
    s.x2[i - kGuard * kX2Ld] = __float2bfloat16_rn(0.f);
    s.x2[(size_t)nr * kX2Ld + i] = __float2bfloat16_rn(0.f);
  }

  // ---- stem: k5 s2 conv 320 -> 128, BN-ReLU, mask -> concat[:, :128] ----
  {
    const StemLoader ld{p.x + (size_t)b * p.T_raw * kStemIn, p.T_raw};
    bf16* X = bufs[0];
    for (int m0 = r0; m0 < r1; m0 += kMC) {
      gemm_chunk(ld, m0, 5 * kStemIn, p.w_stem, kInit, 0, s);
      for (int i = tid; i < kMC * kInit; i += kThreads) {
        const int r = m0 + i / kInit, c = i % kInit;
        if (r >= r1) continue;
        float v = s.sC[(i / kInit) * kCLd + c] + p.stem_aff[c];
        v = fmaxf(v * p.stem_aff[kInit + c] + p.stem_aff[2 * kInit + c], 0.f);
        X[(size_t)r * kWide + c] = __float2bfloat16_rn(r < tv ? v : 0.f);
      }
      __syncthreads();
    }
  }

  int cur = 0, layer = 0, c_in = kInit;
  size_t lin1_off = 0;
  const int nseg = (tv + kSeg - 1) / kSeg;
  // the segments this block's valid rows touch: [sg_lo, sg_lo + nsg_own)
  const int sg_lo = r0 / kSeg;
  const int nsg_own = rv > r0 ? (rv - 1) / kSeg - sg_lo + 1 : 0;
  for (int blk = 0; blk < 3; ++blk) {
    const int n_layers = kBlockLayers[blk], dil = kBlockDil[blk];
    bf16* X = bufs[cur];
    for (int li = 0; li < n_layers; ++li, ++layer) {
      const int cin = c_in + li * kGrowth;
      const bf16* wab = p.wide_ab + (size_t)layer * 2 * kWide;
      const float* la = p.lin1_aff + (size_t)layer * 3 * kBn;
      const float* cb = p.cam_bias + (size_t)layer * 128;

      // peers have read this block's x2 edges and partial sums of the
      // previous layer (their arrive after the reads, below)
      if (cs > 1 && layer > 0) cluster_wait();

      // 1x1 bottleneck cin -> 128 over the wide BN-ReLU, then BN-ReLU, mask
      const WideLoader ld{X, wab, wab + kWide, r1};
      for (int m0 = r0; m0 < r1; m0 += kMC) {
        gemm_chunk(ld, m0, cin, p.w_lin1 + lin1_off * kBn, kBn, 0, s);
        for (int i = tid; i < kMC * kBn; i += kThreads) {
          const int r = m0 + i / kBn, c = i % kBn;
          if (r >= r1) continue;
          float v = s.sC[(i / kBn) * kCLd + c] + la[c];
          v = fmaxf(v * la[kBn + c] + la[2 * kBn + c], 0.f);
          s.x2[(size_t)(r - r0) * kX2Ld + c] = __float2bfloat16_rn(r < tv ? v : 0.f);
        }
        __syncthreads();
      }
      lin1_off += cin;

      // CAM context: this block's partial per-segment sums of x2 over its
      // valid rows (zero for segments it does not touch)
      if (tid < kBn) {
        for (int sg = 0; sg < nseg; ++sg) {
          const int lo = max(sg * kSeg, r0), hi = min((sg + 1) * kSeg, rv);
          float acc = 0.f;
          for (int r = lo; r < hi; ++r)
            acc += __bfloat162float(s.x2[(size_t)(r - r0) * kX2Ld + tid]);
          s.segsum[sg * kBn + tid] = acc;
        }
      }
      utt_sync(cs);  // every block's x2 and partial sums are visible

      // totals of all ranks' partial sums, in rank order; with one block
      // the block's own sums are the totals
      const float* tot_seg = s.segsum;
      if (cs > 1) {
        // halo: the neighbours' edge rows into this block's guard rows
        if (tid < 64) {
          const int right = tid >> 5, row = (tid >> 4) & 1, col = (tid & 15) * 8;
          // rank - 1 owns a full R rows whenever this block owns any;
          // rank + 1 owns >= 16 rows whenever r1 < t16
          if (right ? r1 < t16 : rank > 0 && nr > 0) {
            const int dst = right ? nr + row : row - kGuard;
            const int src = right ? row : R - kGuard + row;
            const bf16* peer_x2 = peer(s.x2, rank + (right ? 1 : -1), cs);
            *reinterpret_cast<uint4*>(s.x2 + (ptrdiff_t)dst * kX2Ld + col) =
                *reinterpret_cast<const uint4*>(peer_x2 + (ptrdiff_t)src * kX2Ld + col);
          }
        }
        for (int i = tid; i < nseg * kBn; i += kThreads) {
          float acc = 0.f;
          for (int k = 0; k < cs; ++k) acc += peer(s.segsum, k, cs)[i];
          s.ctx[i] = acc;
        }
        cluster_arrive();  // done reading peers; waited on at the next layer
        __syncthreads();
        tot_seg = s.ctx;
      }
      const bf16* wl = p.w_local + (size_t)layer * 3 * kBn * kGrowth;

      // local k3 dilated conv 128 -> 32 over shifted x2 rows -> sY (fp32)
      for (int tile = warp; tile < (nr / 16) * 2; tile += kWarps) {
        const int mt = tile >> 1, nt = tile & 1;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int tap = 0; tap < 3; ++tap) {
          const bf16* arow = s.x2 + (ptrdiff_t)(mt * 16 + (tap - 1) * dil) * kX2Ld;
#pragma unroll
          for (int kk = 0; kk < kBn; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfg;
            wmma::load_matrix_sync(af, arow + kk, kX2Ld);
            wmma::load_matrix_sync(bfg, wl + (size_t)(tap * kBn + kk) * kGrowth + nt * 16,
                                   kGrowth);
            wmma::mma_sync(acc, af, bfg, acc);
          }
        }
        wmma::store_matrix_sync(s.sY + mt * 16 * kYLd + nt * 16, acc, kYLd,
                                wmma::mem_row_major);
      }

      // ctx of the segments this block needs (in place over the totals)
      if (tid < kBn) {
        float tot = 0.f;
        for (int sg = 0; sg < nseg; ++sg) tot += tot_seg[sg * kBn + tid];
        const float mean = tot / (float)tv;
        for (int sg = sg_lo; sg < sg_lo + nsg_own; ++sg) {
          const int cnt = min((sg + 1) * kSeg, tv) - sg * kSeg;
          s.ctx[sg * kBn + tid] = bfr(mean + tot_seg[sg * kBn + tid] / (float)cnt);
        }
      }
      __syncthreads();
      // 128 -> 64, ReLU
      for (int i = tid; i < nsg_own * kHid; i += kThreads) {
        const int sg = sg_lo + i / kHid, j = i % kHid;
        const bf16* w1 = p.w_cam1 + (size_t)layer * kBn * kHid;
        float acc = 0.f;
        for (int c = 0; c < kBn; ++c)
          acc = fmaf(s.ctx[sg * kBn + c], __bfloat162float(w1[c * kHid + j]), acc);
        s.c1[sg * kHid + j] = bfr(fmaxf(acc + cb[2 * kGrowth + j], 0.f));
      }
      __syncthreads();
      // 64 -> 32, sigmoid
      for (int i = tid; i < nsg_own * kGrowth; i += kThreads) {
        const int sg = sg_lo + i / kGrowth, j = i % kGrowth;
        const bf16* w2 = p.w_cam2 + (size_t)layer * kHid * kGrowth;
        float acc = 0.f;
        for (int c = 0; c < kHid; ++c)
          acc = fmaf(s.c1[sg * kHid + c], __bfloat162float(w2[c * kGrowth + j]), acc);
        acc += cb[kGrowth + j];
        s.gate[sg * kGrowth + j] = bfr(1.f / (1.f + expf(-acc)));
      }
      __syncthreads();

      // gate the local conv, mask, append 32 channels to the concat
      const int c0 = c_in + li * kGrowth;
      for (int i = tid; i < nr * kGrowth; i += kThreads) {
        const int r = i / kGrowth, j = i % kGrowth, g = r0 + r;
        float v = 0.f;
        if (g < tv)
          v = (s.sY[r * kYLd + j] + cb[j]) * s.gate[(g / kSeg) * kGrowth + j];
        X[(size_t)g * kWide + c0 + j] = __float2bfloat16_rn(v);
      }
      __syncthreads();
    }

    // transit: wide BN-ReLU (bf16), 1x1 conv cw -> cw/2, mask, into the
    // other buffer
    const int cw = c_in + n_layers * kGrowth;
    const bf16* wab = p.wide_ab + (size_t)(kLayers + blk) * 2 * kWide;
    const bf16* wt = blk == 0 ? p.w_t0 : (blk == 1 ? p.w_t1 : p.w_t2);
    const float* tb = p.tbias + (size_t)blk * kFinal;
    bf16* Y = bufs[cur ^ 1];
    const WideLoader ld{X, wab, wab + kWide, r1};
    for (int m0 = r0; m0 < r1; m0 += kMC) {
      for (int n0 = 0; n0 < cw / 2; n0 += kNC) {
        gemm_chunk(ld, m0, cw, wt, cw / 2, n0, s);
        for (int i = tid; i < kMC * kNC; i += kThreads) {
          const int r = m0 + i / kNC, c = i % kNC;
          if (r >= r1) continue;
          const float v = s.sC[(i / kNC) * kCLd + c] + tb[n0 + c];
          Y[(size_t)r * kWide + n0 + c] = __float2bfloat16_rn(r < tv ? v : 0.f);
        }
        __syncthreads();
      }
    }
    cur ^= 1;
    c_in = cw / 2;
  }
  if (cs > 1) cluster_wait();  // the last layer's second barrier

  // out BN-ReLU (fp32) + mean || biased std over the valid frames:
  // partial sums -> mean in every block, then partial squared deviations
  // -> std in rank 0
  const bf16* Xf = bufs[cur];
  float* psum = s.sY;
  float* psq = s.sY + kFinal;
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
  err = cudaFuncSetAttribute(campplus_trunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  l.cfg.blockDim = dim3(kThreads);
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
  return (int)cudaOccupancyMaxActiveClusters(n, (const void*)campplus_trunk_kernel, &l.cfg);
}

extern "C" int vpr_campplus_trunk(TrunkParams p, void* stream) {
  if (p.B <= 0 || bad_split(p.cs, p.R, p.t_valid) || p.t16 % 16 != 0 ||
      p.t16 < p.t_valid || p.t16 > kMaxT16 || (long long)p.R * p.cs < p.t16)
    return (int)cudaErrorInvalidValue;
  Launch l;
  cudaError_t err = configure(l, p.B, p.cs, p.R, p.t_valid, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&l.cfg, campplus_trunk_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
