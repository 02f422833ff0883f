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
// inside a block, not by device memory.
//
// Design: one thread block (8 warps) per utterance; the block loops over
// the stem, the 52 layers, the transits and the pooling, so there is no
// reduction across blocks. The growing concat (t16 x 1024 bf16) lives in a
// global workspace of two ping-pong buffers (a transit reads one and
// writes the other). Up to the 8 s bucket (t16 <= 400), x2 (t16 x 128
// bf16) and the local conv's output stay in shared memory, and a layer
// runs x2, the local conv, the segment sums, the gate, then the gated
// append. Past that (the long mode, to t16 = 1600: 462 KB of x2 alone at
// the shared layout, against 227 KB a block), x2 lives in a per-utterance
// global scratch (t16 x 128 bf16, 410 KB at 32 s, which stays in L2) and a
// layer runs x2 over all rows with the segment sums taken in its
// epilogue, then the gate, then the local conv per 16-row tile with the
// gate, mask and append in its epilogue, so the local conv's output is
// never stored. Products use nvcuda::wmma bf16 16x16x16 fragments with
// fp32 accumulation: a 64-row x 128-column output chunk at a time, with A
// (after its BN-ReLU transform) and B staged in shared memory in K-slices
// of 64. The dilated conv reads x2 at shifted rows from shared memory,
// with zero guard rows at both ends and zero rows past the valid count.
// Rounding points follow the TPU kernel so the plain PyTorch version
// (trunk_kernel.trunk_stats_reference) matches closely. wgmma, TMA,
// double buffering and persistent blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

struct TrunkParams {
  const bf16* x;          // (B, T_raw, 320) FCM output, frequency-major
  const int* tvalid;      // (B,) valid trunk frames, in [1, t_valid]
  float* out;             // (B, 1024) mean || biased std
  bf16* ws;               // (2, B, t16, 1024) concat ping-pong workspace
  bf16* x2s;              // long mode: (B, t16 + 4, 128) x2 scratch, else null
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
constexpr int kMaxT = 400;        // shared-memory x2 up to this t16
constexpr int kMaxTLong = 1600;   // the 32 s bucket (3198 frames)
__constant__ int kBlockLayers[3] = {12, 24, 16};
__constant__ int kBlockDil[3] = {1, 2, 2};

constexpr size_t kStageBytes =
    sizeof(bf16) * (kMC * kALd + kKC * kBLd) + sizeof(float) * kMC * kCLd;

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

struct Smem {
  bf16* x2;      // row 0 of x2; rows -kGuard .. t16 + kGuard - 1 exist
  bf16* sA;
  bf16* sB;
  float* sC;
  float* sY;     // aliases sA/sB/sC (used in another phase); in the long
                 // mode, per-warp (16, kYLd) staging of the local conv
  float* segsum; // (segs, 128), segs = ceil(t_valid / 100)
  float* ctx;    // (segs, 128), bf16-rounded values
  float* c1;     // (segs, 64), bf16-rounded values
  float* gate;   // (segs, 32), bf16-rounded values
};

__host__ __device__ inline size_t x2_bytes(int t16) {
  return align128(sizeof(bf16) * (size_t)(t16 + 2 * kGuard) * kX2Ld);
}
__host__ __device__ inline size_t union_bytes(int t16) {
  size_t y = sizeof(float) * (size_t)t16 * kYLd;
  return align128(y > kStageBytes ? y : kStageBytes);
}
__host__ __device__ inline int seg_cap(int t_valid) { return (t_valid + kSeg - 1) / kSeg; }
__host__ __device__ inline size_t small_bytes(int t_valid) {
  return align128(sizeof(float) * seg_cap(t_valid) * (128 + 128 + kHid + kGrowth));
}
// shared memory of a block: the short mode holds x2; the long mode only the
// GEMM stage (which the per-warp local-conv staging aliases)
__host__ __device__ inline size_t smem_bytes(bool long_mode, int t16, int t_valid) {
  return long_mode ? align128(kStageBytes) + small_bytes(t_valid)
                   : x2_bytes(t16) + union_bytes(t16) + small_bytes(t_valid);
}

__device__ inline float bfr(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(v));
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
// xcat is written inside this kernel, so it is read with plain loads.
struct WideLoader {
  const bf16* xcat;  // this utterance's (t16, 1024)
  const bf16* a;     // (1024,)
  const bf16* b;     // (1024,)
  int t16;
  __device__ uint4 operator()(int r, int k) const {
    if (r >= t16) return make_uint4(0, 0, 0, 0);
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

// kLong: x2 in the global scratch p.x2s (row stride 128) instead of shared
// memory (row stride kX2Ld); see the header for the order of a layer's
// phases in each mode.
template <bool kLong>
__global__ void __launch_bounds__(kThreads)
campplus_trunk_kernel(TrunkParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kX2L = kLong ? kBn : kX2Ld;     // x2 row stride
  const int t16 = p.t16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const int segs = seg_cap(p.t_valid);
  Smem s;
  {
    unsigned char* q = smem_raw;
    if (kLong) {
      s.x2 = p.x2s + ((size_t)b * (t16 + 2 * kGuard) + kGuard) * kX2L;
    } else {
      s.x2 = reinterpret_cast<bf16*>(q) + kGuard * kX2L;
      q += x2_bytes(t16);
    }
    s.sA = reinterpret_cast<bf16*>(q);
    s.sB = s.sA + kMC * kALd;
    s.sC = reinterpret_cast<float*>(s.sB + kKC * kBLd);
    s.sY = reinterpret_cast<float*>(q);
    q += kLong ? align128(kStageBytes) : union_bytes(t16);
    s.segsum = reinterpret_cast<float*>(q);
    s.ctx = s.segsum + segs * 128;
    s.c1 = s.ctx + segs * 128;
    s.gate = s.c1 + segs * kHid;
  }
  const int tv = min(max(p.tvalid[b], 1), p.t_valid);
  const size_t buf_stride = (size_t)p.B * t16 * kWide;
  bf16* bufs[2] = {p.ws + (size_t)b * t16 * kWide,
                   p.ws + buf_stride + (size_t)b * t16 * kWide};

  // zero guard rows of x2 (never written afterwards)
  for (int i = tid; i < kGuard * kX2L; i += kThreads) {
    s.x2[i - kGuard * kX2L] = __float2bfloat16_rn(0.f);
    s.x2[(size_t)t16 * kX2L + i] = __float2bfloat16_rn(0.f);
  }

  // ---- stem: k5 s2 conv 320 -> 128, BN-ReLU, mask -> concat[:, :128] ----
  {
    const StemLoader ld{p.x + (size_t)b * p.T_raw * kStemIn, p.T_raw};
    bf16* X = bufs[0];
    for (int m0 = 0; m0 < t16; m0 += kMC) {
      gemm_chunk(ld, m0, 5 * kStemIn, p.w_stem, kInit, 0, s);
      for (int i = tid; i < kMC * kInit; i += kThreads) {
        const int r = m0 + i / kInit, c = i % kInit;
        if (r >= t16) continue;
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
  for (int blk = 0; blk < 3; ++blk) {
    const int n_layers = kBlockLayers[blk], dil = kBlockDil[blk];
    bf16* X = bufs[cur];
    for (int li = 0; li < n_layers; ++li, ++layer) {
      const int cin = c_in + li * kGrowth;
      const bf16* wab = p.wide_ab + (size_t)layer * 2 * kWide;
      const float* la = p.lin1_aff + (size_t)layer * 3 * kBn;
      const float* cb = p.cam_bias + (size_t)layer * 128;

      // 1x1 bottleneck cin -> 128 over the wide BN-ReLU, then BN-ReLU, mask.
      // The long mode also sums each 100-frame segment of the bf16 x2 here.
      if (kLong)
        for (int i = tid; i < segs * kBn; i += kThreads) s.segsum[i] = 0.f;
      const WideLoader ld{X, wab, wab + kWide, t16};
      for (int m0 = 0; m0 < t16; m0 += kMC) {
        gemm_chunk(ld, m0, cin, p.w_lin1 + lin1_off * kBn, kBn, 0, s);
        for (int i = tid; i < kMC * kBn; i += kThreads) {
          const int r = m0 + i / kBn, c = i % kBn;
          if (r >= t16) continue;
          float v = s.sC[(i / kBn) * kCLd + c] + la[c];
          v = fmaxf(v * la[kBn + c] + la[2 * kBn + c], 0.f);
          const bf16 vb = __float2bfloat16_rn(r < tv ? v : 0.f);
          s.x2[(size_t)r * kX2L + c] = vb;
          if (kLong) s.sC[(i / kBn) * kCLd + c] = __bfloat162float(vb);
        }
        if (kLong) {
          __syncthreads();
          if (tid < kBn) {
            const int r1 = min(m0 + kMC, tv);
            int sg = m0 / kSeg;
            float acc = 0.f;
            for (int r = m0; r < r1; ++r) {
              if (r / kSeg != sg) {
                s.segsum[sg * kBn + tid] += acc;
                acc = 0.f;
                sg = r / kSeg;
              }
              acc += s.sC[(r - m0) * kCLd + tid];
            }
            if (r1 > m0) s.segsum[sg * kBn + tid] += acc;
          }
        }
        __syncthreads();
      }
      lin1_off += cin;
      const bf16* wl = p.w_local + (size_t)layer * 3 * kBn * kGrowth;

      if (!kLong) {
        // local k3 dilated conv 128 -> 32 over shifted x2 rows -> sY (fp32)
        const int mtiles = t16 / 16;
        for (int tile = warp; tile < mtiles * 2; tile += kWarps) {
          const int mt = tile >> 1, nt = tile & 1;
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          wmma::fill_fragment(acc, 0.f);
          for (int tap = 0; tap < 3; ++tap) {
            const bf16* arow = s.x2 + (ptrdiff_t)(mt * 16 + (tap - 1) * dil) * kX2L;
#pragma unroll
            for (int kk = 0; kk < kBn; kk += 16) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfg;
              wmma::load_matrix_sync(af, arow + kk, kX2L);
              wmma::load_matrix_sync(bfg, wl + (size_t)(tap * kBn + kk) * kGrowth + nt * 16,
                                     kGrowth);
              wmma::mma_sync(acc, af, bfg, acc);
            }
          }
          wmma::store_matrix_sync(s.sY + mt * 16 * kYLd + nt * 16, acc, kYLd,
                                  wmma::mem_row_major);
        }

        // CAM context: per-segment sums of x2 over the valid frames
        if (tid < kBn) {
          for (int sg = 0; sg < nseg; ++sg) {
            const int r1 = min((sg + 1) * kSeg, tv);
            float acc = 0.f;
            for (int r = sg * kSeg; r < r1; ++r)
              acc += __bfloat162float(s.x2[(size_t)r * kX2L + tid]);
            s.segsum[sg * kBn + tid] = acc;
          }
        }
        __syncthreads();
      }
      if (tid < kBn) {
        float tot = 0.f;
        for (int sg = 0; sg < nseg; ++sg) tot += s.segsum[sg * kBn + tid];
        const float mean = tot / (float)tv;
        for (int sg = 0; sg < nseg; ++sg) {
          const int cnt = min((sg + 1) * kSeg, tv) - sg * kSeg;
          s.ctx[sg * kBn + tid] = bfr(mean + s.segsum[sg * kBn + tid] / (float)cnt);
        }
      }
      __syncthreads();
      // 128 -> 64, ReLU
      for (int i = tid; i < nseg * kHid; i += kThreads) {
        const int sg = i / kHid, j = i % kHid;
        const bf16* w1 = p.w_cam1 + (size_t)layer * kBn * kHid;
        float acc = 0.f;
        for (int c = 0; c < kBn; ++c)
          acc = fmaf(s.ctx[sg * kBn + c], __bfloat162float(w1[c * kHid + j]), acc);
        s.c1[sg * kHid + j] = bfr(fmaxf(acc + cb[2 * kGrowth + j], 0.f));
      }
      __syncthreads();
      // 64 -> 32, sigmoid
      for (int i = tid; i < nseg * kGrowth; i += kThreads) {
        const int sg = i / kGrowth, j = i % kGrowth;
        const bf16* w2 = p.w_cam2 + (size_t)layer * kHid * kGrowth;
        float acc = 0.f;
        for (int c = 0; c < kHid; ++c)
          acc = fmaf(s.c1[sg * kHid + c], __bfloat162float(w2[c * kGrowth + j]), acc);
        acc += cb[kGrowth + j];
        s.gate[sg * kGrowth + j] = bfr(1.f / (1.f + expf(-acc)));
      }
      __syncthreads();

      const int c0 = c_in + li * kGrowth;
      if (!kLong) {
        // gate the local conv, mask, append 32 channels to the concat
        for (int i = tid; i < t16 * kGrowth; i += kThreads) {
          const int r = i / kGrowth, j = i % kGrowth;
          float v = 0.f;
          if (r < tv)
            v = (s.sY[r * kYLd + j] + cb[j]) * s.gate[(r / kSeg) * kGrowth + j];
          X[(size_t)r * kWide + c0 + j] = __float2bfloat16_rn(v);
        }
      } else {
        // local k3 dilated conv 128 -> 32 per 16-row tile from the x2
        // scratch, gated, masked and appended to the concat in its epilogue
        float* st = s.sY + warp * 16 * kYLd;
        for (int mt = warp; mt < t16 / 16; mt += kWarps) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
          wmma::fill_fragment(acc[0], 0.f);
          wmma::fill_fragment(acc[1], 0.f);
          for (int tap = 0; tap < 3; ++tap) {
            const bf16* arow = s.x2 + (ptrdiff_t)(mt * 16 + (tap - 1) * dil) * kX2L;
#pragma unroll
            for (int kk = 0; kk < kBn; kk += 16) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b0, b1;
              wmma::load_matrix_sync(af, arow + kk, kX2L);
              const bf16* wrow = wl + (size_t)(tap * kBn + kk) * kGrowth;
              wmma::load_matrix_sync(b0, wrow, kGrowth);
              wmma::load_matrix_sync(b1, wrow + 16, kGrowth);
              wmma::mma_sync(acc[0], af, b0, acc[0]);
              wmma::mma_sync(acc[1], af, b1, acc[1]);
            }
          }
          wmma::store_matrix_sync(st, acc[0], kYLd, wmma::mem_row_major);
          wmma::store_matrix_sync(st + 16, acc[1], kYLd, wmma::mem_row_major);
          __syncwarp();
          for (int i = lane; i < 16 * kGrowth; i += 32) {
            const int r = mt * 16 + i / kGrowth, j = i % kGrowth;
            float v = 0.f;
            if (r < tv)
              v = (st[(i / kGrowth) * kYLd + j] + cb[j]) * s.gate[(r / kSeg) * kGrowth + j];
            X[(size_t)r * kWide + c0 + j] = __float2bfloat16_rn(v);
          }
          __syncwarp();
        }
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
    const WideLoader ld{X, wab, wab + kWide, t16};
    for (int m0 = 0; m0 < t16; m0 += kMC) {
      for (int n0 = 0; n0 < cw / 2; n0 += kNC) {
        gemm_chunk(ld, m0, cw, wt, cw / 2, n0, s);
        for (int i = tid; i < kMC * kNC; i += kThreads) {
          const int r = m0 + i / kNC, c = i % kNC;
          if (r >= t16) continue;
          const float v = s.sC[(i / kNC) * kCLd + c] + tb[n0 + c];
          Y[(size_t)r * kWide + n0 + c] = __float2bfloat16_rn(r < tv ? v : 0.f);
        }
        __syncthreads();
      }
    }
    cur ^= 1;
    c_in = cw / 2;
  }

  // out BN-ReLU (fp32) + mean || biased std over the valid frames
  const bf16* Xf = bufs[cur];
  for (int c = tid; c < kFinal; c += kThreads) {
    const float a = p.out_aff[c], bb = p.out_aff[kFinal + c];
    float sum = 0.f;
    for (int r = 0; r < tv; ++r)
      sum += fmaxf(__bfloat162float(Xf[(size_t)r * kWide + c]) * a + bb, 0.f);
    const float mean = sum / (float)tv;
    float sq = 0.f;
    for (int r = 0; r < tv; ++r) {
      const float d =
          fmaxf(__bfloat162float(Xf[(size_t)r * kWide + c]) * a + bb, 0.f) - mean;
      sq += d * d;
    }
    p.out[(size_t)b * 2 * kFinal + c] = mean;
    p.out[(size_t)b * 2 * kFinal + kFinal + c] = sqrtf(sq / (float)tv);
  }
}

template <bool kLong>
cudaError_t launch(const TrunkParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(kLong, p.t16, p.t_valid);
  cudaError_t err = cudaFuncSetAttribute(
      campplus_trunk_kernel<kLong>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  campplus_trunk_kernel<kLong><<<p.B, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vpr_campplus_trunk(TrunkParams p, void* stream) {
  if (p.B <= 0 || p.t_valid <= 0 || p.t_valid > kMaxTLong || p.t16 % 16 != 0 ||
      p.t16 < p.t_valid || p.t16 > kMaxTLong)
    return (int)cudaErrorInvalidValue;
  if (p.t16 <= kMaxT) return (int)launch<false>(p, (cudaStream_t)stream);
  if (p.x2s == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch<true>(p, (cudaStream_t)stream);
}
