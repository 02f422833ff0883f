// The CAM++ FCM front end (12 convolutions) for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's models/pallas_fcm.py:
// `_kernel` (pallas_call in `_fcm_call`, one pass per utterance) and
// `_fcm_call_chunked` (the same kernel over halo windows for long buckets).
// The chunked variant existed only because one utterance's activations
// had to fit in VMEM. Here every convolution is a grid over time tiles, so
// one code path serves any length.
//
// What it computes, per utterance (features x: (T, 80) fp32, rounded to
// bf16), in torch's (C, F, T) terms with 'same' zero padding in both
// frequency and time (frames past T read as zero):
//   conv0   1 -> 32, 3x3                    relu(aff0)             F 80
//   block 0 c1 3x3 stride (2,1)             relu(aff1)             F 40
//           c2 3x3 + 1x1 stride-2 shortcut  relu(aff2(c2) + aff3(sc))
//   block 1 c4 3x3                          relu(aff4)
//           c5 3x3 + identity               relu(aff5(c5) + x)
//   block 2 as block 0 (convs 6, 7, 8)                             F 20
//   block 3 as block 1 (convs 9, 10)
//   final   3x3 stride (2,1)                relu(aff11)            F 10
// Each aff is the conv bias and the BatchNorm folded into a per-channel
// fp32 affine. Every conv takes bf16 operands with fp32 accumulation and
// stores bf16, at the TPU kernel's rounding points, so the plain PyTorch
// version (models/fcm_kernel.fcm_reference) matches it closely. The
// output (T, 10, 32) is campplus.FCM's frequency-major (T, 320).
//
// What bounds it on the H100: about 4.8 MFLOP per frame (1.4 GFLOP per
// 3 s utterance), nearly all in the ten 32 -> 32 3x3 convs, which are
// small GEMMs (K = 288, N = 32). With bf16 channels-last intermediates in
// device memory each conv reads and writes 2.5-5 KB per frame, so at these
// widths the kernel sits near the line between the tensor cores and device
// memory; the whole chain in one kernel (no intermediates in device
// memory) is later work.
//
// Design: activations are channels-last bf16 (B, T_pad, F, 32) in a
// workspace the wrapper allocates (T_pad = T rounded up to 32). conv0
// (K = 9) runs on the CUDA cores. Every other conv is one templated
// implicit-GEMM kernel: one block of 8 warps per (32-frame time tile,
// frequency band, utterance) stages the input tile with its +-1 frame and
// +-1 frequency halo in shared memory (zero outside the utterance and the
// band), and the 288 x 32 weights. A warp's unit is 16 frames at one
// output frequency x all 32 output channels: two nvcuda::wmma bf16
// 16x16x16 accumulators over 9 taps x 2 K-slices read straight from the
// staged tile (rows 16 frames apart in time are a fixed stride apart).
// The epilogue stages the accumulators per warp in shared memory and
// applies the affine, the shortcut or identity residual, the ReLU and the
// bf16 store. The 1x1 shortcut is a third and fourth accumulator in the
// same kernel, read from the block input in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

struct FcmParams {
  const float* x;      // (B, T, 80) features
  bf16* out;           // (B, T, 320) = (B, T, 10, 32)
  bf16* ws;            // workspace of vpr_fcm_workspace_elems(B, T_pad) bf16
  // conv i: (9 * cin, 32), rows (df * 3 + dt) * cin + c; the 1x1
  // shortcuts 3 and 8: (32, 32)
  const bf16 *w0, *w1, *w2, *w3, *w4, *w5, *w6, *w7, *w8, *w9, *w10, *w11;
  const float* aff;    // (12, 2, 32): scale, shift
  int B, T, T_pad;
};

namespace {

constexpr int kC = 32;           // channels
constexpr int kF0 = 80;          // input mel bins
constexpr int kThreads = 256, kWarps = 8;
constexpr int kTT = 32;          // time tile (frames)
constexpr int kStageLd = 36;     // fp32 epilogue staging row (floats)
constexpr int kStageFloats = 16 * kStageLd;

enum Mode { kPlain = 0, kShortcut = 1, kIdentity = 2 };

__device__ inline float bfr(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- conv0: 1 -> 32, 3x3, on the CUDA cores --------------------------------
// One thread per output (b, t, f), all 32 channels.
__global__ void __launch_bounds__(kThreads)
fcm_conv0_kernel(const float* __restrict__ x, bf16* __restrict__ y,
                 const bf16* __restrict__ w0, const float* __restrict__ aff,
                 int B, int T, int T_pad) {
  __shared__ float ws[9 * kC];
  __shared__ float as[2 * kC];
  for (int i = threadIdx.x; i < 9 * kC; i += blockDim.x) ws[i] = __bfloat162float(w0[i]);
  for (int i = threadIdx.x; i < 2 * kC; i += blockDim.x) as[i] = aff[i];
  __syncthreads();
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * T * kF0) return;
  const int f = (int)(idx % kF0);
  const long long bt = idx / kF0;
  const int t = (int)(bt % T), b = (int)(bt / T);
  float in[9];
#pragma unroll
  for (int df = 0; df < 3; ++df)
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      const int fi = f + df - 1, ti = t + dt - 1;
      in[df * 3 + dt] = (fi >= 0 && fi < kF0 && ti >= 0 && ti < T)
                            ? bfr(x[((size_t)b * T + ti) * kF0 + fi]) : 0.f;
    }
  uint32_t o[kC / 2];   // bf16 pairs
#pragma unroll
  for (int c = 0; c < kC; c += 2) {
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      acc0 = fmaf(in[k], ws[k * kC + c], acc0);
      acc1 = fmaf(in[k], ws[k * kC + c + 1], acc1);
    }
    const __nv_bfloat162 h = __floats2bfloat162_rn(
        fmaxf(acc0 * as[c] + as[kC + c], 0.f),
        fmaxf(acc1 * as[c + 1] + as[kC + c + 1], 0.f));
    o[c / 2] = *reinterpret_cast<const uint32_t*>(&h);
  }
  uint4* dst = reinterpret_cast<uint4*>(y + (((size_t)b * T_pad + t) * kF0 + f) * kC);
#pragma unroll
  for (int i = 0; i < kC / 8; ++i)
    dst[i] = make_uint4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
}

// ---- 32 -> 32 3x3 convs: implicit GEMM on wmma ----------------------------
struct ConvArgs {
  const bf16* in;      // (B, T_pad, f_in, 32)
  bf16* out;           // (B, out_ts, f_out, 32)
  const bf16* w;       // (288, 32)
  const float* aff;    // (2, 32)
  const bf16* sc_in;   // kShortcut: block input (B, T_pad, 2 * f_out, 32)
  const bf16* w_sc;    // kShortcut: (32, 32)
  const float* aff_sc; // kShortcut: (2, 32)
  const bf16* res;     // kIdentity: (B, T_pad, f_out, 32)
  int f_in, f_out, out_ts, T, T_pad;
};

// frequency band per block: FB output frequencies
template <int STRIDE, int FB>
struct Geo {
  static constexpr int kSlots = STRIDE * (FB - 1) + 3;   // input freqs + halo
  static constexpr int kRowRaw = kSlots * kC;
  // time-row stride of the staged tile, in bf16: a multiple of 16 (32-byte
  // aligned wmma pointers at any row) and 16 mod 64 (8 consecutive rows fall
  // in 2 groups of banks instead of 1)
  static constexpr int kRow = kRowRaw + ((16 - kRowRaw % 64) + 64) % 64;
  static constexpr size_t kTileBytes = sizeof(bf16) * (size_t)(kTT + 2) * kRow;
  static constexpr size_t kWBytes = sizeof(bf16) * 9 * kC * kC;
  static constexpr size_t kWscBytes = sizeof(bf16) * kC * kC;
  static constexpr size_t kStageBytes = sizeof(float) * kStageFloats;
  static size_t smem(int mode) {
    return kTileBytes + kWBytes + (mode == kShortcut ? kWscBytes : 0) +
           kWarps * kStageBytes * (mode == kShortcut ? 2 : 1);
  }
};

template <int STRIDE, int FB, int MODE>
__global__ void __launch_bounds__(kThreads)
fcm_conv_kernel(ConvArgs a) {
  using G = Geo<STRIDE, FB>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);
  bf16* wS = reinterpret_cast<bf16*>(smem_raw + G::kTileBytes);
  bf16* wscS = wS + 9 * kC * kC;
  float* stage = reinterpret_cast<float*>(
      smem_raw + G::kTileBytes + G::kWBytes + (MODE == kShortcut ? G::kWscBytes : 0));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * kTT, f0 = blockIdx.y * FB, b = blockIdx.z;

  // stage the input tile: row r = time t0 - 1 + r, slot s = input frequency
  // STRIDE * f0 - 1 + s, 32 channels as 4 x 16 bytes; zero outside
  {
    const int fi0 = STRIDE * f0 - 1;
    const int n = (kTT + 2) * G::kSlots * 4;
    for (int v = tid; v < n; v += kThreads) {
      const int q = v & 3, s = (v >> 2) % G::kSlots, r = (v >> 2) / G::kSlots;
      const int t = t0 - 1 + r, fi = fi0 + s;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (t >= 0 && t < a.T && fi >= 0 && fi < a.f_in)
        val = __ldg(reinterpret_cast<const uint4*>(
            a.in + (((size_t)b * a.T_pad + t) * a.f_in + fi) * kC) + q);
      *reinterpret_cast<uint4*>(tile + (size_t)r * G::kRow + s * kC + q * 8) = val;
    }
    for (int v = tid; v < 9 * kC * kC / 8; v += kThreads)
      reinterpret_cast<uint4*>(wS)[v] = __ldg(reinterpret_cast<const uint4*>(a.w) + v);
    if (MODE == kShortcut)
      for (int v = tid; v < kC * kC / 8; v += kThreads)
        reinterpret_cast<uint4*>(wscS)[v] = __ldg(reinterpret_cast<const uint4*>(a.w_sc) + v);
  }
  __syncthreads();

  // this lane's two output channels in the epilogue, and their affines
  const int cp = (lane & 15) * 2;
  const float s0 = a.aff[cp], s1 = a.aff[cp + 1];
  const float h0 = a.aff[kC + cp], h1 = a.aff[kC + cp + 1];
  float ss0 = 0.f, ss1 = 0.f, sh0 = 0.f, sh1 = 0.f;
  if (MODE == kShortcut) {
    ss0 = a.aff_sc[cp]; ss1 = a.aff_sc[cp + 1];
    sh0 = a.aff_sc[kC + cp]; sh1 = a.aff_sc[kC + cp + 1];
  }
  float* st = stage + warp * kStageFloats * (MODE == kShortcut ? 2 : 1);
  float* st_sc = st + kStageFloats;

  constexpr int kUnits = (kTT / 16) * FB;
  for (int u = warp; u < kUnits; u += kWarps) {
    const int mt = u / FB, fl = u % FB, f = f0 + fl;
    if (f >= a.f_out) continue;  // warp-uniform
    const int tb = t0 + mt * 16;
    if (tb >= a.T) continue;     // warp-uniform: the whole 16 rows are past T

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
    for (int df = 0; df < 3; ++df) {
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const bf16* arow = tile + (size_t)(mt * 16 + dt) * G::kRow + (STRIDE * fl + df) * kC;
        const bf16* wrow = wS + (size_t)(df * 3 + dt) * kC * kC;
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b0, b1;
          wmma::load_matrix_sync(af, arow + kc * 16, G::kRow);
          wmma::load_matrix_sync(b0, wrow + kc * 16 * kC, kC);
          wmma::load_matrix_sync(b1, wrow + kc * 16 * kC + 16, kC);
          wmma::mma_sync(acc[0], af, b0, acc[0]);
          wmma::mma_sync(acc[1], af, b1, acc[1]);
        }
      }
    }
    wmma::store_matrix_sync(st, acc[0], kStageLd, wmma::mem_row_major);
    wmma::store_matrix_sync(st + 16, acc[1], kStageLd, wmma::mem_row_major);

    if (MODE == kShortcut) {
      // 1x1 stride-(2,1) shortcut: block input at frequency 2f, rows tb..tb+15
      // (rows past T lie inside T_pad and only feed rows that are not stored)
      const int f_sc = 2 * a.f_out;
      const bf16* srow = a.sc_in + (((size_t)b * a.T_pad + tb) * f_sc + 2 * f) * kC;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc[2];
      wmma::fill_fragment(sc[0], 0.f);
      wmma::fill_fragment(sc[1], 0.f);
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b0, b1;
        wmma::load_matrix_sync(af, srow + kc * 16, f_sc * kC);
        wmma::load_matrix_sync(b0, wscS + kc * 16 * kC, kC);
        wmma::load_matrix_sync(b1, wscS + kc * 16 * kC + 16, kC);
        wmma::mma_sync(sc[0], af, b0, sc[0]);
        wmma::mma_sync(sc[1], af, b1, sc[1]);
      }
      wmma::store_matrix_sync(st_sc, sc[0], kStageLd, wmma::mem_row_major);
      wmma::store_matrix_sync(st_sc + 16, sc[1], kStageLd, wmma::mem_row_major);
    }
    __syncwarp();

    // epilogue: lane owns channels cp, cp + 1 of rows lane / 16 + 2k
    for (int r = lane >> 4; r < 16; r += 2) {
      const int t = tb + r;
      if (t >= a.T) break;
      float v0 = st[r * kStageLd + cp] * s0 + h0;
      float v1 = st[r * kStageLd + cp + 1] * s1 + h1;
      if (MODE == kShortcut) {
        v0 += st_sc[r * kStageLd + cp] * ss0 + sh0;
        v1 += st_sc[r * kStageLd + cp + 1] * ss1 + sh1;
      }
      if (MODE == kIdentity) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
            a.res + (((size_t)b * a.T_pad + t) * a.f_out + f) * kC + cp);
        v0 += __bfloat162float(x.x);
        v1 += __bfloat162float(x.y);
      }
      __nv_bfloat162 o;
      o.x = __float2bfloat16_rn(fmaxf(v0, 0.f));
      o.y = __float2bfloat16_rn(fmaxf(v1, 0.f));
      *reinterpret_cast<__nv_bfloat162*>(
          a.out + (((size_t)b * a.out_ts + t) * a.f_out + f) * kC + cp) = o;
    }
    __syncwarp();
  }
}

template <int STRIDE, int FB, int MODE>
cudaError_t launch_conv(const ConvArgs& a, int B, cudaStream_t stream) {
  const size_t smem = Geo<STRIDE, FB>::smem(MODE);
  cudaError_t err = cudaFuncSetAttribute(fcm_conv_kernel<STRIDE, FB, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kTT - 1) / kTT, (a.f_out + FB - 1) / FB, B);
  fcm_conv_kernel<STRIDE, FB, MODE><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

constexpr int kFB1 = 20, kFB2 = 10;  // frequency bands: stride 1, stride 2

}  // namespace

// Workspace, in bf16 elements: one (B, T_pad, 80, 32) buffer, three at
// F = 40 and three at F = 20. The wrapper allocates it from this count.
extern "C" long long vpr_fcm_workspace_elems(int B, int T_pad) {
  return (long long)B * T_pad * kC * (80 + 3 * 40 + 3 * 20);
}

extern "C" int vpr_fcm(FcmParams p, void* stream_) {
  if (p.B <= 0 || p.B > 65535 || p.T <= 0 || p.T_pad < p.T || p.T_pad % kTT != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const size_t per = (size_t)p.B * p.T_pad * kC;   // elements per frequency
  bf16* a80 = p.ws;
  bf16* y40 = a80 + per * 80;
  bf16* x40a = y40 + per * 40;
  bf16* x40b = x40a + per * 40;
  bf16* y20 = x40b + per * 40;
  bf16* x20a = y20 + per * 20;
  bf16* x20b = x20a + per * 20;
  const float* aff = p.aff;
  const bf16* w[12] = {p.w0, p.w1, p.w2, p.w3, p.w4, p.w5,
                       p.w6, p.w7, p.w8, p.w9, p.w10, p.w11};
  auto A = [&](int i) { return aff + i * 2 * kC; };

  {
    const long long n = (long long)p.B * p.T * kF0;
    fcm_conv0_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        p.x, a80, w[0], A(0), p.B, p.T, p.T_pad);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  auto conv = [&](const bf16* in, int f_in, bf16* out, int f_out, int i) {
    ConvArgs a{};
    a.in = in; a.out = out; a.w = w[i]; a.aff = A(i);
    a.f_in = f_in; a.f_out = f_out; a.out_ts = p.T_pad; a.T = p.T; a.T_pad = p.T_pad;
    return a;
  };
  cudaError_t err;
#define VPR_TRY(x) do { err = (x); if (err != cudaSuccess) return (int)err; } while (0)
  // block 0 (F 80 -> 40)
  VPR_TRY((launch_conv<2, kFB2, kPlain>(conv(a80, 80, y40, 40, 1), p.B, stream)));
  {
    ConvArgs a = conv(y40, 40, x40a, 40, 2);
    a.sc_in = a80; a.w_sc = w[3]; a.aff_sc = A(3);
    VPR_TRY((launch_conv<1, kFB1, kShortcut>(a, p.B, stream)));
  }
  // block 1
  VPR_TRY((launch_conv<1, kFB1, kPlain>(conv(x40a, 40, y40, 40, 4), p.B, stream)));
  {
    ConvArgs a = conv(y40, 40, x40b, 40, 5);
    a.res = x40a;
    VPR_TRY((launch_conv<1, kFB1, kIdentity>(a, p.B, stream)));
  }
  // block 2 (F 40 -> 20)
  VPR_TRY((launch_conv<2, kFB2, kPlain>(conv(x40b, 40, y20, 20, 6), p.B, stream)));
  {
    ConvArgs a = conv(y20, 20, x20a, 20, 7);
    a.sc_in = x40b; a.w_sc = w[8]; a.aff_sc = A(8);
    VPR_TRY((launch_conv<1, kFB1, kShortcut>(a, p.B, stream)));
  }
  // block 3
  VPR_TRY((launch_conv<1, kFB1, kPlain>(conv(x20a, 20, y20, 20, 9), p.B, stream)));
  {
    ConvArgs a = conv(y20, 20, x20b, 20, 10);
    a.res = x20a;
    VPR_TRY((launch_conv<1, kFB1, kIdentity>(a, p.B, stream)));
  }
  // final conv (F 20 -> 10) straight into the (B, T, 320) output
  {
    ConvArgs a = conv(x20b, 20, p.out, 10, 11);
    a.out_ts = p.T;
    VPR_TRY((launch_conv<2, kFB2, kPlain>(a, p.B, stream)));
  }
#undef VPR_TRY
  return (int)cudaSuccess;
}
