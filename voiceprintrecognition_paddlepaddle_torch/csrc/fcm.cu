// The CAM++ FCM front end (12 convolutions in 10 launches) for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of the JAX package's models/pallas_fcm.py:
// `_kernel` (:251; pallas_call in `_fcm_call`, :399, one pass per
// utterance) and `_fcm_call_chunked` (:442; the same kernel over halo
// windows for long buckets). The chunked variant existed only because one
// utterance's activations had to fit in VMEM. Here every convolution is a
// walk over time tiles, so one code path serves any length.
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
// What bounds it on the H100. The function needs 4.8 MFLOP a frame, nearly
// all in the ten 32 -> 32 3x3 convs (small GEMMs: K = 288, N = 32): at
// b32 x 1598 frames 244 GFLOP, 0.247 ms on the bf16 tensor cores (b256 x
// 298: 0.368 ms); its own bytes (features in, output out) take less. This
// design keeps the intermediates in device memory, one launch per conv:
// the launches read and write 775 "units" (a unit is one frequency of 32
// bf16 channels over every frame; fcm_kernel.FCM_LAUNCHES), 2.54 GB at
// b32 x 1598, a byte floor of 0.76 ms at 3.35 TB/s (b256 x 298: 3.78 GB,
// 1.13 ms). At about 144 FLOP per byte a 32 -> 32 conv sits below the
// card's ridge (295 FLOP/B for bf16 wgmma; mma.sync issues at about half
// that rate, so for it the ridge is near 150), so the loads and the
// product issue both have to be kept busy. On the H100 each conv runs at
// 41-61 % of its byte floor and 164-213 TFLOP/s (PERF.md). Fusing the
// chain (the activations kept on chip) is the step after this one.
//
// Design. Activations are channels-last bf16 (B, T_pad, F, 32) in a
// workspace the wrapper allocates (T_pad = T rounded up to 32; rows past T
// are never written and never read: the loads zero-fill them). conv0
// (K = 9) runs on the CUDA cores. Every other conv is one templated
// implicit-GEMM kernel with persistent blocks:
//   - the grid of each launch is the wrapper's (fcm_kernel.fcm_grids: the
//     card's resident blocks from vpr_fcm_occupancy, or the item count if
//     smaller); each block walks items (32-frame time tile, band of 10
//     output frequencies, utterance), stride gridDim.x, and stages the conv's
//     weights (and the 1x1 shortcut's) and affines in shared memory once;
//   - a ring of 3 input stages filled by cp.async.cg 16-byte copies keeps
//     the next two items' loads in flight while one is computed (one block
//     barrier per item: after it, the stage of the item before is free
//     and takes the item two ahead). A stage
//     holds the item's tile with its +-1 frame and +-1 frequency halo;
//     frames outside [0, T) and frequencies outside the layer are
//     zero-filled by the copy (src-size 0), never read from memory. The
//     shortcut's input (the block input at the even frequencies) or the
//     identity residual is a second, smaller copy into the same stage;
//   - 10 warps, one output frequency each, 32 frames x 32 channels: the
//     products are mma.sync.m16n8k16 bf16 in PTX, with A (16 frames x 16
//     channels of one tap) from the staged tile by ldmatrix (rows 1 frame
//     apart are a fixed stride apart, so each tap's window is a shifted
//     view) and B (the tap's 16 x 32 weights) by ldmatrix.trans, loaded
//     once per tap and used for both 16-frame halves. mma.sync and not
//     wgmma: a wgmma tile is 64 rows of one warpgroup, and a 64-row A from
//     registers needs the same ldmatrix traffic, while a 10-frequency band
//     of 32 frames gives every warp its own small tile, no cross-warp
//     barrier per tap, and items small enough that one long utterance
//     still spreads over the SMs (b1 x 1598: 200 items). Keeping all 144
//     B registers for the whole walk was tried: ten warps leave 168
//     registers a thread, so it spilled and ran slower;
//   - the epilogue works on the accumulator fragments in registers: the
//     affine, the shortcut (its own accumulators, the 1x1 product over the
//     same rows from the staged shortcut input), the identity residual
//     (from the staged copy), the ReLU and the bf16 rounding; a per-warp
//     1 KB bf16 transpose (XOR-swizzled, no bank conflicts) turns the
//     fragments into 16-byte stores of 8 channels per lane.
// Shared-memory rows are padded to an odd number of 16-byte chunks so that
// the 8 row addresses of every ldmatrix fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

typedef __nv_bfloat16 bf16;

struct FcmParams {
  const float* x;      // (B, T, 80) features
  bf16* out;           // (B, T, 320) = (B, T, 10, 32)
  bf16* ws;            // workspace of vpr_fcm_workspace_elems(B, T_pad) bf16
  // conv i: (9 * cin, 32), rows (df * 3 + dt) * cin + c; the 1x1
  // shortcuts 3 and 8: (32, 32)
  const bf16 *w0, *w1, *w2, *w3, *w4, *w5, *w6, *w7, *w8, *w9, *w10, *w11;
  const float* aff;    // (12, 2, 32): scale, shift
  // null, or 11 events: recorded before the first launch and after each of
  // the 10 launches (per-launch times, for measurement)
  cudaEvent_t* events;
  int B, T, T_pad;
  // blocks of each conv launch after conv0, in launch order (any count
  // >= 1 computes every item; fcm_kernel.fcm_grids sizes them)
  int grid[9];
};

namespace {

constexpr int kC = 32;           // channels
constexpr int kF0 = 80;          // input mel bins
constexpr int kThreads = 256;    // conv0
constexpr int kTT = 32;          // time tile (frames)
constexpr int kFB = 10;          // output frequencies per item (divides 40, 20, 10)
constexpr int kCWarps = kFB;     // conv kernel: one warp per output frequency
constexpr int kCThreads = 32 * kCWarps;
constexpr int kStages = 3;       // input ring depth
constexpr int kWRowB = kC * 2 + 16;  // a staged weight row, bytes (5 chunks)
constexpr int kMaxDevices = 64;

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

// ---- PTX: asynchronous copies, ldmatrix, mma.sync -------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros when !full (src-size 0:
// nothing is read from `src`)
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row-major) x b (16x8, col-major), bf16 in, fp32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of a 16 x 32 weight slice (staged rows of kWRowB bytes; `w`
// is this lane's ldmatrix row address in it): b[j] for the n-tile of
// channels 8j .. 8j + 7
__device__ __forceinline__ void load_b(uint32_t (&b)[4][2], uint32_t w) {
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t r[4];
    ldsm_x4_trans(r, w + np * 32);
    b[2 * np][0] = r[0];
    b[2 * np][1] = r[1];
    b[2 * np + 1][0] = r[2];
    b[2 * np + 1][1] = r[3];
  }
}

// ---- 32 -> 32 3x3 convs: persistent implicit GEMM on mma.sync ------------
struct ConvArgs {
  const bf16* in;      // (B, T_pad, f_in, 32)
  bf16* out;           // (B, out_ts, f_out, 32)
  const bf16* w;       // (288, 32)
  const float* aff;    // (2, 32)
  const bf16* sc_in;   // kShortcut: block input (B, T_pad, 2 * f_out, 32)
  const bf16* w_sc;    // kShortcut: (32, 32)
  const float* aff_sc; // kShortcut: (2, 32)
  const bf16* res;     // kIdentity: (B, T_pad, f_out, 32)
  int B, f_in, f_out, out_ts, T, T_pad;
};

// shared-memory layout of one instance, in bytes
template <int STRIDE, int MODE>
struct Geo {
  static constexpr int kSlots = STRIDE * (kFB - 1) + 3;   // input freqs + halo
  static constexpr int kRowB = kSlots * kC * 2 + 16;      // a staged frame: odd chunks
  static constexpr int kTileB = (kTT + 2) * kRowB;
  static constexpr int kXRowB = kFB * kC * 2 + 16;        // shortcut input / residual
  static constexpr int kXB = MODE == kPlain ? 0 : kTT * kXRowB;
  static constexpr int kStageB = kTileB + kXB;
  static constexpr int kOffW = kStages * kStageB;
  static constexpr int kOffWsc = kOffW + 9 * kC * kWRowB;
  static constexpr int kOffAff = kOffWsc + (MODE == kShortcut ? kC * kWRowB : 0);
  static constexpr int kOffXpose = kOffAff + (MODE == kShortcut ? 4 : 2) * kC * 4;
  static constexpr int kSmem = kOffXpose + kCWarps * 16 * kC * 2;
};

// Issue the copies of item `item` into `stage` (all threads; one commit
// group per item is the caller's).
template <int STRIDE, int MODE>
__device__ __forceinline__ void stage_item(const ConvArgs& a, uint32_t stage, int item, int n_tt,
                                           int n_fb) {
  using G = Geo<STRIDE, MODE>;
  const int fb = item % n_fb, rest = item / n_fb;
  const int t0 = (rest % n_tt) * kTT, b = rest / n_tt, f0 = fb * kFB;
  // row r = frame t0 - 1 + r, slot s = input frequency STRIDE * f0 - 1 + s
  for (int v = threadIdx.x; v < (kTT + 2) * G::kSlots * 4; v += kCThreads) {
    const int q = v & 3, s = (v >> 2) % G::kSlots, r = (v >> 2) / G::kSlots;
    const int t = t0 - 1 + r, fi = STRIDE * f0 - 1 + s;
    const bool ok = t >= 0 && t < a.T && fi >= 0 && fi < a.f_in;
    const bf16* src = ok ? a.in + (((size_t)b * a.T_pad + t) * a.f_in + fi) * kC + q * 8 : a.in;
    cp_async16(stage + r * G::kRowB + s * kC * 2 + q * 16, src, ok);
  }
  if (MODE != kPlain) {
    // row r = frame t0 + r, slot s = output frequency f0 + s: the shortcut's
    // input at frequency 2 (f0 + s), or the residual at f0 + s
    const bf16* base = MODE == kShortcut ? a.sc_in : a.res;
    const int fx = MODE == kShortcut ? 2 * a.f_out : a.f_out;
    for (int v = threadIdx.x; v < kTT * kFB * 4; v += kCThreads) {
      const int q = v & 3, s = (v >> 2) % kFB, r = (v >> 2) / kFB;
      const int t = t0 + r, fi = MODE == kShortcut ? 2 * (f0 + s) : f0 + s;
      const bool ok = t < a.T;
      const bf16* src = ok ? base + (((size_t)b * a.T_pad + t) * fx + fi) * kC + q * 8 : base;
      cp_async16(stage + G::kTileB + r * G::kXRowB + s * kC * 2 + q * 16, src, ok);
    }
  }
}

template <int STRIDE, int MODE>
__global__ void __launch_bounds__(kCThreads, 1)
fcm_conv_kernel(ConvArgs a) {
  using G = Geo<STRIDE, MODE>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t s0 = smem_u32(smem);

  // the weights (rows padded to kWRowB) and affines, once per block
  for (int v = tid; v < 9 * kC * 4; v += kCThreads)
    *reinterpret_cast<uint4*>(smem + G::kOffW + (v >> 2) * kWRowB + (v & 3) * 16) =
        __ldg(reinterpret_cast<const uint4*>(a.w) + v);
  if (MODE == kShortcut)
    for (int v = tid; v < kC * 4; v += kCThreads)
      *reinterpret_cast<uint4*>(smem + G::kOffWsc + (v >> 2) * kWRowB + (v & 3) * 16) =
          __ldg(reinterpret_cast<const uint4*>(a.w_sc) + v);
  float* affS = reinterpret_cast<float*>(smem + G::kOffAff);  // scale, shift (, sc scale, shift)
  for (int v = tid; v < 2 * kC; v += kCThreads) {
    affS[v] = a.aff[v];
    if (MODE == kShortcut) affS[2 * kC + v] = a.aff_sc[v];
  }

  const int n_tt = (a.T + kTT - 1) / kTT, n_fb = a.f_out / kFB;
  const int n_items = a.B * n_tt * n_fb;
  // prologue: the first kStages - 1 items, one commit group each (empty
  // groups past the end keep the count uniform)
  int ahead = blockIdx.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s, ahead += gridDim.x) {
    if (ahead < n_items) stage_item<STRIDE, MODE>(a, s0 + s * G::kStageB, ahead, n_tt, n_fb);
    cp_async_commit();
  }

  // ldmatrix roles: this lane gives row (lane & 7) of matrix (lane >> 3);
  // matrices 0-3 are (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15),
  // (8-15, 8-15) of a 16 x 16 bf16 block
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  const int g = lane >> 2, q = lane & 3;   // accumulator rows g, g + 8; cols 2q, 2q + 1
  const int fl = warp;                     // this warp's output frequency in the band
  const uint32_t w_lane = s0 + G::kOffW + lrow * kWRowB + lcol * 2;
  uint32_t* xpose = reinterpret_cast<uint32_t*>(smem + G::kOffXpose) + warp * 16 * 16;

  int slot = 0;   // the stage of `item`
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ahead += gridDim.x) {
    cp_async_wait<kStages - 2>();   // this thread's copies of `item` have landed
    // everyone's have, and every warp is done with the previous item, so
    // its stage takes the item kStages - 1 ahead
    __syncthreads();
    if (ahead < n_items)
      stage_item<STRIDE, MODE>(a, s0 + ((slot + kStages - 1) % kStages) * G::kStageB, ahead,
                               n_tt, n_fb);
    cp_async_commit();

    const int fb = item % n_fb, rest = item / n_fb;
    const int t0 = (rest % n_tt) * kTT, b = rest / n_tt, f = fb * kFB + fl;
    const unsigned char* stage_p = smem + slot * G::kStageB;
    const uint32_t stage = s0 + slot * G::kStageB;
    const uint32_t a_lane = stage + lrow * G::kRowB + STRIDE * fl * kC * 2 + lcol * 2;

    // products: frames t0 .. t0 + 31 (two 16-row halves) x 32 channels
    float acc[2][4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;
#pragma unroll
    for (int df = 0; df < 3; ++df) {
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const int tap = df * 3 + dt;
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          uint32_t bw[4][2];
          load_b(bw, w_lane + (tap * kC + kc * 16) * kWRowB);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // output frame t0 + 16h + i reads tile row 16h + i + dt
            uint32_t af[4];
            ldsm_x4(af, a_lane + (h * 16 + dt) * G::kRowB + df * kC * 2 + kc * 32);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma16816(acc[h][j], af, bw[j][0], bw[j][1]);
          }
        }
      }
    }

    // epilogue per 16-frame half, from the accumulator fragments
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tb = t0 + h * 16;
      if (tb >= a.T) break;   // warp-uniform
      float sc[4][4];
      if (MODE == kShortcut) {
        // 1x1 stride-(2,1) shortcut over the same 16 frames
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
        const uint32_t x_lane = stage + G::kTileB + (h * 16 + lrow) * G::kXRowB +
                                fl * kC * 2 + lcol * 2;
        const uint32_t wsc_lane = s0 + G::kOffWsc + lrow * kWRowB + lcol * 2;
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          uint32_t af[4], bw[4][2];
          ldsm_x4(af, x_lane + kc * 32);
          load_b(bw, wsc_lane + kc * 16 * kWRowB);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma16816(sc[j], af, bw[j][0], bw[j][1]);
        }
      }
      // rows g + 8 * e2 of the half, channels c, c + 1 = 8j + 2q, + 1
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int r = g + 8 * e2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * j + 2 * q;
          float v0 = acc[h][j][2 * e2] * affS[c] + affS[kC + c];
          float v1 = acc[h][j][2 * e2 + 1] * affS[c + 1] + affS[kC + c + 1];
          if (MODE == kShortcut) {
            v0 += sc[j][2 * e2] * affS[2 * kC + c] + affS[3 * kC + c];
            v1 += sc[j][2 * e2 + 1] * affS[2 * kC + c + 1] + affS[3 * kC + c + 1];
          }
          if (MODE == kIdentity) {
            const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
                stage_p + G::kTileB + (h * 16 + r) * G::kXRowB + fl * kC * 2 + c * 2);
            v0 += __bfloat162float(x.x);
            v1 += __bfloat162float(x.y);
          }
          const __nv_bfloat162 o = __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          // row r, 16-byte chunk j, swizzled by (r >> 1) & 3
          xpose[r * 16 + ((j ^ ((r >> 1) & 3)) << 2) + q] = *reinterpret_cast<const uint32_t*>(&o);
        }
      }
      __syncwarp();
      // 16 rows x 4 chunks: 16 bytes (8 channels) a lane, two rounds
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int cidx = lane + 32 * k, r = cidx >> 2, p = cidx & 3;
        const uint4 v = *reinterpret_cast<const uint4*>(xpose + r * 16 + ((p ^ ((r >> 1) & 3)) << 2));
        const int t = tb + r;
        if (t < a.T)
          *reinterpret_cast<uint4*>(a.out + (((size_t)b * a.out_ts + t) * a.f_out + f) * kC + p * 8) = v;
      }
      __syncwarp();
    }
    slot = (slot + 1) % kStages;
  }
  cp_async_wait<0>();
}

// The kernel's dynamic shared-memory limit is one setting per device for
// the whole process, as is its occupancy. Each instance sets the limit
// once per device, under a lock, at the one size every launch of it asks
// for, and asks the occupancy then; launches from many threads (a server)
// find it done.
std::mutex g_setup_mu;

template <int STRIDE, int MODE>
cudaError_t conv_setup(int* blocks_per_sm, int* n_sms) {
  static bool done[kMaxDevices] = {};
  static int bps[kMaxDevices] = {}, sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(g_setup_mu);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(fcm_conv_kernel<STRIDE, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Geo<STRIDE, MODE>::kSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &bps[dev], fcm_conv_kernel<STRIDE, MODE>, kCThreads, Geo<STRIDE, MODE>::kSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  *blocks_per_sm = bps[dev];
  *n_sms = sms[dev];
  return cudaSuccess;
}

template <int STRIDE, int MODE>
cudaError_t launch_conv(const ConvArgs& a, int grid, cudaStream_t stream) {
  int bps = 0, sms = 0;
  cudaError_t err = conv_setup<STRIDE, MODE>(&bps, &sms);
  if (err != cudaSuccess) return err;
  if (bps < 1) return cudaErrorInvalidConfiguration;
  // the kernel's item index is an int
  if (grid < 1 || (long long)a.B * ((a.T + kTT - 1) / kTT) * (a.f_out / kFB) > 0x7fffffff)
    return cudaErrorInvalidValue;
  fcm_conv_kernel<STRIDE, MODE><<<grid, kCThreads, Geo<STRIDE, MODE>::kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Workspace, in bf16 elements: one (B, T_pad, 80, 32) buffer, three at
// F = 40 and three at F = 20. The wrapper allocates it from this count.
extern "C" long long vpr_fcm_workspace_elems(int B, int T_pad) {
  return (long long)B * T_pad * kC * (80 + 3 * 40 + 3 * 20);
}

// What the wrapper sizes the persistent grids from: the resident blocks
// per SM of the conv kernel's instances (stride 2; stride 1 with the
// shortcut; stride 1; stride 1 with the identity) into out[0..3], the SM
// count into out[4], and the item's time tile and frequency band (kTT,
// kFB) into out[5..6].
extern "C" int vpr_fcm_occupancy(int* out) {
  cudaError_t err = conv_setup<2, kPlain>(&out[0], &out[4]);
  if (err == cudaSuccess) err = conv_setup<1, kShortcut>(&out[1], &out[4]);
  if (err == cudaSuccess) err = conv_setup<1, kPlain>(&out[2], &out[4]);
  if (err == cudaSuccess) err = conv_setup<1, kIdentity>(&out[3], &out[4]);
  out[5] = kTT;
  out[6] = kFB;
  return (int)err;
}

extern "C" int vpr_fcm(FcmParams p, void* stream_) {
  if (p.B <= 0 || p.T <= 0 || p.T_pad < p.T || p.T_pad % kTT != 0)
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
  int n_marked = 0;
  auto mark = [&]() {
    return p.events ? cudaEventRecord(p.events[n_marked++], stream) : cudaSuccess;
  };
  cudaError_t err;
#define VPR_TRY(x) do { err = (x); if (err != cudaSuccess) return (int)err; } while (0)
  VPR_TRY(mark());
  {
    const long long n = (long long)p.B * p.T * kF0;
    fcm_conv0_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        p.x, a80, w[0], A(0), p.B, p.T, p.T_pad);
    VPR_TRY(cudaGetLastError());
    VPR_TRY(mark());
  }
  auto conv = [&](const bf16* in, int f_in, bf16* out, int f_out, int i) {
    ConvArgs a{};
    a.in = in; a.out = out; a.w = w[i]; a.aff = A(i);
    a.B = p.B; a.f_in = f_in; a.f_out = f_out; a.out_ts = p.T_pad; a.T = p.T;
    a.T_pad = p.T_pad;
    return a;
  };
  // block 0 (F 80 -> 40)
  VPR_TRY((launch_conv<2, kPlain>(conv(a80, 80, y40, 40, 1), p.grid[0], stream)));
  VPR_TRY(mark());
  {
    ConvArgs a = conv(y40, 40, x40a, 40, 2);
    a.sc_in = a80; a.w_sc = w[3]; a.aff_sc = A(3);
    VPR_TRY((launch_conv<1, kShortcut>(a, p.grid[1], stream)));
    VPR_TRY(mark());
  }
  // block 1
  VPR_TRY((launch_conv<1, kPlain>(conv(x40a, 40, y40, 40, 4), p.grid[2], stream)));
  VPR_TRY(mark());
  {
    ConvArgs a = conv(y40, 40, x40b, 40, 5);
    a.res = x40a;
    VPR_TRY((launch_conv<1, kIdentity>(a, p.grid[3], stream)));
    VPR_TRY(mark());
  }
  // block 2 (F 40 -> 20)
  VPR_TRY((launch_conv<2, kPlain>(conv(x40b, 40, y20, 20, 6), p.grid[4], stream)));
  VPR_TRY(mark());
  {
    ConvArgs a = conv(y20, 20, x20a, 20, 7);
    a.sc_in = x40b; a.w_sc = w[8]; a.aff_sc = A(8);
    VPR_TRY((launch_conv<1, kShortcut>(a, p.grid[5], stream)));
    VPR_TRY(mark());
  }
  // block 3
  VPR_TRY((launch_conv<1, kPlain>(conv(x20a, 20, y20, 20, 9), p.grid[6], stream)));
  VPR_TRY(mark());
  {
    ConvArgs a = conv(y20, 20, x20b, 20, 10);
    a.res = x20a;
    VPR_TRY((launch_conv<1, kIdentity>(a, p.grid[7], stream)));
    VPR_TRY(mark());
  }
  // final conv (F 20 -> 10) straight into the (B, T, 320) output
  {
    ConvArgs a = conv(x20b, 20, p.out, 10, 11);
    a.out_ts = p.T;
    VPR_TRY((launch_conv<2, kPlain>(a, p.grid[8], stream)));
    VPR_TRY(mark());
  }
#undef VPR_TRY
  return (int)cudaSuccess;
}
