// Fused Kaldi fbank from the waveform, for Hopper (sm_90a): a real FFT per
// frame in fp32 on the CUDA cores.
//
// Replaces the TPU kernel ops/pallas_fbank.py `_kernel` (pallas_call in
// `fbank_pallas`) of the JAX package. What it computes, per utterance b
// and frame t (25/10 ms frames at 16 kHz, snip edges), in kaldi's order:
//
//   x      = wave[b, 160 t : 160 t + 400]
//   y[j]   = window[j] * ((x[j] - mean) - 0.97 (x[j-1] - mean)),  x[-1] = x[0]
//   X      = rfft(y zero-padded to 512), bins 0..255 (Nyquist: mel weight 0)
//   out[t] = log(max(|X|^2 @ mel, FLT_EPSILON))
//
// What bounds it on the H100: bytes. At b256 x 3 s it must read 49.2 MB
// of waveform and write 24.4 MB of log-mel, 73.6 MB or 0.022 ms at
// 3.35 TB/s; a 512-point FFT per frame is 1.14 GFLOP, 0.017 ms at the
// 67 TFLOP/s of fp32 outside the tensor cores. (A folded 400 x 512 DFT
// as a product, the kernel this one replaced, is 31.4 GFLOP and ran at
// 2 % of the bound.)
//
// Design: a block takes kFrames frames of one utterance, 16 lanes (half a
// warp) per frame, so a 3 s request (398 frames) spreads over 50 blocks.
// The block stages its span of the waveform, (kFrames - 1) * 160 + 400
// samples, into shared memory with 16-byte loads (a scalar head and tail
// where the row does not start on 16 bytes: L % 4 != 0), and never reads
// past it. Each lane then holds 16 complex points of the packed sequence
// z[n] = y[2n] + i y[2n+1], n = l + 16 q, in registers:
//
//   1. a 16-point DFT over q in each lane (four-step 4 x 4),
//   2. the twiddles W_256^(l kq),
//   3. one transpose through a padded shared buffer (row stride 17, the
//      two frames of a warp 16 banks apart: no bank conflicts),
//   4. a 16-point DFT over l: lane kq holds Z[kq + 16 kp],
//   5. the split of the 256-point complex FFT into the 512-point real one,
//      E = (Z[k] + conj Z[256-k]) / 2, O = -i (Z[k] - conj Z[256-k]) / 2,
//      X[k] = E + W_512^k O and X[256-k] = conj(E - W_512^k O), so one pair
//      of loads and one twiddle give two bins (k < 128; bin 128 pairs with
//      itself), with Z[256-k] read back from shared memory,
//   6. the power to shared memory, then each lane sums the nonzero weights
//      of filters m = l, l + 16, ..., four bins per step (one 16-byte load
//      of weights), and stores the log coalesced.
//
// Every twiddle, W_16's included, comes from the host's table of
// W_512^k = (cos, -sin)(2 pi k / 512), computed in float64 and rounded to
// fp32; no sine or cosine is evaluated here. No tensor cores: bf16 and TF32
// products corrupt low-energy bins, and the work is below the byte bound.
// Nothing is shared between launches, so concurrent launches from several
// threads need no lock.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFrameLen = 400;
constexpr int kShift = 160;
constexpr int kBins = 256;                       // 512-point rfft, Nyquist dropped
constexpr int kFrames = 8;                       // frames per block
constexpr int kThreads = 16 * kFrames;           // 16 lanes per frame
constexpr int kLd = 17;                          // transpose row stride (floats)
constexpr int kBuf = 560;                        // floats per frame (re 272 | im 272 | pad);
                                                 // 560 % 32 == 16: a warp's two frames
                                                 // sit 16 banks apart
constexpr int kSpanMax = (kFrames - 1) * kShift + kFrameLen;
constexpr float kPreemph = 0.97f;

static_assert(2 * 16 * kLd <= kBuf && kBuf % 32 == 16, "frame buffer layout");

// cos(pi/8), sin(pi/8), sqrt(1/2): W_16 from the host table
struct W16 {
  float c1, s1, r;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// a * W_16^m for the exponents a 4 x 4 four-step needs (m = p4 * k4)
__device__ __forceinline__ float2 mul_w16(float2 v, int m, const W16& w) {
  const float a = v.x, b = v.y;
  switch (m) {
    case 1: return make_float2(a * w.c1 + b * w.s1, b * w.c1 - a * w.s1);
    case 2: return make_float2(w.r * (a + b), w.r * (b - a));
    case 3: return make_float2(a * w.s1 + b * w.c1, b * w.s1 - a * w.c1);
    case 4: return make_float2(b, -a);
    case 6: return make_float2(w.r * (b - a), -w.r * (a + b));
    case 9: return make_float2(-(a * w.c1 + b * w.s1), -(b * w.c1 - a * w.s1));
    default: return v;   // m == 0
  }
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 s0 = make_float2(a0.x + a2.x, a0.y + a2.y);
  const float2 d0 = make_float2(a0.x - a2.x, a0.y - a2.y);
  const float2 s1 = make_float2(a1.x + a3.x, a1.y + a3.y);
  const float2 d1 = make_float2(a1.x - a3.x, a1.y - a3.y);
  a0 = make_float2(s0.x + s1.x, s0.y + s1.y);
  a1 = make_float2(d0.x + d1.y, d0.y - d1.x);
  a2 = make_float2(s0.x - s1.x, s0.y - s1.y);
  a3 = make_float2(d0.x - d1.y, d0.y + d1.x);
}

// forward 16-point DFT in registers, in place, natural order in and out
__device__ __forceinline__ void dft16(float2 (&a)[16], const W16& w) {
#pragma unroll
  for (int p4 = 0; p4 < 4; ++p4) dft4(a[p4], a[p4 + 4], a[p4 + 8], a[p4 + 12]);
  // a[p4 + 4 k4] = B[p4][k4]
#pragma unroll
  for (int p4 = 1; p4 < 4; ++p4)
#pragma unroll
    for (int k4 = 1; k4 < 4; ++k4)
      a[p4 + 4 * k4] = mul_w16(a[p4 + 4 * k4], p4 * k4, w);
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4)
    dft4(a[4 * k4], a[4 * k4 + 1], a[4 * k4 + 2], a[4 * k4 + 3]);
  // a[4 k4 + kp4] = X[k4 + 4 kp4]
  float2 t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = a[i];
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
    for (int kp4 = 0; kp4 < 4; ++kp4) a[k4 + 4 * kp4] = t[4 * k4 + kp4];
}

__global__ void __launch_bounds__(kThreads)
fbank_kernel(const float* __restrict__ wave, const float* __restrict__ window,
             const float2* __restrict__ tw, const float* __restrict__ mel_packed,
             const int2* __restrict__ mel_range, float* __restrict__ out, int L,
             int T, int n_mels, int mel_width) {
  __shared__ __align__(16) float sw[kSpanMax + 4];
  __shared__ __align__(16) float sbuf[kFrames * kBuf];

  // ---- stage the block's span of the waveform: w[i] -> sw[s + i] -------
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, T - t0);
  const int span = (nf - 1) * kShift + kFrameLen;    // <= L - t0 * kShift
  const float* w = wave + (size_t)b * L + (size_t)t0 * kShift;
  const int s = (int)((reinterpret_cast<uintptr_t>(w) >> 2) & 3);
  const int head = (4 - s) & 3;                      // s + head is 0 or 4
  const int n4 = (span - head) >> 2;
  const int tail = head + 4 * n4;
  const float4* w4 = reinterpret_cast<const float4*>(w + head);
  float4* s4 = reinterpret_cast<float4*>(sw + s + head);
  for (int i = threadIdx.x; i < n4; i += kThreads) s4[i] = __ldg(w4 + i);
  if (threadIdx.x < head) sw[s + threadIdx.x] = __ldg(w + threadIdx.x);
  if (threadIdx.x < span - tail)
    sw[s + tail + threadIdx.x] = __ldg(w + tail + threadIdx.x);
  __syncthreads();

  const int f = threadIdx.x >> 4;                    // frame of this half-warp
  const int l = threadIdx.x & 15;                    // lane within the frame
  // a half-warp past T redoes the last frame and stores nothing, so every
  // lane reaches every __syncwarp
  const float* x = sw + s + min(f, nf - 1) * kShift;
  float* re = sbuf + f * kBuf;
  float* im = re + 16 * kLd;
  const float2 w1 = __ldg(tw + 32), w2 = __ldg(tw + 64);
  const W16 w16 = {w1.x, -w1.y, w2.x};

  // ---- lane l, register q: samples j = 2l + 32q and j + 1 ----------------
  float2 a[16];
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int j = 2 * l + 32 * q;
    a[q] = make_float2(0.f, 0.f);
    if (q < 13 && j < kFrameLen) a[q] = make_float2(x[j], x[j + 1]);
    sum += a[q].x;
    sum += a[q].y;
  }
#pragma unroll
  for (int off = 8; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mu = sum / kFrameLen;
#pragma unroll
  for (int q = 0; q < 13; ++q) {
    const int j = 2 * l + 32 * q;
    if (j < kFrameLen) {
      const float xm = x[j > 0 ? j - 1 : 0] - mu;   // kaldi replicates x[0]
      const float x0 = a[q].x - mu, x1 = a[q].y - mu;
      const float2 wj = __ldg(reinterpret_cast<const float2*>(window) + (j >> 1));
      a[q] = make_float2((x0 - kPreemph * xm) * wj.x, (x1 - kPreemph * x0) * wj.y);
    }
  }

  // ---- 256-point complex FFT: 16 x 16 four-step --------------------------
  dft16(a, w16);                                     // a[kq] = A[l][kq]
#pragma unroll
  for (int kq = 1; kq < 16; ++kq) a[kq] = cmul(a[kq], __ldg(tw + 2 * l * kq));
#pragma unroll
  for (int kq = 0; kq < 16; ++kq) {
    re[l * kLd + kq] = a[kq].x;
    im[l * kLd + kq] = a[kq].y;
  }
  __syncwarp();
#pragma unroll
  for (int p = 0; p < 16; ++p) a[p] = make_float2(re[p * kLd + l], im[p * kLd + l]);
  __syncwarp();
  dft16(a, w16);                                     // a[kp] = Z[l + 16 kp]
#pragma unroll
  for (int kp = 0; kp < 16; ++kp) {
    re[l + 16 * kp] = a[kp].x;
    im[l + 16 * kp] = a[kp].y;
  }
  __syncwarp();

  // ---- split into the real FFT, power --------------------------------------
  // bins k = l + 16 r < 128 and 256 - k (k = 0's partner is Nyquist)
  float pk[8], pc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int k = l + 16 * r;
    const int c = (kBins - k) & (kBins - 1);
    const float ar = a[r].x, ai = a[r].y, br = re[c], bi = im[c];
    const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
    const float orr = 0.5f * (ai + bi), oi = 0.5f * (br - ar);
    const float2 wk = __ldg(tw + k);
    const float tr = wk.x * orr - wk.y * oi, ti = wk.x * oi + wk.y * orr;
    pk[r] = (er + tr) * (er + tr) + (ei + ti) * (ei + ti);
    pc[r] = (er - tr) * (er - tr) + (ei - ti) * (ei - ti);
  }
  float p128 = 0.f;
  if (l == 0) {   // bin 128 pairs with itself: Z[128] (lane 0's a[8])
    const float ar = a[8].x, ai = a[8].y;   // gives E = Re Z, O = Im Z
    const float2 wk = __ldg(tw + 128);
    const float tr = wk.x * ai, ti = wk.y * ai;
    p128 = (ar + tr) * (ar + tr) + ti * ti;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    re[l + 16 * r] = pk[r];
    if (l + r > 0) re[kBins - l - 16 * r] = pc[r];
  }
  if (l == 0) re[128] = p128;
  if (l < 4) re[kBins + l] = 0.f;   // bins past 255 for the 4-wide steps
  __syncwarp();

  // ---- mel over each filter's nonzero bins, 4 at a time, log --------------
  if (f >= nf) return;
  float* o = out + ((size_t)b * T + t0 + f) * n_mels;
  for (int m = l; m < n_mels; m += 16) {
    const int2 rg = __ldg(mel_range + m);
    // filter m's weights for bins [rg.x, rg.y) from column 0, zero-padded
    // to mel_width (a multiple of 4), so a step past rg.y adds 0
    const float4* wm =
        reinterpret_cast<const float4*>(mel_packed + (size_t)m * mel_width);
    const float* p = re + rg.x;
    float acc = 0.f;
    for (int i = 0; i < rg.y - rg.x; i += 4) {
      const float4 wv = __ldg(wm + (i >> 2));
      acc = fmaf(p[i], wv.x, acc);
      acc = fmaf(p[i + 1], wv.y, acc);
      acc = fmaf(p[i + 2], wv.z, acc);
      acc = fmaf(p[i + 3], wv.w, acc);
    }
    o[m] = logf(fmaxf(acc, FLT_EPSILON));
  }
}

}  // namespace

// wave (B, L) fp32; window (400,) fp32; twiddles (512, 2) fp32, W_512^k as
// (cos, -sin); mel_packed (n_mels, mel_width) fp32, filter m's weights for
// bins [lo, hi) from column 0, zero-padded, mel_width a multiple of 4 and
// at least hi - lo; mel_range (n_mels, 2) int32 [lo, hi); out
// (B, T, n_mels) fp32; all contiguous on the current device.
extern "C" int vpr_fbank(const float* wave, const float* window,
                         const float* twiddles, const float* mel_packed,
                         const int* mel_range, float* out, int B, int L, int T,
                         int n_mels, int mel_width, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || n_mels <= 0 || n_mels > kBins ||
      mel_width <= 0 || mel_width % 4 || (long long)(T - 1) * kShift + kFrameLen > L)
    return (int)cudaErrorInvalidValue;
  dim3 grid((T + kFrames - 1) / kFrames, B);
  fbank_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      wave, window, reinterpret_cast<const float2*>(twiddles), mel_packed,
      reinterpret_cast<const int2*>(mel_range), out, L, T, n_mels, mel_width);
  return (int)cudaGetLastError();
}
