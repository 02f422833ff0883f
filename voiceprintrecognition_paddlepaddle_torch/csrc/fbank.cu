// Fused Kaldi fbank from the waveform, for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas_fbank.py `_kernel` (pallas_call in
// `fbank_pallas`) of the JAX package. What it computes, per utterance b
// and frame t (25/10 ms frames at 16 kHz):
//
//   spec[t] = wave[160 t : 160 t + 400] @ Bfold      Bfold (400, 512) fp32
//   power   = re^2 + im^2                            (256 bins, Nyquist dropped)
//   out[t]  = log(max(power @ mel, FLT_EPSILON))     mel (256, n_mels)
//
// Bfold already holds DC removal, pre-emphasis and the povey window
// (fbank_kernel.folded_dft_np), so frames are never materialised.
//
// What bounds it on the H100: the DFT is 400 x 512 multiply-adds per frame
// (about 0.2 MFLOP), against 640 bytes of new waveform per frame, so it is
// bound by arithmetic, not by device memory. The DFT has heavy
// cancellation: single-pass bf16 corrupts low-energy bins and TF32 keeps
// only 3 more bits, so this version does the DFT with fp32 FMA on the CUDA
// cores (67 TFLOP/s peak) rather than on the tensor cores. A 3xTF32 or
// 3xbf16 split on the tensor cores is later work.
//
// Design: one block per (utterance, tile of TF frames). The tile's span of
// the waveform sits in shared memory; each thread owns one frequency bin
// and keeps the TF frames' real and imaginary sums in registers, reading
// its two Bfold columns from L2 (800 KB, shared by all blocks) once per
// tile and the waveform as shared-memory broadcasts, four samples per
// 16-byte load, so one load feeds eight FMAs. The power spectrum goes to
// shared memory for the mel product, which visits only each filter's
// nonzero bins (about 2 of 256 weights per bin are nonzero). Only frames
// t < T are computed, and the span of a valid frame never passes L, so
// the kernel never reads past the end of the waveform.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kTF = 32;        // frames per block
constexpr int kThreads = 256;  // one thread per frequency bin

__global__ void __launch_bounds__(kThreads)
fbank_kernel(const float* __restrict__ wave, const float* __restrict__ bfold,
             const float* __restrict__ mel, const int* __restrict__ mel_range,
             float* __restrict__ out, int L, int T, int frame_len, int shift,
             int nbins, int n_mels) {
  extern __shared__ float smem[];
  const int span_max = (kTF - 1) * shift + frame_len;
  float* sw = smem;              // waveform span of the tile
  float* sp = smem + span_max;   // power spectrum (kTF, nbins)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTF;
  const int nf = min(kTF, T - t0);
  const int span = (nf - 1) * shift + frame_len;   // <= L - t0 * shift
  const float* w = wave + (size_t)b * L + (size_t)t0 * shift;
  for (int i = threadIdx.x; i < span_max; i += kThreads)
    sw[i] = i < span ? w[i] : 0.f;
  __syncthreads();

  const int j = threadIdx.x;
  if (j < nbins) {
    float re[kTF], im[kTF];
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    const float* bc = bfold + j;
    const float* bs = bfold + nbins + j;
    const int ld = 2 * nbins;
    for (int k = 0; k < frame_len; k += 4) {   // frame_len, shift: x4
      float c[4], s[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c[q] = __ldg(bc + (size_t)(k + q) * ld);
        s[q] = __ldg(bs + (size_t)(k + q) * ld);
      }
#pragma unroll
      for (int f = 0; f < kTF; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(sw + f * shift + k);
        re[f] = fmaf(x.x, c[0], re[f]);
        im[f] = fmaf(x.x, s[0], im[f]);
        re[f] = fmaf(x.y, c[1], re[f]);
        im[f] = fmaf(x.y, s[1], im[f]);
        re[f] = fmaf(x.z, c[2], re[f]);
        im[f] = fmaf(x.z, s[2], im[f]);
        re[f] = fmaf(x.w, c[3], re[f]);
        im[f] = fmaf(x.w, s[3], im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kTF; ++f)
      sp[f * nbins + j] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nf * n_mels; idx += kThreads) {
    const int f = idx / n_mels, m = idx - f * n_mels;
    const float* p = sp + f * nbins;
    float acc = 0.f;   // weights outside [lo, hi) are exactly 0
    for (int q = __ldg(mel_range + 2 * m); q < __ldg(mel_range + 2 * m + 1); ++q)
      acc = fmaf(p[q], __ldg(mel + (size_t)q * n_mels + m), acc);
    out[((size_t)b * T + t0 + f) * n_mels + m] = logf(fmaxf(acc, FLT_EPSILON));
  }
}

}  // namespace

// wave (B, L) fp32, bfold (frame_len, 2*nbins) fp32, mel (nbins, n_mels)
// fp32, mel_range (n_mels, 2) int32 [first, last + 1) nonzero bin of each
// filter, out (B, T, n_mels) fp32; all contiguous on the current device.
extern "C" int vpr_fbank(const float* wave, const float* bfold,
                         const float* mel, const int* mel_range, float* out,
                         int B, int L, int T, int frame_len, int shift,
                         int nbins, int n_mels, void* stream) {
  if (B <= 0 || T <= 0 || nbins > kThreads || frame_len % 4 || shift % 4 ||
      (T - 1) * shift + frame_len > L)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(kTF - 1) * shift + frame_len + (size_t)kTF * nbins);
  cudaError_t err = cudaFuncSetAttribute(
      fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kTF - 1) / kTF, B);
  fbank_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      wave, bfold, mel, mel_range, out, L, T, frame_len, shift, nbins, n_mels);
  return (int)cudaGetLastError();
}
