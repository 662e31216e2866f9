// Fused STFT + features for Hopper (sm_90a): framing, windowed real DFT and
// an epilogue that writes only the requested outputs among the complex
// spectrum, |X|, log(|X| + eps) and log(|X| @ mel + eps).
//
// Replaces: gan_sass_tf_tpu/ops/pallas_stft.py, _stft_features_kernel
// (entry stft_features_pallas), and, as the spec-only instantiation
// stft_features_kernel<true> behind stft_launch, _stft_kernel (entry
// stft_pallas): the plain complex STFT of the oracle bounds.  That one has
// no |X|/log/mel epilogue and stages no |X| tile; its DFT loop is K1's, so
// it has K1's bound below, and it does O(n_fft) work per bin where an FFT
// does O(log n_fft): at n_fft 2048 a cuFFT rfft is an order faster.  Fewer
// registers than the full epilogue (64 against 96) let two blocks share an
// SM.
//
// What bounds it on this card: the DFT is 4·n_fft·K flops per frame in
// f32 (TF32 would break the 3e-4·max|X| tolerance, so no tensor cores);
// at the wsj0_logmel shape (B=16, F=184, n_fft=512, K=257) that is 1.5
// GFLOP against ~10 MB of waveform, DFT matrices and outputs, so it is
// compute bound on the CUDA cores.  For each sample index the inner loop
// does kTileF shared-memory reads (one per frame, broadcast to the warp)
// and two L2-resident global reads (cos/sin, coalesced across bins) for
// 2·kTileF FMAs, so shared-memory issue, not the FMA rate, is its limit.
//
// Design: one block covers kTileF frames and every bin, so the log-mel
// epilogue sees all of a frame's |X| in shared memory.  Frames are read
// straight from the waveform at stride hop (the tile's span of samples is
// staged once in shared memory), with no shifted copies in device memory.
// The windowed cos/sin matrices (n_fft, K) come from device memory, built on
// the host in float64.  re/im accumulate in f32 registers, one bin per
// thread.  Nothing that was not requested is written.

#include <cuda_runtime.h>

namespace {

constexpr int kTileF = 16;   // frames per block

template <bool kSpecOnly>
__global__ void stft_features_kernel(
    const float* __restrict__ x,       // (B, T)
    const float* __restrict__ wc,      // (n_fft, K)  w[n]·cos(2πnk/N)
    const float* __restrict__ ws,      // (n_fft, K) -w[n]·sin(2πnk/N)
    const float* __restrict__ mel,     // (K, M) or null
    float* __restrict__ spec,          // (B, F, K, 2) or null
    float* __restrict__ mag_out,       // (B, F, K) or null
    float* __restrict__ logmag_out,    // (B, F, K) or null
    float* __restrict__ logmel_out,    // (B, F, M) or null
    int T, int F, int n_fft, int hop, int K, int M, float eps) {
  extern __shared__ float smem[];
  const int span = (kTileF - 1) * hop + n_fft;
  float* xs = smem;                    // the tile's samples
  float* mag_s = smem + span;          // (kTileF, K), logmel only
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTileF;
  const int nf = min(kTileF, F - f0);
  const float* xb = x + (size_t)b * T;
  const long long s0 = (long long)f0 * hop;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long long t = s0 + i;
    xs[i] = t < T ? xb[t] : 0.f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float re[kTileF], im[kTileF];
#pragma unroll
    for (int f = 0; f < kTileF; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    for (int n = 0; n < n_fft; ++n) {
      const float c = __ldg(wc + (size_t)n * K + k);
      const float s = __ldg(ws + (size_t)n * K + k);
#pragma unroll
      for (int f = 0; f < kTileF; ++f) {
        const float v = xs[f * hop + n];
        re[f] = fmaf(v, c, re[f]);
        im[f] = fmaf(v, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kTileF; ++f) {
      if (f < nf) {
        const size_t o = ((size_t)b * F + f0 + f) * K + k;
        if (kSpecOnly || spec)
          reinterpret_cast<float2*>(spec)[o] = make_float2(re[f], im[f]);
        if constexpr (!kSpecOnly) {
          const float m = sqrtf(re[f] * re[f] + im[f] * im[f]);
          if (mag_out) mag_out[o] = m;
          if (logmag_out) logmag_out[o] = logf(m + eps);
          if (logmel_out) mag_s[f * K + k] = m;
        }
      }
    }
  }
  if (kSpecOnly || logmel_out == nullptr) return;   // uniform across the block
  __syncthreads();
  for (int i = threadIdx.x; i < nf * M; i += blockDim.x) {
    const int f = i / M, m = i % M;
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(mag_s[f * K + k], __ldg(mel + (size_t)k * M + m), acc);
    logmel_out[((size_t)b * F + f0 + f) * M + m] = logf(acc + eps);
  }
}

template <bool kSpecOnly>
int launch(const void* x, const void* wc, const void* ws, const void* mel,
           void* spec, void* mag, void* logmag, void* logmel,
           int B, int T, int F, int n_fft, int hop, int K, int M, float eps,
           int threads, int smem_bytes, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(stft_features_kernel<kSpecOnly>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((F + kTileF - 1) / kTileF, B);
  stft_features_kernel<kSpecOnly>
      <<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
          (const float*)x, (const float*)wc, (const float*)ws,
          (const float*)mel, (float*)spec, (float*)mag, (float*)logmag,
          (float*)logmel, T, F, n_fft, hop, K, M, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stft_features_tile_frames() { return kTileF; }

// Each launcher returns cudaGetLastError() after the launch (0 = launched).
extern "C" int stft_features_launch(
    const void* x, const void* wc, const void* ws, const void* mel,
    void* spec, void* mag, void* logmag, void* logmel,
    int B, int T, int F, int n_fft, int hop, int K, int M, float eps,
    int threads, int smem_bytes, void* stream, int device) {
  return launch<false>(x, wc, ws, mel, spec, mag, logmag, logmel, B, T, F,
                       n_fft, hop, K, M, eps, threads, smem_bytes, stream,
                       device);
}

// The complex STFT alone: spec (B, F, K, 2) f32, interleaved re/im.
extern "C" int stft_launch(
    const void* x, const void* wc, const void* ws, void* spec,
    int B, int T, int F, int n_fft, int hop, int K,
    int threads, int smem_bytes, void* stream, int device) {
  return launch<true>(x, wc, ws, nullptr, spec, nullptr, nullptr, nullptr, B,
                      T, F, n_fft, hop, K, 0, 0.f, threads, smem_bytes,
                      stream, device);
}
