// Fused STFT + features for Hopper (sm_90a): framing, windowed real FFT in
// shared memory and an epilogue that writes only the requested outputs among
// the complex spectrum, |X|, log(|X| + eps) and log(|X| @ mel + eps).
//
// Replaces: gan_sass_tf_tpu/ops/pallas_stft.py:63, _stft_features_kernel
// (entry stft_features_pallas), and, as the spec-only instantiation
// stft_features_kernel<true> behind stft_launch, pallas_stft.py:228,
// _stft_kernel (entry stft_pallas): the plain complex STFT of the oracle
// bounds.  That one has no |X|/log/mel epilogue.  Both Pallas kernels run
// the DFT as a matmul on the MXU; on Hopper the f32 tensor-core route is
// closed (TF32 breaks the 3e-4·max|X| tolerance, split bf16 blew up log|X|
// at near-silent bins), so this is an FFT in f32 on the CUDA cores.
//
// What bounds it on this card: memory.  Per frame an FFT costs about
// 2.5·n_fft·log2(n_fft) flops (56 kFLOP at n_fft 2048), plus 2·K·M for the
// log-mel product, against 4·hop bytes of new waveform and 8·K bytes of
// complex output (n_fft / hop = 4 in every preset).  At the shapes the
// main path uses the bytes take 2.6-17.5 µs at 3.35 TB/s and the flops
// 1.4-3.4 µs at the 67 TFLOP/s f32 peak, so the least time is the input
// read once plus each requested output written once.
//
// Design: a block covers a tile of frames of one signal (tile_frames():
// kTileSamples / n_fft frames, from 1 to kMaxTile).  It stages
// the tile's span of waveform samples, (tile - 1)·hop + n_fft floats, in
// shared memory once, so each sample is read from device memory about once
// rather than n_fft/hop times.  Each frame is a real input of n_fft points,
// packed as z[m] = w[2m]·x[2m] + i·w[2m+1]·x[2m+1] into a complex FFT of
// H = n_fft/2 points, run as Stockham auto-sort stages (no bit-reversal
// pass) between two float2 buffers per frame: one radix-2 stage first
// where log2(H) is odd, then radix-4 stages.  Every thread of the block
// works on every frame of the tile: butterflies are numbered across the
// tile's frames, with one __syncthreads() between stages.  The split step
// gives the K = H + 1 bins,
//   X[k] = ½(Z[k] + conj Z[H-k]) - ½·i·e^{-2πik/N}·(Z[k] - conj Z[H-k]),
// with Z[H] = Z[0].  The window, the stage twiddles e^{-2πim/H} and the
// split twiddles e^{-2πik/N} are f32 tables built on the host in float64
// (no sincos intrinsics, no fast math).  Neighbouring threads write
// neighbouring bins of one frame, and a tile's frames are contiguous rows,
// so every store is coalesced.  For log-mel the |X| tile goes to the free
// ping-pong buffer, and each thread forms one (frame, mel band) sum.
// Nothing that was not requested is written.

#include <cuda_runtime.h>

namespace {

// Threads per block, and waveform samples per block (frames per block ×
// n_fft).  Picked on an H100 by timing tiles of 2048 to 16384 samples with
// 128, 256 and 512 threads at the main path's four STFT shapes (PERF.md,
// Findings); chip_smoke.py times the chosen shape on every run.
constexpr int kThreads = 256;
constexpr int kTileSamples = 2048;
constexpr int kMaxTile = 16;
constexpr int kMinFft = 64, kMaxFft = 4096;

int tile_frames(int n_fft) {
  const int t = kTileSamples / n_fft;
  return t < 1 ? 1 : (t > kMaxTile ? kMaxTile : t);
}

// Bytes of dynamic shared memory: two (tile, H) float2 buffers, then the
// tile's span of samples.
int smem_bytes(int n_fft, int hop) {
  const int tile = tile_frames(n_fft);
  return 8 * n_fft * tile + 4 * ((tile - 1) * hop + n_fft);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

template <bool kSpecOnly>
__global__ void __launch_bounds__(kThreads) stft_features_kernel(
    const float* __restrict__ x,        // (B, T)
    const float* __restrict__ win,      // (n_fft,) analysis window
    const float2* __restrict__ tw,      // (H,)   e^{-2πim/H}
    const float2* __restrict__ tws,     // (H+1,) e^{-2πik/N}
    const float* __restrict__ mel,      // (K, M) or null
    float* __restrict__ spec,           // (B, F, K, 2) or null
    float* __restrict__ mag_out,        // (B, F, K) or null
    float* __restrict__ logmag_out,     // (B, F, K) or null
    float* __restrict__ logmel_out,     // (B, F, M) or null
    int T, int F, int n_fft, int log2h, int hop, int tile, int M,
    float eps) {
  extern __shared__ float4 smem_raw[];
  const int H = n_fft >> 1, K = H + 1;
  float2* buf0 = reinterpret_cast<float2*>(smem_raw);     // (tile, H)
  float2* buf1 = buf0 + tile * H;                         // (tile, H)
  float* xs = reinterpret_cast<float*>(buf1 + tile * H);  // the tile's samples
  const int span = (tile - 1) * hop + n_fft;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * tile;
  const int nf = min(tile, F - f0);
  const float* xb = x + (size_t)b * T;
  const long long s0 = (long long)f0 * hop;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long t = s0 + i;
    xs[i] = t < T ? xb[t] : 0.f;
  }
  __syncthreads();

  // Pack each windowed frame into H complex points.
  for (int i = threadIdx.x; i < nf * H; i += kThreads) {
    const int f = i >> log2h, m = (i & (H - 1)) << 1;
    const float* fr = xs + f * hop;
    buf0[i] = make_float2(win[m] * fr[m], win[m + 1] * fr[m + 1]);
  }
  __syncthreads();

  float2* src = buf0;
  float2* dst = buf1;
  int ns = 1;   // length of the sub-transforms done so far
  if (log2h & 1) {   // radix 2, twiddles all 1
    const int half = H >> 1;
    for (int i = threadIdx.x; i < nf * half; i += kThreads) {
      const int f = i >> (log2h - 1), j = i & (half - 1);
      const float2 a = src[f * H + j], c = src[f * H + j + half];
      dst[f * H + 2 * j] = cadd(a, c);
      dst[f * H + 2 * j + 1] = csub(a, c);
    }
    float2* t = src; src = dst; dst = t;
    ns = 2;
    __syncthreads();
  }
  const int quarter = H >> 2;
  for (; ns < H; ns <<= 2) {
    const int stride = H / (4 * ns);   // twiddle index step for this stage
    for (int i = threadIdx.x; i < nf * quarter; i += kThreads) {
      const int f = i >> (log2h - 2), j = i & (quarter - 1);
      const int k = j & (ns - 1);
      const float2* s = src + f * H;
      float2 v0 = s[j], v1 = s[j + quarter], v2 = s[j + 2 * quarter],
             v3 = s[j + 3 * quarter];
      if (ns > 1) {
        v1 = cmul(v1, tw[k * stride]);
        v2 = cmul(v2, tw[2 * k * stride]);
        v3 = cmul(v3, tw[3 * k * stride]);
      }
      const float2 a0 = cadd(v0, v2), a1 = csub(v0, v2), a2 = cadd(v1, v3);
      const float2 d = csub(v1, v3);
      const float2 a3 = make_float2(d.y, -d.x);   // -i·(v1 - v3)
      float2* o = dst + f * H + (j - k) * 4 + k;
      o[0] = cadd(a0, a2);
      o[ns] = cadd(a1, a3);
      o[2 * ns] = csub(a0, a2);
      o[3 * ns] = csub(a1, a3);
    }
    float2* t = src; src = dst; dst = t;
    __syncthreads();
  }

  // Split into the K bins of the real transform, then the epilogue.
  float* mag_s = reinterpret_cast<float*>(dst);   // (tile, K), logmel only
  const size_t o0 = ((size_t)b * F + f0) * K;
  for (int i = threadIdx.x; i < nf * K; i += kThreads) {
    const int f = i / K, k = i - f * K;
    const float2* z = src + f * H;
    const float2 a = z[k & (H - 1)];
    const float2 c = z[(H - k) & (H - 1)];
    const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
    const float2 h = make_float2(0.5f * (a.x - c.x), 0.5f * (a.y + c.y));
    const float2 wd = cmul(tws[k], h);
    const float re = e.x + wd.y, im = e.y - wd.x;   // e - i·w·h
    if (kSpecOnly || spec)
      reinterpret_cast<float2*>(spec)[o0 + i] = make_float2(re, im);
    if constexpr (!kSpecOnly) {
      const float m = sqrtf(re * re + im * im);
      if (mag_out) mag_out[o0 + i] = m;
      if (logmag_out) logmag_out[o0 + i] = logf(m + eps);
      if (logmel_out) mag_s[i] = m;
    }
  }
  if (kSpecOnly || logmel_out == nullptr) return;   // uniform across the block
  __syncthreads();
  for (int i = threadIdx.x; i < nf * M; i += kThreads) {
    const int f = i / M, m = i - f * M;
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(mag_s[f * K + k], __ldg(mel + (size_t)k * M + m), acc);
    logmel_out[((size_t)b * F + f0 + f) * M + m] = logf(acc + eps);
  }
}

template <bool kSpecOnly>
int launch(const void* x, const void* win, const void* tw, const void* tws,
           const void* mel, void* spec, void* mag, void* logmag, void* logmel,
           int B, int T, int F, int n_fft, int hop, int M, float eps,
           void* stream, int device) {
  if (n_fft < kMinFft || n_fft > kMaxFft || (n_fft & (n_fft - 1)) ||
      hop < 1 || n_fft % hop)
    return (int)cudaErrorInvalidValue;
  int log2h = 0;
  while ((2 << log2h) < n_fft) ++log2h;   // H = n_fft / 2 = 1 << log2h
  const int tile = tile_frames(n_fft), smem = smem_bytes(n_fft, hop);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {   // above the default only by opting in
    err = cudaFuncSetAttribute(stft_features_kernel<kSpecOnly>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((F + tile - 1) / tile, B);
  stft_features_kernel<kSpecOnly>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          (const float*)x, (const float*)win, (const float2*)tw,
          (const float2*)tws, (const float*)mel, (float*)spec, (float*)mag,
          (float*)logmag, (float*)logmel, T, F, n_fft, log2h, hop, tile, M,
          eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher returns cudaGetLastError() after the launch (0 = launched);
// win, tw and tws are the tables of ops/stft_features.py::fft_tables.
extern "C" int stft_features_launch(
    const void* x, const void* win, const void* tw, const void* tws,
    const void* mel, void* spec, void* mag, void* logmag, void* logmel,
    int B, int T, int F, int n_fft, int hop, int M, float eps, void* stream,
    int device) {
  return launch<false>(x, win, tw, tws, mel, spec, mag, logmag, logmel, B, T,
                       F, n_fft, hop, M, eps, stream, device);
}

// The complex STFT alone: spec (B, F, K, 2) f32, interleaved re/im.
extern "C" int stft_launch(
    const void* x, const void* win, const void* tw, const void* tws,
    void* spec, int B, int T, int F, int n_fft, int hop, void* stream,
    int device) {
  return launch<true>(x, win, tw, tws, nullptr, spec, nullptr, nullptr,
                      nullptr, B, T, F, n_fft, hop, 0, 0.f, stream, device);
}
