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
// The same body, as istft_adjoint_kernel (istft_adjoint_launch), is the
// backward of the differentiable iSTFT (K3; XLA in the reference,
// gan_sass_tf_tpu/ops/pallas_istft.py:151, _istft_ri_bwd): the cotangent
// times the inverse envelope is staged, transformed like any waveform, and
// the split epilogue writes a_k·Re X and a_k·Im X (a_k = 1/N at DC and
// Nyquist, 2/N elsewhere; Im X there is 0, the adjoint of the synthesis
// side dropping those imaginary parts) into two (B, F, K) f32 planes.
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
// H = n_fft/2 points (fft.cuh: Stockham stages, radix 4 after one radix-2
// stage where log2(H) is odd).  The split step gives the K = H + 1 bins,
//   X[k] = ½(Z[k] + conj Z[H-k]) - ½·i·e^{-2πik/N}·(Z[k] - conj Z[H-k]),
// with Z[H] = Z[0].  The window, the stage twiddles e^{-2πim/H} and the
// split twiddles e^{-2πik/N} are f32 tables built on the host in float64
// (no sincos intrinsics, no fast math).  Neighbouring threads write
// neighbouring bins of one frame, and a tile's frames are contiguous rows,
// so every store is coalesced.  For log-mel the |X| tile goes to the free
// ping-pong buffer, and each thread forms one (frame, mel band) sum.
// Nothing that was not requested is written.

#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

// Threads per block, and waveform samples per block (frames per block ×
// n_fft).  Picked on an H100 by timing tiles of 2048 to 16384 samples with
// 128, 256 and 512 threads at the main path's four STFT shapes (PERF.md,
// Findings); chip_smoke.py times the chosen shape on every run.
constexpr int kThreads = 256;
constexpr int kTileSamples = 2048;
constexpr int kMaxTile = 16;
constexpr int kMinFft = 64, kMaxFft = 4096;

// What the epilogue writes.
enum Mode : int {
  kFeatures = 0,  // K1: any of spec, |X|, log|X|, log-mel
  kSpec = 1,      // K4: the complex spectrum alone
  kAdjoint = 2,   // K3's backward: a_k-scaled re and im planes
};

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

// out0: kFeatures/kSpec -> the (B, F, K, 2) spectrum or null; kAdjoint ->
// the (B, F, K) re plane.  out1: kAdjoint -> the im plane.  inv_env
// (length T) multiplies the staged samples in kAdjoint only.
template <int kMode>
__device__ __forceinline__ void analysis_tile(
    const float* __restrict__ x,        // (B, T)
    const float* __restrict__ inv_env,  // (T,) or null
    const float* __restrict__ win,      // (n_fft,) analysis window
    const float2* __restrict__ tw,      // (H,)   e^{-2πim/H}
    const float2* __restrict__ tws,     // (H+1,) e^{-2πik/N}
    const float* __restrict__ mel,      // (K, M) or null
    float* __restrict__ out0,
    float* __restrict__ out1,
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
    float v = 0.f;
    if (t < T) v = kMode == kAdjoint ? xb[t] * inv_env[t] : xb[t];
    xs[i] = v;
  }
  __syncthreads();

  // Pack each windowed frame into H complex points.
  for (int i = threadIdx.x; i < nf * H; i += kThreads) {
    const int f = i >> log2h, m = (i & (H - 1)) << 1;
    const float* fr = xs + f * hop;
    buf0[i] = make_float2(win[m] * fr[m], win[m + 1] * fr[m + 1]);
  }
  __syncthreads();

  const float2* src = stockham<kThreads, false>(buf0, buf1, nf, H, log2h, tw);

  // Split into the K bins of the real transform, then the epilogue.
  float* mag_s = reinterpret_cast<float*>(src == buf0 ? buf1 : buf0);   // (tile, K), logmel only
  const size_t o0 = ((size_t)b * F + f0) * K;
  const float inv_n = 1.f / n_fft;   // exact: n_fft is a power of two
  for (int i = threadIdx.x; i < nf * K; i += kThreads) {
    const int f = i / K, k = i - f * K;
    const float2* z = src + f * H;
    const float2 a = z[k & (H - 1)];
    const float2 c = z[(H - k) & (H - 1)];
    const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
    const float2 h = make_float2(0.5f * (a.x - c.x), 0.5f * (a.y + c.y));
    const float2 wd = cmul(tws[k], h);
    const float re = e.x + wd.y, im = e.y - wd.x;   // e - i·w·h
    if constexpr (kMode == kAdjoint) {
      const bool edge = k == 0 || k == H;
      const float ak = edge ? inv_n : 2.f * inv_n;
      out0[o0 + i] = ak * re;
      out1[o0 + i] = edge ? 0.f : ak * im;
    } else {
      if (kMode == kSpec || out0)
        reinterpret_cast<float2*>(out0)[o0 + i] = make_float2(re, im);
    }
    if constexpr (kMode == kFeatures) {
      const float m = sqrtf(re * re + im * im);
      if (mag_out) mag_out[o0 + i] = m;
      if (logmag_out) logmag_out[o0 + i] = logf(m + eps);
      if (logmel_out) mag_s[i] = m;
    }
  }
  if (kMode != kFeatures || logmel_out == nullptr) return;   // uniform across the block
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
__global__ void __launch_bounds__(kThreads) stft_features_kernel(
    const float* __restrict__ x, const float* __restrict__ win,
    const float2* __restrict__ tw, const float2* __restrict__ tws,
    const float* __restrict__ mel, float* __restrict__ spec,
    float* __restrict__ mag_out, float* __restrict__ logmag_out,
    float* __restrict__ logmel_out, int T, int F, int n_fft, int log2h,
    int hop, int tile, int M, float eps) {
  analysis_tile<kSpecOnly ? kSpec : kFeatures>(
      x, nullptr, win, tw, tws, mel, spec, nullptr, mag_out, logmag_out,
      logmel_out, T, F, n_fft, log2h, hop, tile, M, eps);
}

__global__ void __launch_bounds__(kThreads) istft_adjoint_kernel(
    const float* __restrict__ dy, const float* __restrict__ inv_env,
    const float* __restrict__ win, const float2* __restrict__ tw,
    const float2* __restrict__ tws, float* __restrict__ dre,
    float* __restrict__ dim, int T, int F, int n_fft, int log2h, int hop,
    int tile) {
  analysis_tile<kAdjoint>(dy, inv_env, win, tw, tws, nullptr, dre, dim,
                          nullptr, nullptr, nullptr, T, F, n_fft, log2h, hop,
                          tile, 0, 0.f);
}

// Checks the geometry, selects the device and lets `kernel` take its
// shared memory; 0 or a cudaError.
int prepare(const void* kernel, int n_fft, int hop, int device, int* log2h,
            int* tile, int* smem) {
  if (n_fft < kMinFft || n_fft > kMaxFft || (n_fft & (n_fft - 1)) ||
      hop < 1 || n_fft % hop)
    return (int)cudaErrorInvalidValue;
  *log2h = 0;
  while ((2 << *log2h) < n_fft) ++*log2h;   // H = n_fft / 2 = 1 << log2h
  *tile = tile_frames(n_fft);
  *smem = smem_bytes(n_fft, hop);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (*smem > 48 * 1024)   // above the default only by opting in
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem);
  return (int)err;
}

template <bool kSpecOnly>
int launch(const void* x, const void* win, const void* tw, const void* tws,
           const void* mel, void* spec, void* mag, void* logmag, void* logmel,
           int B, int T, int F, int n_fft, int hop, int M, float eps,
           void* stream, int device) {
  int log2h, tile, smem;
  const int rc = prepare((const void*)stft_features_kernel<kSpecOnly>, n_fft,
                         hop, device, &log2h, &tile, &smem);
  if (rc) return rc;
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

// K3's backward: the (B, T) cotangent, T = (F - 1)·hop + n_fft, and the
// (T,) inverse envelope -> dre, dim, two (B, F, K) f32 planes.
extern "C" int istft_adjoint_launch(
    const void* dy, const void* inv_env, const void* win, const void* tw,
    const void* tws, void* dre, void* dim, int B, int T, int F, int n_fft,
    int hop, void* stream, int device) {
  int log2h, tile, smem;
  const int rc = prepare((const void*)istft_adjoint_kernel, n_fft, hop,
                         device, &log2h, &tile, &smem);
  if (rc) return rc;
  dim3 grid((F + tile - 1) / tile, B);
  istft_adjoint_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)dy, (const float*)inv_env, (const float*)win,
      (const float2*)tw, (const float2*)tws, (float*)dre, (float*)dim, T, F,
      n_fft, log2h, hop, tile);
  return (int)cudaGetLastError();
}
