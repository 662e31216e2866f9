// Inverse real FFT + windowed overlap-add + least-squares envelope for
// Hopper (sm_90a), in three instantiations of one kernel body:
//
//   K2  mixture STFT and per-source masks in (magnitude or complex masks),
//       separated waveforms out; the masks are applied as the spectrum is
//       loaded, so the masked spectra never reach device memory.
//       Replaces: gan_sass_tf_tpu/ops/pallas_istft.py:175,
//       _masked_istft_kernel (entry masked_istft_pallas).
//   K3  real and imaginary f32 planes in, waveforms out, no mask: the
//       forward of the train step's differentiable iSTFT (its backward is
//       istft_adjoint_kernel in stft_features.cu, see ops/istft.py).
//       Replaces: gan_sass_tf_tpu/ops/pallas_istft.py:71, _istft_kernel
//       (_istft_ri_fwd_impl under the _istft_ri custom VJP, entry
//       istft_pallas).
//
// What bounds it on this card: memory.  Per frame an inverse FFT costs
// about 2.5·n_fft·log2(n_fft) flops against 8·K bytes of spectrum (plus
// 4·K or 8·K of mask) in and 4·hop bytes of output, so at the main path's
// shapes the bytes take several times longer than the flops at 3.35 TB/s
// and the 67 TFLOP/s f32 peak.
//
// Design: the grid is (blocks of `rows` output hop-rows) x (signals).
// Output row q holds chunk j of frame q - j for j < r = n_fft/hop, so the
// rows [q0, q0 + rows) take frames q0 - r + 1 .. q0 + rows - 1: a halo of
// r - 1 frames that the neighbouring block inverts too, so no sum crosses
// blocks (no atomics, no second pass, no cap on the length).  The block
// walks those frames in chunks of `tile`.  Per chunk, in shared memory:
//   1. load X[k] and X[H-k] of each frame (H = n_fft/2), masks applied;
//      Im X[0] and Im X[H] are set to 0, as irfft ignores them;
//   2. the inverse split, scaled by 1/N (exact), into H complex points
//        Z[k] = (X[k] + conj X[H-k])/N + i·e^{+2πik/N}·(X[k] - conj X[H-k])/N;
//   3. the unscaled inverse FFT of H points (fft.cuh), after which the
//      buffer read as floats is the frame, x[2m] + i·x[2m+1] = z[m];
//   4. window × frame is added into an accumulator of rows·hop floats in
//      shared memory, over the rows the chunk's frames touch: one thread a
//      sample, which adds the chunk's frames in increasing order.  Chunks
//      follow each other between barriers, so each sample sums its frames
//      in the same order on every run and for every block shape.
// After the last chunk the accumulator times the clamped inverse envelope
// (null = env "none") is written out.  The window, the stage twiddles
// e^{-2πim/H} and the split twiddles e^{-2πik/N} are the f32 tables of
// ops/stft_features.py::fft_tables (built in float64), conjugated on read;
// no sincos intrinsics, no fast math.  `rows` and `tile` come from the
// wrapper (ops/masked_istft.py::synthesis_block).

#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinFft = 64, kMaxFft = 4096;

// Where a block's spectrum comes from.
enum SpecInput : int {
  kPlanes = 0,         // K3: re and im planes, (B, F, K) each, no mask
  kMagnitudeMask = 1,  // K2: complex spectrum (B, F, K) x masks (B, S, F, K)
  kComplexMask = 2,    // K2: complex spectrum x masks (B, S, F, K, 2)
};

// Bin k of frame f of signal bs (signal bs of K2 is source bs % S of
// mixture bs / S).  a: kPlanes -> re plane; otherwise the complex spectrum
// as (re, im) pairs.  b: kPlanes -> im plane; otherwise the masks.
template <int kInput>
__device__ __forceinline__ float2 load_bin(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int bs, int S, int F, int K, int f,
                                           int k) {
  const size_t o = ((size_t)bs * F + f) * K + k;
  if (kInput == kPlanes) return make_float2(a[o], b[o]);
  const float2 X =
      reinterpret_cast<const float2*>(a)[((size_t)(bs / S) * F + f) * K + k];
  if (kInput == kComplexMask)
    return cmul(reinterpret_cast<const float2*>(b)[o], X);
  const float m = b[o];
  return make_float2(m * X.x, m * X.y);
}

// Z[k] from a = X[k], c = X[H-k] and t = e^{-2πik/N}, scaled by s = 1/N.
__device__ __forceinline__ float2 inverse_split(float2 a, float2 c, float2 t,
                                                float s) {
  const float2 e = make_float2(s * (a.x + c.x), s * (a.y - c.y));
  const float2 d = make_float2(s * (a.x - c.x), s * (a.y + c.y));
  const float2 wd = cmul(conjf2(t), d);
  return make_float2(e.x - wd.y, e.y + wd.x);   // e + i·wd
}

template <int kInput>
__global__ void __launch_bounds__(kThreads) istft_ola_kernel(
    const float* __restrict__ a,
    const float* __restrict__ b,
    const float* __restrict__ win,      // (n_fft,) synthesis window
    const float2* __restrict__ tw,      // (H,)   e^{-2πim/H}
    const float2* __restrict__ tws,     // (H+1,) e^{-2πik/N}
    const float* __restrict__ inv_env,  // (nrows·hop,) or null
    float* __restrict__ out,            // (signals, nrows·hop)
    int S, int F, int n_fft, int log2h, int log2hop, int rows, int tile) {
  extern __shared__ float4 smem_raw[];
  const int H = n_fft >> 1, K = H + 1, half = H >> 1;
  const int hop = 1 << log2hop, r = n_fft >> log2hop;
  const int nrows = F + r - 1;
  float2* buf0 = reinterpret_cast<float2*>(smem_raw);      // (tile, H)
  float2* buf1 = buf0 + tile * H;                          // (tile, H)
  float* acc = reinterpret_cast<float*>(buf1 + tile * H);  // (rows, hop)
  const int span = rows << log2hop;
  const int bs = blockIdx.y;
  const int q0 = blockIdx.x * rows;
  const int fbase = q0 - r + 1;   // frame of local index 0
  // Local frames [lo, hi) touch the block's rows and exist.
  const int lo = max(0, -fbase), hi = min(rows + r - 1, F - fbase);
  const float s = 1.f / n_fft;    // exact: n_fft is a power of two
  for (int i = threadIdx.x; i < span; i += kThreads) acc[i] = 0.f;

  for (int c0 = lo; c0 < hi; c0 += tile) {
    const int nf = min(tile, hi - c0);
    // Steps 1-2, one (k, H - k) pair a thread: Z[k] and Z[H - k].
    for (int i = threadIdx.x; i < nf * (half + 1); i += kThreads) {
      const int l = i / (half + 1), k = i - l * (half + 1);
      const int f = fbase + c0 + l;
      float2 xk = load_bin<kInput>(a, b, bs, S, F, K, f, k);
      float2 xh = load_bin<kInput>(a, b, bs, S, F, K, f, H - k);
      if (k == 0) xk.y = xh.y = 0.f;   // Im X[0], Im X[H]
      float2* z = buf0 + l * H;
      z[k] = inverse_split(xk, xh, tws[k], s);
      if (k != 0 && k != half) z[H - k] = inverse_split(xh, xk, tws[H - k], s);
    }
    __syncthreads();
    // Step 3; frame c0 + l is x[l·n_fft .. (l + 1)·n_fft).
    const float* x = reinterpret_cast<const float*>(
        stockham<kThreads, true>(buf0, buf1, nf, H, log2h, tw));
    // Step 4: row q0 + q takes sample (q + r - 1 - l)·hop + o of local
    // frame l, for l in [q, q + r - 1]; so frames [c0, c0 + nf) touch the
    // rows [c0 - r + 1, c0 + nf).
    const int i1 = min(rows, c0 + nf) << log2hop;
    for (int i = (max(0, c0 - r + 1) << log2hop) + threadIdx.x; i < i1;
         i += kThreads) {
      const int q = i >> log2hop, o = i & (hop - 1);
      const int l1 = min(q + r, c0 + nf);
      float v = acc[i];
      for (int l = max(q, c0); l < l1; ++l) {
        const int n = ((q + r - 1 - l) << log2hop) + o;
        v = fmaf(__ldg(win + n), x[(l - c0) * n_fft + n], v);
      }
      acc[i] = v;
    }
    __syncthreads();   // the next chunk refills both buffers
  }

  float* ob = out + (size_t)bs * nrows * hop;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    if (q0 + (i >> log2hop) < nrows) {
      const size_t t = ((size_t)q0 << log2hop) + i;
      ob[t] = inv_env ? acc[i] * inv_env[t] : acc[i];
    }
  }
}

template <int kInput>
int launch(const void* a, const void* b, const void* win, const void* tw,
           const void* tws, const void* inv_env, void* out, int signals,
           int S, int F, int n_fft, int hop, int rows, int tile,
           void* stream, int device) {
  if (n_fft < kMinFft || n_fft > kMaxFft || (n_fft & (n_fft - 1)) ||
      hop < 1 || n_fft % hop || rows < 1 || tile < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  int log2h = 0, log2hop = 0;
  while ((2 << log2h) < n_fft) ++log2h;     // H = n_fft / 2 = 1 << log2h
  while ((1 << log2hop) < hop) ++log2hop;   // hop | n_fft: a power of two
  // Two (tile, H) float2 buffers and the (rows, hop) accumulator.
  const int smem = 8 * n_fft * tile + 4 * rows * hop;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {   // above the default only by opting in
    err = cudaFuncSetAttribute(istft_ola_kernel<kInput>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nrows = F + n_fft / hop - 1;
  dim3 grid((nrows + rows - 1) / rows, signals);
  istft_ola_kernel<kInput><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)win, (const float2*)tw,
      (const float2*)tws, (const float*)inv_env, (float*)out, S, F, n_fft,
      log2h, log2hop, rows, tile);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher returns cudaGetLastError() after the launch (0 = launched);
// win, tw and tws are the tables of ops/stft_features.py::fft_tables.

// K2: spec (B, F, K, 2) f32 and masks -> out (B·S, (F - 1)·hop + n_fft).
extern "C" int masked_istft_launch(
    const void* spec, const void* masks, const void* win, const void* tw,
    const void* tws, const void* inv_env, void* out, int B, int S, int F,
    int n_fft, int hop, int complex_mask, int rows, int tile, void* stream,
    int device) {
  if (complex_mask)
    return launch<kComplexMask>(spec, masks, win, tw, tws, inv_env, out,
                                B * S, S, F, n_fft, hop, rows, tile, stream,
                                device);
  return launch<kMagnitudeMask>(spec, masks, win, tw, tws, inv_env, out,
                                B * S, S, F, n_fft, hop, rows, tile, stream,
                                device);
}

// K3: re, im (B, F, K) -> out (B, (F - 1)·hop + n_fft).
extern "C" int istft_launch(
    const void* re, const void* im, const void* win, const void* tw,
    const void* tws, const void* inv_env, void* out, int B, int F, int n_fft,
    int hop, int rows, int tile, void* stream, int device) {
  return launch<kPlanes>(re, im, win, tw, tws, inv_env, out, B, 1, F, n_fft,
                         hop, rows, tile, stream, device);
}
