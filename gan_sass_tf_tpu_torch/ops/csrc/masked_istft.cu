// Inverse real DFT + windowed overlap-add + least-squares envelope for
// Hopper (sm_90a), in two instantiations of one kernel body:
//
//   K2  mixture STFT and per-source masks in, separated waveforms out; the
//       masked spectra never reach device memory.
//       Replaces: gan_sass_tf_tpu/ops/pallas_istft.py, _masked_istft_kernel
//       (entry masked_istft_pallas).
//   K3  real and imaginary f32 planes in, waveforms out, no mask: the
//       forward of the train step's differentiable iSTFT (its backward runs
//       on the STFT-features kernel, see ops/istft.py).
//       Replaces: gan_sass_tf_tpu/ops/pallas_istft.py, _istft_kernel
//       (_istft_ri_fwd_impl under the _istft_ri custom VJP, entry
//       istft_pallas).
//
// What bounds it on this card: 4·K·n_fft f32 flops per (signal, frame) —
// 3.1 GFLOP for K2 at the wsj0_logmel batch (B=16, S=2, F=184) and 8.3 GFLOP
// for K3 at the stream_v5e8 train step (B·S=64, F=247), against 16-33 MB of
// spectra, masks, matrices and output, so it is compute bound on the CUDA
// cores (f32; TF32 would break the 2e-4 reconstruction tolerance).  Each
// FMA pair reads one float2 of spectrum from shared memory (a warp
// broadcast) and, per bin, the synthesis matrices from L2 (coalesced
// across output samples): shared-memory issue is its limit.
//
// Design: the grid is (tiles of kRows output hop-rows) x (signals).  Output
// row q holds chunk j of frame q - j for j < r = n_fft/hop, so a tile of
// rows [q0, q0+kRows) needs frames q0-r+1 .. q0+kRows-1: a halo of r-1
// frames.  The block stages those frames' (masked) spectra in shared
// memory, bin-major so that the kRows frames one thread reads for a bin sit
// at fixed offsets from one base (1.6x faster than frame-major on the
// card), then each thread owns one sample column of the tile and sums every
// frame's contribution in registers: no atomics, nothing staged per whole
// signal, so the input length has no cap.  The synthesis window and
// hermitian bin weights are folded into Ci/Si (built on the host in
// float64); the clamped inverse envelope multiplies on the way out (null =
// env "none").  Only the staging loop differs between K2 and K3.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;   // output hop-rows per block

// Where a block's spectrum comes from.
enum SpecInput : int {
  kPlanes = 0,         // K3: re and im planes, (B, F, K) each, no mask
  kMagnitudeMask = 1,  // K2: complex spectrum (B, F, K) x masks (B, S, F, K)
  kComplexMask = 2,    // K2: complex spectrum x masks (B, S, F, K, 2)
};

// a: kPlanes -> re plane; otherwise the complex spectrum as (re, im) pairs.
// b: kPlanes -> im plane; otherwise the masks.
template <int kInput>
__global__ void istft_ola_kernel(
    const float* __restrict__ a,
    const float* __restrict__ b,
    const float* __restrict__ ci,      // (K, n_fft)
    const float* __restrict__ si,      // (K, n_fft)
    const float* __restrict__ inv_env, // (nrows * hop) or null
    float* __restrict__ out,           // (signals, nrows * hop)
    int S, int F, int n_fft, int hop, int K) {
  extern __shared__ float2 ms[];       // (K, kRows + r - 1) staged spectra
  const int r = n_fft / hop;
  const int nrows = F + r - 1;
  const int nfr = kRows + r - 1;
  const int bs = blockIdx.y;           // signal: batch·source (S = 1 for K3)
  const int q0 = blockIdx.x * kRows;
  const int fbase = q0 - r + 1;        // frame of local index 0
  for (int i = threadIdx.x; i < nfr * K; i += blockDim.x) {
    const int f = fbase + i / K, k = i % K;
    float2 v = make_float2(0.f, 0.f);
    if (f >= 0 && f < F) {
      const size_t o = ((size_t)bs * F + f) * K + k;
      if (kInput == kPlanes) {
        v = make_float2(a[o], b[o]);
      } else {
        const float2 X =
            reinterpret_cast<const float2*>(a)[((size_t)(bs / S) * F + f) * K + k];
        if (kInput == kComplexMask) {
          const float2 m = reinterpret_cast<const float2*>(b)[o];
          v = make_float2(m.x * X.x - m.y * X.y, m.x * X.y + m.y * X.x);
        } else {
          const float m = b[o];
          v = make_float2(m * X.x, m * X.y);
        }
      }
    }
    ms[(size_t)k * nfr + i / K] = v;   // bin-major: a row run is contiguous
  }
  __syncthreads();

  float* ob = out + (size_t)bs * nrows * hop;
  for (int o = threadIdx.x; o < hop; o += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = 0.f;
    for (int j = 0; j < r; ++j) {
      const int n = j * hop + o;
      // Row q0+q takes chunk j of frame q0+q-j: local index q + (r-1-j).
      const float2* mj = ms + (r - 1 - j);
      for (int k = 0; k < K; ++k) {
        const float c = __ldg(ci + (size_t)k * n_fft + n);
        const float s = __ldg(si + (size_t)k * n_fft + n);
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float2 v = mj[(size_t)k * nfr + q];
          acc[q] = fmaf(v.x, c, fmaf(v.y, s, acc[q]));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int row = q0 + q;
      if (row < nrows) {
        const size_t t = (size_t)row * hop + o;
        ob[t] = inv_env ? acc[q] * inv_env[t] : acc[q];
      }
    }
  }
}

template <int kInput>
int launch(const void* a, const void* b, const void* ci, const void* si,
           const void* inv_env, void* out, int signals, int S, int F,
           int n_fft, int hop, int K, int threads, int smem_bytes,
           void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(istft_ola_kernel<kInput>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int nrows = F + n_fft / hop - 1;
  dim3 grid((nrows + kRows - 1) / kRows, signals);
  istft_ola_kernel<kInput><<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)ci, (const float*)si,
      (const float*)inv_env, (float*)out, S, F, n_fft, hop, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int masked_istft_tile_rows() { return kRows; }

// K2.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int masked_istft_launch(
    const void* spec, const void* masks, const void* ci, const void* si,
    const void* inv_env, void* out,
    int B, int S, int F, int n_fft, int hop, int K, int complex_mask,
    int threads, int smem_bytes, void* stream, int device) {
  if (complex_mask)
    return launch<kComplexMask>(spec, masks, ci, si, inv_env, out, B * S, S,
                                F, n_fft, hop, K, threads, smem_bytes, stream,
                                device);
  return launch<kMagnitudeMask>(spec, masks, ci, si, inv_env, out, B * S, S, F,
                                n_fft, hop, K, threads, smem_bytes, stream,
                                device);
}

// K3.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int istft_launch(
    const void* re, const void* im, const void* ci, const void* si,
    const void* inv_env, void* out, int B, int F, int n_fft, int hop, int K,
    int threads, int smem_bytes, void* stream, int device) {
  return launch<kPlanes>(re, im, ci, si, inv_env, out, B, 1, F, n_fft, hop, K,
                         threads, smem_bytes, stream, device);
}
