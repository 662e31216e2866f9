// Complex arithmetic for the kernels of this directory, and the inverse FFT
// that the synthesis kernels (masked_istft.cu) run per frame in shared
// memory: Stockham auto-sort stages (no bit-reversal pass) between two
// float2 buffers of (frames, H) points, one radix-2 stage first where
// log2(H) is odd, then radix-4 stages.  Every thread of the block works on
// every frame: butterflies are numbered across the frames, with one
// __syncthreads() after each stage.  The stage twiddles are the f32 table
// e^{-2πim/H} of ops/stft_features.py::fft_tables read conjugated (exact),
// and the radix-4 constant is +i, so it is the unscaled inverse transform.
// tests/test_torch_ops.py mirrors it in numpy f32 (_ifft_schedule).  The
// analysis kernels (stft_features.cu) run their own passes in registers.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 conjf2(float2 a) {
  return make_float2(a.x, -a.y);
}

// Inverse-transforms the nf frames of H = 1 << log2h points in src (frame
// f at src + f·H), ping-ponging with dst; returns the buffer that holds
// the result (the other one is then free).  The caller synchronizes
// between filling src and this call.
template <int kThreads, bool kInverse>
__device__ __forceinline__ float2* stockham(float2* src, float2* dst, int nf,
                                            int H, int log2h,
                                            const float2* __restrict__ tw) {
  static_assert(kInverse, "the forward FFT runs in stft_features.cu");
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
        float2 t1 = tw[k * stride], t2 = tw[2 * k * stride],
               t3 = tw[3 * k * stride];
        t1 = conjf2(t1);
        t2 = conjf2(t2);
        t3 = conjf2(t3);
        v1 = cmul(v1, t1);
        v2 = cmul(v2, t2);
        v3 = cmul(v3, t3);
      }
      const float2 a0 = cadd(v0, v2), a1 = csub(v0, v2), a2 = cadd(v1, v3);
      const float2 d = csub(v1, v3);
      const float2 a3 = make_float2(-d.y, d.x);   // +i·(v1 - v3)
      float2* o = dst + f * H + (j - k) * 4 + k;
      o[0] = cadd(a0, a2);
      o[ns] = cadd(a1, a3);
      o[2 * ns] = csub(a0, a2);
      o[3 * ns] = csub(a1, a3);
    }
    float2* t = src; src = dst; dst = t;
    __syncthreads();
  }
  return src;
}
