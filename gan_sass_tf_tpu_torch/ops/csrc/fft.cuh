// What the FFT bodies of this directory share: the analysis body
// (stft_features.cu: K1, K4 and K3's backward) and the synthesis body
// (masked_istft.cu: K2 and K3).
//
// - Complex arithmetic.  Every product is an explicit __fmul_rn or
//   __fmaf_rn, so the compiler fuses none differently from one build (or
//   block shape) to the next, and a kernel's bits depend on its source
//   alone.
// - The register-resident FFT of H = n_fft/2 = 1 << L points: TF = H/16
//   threads own a frame, 16 points each (v[s] = point t + TF·s of thread
//   t), and run Stockham passes of radix 16 in registers (a 4×4
//   decomposition), then one pass of radix 2, 4 or 8 where L is not a
//   multiple of 4.  Points cross threads only between passes, through a
//   shared buffer padded one float2 in 16 (free of bank conflicts), behind
//   a __syncwarp (TF ≤ 32: a frame within a warp) or a named barrier over
//   the frame's warps (bar.sync 1 + group, TF threads).  A pass's twiddles
//   come from a shared copy of the pass table (ops/stft_features.py::
//   pass_twiddles); the radix-16 roots from the stage table.  It is the
//   forward transform; the synthesis body runs the inverse as
//   conj(fft(conj Z)), two exact sign flips around the same passes.
// - Asynchronous copies of a span of floats into shared memory: 16-byte
//   cp.async from the first 16-byte boundary, 4-byte ones at the ragged
//   ends, so a span at any 4-byte offset and of any length works.
// tests/test_torch_ops.py mirrors the passes in numpy f32 (_dft_r,
// _fft_passes).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

constexpr int kPoints = 16;   // points of a frame a thread holds

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) {   // -i·a, exact
  return make_float2(a.y, -a.x);
}
__device__ __forceinline__ float2 cmul_rn(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, __fmul_rn(-a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

// Entries of the pass table for H = 1 << L: (R - 1)·ns for each pass after
// the first (passes of radix 16, then the last radix 2^(L mod 4)).
__host__ __device__ constexpr int pass_twiddle_count(int L) {
  return (L / 4 >= 2 ? 15 * 16 : 0) +
         (L % 4 ? ((1 << (L % 4)) - 1) << (4 * (L / 4)) : 0);
}

// The geometry of one frame of H = 1 << L points.
template <int L>
struct Frame {
  static constexpr int H = 1 << L, K = H + 1;
  static constexpr int TF = H / kPoints;           // threads a frame
  static constexpr int ZS = H + H / 16;            // padded frame in a buffer
  static constexpr int P16 = L / 4;                // radix-16 passes
  static constexpr int RLAST = 1 << (L % 4);       // last radix (1: none)
  static constexpr int PTW = pass_twiddle_count(L);
};

// Exchange layout: one float2 of padding in 16.
__device__ __forceinline__ int zpad(int i) { return i + (i >> 4); }

// The radix-16 roots e^{-2πie/16} the in-register DFTs use (e = 4: -i, exact).
struct Roots {
  float2 w1, w2, w3, w6, w9;
};

// The roots from the stage table e^{-2πim/H}.
__device__ __forceinline__ Roots roots_of(const float2* __restrict__ tw, int H) {
  return {tw[H / 16], tw[2 * H / 16], tw[3 * H / 16], tw[6 * H / 16],
          tw[9 * H / 16]};
}

__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 s = cadd(a, b), d = csub(a, b);
  a = s;
  b = d;
}

// y[r] = Σ_n u[n]·e^{-2πinr/4}.
__device__ __forceinline__ void dft4(float2& u0, float2& u1, float2& u2,
                                     float2& u3) {
  const float2 a0 = cadd(u0, u2), a1 = csub(u0, u2), a2 = cadd(u1, u3);
  const float2 a3 = mul_neg_i(csub(u1, u3));
  u0 = cadd(a0, a2);
  u1 = cadd(a1, a3);
  u2 = csub(a0, a2);
  u3 = csub(a1, a3);
}

// An R-point DFT in registers, R = 2, 4, 8 or 16.  R = 8 and 16 split
// n = 4·n1 + n2, r = r1 + (R/4)·r2: a DFT over n1 for each n2, the twiddle
// e^{-2πi·n2·r1/R}, a 4-point DFT over n2 for each r1.
template <int R>
__device__ __forceinline__ void dft(float2 (&u)[R], const Roots& w) {
  if constexpr (R == 2) {
    dft2(u[0], u[1]);
  } else if constexpr (R == 4) {
    dft4(u[0], u[1], u[2], u[3]);
  } else if constexpr (R == 8) {
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) dft2(u[n2], u[4 + n2]);   // r1 = 0, 1
    u[5] = cmul_rn(u[5], w.w2);            // n2 = 1: e^{-2πi/8}
    u[6] = mul_neg_i(u[6]);             // n2 = 2: -i
    u[7] = cmul_rn(u[7], w.w6);            // n2 = 3: e^{-2πi·3/8}
    float2 y[8];
#pragma unroll
    for (int r1 = 0; r1 < 2; ++r1) {
      float2 a = u[4 * r1], b = u[4 * r1 + 1], c = u[4 * r1 + 2],
             d = u[4 * r1 + 3];
      dft4(a, b, c, d);
      y[r1] = a;
      y[r1 + 2] = b;
      y[r1 + 4] = c;
      y[r1 + 6] = d;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) u[i] = y[i];
  } else {
    static_assert(R == 16, "radix 2, 4, 8 or 16");
    float2 a[16];   // a[4·n2 + r1]
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      float2 p = u[n2], q = u[4 + n2], r = u[8 + n2], s = u[12 + n2];
      dft4(p, q, r, s);
      a[4 * n2] = p;
      a[4 * n2 + 1] = q;
      a[4 * n2 + 2] = r;
      a[4 * n2 + 3] = s;
    }
    a[5] = cmul_rn(a[5], w.w1);        // n2 = 1, r1 = 1: e^{-2πi/16}
    a[6] = cmul_rn(a[6], w.w2);        // (1, 2): ^2
    a[7] = cmul_rn(a[7], w.w3);        // (1, 3): ^3
    a[9] = cmul_rn(a[9], w.w2);        // (2, 1): ^2
    a[10] = mul_neg_i(a[10]);       // (2, 2): ^4 = -i
    a[11] = cmul_rn(a[11], w.w6);      // (2, 3): ^6
    a[13] = cmul_rn(a[13], w.w3);      // (3, 1): ^3
    a[14] = cmul_rn(a[14], w.w6);      // (3, 2): ^6
    a[15] = cmul_rn(a[15], w.w9);      // (3, 3): ^9
#pragma unroll
    for (int r1 = 0; r1 < 4; ++r1) {
      float2 p = a[r1], q = a[4 + r1], r = a[8 + r1], s = a[12 + r1];
      dft4(p, q, r, s);
      u[r1] = p;
      u[r1 + 4] = q;
      u[r1 + 8] = r;
      u[r1 + 12] = s;
    }
  }
}

// Syncs the threads of one frame: a warp, or the frame's warps.
template <int L>
__device__ __forceinline__ void frame_sync(int group) {
  if constexpr (Frame<L>::TF <= 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "n"(Frame<L>::TF)
                 : "memory");
  }
}

// One Stockham pass of radix R after `ns` points per sub-transform, on the
// 16 points v[s] = src[t + TF·s] that thread t of its frame holds: 16/R
// butterflies j = t + q·TF, with inputs s = q + r·(16/R).  A pass that is
// not the last writes its outputs to z at (j - k)·R + k + r·ns (k = j mod
// ns), padded; the last leaves them in v, where v[s] is then Z[t + TF·s].
template <int L, int R, int NS, int OFF, bool kLast>
__device__ __forceinline__ void fft_pass(float2 (&v)[kPoints],
                                         float2* __restrict__ z, int t,
                                         const float2* __restrict__ ptw,
                                         const Roots& w) {
  constexpr int Q = kPoints / R;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + q * Frame<L>::TF;
    const int k = j & (NS - 1);
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      u[r] = v[q + r * Q];
      if (NS > 1 && r > 0) u[r] = cmul_rn(u[r], ptw[OFF + (r - 1) * NS + k]);
    }
    dft<R>(u, w);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (kLast)
        v[q + r * Q] = u[r];
      else
        z[zpad((j - k) * R + k + r * NS)] = u[r];
    }
  }
}

// Reads a frame's points back after an exchange: v[s] = z[t + TF·s].
template <int L>
__device__ __forceinline__ void gather(float2 (&v)[kPoints],
                                       const float2* __restrict__ z, int t) {
#pragma unroll
  for (int s = 0; s < kPoints; ++s) v[s] = z[zpad(t + Frame<L>::TF * s)];
}

// The forward transform of the frame in v (natural order in): the radix-16
// passes, then the last radix, exchanging through the frame's buffer z
// (Frame<L>::ZS float2).  On return v[s] = Z[t + TF·s], and every thread
// of the frame is done with z (a frame_sync follows its last read), so the
// caller may write z at once.
template <int L>
__device__ __forceinline__ void fft_passes(float2 (&v)[kPoints], float2* z,
                                           int t, int group,
                                           const float2* __restrict__ ptw,
                                           const Roots& w) {
  using G = Frame<L>;
  static_assert(G::P16 >= 2 || G::RLAST > 1, "at least one exchange");
  fft_pass<L, 16, 1, 0, false>(v, z, t, ptw, w);
  frame_sync<L>(group);
  gather<L>(v, z, t);
  frame_sync<L>(group);
  if constexpr (G::P16 == 2) {
    constexpr bool kLast2 = G::RLAST == 1;
    fft_pass<L, 16, 16, 0, kLast2>(v, z, t, ptw, w);
    if constexpr (!kLast2) {
      frame_sync<L>(group);
      gather<L>(v, z, t);
      frame_sync<L>(group);
      fft_pass<L, G::RLAST, 256, 240, true>(v, z, t, ptw, w);
    }
  } else {
    fft_pass<L, G::RLAST, 16, 0, true>(v, z, t, ptw, w);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_older() {   // all but the newest
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Where element 0 of a span starting at src sits in its stage: the span is
// placed so that 16-byte boundaries of device memory fall on 16-byte
// boundaries of the stage.
__device__ __forceinline__ int span_head(const float* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// Starts the copy of span floats at src into stage + span_head(src) (each
// of the block's nthreads threads takes a share; the caller commits the
// group).  The stage holds span + 3 floats from a 16-byte boundary.
__device__ __forceinline__ void prefetch(float* stage, const float* src,
                                         int span, int nthreads) {
  const int head = span_head(src);
  const int first = (4 - head) & 3;   // floats before the first boundary
  const int nvec = (span - first) >> 2;
  const int rest = first + 4 * nvec;
  float* dst = stage + head;
  for (int i = threadIdx.x; i < first; i += nthreads)
    cp_async4(dst + i, src + i);
  for (int c = threadIdx.x; c < nvec; c += nthreads)
    cp_async16(dst + first + 4 * c, src + first + 4 * c);
  for (int i = rest + threadIdx.x; i < span; i += nthreads)
    cp_async4(dst + i, src + i);
}
template <int kThreads>
__device__ __forceinline__ void prefetch(float* stage, const float* src,
                                         int span) {
  prefetch(stage, src, span, kThreads);
}
