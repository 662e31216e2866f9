// Fused STFT + features for Hopper (sm_90a): framing, windowed real FFT
// with its passes in registers, and an epilogue that writes only the
// requested outputs among the complex spectrum, |X|, log(|X| + eps) and
// log(|X| @ mel + eps).
//
// Replaces: gan_sass_tf_tpu/ops/pallas_stft.py:63, _stft_features_kernel
// (entry stft_features_pallas); as the spec-only mode behind stft_launch,
// pallas_stft.py:228, _stft_kernel (entry stft_pallas), the plain complex
// STFT of the oracle bounds; and as the adjoint mode behind
// istft_adjoint_launch, the backward of the differentiable iSTFT (K3), which
// the reference leaves to XLA (gan_sass_tf_tpu/ops/pallas_istft.py:151,
// _istft_ri_bwd): the cotangent times the inverse envelope is transformed
// like any waveform, and the epilogue writes a_k·Re X and a_k·Im X (a_k =
// 1/N at DC and Nyquist, 2/N elsewhere; Im X there is 0, the adjoint of the
// synthesis side dropping those imaginary parts) interleaved, (B, F, K, 2),
// the layout K3's forward reads.
// Both Pallas kernels run the DFT as a matmul on the MXU; on Hopper the f32
// tensor-core route is closed (TF32 breaks the 3e-4·max|X| tolerance, split
// bf16 blew up log|X| at near-silent bins), so this is an FFT in f32 on the
// CUDA cores, with no fast math and no sincos intrinsics: every twiddle is
// an f32 table built on the host in float64.
//
// What bounds it on this card: bytes.  A frame costs about
// 2.5·n_fft·log2(n_fft) flops (11.5 kFLOP at n_fft 512), plus 2·(band
// widths) for log-mel, against 4·hop bytes of new waveform and 4 to 12·K
// bytes of output (n_fft / hop = 4 in every preset).  At the main path's
// shapes (128 × 23 936 at n_fft 512; 16 × 132 300 at 2048) the bytes take
// 12-36 µs at 3.35 TB/s and the flops 3-5 µs at the 67 TFLOP/s f32 peak.
// So the design keeps the waveform read once, every output written once
// and wide, and the FFT's own traffic out of device memory and off the
// critical path.  What holds it above that bound is instruction issue:
// the epilogue's sqrt and log a bin, log-mel's sums and log a band, and
// the FFT each take longer than the stores, at 2 blocks of 8 warps an SM
// (PERF.md; scripts/time_analysis.py --ablate times each part).
//
// - Register-resident radix passes (fft.cuh, shared with the synthesis
//   body).  Each frame of n_fft real samples is packed as
//   z[m] = w[2m]·x[2m] + i·w[2m+1]·x[2m+1], a complex FFT of H = n_fft/2
//   points.  TF = H/16 threads own a frame, 16 points each, and run
//   Stockham passes of radix 16 in registers, then one pass of radix 2, 4
//   or 8 where log2(H) is not a multiple of 4 (H = 256: 16·16; H = 1024:
//   16·16·4), exchanging through padded shared memory behind warp or named
//   barriers.  A pass's twiddles come from a shared copy of the pass table
//   (ops/stft_features.py::pass_twiddles, entries of the stage table laid
//   out [pass][r][k] so that neighbouring threads read neighbouring
//   words).  The split step gives the K = H + 1 bins,
//     X[k] = ½(Z[k] + conj Z[H-k]) - ½·i·e^{-2πik/N}·(Z[k] - conj Z[H-k]),
//   with Z[H] = Z[0] and the split twiddles from a shared copy.
// - Persistent blocks fed ahead by asynchronous copies.  About (SMs ×
//   BLOCKS_PER_SM) blocks walk the (row, tile) work items; a tile is
//   `rounds` rounds of kThreads/TF frames of one row (fewer frames, down
//   to one, where a call is too small to give every SM a tile), and its
//   span of waveform, (frames - 1)·hop + n_fft floats, lands in one of
//   two shared stages by cp.async (16-byte copies from the first 16-byte
//   boundary, 4-byte copies at the ragged ends, so a row of any length
//   works) while the block transforms and writes the tile before it.
// - Banded log-mel.  The wrapper builds, once per mel matrix, a table of
//   each band's first and last non-zero bin (ops/stft_features.py::
//   mel_bands), so that no block reads the whole matrix; each block
//   stages the table and the bands' weights in shared memory (or reads
//   the weights from device memory where a matrix's bands are too wide
//   for the stage).  A band sums its bins in order over that range
//   only, one band a lane: the terms it skips are exact zeros
//   (fmaf(|X|, 0, acc) = acc for finite |X|), so each band gives the f32
//   sum the dense loop over all K bins gives, at 501 terms a frame
//   instead of 20 560 for the presets' 80-band filterbanks.
// - Wide stores.  A round's outputs are contiguous rows of (B, F, ·), and
//   the epilogue walks them flat in groups of four, each group aligned in
//   the output: float4 stores of |X| and log|X|, two float4 stores of the
//   complex spectrum (and of the adjoint's scaled one), and float4 stores of
//   log-mel gathered from eight lanes by shuffles; scalar stores only at
//   a round's two ends.  Nothing that was not requested is written.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

#include "fft.cuh"

#ifndef STFT_THREADS
#define STFT_THREADS 256
#endif

namespace {

// Threads per block: compile-time, as the register-resident passes need.
// The frames per tile (in rounds) and the blocks per SM come from the
// wrapper (ops/stft_features.py: TILE_ROUNDS, BLOCKS_PER_SM), picked on an
// H100 by gan_sass_tf_tpu_torch/scripts/time_analysis.py --sweep, which
// rebuilds this file with -DSTFT_THREADS= to sweep this one.
constexpr int kThreads = STFT_THREADS;
constexpr int kMinLog2H = 5, kMaxLog2H = 11;   // n_fft 64 ... 4096
constexpr int kMelStage = 2048;   // banded mel weights staged (floats)
static_assert(kThreads % 128 == 0 && kThreads <= 1024,
              "a block holds whole frames of up to 128 threads");

// What the epilogue writes.
enum Mode : int {
  kFeatures = 0,  // K1: any of spec, |X|, log|X|, log-mel
  kSpec = 1,      // K4: the complex spectrum alone
  kAdjoint = 2,   // K3's backward: a_k-scaled re and im planes
};

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

// The geometry of one H = 1 << L in a block of kThreads.
template <int L>
struct Geo : Frame<L> {
  static constexpr int G = kThreads / Frame<L>::TF;   // frames a round
  static_assert(G >= 1 && (Frame<L>::TF <= 32 || G <= 15), "named barriers 1..15");
};

// The dynamic shared memory, in floats from a 16-byte-aligned base: two
// waveform stages, the exchange buffer, the window, the split and pass
// twiddles, then for K1 the |X| of a round and the banded mel.
struct Layout {
  int stage, zbuf, win, tws, ptw, mag, bands, wts, total;
};

__host__ __device__ inline Layout layout(int L, int tile_frames, int hop,
                                         int M) {
  const int H = 1 << L, K = H + 1, tf = H / kPoints, g = kThreads / tf;
  Layout s;
  const int span = (tile_frames - 1) * hop + 2 * H;
  s.stage = align4(span + 4);   // + up to 3 floats ahead of a 16-byte boundary
  s.zbuf = 2 * s.stage;
  s.win = s.zbuf + align4(2 * g * (H + H / 16));
  s.tws = s.win + align4(2 * H);
  s.ptw = s.tws + align4(2 * K);
  s.mag = s.ptw + align4(2 * pass_twiddle_count(L));
  s.bands = s.mag + (M ? align4(g * K) : 0);
  s.wts = s.bands + align4(3 * M + 1);
  s.total = M ? s.wts + kMelStage : s.bands;
  return s;
}

struct Args {
  const float* x;         // (B, T) waveform or cotangent
  const float* inv_env;   // (T,) kAdjoint only
  const float* win;       // (n_fft,) analysis window
  const float2* tw;       // (H,)   e^{-2πim/H}
  const float2* tws;      // (H+1,) e^{-2πik/N}
  const float2* ptw;      // pass twiddles (pass_twiddles)
  const float* mel;       // (K, M) or null
  const int* bands;       // mel_bands(mel): (3M + 1,) or null
  float* out0;            // spectrum (B, F, K, 2), or kAdjoint's scaled one
  // Unused.  It keeps the parameter block's layout, which ptxas's code
  // follows: without it the int fields move and K1 and K4 run 1-9 %
  // slower on an H100 (PERF.md §6), with the same outputs.
  float* reserved;
  float* mag;             // (B, F, K) or null
  float* logmag;          // (B, F, K) or null
  float* logmel;          // (B, F, M) or null
  int B, T, F, hop, M, tile_frames;
  float eps;
};

// The transform's result is laid out with bits 4-5 of the bin xored into
// bits 0-1 (zout), so that the epilogue's threads, each reading four
// neighbouring bins, hit distinct banks.
__device__ __forceinline__ int zout(int k) { return k ^ ((k >> 4) & 3); }

// The whole transform of the frame in v (packed, natural order in); Z[k]
// ends in z at zout(k).
template <int L>
__device__ __forceinline__ void fft_frame(float2 (&v)[kPoints], float2* z,
                                          int t, int group,
                                          const float2* __restrict__ ptw,
                                          const Roots& w) {
  fft_passes<L>(v, z, t, group, ptw, w);
#pragma unroll
  for (int s = 0; s < kPoints; ++s) z[zout(t + Frame<L>::TF * s)] = v[s];
}

// Copies the band table of the (K, M) mel matrix (ops/stft_features.py::
// mel_bands: each band's first and last non-zero bin, then the offsets of
// the bands' weights, (3M + 1) ints) into shared memory and, when they fit
// the stage, the bands' weights; returns whether they do.  Block-wide (a
// barrier inside; the caller's next barrier publishes the weights).
__device__ bool stage_mel(const float* __restrict__ mel,
                          const int* __restrict__ bands, int M, int* lo,
                          float* wts) {
  const int* off = lo + 2 * M;
  for (int i = threadIdx.x; i < 3 * M + 1; i += kThreads) lo[i] = __ldg(bands + i);
  __syncthreads();
  const int total = off[M];
  const bool staged = total <= kMelStage;
  constexpr int kBatch = 8;   // independent loads in flight a thread
  for (int i0 = threadIdx.x; staged && i0 < total; i0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) {
        int a = 0, b = M;   // the band m with off[m] <= i < off[m + 1]
        while (b - a > 1) {
          const int c = (a + b) >> 1;
          if (off[c] <= i) a = c; else b = c;
        }
        v[u] = __ldg(mel + (size_t)(lo[a] + i - off[a]) * M + a);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * kThreads < total) wts[i0 + u * kThreads] = v[u];
  }
  return staged;
}

template <int L, int kMode>
__device__ __forceinline__ void analysis_body(const Args p) {
  using G = Geo<L>;
  constexpr int H = G::H, K = G::K, TF = G::TF;
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const bool want_mel = kMode == kFeatures && p.logmel != nullptr;
  const Layout lay = layout(L, p.tile_frames, p.hop, want_mel ? p.M : 0);
  float2* zbuf = reinterpret_cast<float2*>(sm + lay.zbuf);
  const float2* win2 = reinterpret_cast<const float2*>(sm + lay.win);
  float2* tws = reinterpret_cast<float2*>(sm + lay.tws);
  float2* ptw = reinterpret_cast<float2*>(sm + lay.ptw);
  float* mag_s = sm + lay.mag;

  const int tid = threadIdx.x;
  const int group = tid / TF, t = tid - group * TF;
  const int n_tiles = (p.F + p.tile_frames - 1) / p.tile_frames;
  const int n_items = p.B * n_tiles;
  int item = blockIdx.x;

  auto span_of = [&](int it, const float** src, int* nf) {
    const int b = it / n_tiles, f0 = (it - b * n_tiles) * p.tile_frames;
    *nf = min(p.tile_frames, p.F - f0);
    *src = p.x + (size_t)b * p.T + (size_t)f0 * p.hop;
    return (*nf - 1) * p.hop + 2 * H;
  };
  {
    const float* src;
    int nf;
    const int span = span_of(item, &src, &nf);
    prefetch<kThreads>(sm, src, span);
    cp_async_commit();
  }
  for (int i = tid; i < 2 * H; i += kThreads) sm[lay.win + i] = __ldg(p.win + i);
  for (int i = tid; i < K; i += kThreads) tws[i] = p.tws[i];
  for (int i = tid; i < G::PTW; i += kThreads) ptw[i] = p.ptw[i];
  const Roots w = roots_of(p.tw, H);
  int* lo = reinterpret_cast<int*>(sm + lay.bands);   // then hi, off
  const int *hi = lo + p.M, *off = lo + 2 * p.M;
  float* wts = sm + lay.wts;
  const bool mel_staged = want_mel && stage_mel(p.mel, p.bands, p.M, lo, wts);
  constexpr float inv_n = 1.f / (2 * H);   // exact: n_fft is a power of two

  for (int s = 0; item < n_items; item += gridDim.x, s ^= 1) {
    const int next = item + gridDim.x;
    if (next < n_items) {
      const float* src;
      int nf;
      const int span = span_of(next, &src, &nf);
      prefetch<kThreads>(sm + (s ^ 1) * lay.stage, src, span);
    }
    cp_async_commit();
    cp_async_wait_older();
    __syncthreads();   // this tile's span (and the tables) in place for all

    const int b = item / n_tiles, f0 = (item - b * n_tiles) * p.tile_frames;
    const int nf = min(p.tile_frames, p.F - f0);
    const float* xs = sm + s * lay.stage + span_head(p.x + (size_t)b * p.T + (size_t)f0 * p.hop);
    for (int r0 = 0; r0 < nf; r0 += G::G) {
      const int nfr = min(G::G, nf - r0);
      // Pack this thread's 16 points of its frame and transform it.  A
      // warp whose frames all lie past the round's end skips; one that
      // holds some repeats the last frame in the others, not written.
      const int lead = TF <= 32 ? (tid & ~31) / TF : group;   // its first frame
      if (lead < nfr) {
        const int fi = min(r0 + group, nf - 1);
        const float* fr = xs + fi * p.hop;
        const bool paired = ((fr - sm) & 1) == 0;   // fr[2m] 8-byte aligned
        float2 v[kPoints];
#pragma unroll
        for (int q = 0; q < kPoints; ++q) {
          const int m = t + TF * q;
          float a0, a1;
          if (paired) {
            const float2 x2 = reinterpret_cast<const float2*>(fr)[m];
            a0 = x2.x;
            a1 = x2.y;
          } else {
            a0 = fr[2 * m];
            a1 = fr[2 * m + 1];
          }
          if constexpr (kMode == kAdjoint) {
            const float* env = p.inv_env + (size_t)(f0 + fi) * p.hop + 2 * m;
            a0 = __fmul_rn(a0, __ldg(env));
            a1 = __fmul_rn(a1, __ldg(env + 1));
          }
          const float2 wm = win2[m];
          v[q] = make_float2(__fmul_rn(wm.x, a0), __fmul_rn(wm.y, a1));
        }
        fft_frame<L>(v, zbuf + group * G::ZS, t, group, ptw, w);
      }
      __syncthreads();   // the round's spectra in zbuf

      // Split into the K bins and write the requested outputs.
      const size_t row0 = (size_t)b * p.F + f0 + r0;
      auto bin = [&](int f, int k) -> float2 {   // bin k of the round's frame f
        const float2* zf = zbuf + f * G::ZS;
        const float2 a = zf[zout(k & (H - 1))];
        const float2 c = zf[zout((H - k) & (H - 1))];
        const float2 e = make_float2(__fmul_rn(0.5f, a.x + c.x),
                                     __fmul_rn(0.5f, a.y - c.y));
        const float2 h = make_float2(__fmul_rn(0.5f, a.x - c.x),
                                     __fmul_rn(0.5f, a.y + c.y));
        const float2 wd = cmul_rn(tws[k], h);
        return make_float2(e.x + wd.y, e.y - wd.x);   // e - i·w·h
      };
      const int n = nfr * K;
      const size_t g0 = row0 * K;
      // Values a thread takes at a time: 4, stored as float4s of each
      // output; 2 for the adjoint, whose one interleaved output a warp then
      // stores as whole 512-byte runs, one float4 a lane.
      constexpr int kLog2W = kMode == kAdjoint ? 1 : 2, kW = 1 << kLog2W;
      const int a = (int)(g0 & (kW - 1));
      const int groups = (n + a + kW - 1) >> kLog2W;
      for (int u = tid; u < groups; u += kThreads) {
        const int i0 = kW * u - a;
        const bool whole = i0 >= 0 && i0 + kW <= n;
        float re[kW], im[kW];
        int kb[kW];
        // (frame, bin) of the group's first value in the round, then one
        // step a value; lanes outside the round repeat a bin, not stored.
        const int ib = max(i0, 0);
        int f = ib / K, k = ib - f * K;
#pragma unroll
        for (int e = 0; e < kW; ++e) {
          const float2 x = bin(min(f, nfr - 1), k);
          re[e] = x.x;
          im[e] = x.y;
          kb[e] = k;
          if (i0 + e >= 0 && ++k == K) {
            k = 0;
            ++f;
          }
        }
        const size_t gb = g0 - a + kW * (size_t)u;   // a multiple of kW
        auto put = [&](float* out, float (&val)[4]) {
          if (whole) {
            *reinterpret_cast<float4*>(out + gb) =
                make_float4(val[0], val[1], val[2], val[3]);
          } else {
            for (int e = 0; e < 4; ++e)
              if (i0 + e >= 0 && i0 + e < n) out[gb + e] = val[e];
          }
        };
        if constexpr (kMode == kAdjoint) {
#pragma unroll
          for (int e = 0; e < kW; ++e) {
            const bool edge = kb[e] == 0 || kb[e] == H;
            const float ak = edge ? inv_n : 2.f * inv_n;
            re[e] = __fmul_rn(ak, re[e]);
            im[e] = edge ? 0.f : __fmul_rn(ak, im[e]);
          }
        }
        {
          if (kMode != kFeatures || p.out0) {
            float2* spec = reinterpret_cast<float2*>(p.out0);
            if (whole) {
              float4* s4 = reinterpret_cast<float4*>(spec + gb);
              s4[0] = make_float4(re[0], im[0], re[1], im[1]);
              if constexpr (kW == 4) s4[1] = make_float4(re[2], im[2], re[3], im[3]);
            } else {
              for (int e = 0; e < kW; ++e)
                if (i0 + e >= 0 && i0 + e < n)
                  spec[gb + e] = make_float2(re[e], im[e]);
            }
          }
          if constexpr (kMode == kFeatures) {
            if (p.mag || p.logmag || want_mel) {
              float m[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                m[e] = sqrtf(__fmaf_rn(re[e], re[e], __fmul_rn(im[e], im[e])));
              if (p.mag) put(p.mag, m);
              if (p.logmag) {
                float lm[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) lm[e] = logf(m[e] + p.eps);
                put(p.logmag, lm);
              }
              if (want_mel)
                for (int e = 0; e < 4; ++e)
                  if (i0 + e >= 0 && i0 + e < n) mag_s[i0 + e] = m[e];
            }
          }
        }
      }
      if (want_mel) {
        __syncthreads();   // the round's |X| in mag_s
        const int M = p.M, nm = nfr * M;
        const size_t gm = row0 * M;
        const int am = (int)(gm & 3), lane = tid & 31;
        // Band mb of the round's frame fb, summed in order of k over the
        // band's bins (eight at a time, loads first); a term past the band
        // adds nothing (skipped).
        auto band = [&](int fb, int mb) -> float {
          const float* mg = mag_s + fb * K;
          const int k0 = lo[mb], k1 = hi[mb];
          float acc = 0.f;
          if (mel_staged) {
            const float* wm = wts + off[mb] - k0;
            for (int k = k0; k <= k1; k += 8) {
              float x[8], y[8];
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const bool in = k + j <= k1;
                x[j] = in ? mg[k + j] : 0.f;
                y[j] = in ? wm[k + j] : 0.f;
              }
#pragma unroll
              for (int j = 0; j < 8; ++j)
                if (k + j <= k1) acc = __fmaf_rn(x[j], y[j], acc);
            }
          } else {
            for (int k = k0; k <= k1; ++k)
              acc = __fmaf_rn(mg[k], __ldg(p.mel + (size_t)k * M + mb), acc);
          }
          return logf(acc + p.eps);
        };
        // One (frame, band) value a lane in windows of 32 that start on
        // 16-byte boundaries of the output, two windows at a time (their
        // sums independent); lanes 0-7 then store four values of each
        // window, gathered by shuffles.  (f, m) steps by the windows'
        // stride, so only the first value divides by M.
        int i = (tid >> 5) * 32 + lane - am;   // this lane's value, first window
        int f = 0, m = 0;
        if (i >= 0) {
          f = i / M;
          m = i - f * M;
        }
        const int df = kThreads / M, dm = kThreads - df * M;
        auto step = [&](int& fs, int& ms) {   // (f, m) of the value kThreads on
          fs += df;
          ms += dm;
          if (ms >= M) {
            ms -= M;
            ++fs;
          }
        };
        for (int w0 = (tid >> 5) * 32; w0 < nm + am; w0 += 2 * kThreads) {
          int f1 = f, m1 = m;   // the value kThreads on (i + kThreads > 0)
          if (i >= 0) {
            step(f1, m1);
          } else {
            f1 = (i + kThreads) / M;
            m1 = i + kThreads - f1 * M;
          }
          const float val[2] = {i >= 0 && i < nm ? band(f, m) : 0.f,
                                i + kThreads < nm ? band(f1, m1) : 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int wh = w0 + h * kThreads;
            float4 v4;
            v4.x = __shfl_sync(0xffffffffu, val[h], 4 * (lane & 7));
            v4.y = __shfl_sync(0xffffffffu, val[h], 4 * (lane & 7) + 1);
            v4.z = __shfl_sync(0xffffffffu, val[h], 4 * (lane & 7) + 2);
            v4.w = __shfl_sync(0xffffffffu, val[h], 4 * (lane & 7) + 3);
            const int j0 = wh + 4 * lane - am;   // lane < 8: its group's first value
            float* out = p.logmel + (gm - am) + wh + 4 * lane;
            if (lane < 8 && j0 + 4 > 0 && j0 < nm) {
              if (j0 >= 0 && j0 + 4 <= nm) {
                *reinterpret_cast<float4*>(out) = v4;
              } else {
                const float v[4] = {v4.x, v4.y, v4.z, v4.w};
                for (int e = 0; e < 4; ++e)
                  if (j0 + e >= 0 && j0 + e < nm) out[e] = v[e];
              }
            }
          }
          i += 2 * kThreads;   // two windows on
          f = f1;
          m = m1;
          step(f, m);
        }
      }
      __syncthreads();   // zbuf, mag_s and this stage free again
    }
  }
}

// The kernels, by the names traces and profiles know them: K1 and K4 (the
// spectrum alone), and K3's backward.
template <int L, bool kSpecOnly>
__global__ void __launch_bounds__(kThreads) stft_features_kernel(const Args p) {
  analysis_body<L, kSpecOnly ? kSpec : kFeatures>(p);
}

template <int L>
__global__ void __launch_bounds__(kThreads) istft_adjoint_kernel(const Args p) {
  analysis_body<L, kAdjoint>(p);
}

struct Occupancy {
  const void* fn;
  int smem, device, blocks;
};

int sm_count_and_optin(int device, int* sms, int* optin) {
  static std::mutex mu;
  static int cached_sms[64], cached_optin[64];
  std::lock_guard<std::mutex> lock(mu);
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!cached_sms[device]) {
    cudaError_t err =
        cudaDeviceGetAttribute(&cached_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached_optin[device],
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) {
      cached_sms[device] = 0;
      return (int)err;
    }
  }
  *sms = cached_sms[device];
  *optin = cached_optin[device];
  return 0;
}

// Blocks of `fn` with `smem` bytes that fit an SM, cached; lets `fn` take
// up to the opt-in maximum of dynamic shared memory.
int blocks_per_sm(const void* fn, int smem, int optin, int device,
                  int* blocks) {
  static std::mutex mu;
  static Occupancy cache[64];
  static int used = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == fn && cache[i].smem == smem && cache[i].device == device) {
      *blocks = cache[i].blocks;
      return 0;
    }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (used < 64) cache[used++] = {fn, smem, device, *blocks};
  return 0;
}

template <int L, int kMode>
int launch_l(Args& a, int rounds, int per_sm, int device,
             cudaStream_t stream) {
  using G = Geo<L>;
  void (*kernel)(const Args);
  if constexpr (kMode == kAdjoint)
    kernel = istft_adjoint_kernel<L>;
  else
    kernel = stft_features_kernel<L, kMode == kSpec>;
  const void* fn = (const void*)kernel;
  int sms, optin;
  int rc = sm_count_and_optin(device, &sms, &optin);
  if (rc) return rc;
  const int m = kMode == kFeatures && a.logmel ? a.M : 0;
  // A smaller tile where a long hop would overflow shared memory, or where
  // the call has too few tiles to give every SM one: down to one frame, a
  // block then transforming copies of its last frame beside it (a frame's
  // bits do not depend on the tile).
  int smem = 0;
  for (a.tile_frames = rounds * G::G;; a.tile_frames >>= 1) {
    smem = 4 * layout(L, a.tile_frames, a.hop, m).total;
    const long long tiles =
        (long long)a.B * ((a.F + a.tile_frames - 1) / a.tile_frames);
    if (a.tile_frames == 1 || (smem <= optin && tiles >= sms)) break;
  }
  if (smem > optin) return (int)cudaErrorInvalidConfiguration;
  int fit;
  rc = blocks_per_sm(fn, smem, optin, device, &fit);
  if (rc) return rc;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items =
      (long long)a.B * ((a.F + a.tile_frames - 1) / a.tile_frames);
  const long long grid = std::min<long long>(items, (long long)sms * std::min(fit, per_sm));
  kernel<<<(int)grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch(Args a, int n_fft, int rounds, int per_sm, void* stream,
           int device) {
  if (n_fft < 2 << kMinLog2H || n_fft > 2 << kMaxLog2H ||
      (n_fft & (n_fft - 1)) || a.hop < 1 || n_fft % a.hop || rounds < 1 ||
      per_sm < 1 || a.B < 1 || a.F < 1)
    return (int)cudaErrorInvalidValue;
  const uintptr_t outs = reinterpret_cast<uintptr_t>(a.out0) |
                         reinterpret_cast<uintptr_t>(a.mag) |
                         reinterpret_cast<uintptr_t>(a.logmag) |
                         reinterpret_cast<uintptr_t>(a.logmel);
  if (outs & 15) return (int)cudaErrorMisalignedAddress;   // float4 stores
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_fft) {
    case 64: return launch_l<5, kMode>(a, rounds, per_sm, device, s);
    case 128: return launch_l<6, kMode>(a, rounds, per_sm, device, s);
    case 256: return launch_l<7, kMode>(a, rounds, per_sm, device, s);
    case 512: return launch_l<8, kMode>(a, rounds, per_sm, device, s);
    case 1024: return launch_l<9, kMode>(a, rounds, per_sm, device, s);
    case 2048: return launch_l<10, kMode>(a, rounds, per_sm, device, s);
    default: return launch_l<11, kMode>(a, rounds, per_sm, device, s);
  }
}

}  // namespace

// Each launcher returns cudaGetLastError() after its one launch (0 =
// launched).  win, tw and tws are the tables of
// ops/stft_features.py::fft_tables, ptw its pass_twiddles, bands the
// mel matrix's mel_bands; rounds (frames a tile, in rounds of
// kThreads/(n_fft/32) frames) and per_sm (resident blocks an SM at most)
// are the wrapper's block shape.  Every output pointer must be 16-byte
// aligned.
extern "C" int stft_features_launch(
    const void* x, const void* win, const void* tw, const void* tws,
    const void* ptw, const void* mel, const void* bands, void* spec,
    void* mag, void* logmag, void* logmel, int B, int T, int F, int n_fft,
    int hop, int M, float eps, int rounds, int per_sm, void* stream,
    int device) {
  Args a{(const float*)x, nullptr, (const float*)win, (const float2*)tw,
         (const float2*)tws, (const float2*)ptw, (const float*)mel,
         (const int*)bands, (float*)spec, nullptr, (float*)mag,
         (float*)logmag, (float*)logmel, B, T, F, hop, M, 0, eps};
  if (logmel && (mel == nullptr || bands == nullptr || M < 1))
    return (int)cudaErrorInvalidValue;
  return launch<kFeatures>(a, n_fft, rounds, per_sm, stream, device);
}

// The complex STFT alone: spec (B, F, K, 2) f32, interleaved re/im.
extern "C" int stft_launch(const void* x, const void* win, const void* tw,
                           const void* tws, const void* ptw, void* spec, int B,
                           int T, int F, int n_fft, int hop, int rounds,
                           int per_sm, void* stream, int device) {
  Args a{(const float*)x, nullptr, (const float*)win, (const float2*)tw,
         (const float2*)tws, (const float2*)ptw, nullptr, nullptr,
         (float*)spec, nullptr, nullptr, nullptr, nullptr, B, T, F, hop, 0, 0,
         0.f};
  return launch<kSpec>(a, n_fft, rounds, per_sm, stream, device);
}

// K3's backward: the (B, T) cotangent, T = (F - 1)·hop + n_fft, and the
// (T,) inverse envelope -> its gradient w.r.t. K3's input, (B, F, K, 2) f32
// interleaved (a_k·Re, a_k·Im).
extern "C" int istft_adjoint_launch(
    const void* dy, const void* inv_env, const void* win, const void* tw,
    const void* tws, const void* ptw, void* dspec, int B, int T, int F,
    int n_fft, int hop, int rounds, int per_sm, void* stream, int device) {
  Args a{(const float*)dy, (const float*)inv_env, (const float*)win,
         (const float2*)tw, (const float2*)tws, (const float2*)ptw, nullptr,
         nullptr, (float*)dspec, nullptr, nullptr, nullptr, nullptr, B, T, F,
         hop, 0, 0, 0.f};
  return launch<kAdjoint>(a, n_fft, rounds, per_sm, stream, device);
}
