// Inverse real FFT + windowed overlap-add + least-squares envelope for
// Hopper (sm_90a), in three instantiations of one kernel body:
//
//   K2  mixture STFT and per-source masks in (magnitude or complex masks),
//       separated waveforms out; the masks are applied in registers as the
//       spectrum is loaded, so the masked spectra never reach device
//       memory.  Replaces: gan_sass_tf_tpu/ops/pallas_istft.py:175,
//       _masked_istft_kernel (entry masked_istft_pallas).
//   K3  the complex spectrum alone, (B, F, K, 2) f32 interleaved, in,
//       waveforms out: the forward of the train step's differentiable
//       iSTFT (its backward is istft_adjoint_kernel in stft_features.cu,
//       which writes the same layout; see ops/istft.py).  Replaces:
//       gan_sass_tf_tpu/ops/pallas_istft.py:71, _istft_kernel
//       (_istft_ri_fwd_impl under the _istft_ri custom VJP, entry
//       istft_pallas).
//
// Per frame: Im X[0] and Im X[H] set to 0 (irfft ignores them); the
// inverse split into H = n_fft/2 complex points, scaled by 1/N (exact),
//   Z[k] = (X[k] + conj X[H-k])/N + i·e^{+2πik/N}·(X[k] - conj X[H-k])/N;
// the unscaled inverse FFT of H points, after which z[m] = x[2m] +
// i·x[2m+1] is the frame; the synthesis window; overlap-add; × the clamped
// inverse envelope (null: env "none").
//
// What bounds it on this card: bytes.  A frame costs about
// 2.5·n_fft·log2(n_fft) flops against 8·K bytes of spectrum (plus 4·K or
// 8·K a source of masks) in and 4·hop bytes a signal out; at the main
// path's shapes the bytes take 4-18 µs at 3.35 TB/s and the flops a fifth
// of that at the 67 TFLOP/s f32 peak.  So the design reads every bin once,
// writes every sample once and wide, and keeps the transform's own traffic
// in registers and shared memory:
//
// - Each frame inverted once.  Persistent blocks (SMs × blocks an SM, from
//   occupancy) walk work items: a segment of `seg_rows` consecutive output
//   hop-rows of one mixture, for a group of up to G sources (G below).  Output row q
//   holds chunk j of frame q - j for j < r = n_fft/hop, so a segment of
//   rows [q0, q1) takes frames q0 - r + 1 .. q1 - 1: the item inverts them
//   in increasing order, a tile of `tile_frames` at a time, and carries the
//   rows still open from one tile to the next in a ring accumulator of
//   power-of-two rows in shared memory.  Only the r - 1 halo frames of a
//   segment's first tile are inverted twice (by the item before it too).
//   The wrapper (ops/masked_istft.py::synthesis_segment) makes segments
//   long where the call has many signals and short where it has few.
// - The mixture spectrum read once for all its sources.  A tile is one
//   round of the block's G = threads/TF frame slots, sources × frames
//   (K2: G/S frames of each of S sources); each slot applies its source's
//   mask (magnitude, or complex as (re, im) pairs) to the shared bins in
//   registers.
// - The next tile's spectrum, masks and inverse envelope (over the rows
//   the tile touches) staged by cp.async (fft.cuh) while the block
//   transforms the current one, in two shared regions; a region's staged
//   bins are read into registers, then the same region is the exchange
//   buffer of the transform and, after it, holds the tile's windowed
//   frames for the overlap-add.  The tables join the first tile's copies.
// - The analysis body's register-resident passes (fft.cuh): TF = H/16
//   threads a frame, 16 points each, radix-16 passes and one radix 2, 4 or
//   8, run as ifft(Z) = conj(fft(conj Z)), exact sign flips on both sides;
//   the inverse split in registers before them, the window product after.
// - Deterministic overlap-add.  Each output sample adds its frames' window
//   × frame products in increasing frame order, from 0 (a row's partial
//   sum waits in the ring between tiles), so its bits are the same on every
//   run and for every segment length, tile size, block count and
//   occupancy.  Every product is an explicit __fmul_rn or __fmaf_rn and
//   every sum an __fadd_rn.  A finished row times the inverse envelope is
//   stored as float4 (hop a multiple of 4; scalar otherwise).
//
// The window, the stage twiddles e^{-2πim/H}, the split twiddles
// e^{-2πik/N} and the pass table are the f32 tables of ops/stft_features.py
// (built in float64); no sincos intrinsics, no fast math.  The block's
// threads (256 or 512: ops/masked_istft.py::synthesis_threads picks the one
// that loads the SMs most evenly), frames a tile, blocks an SM and the
// segment come from the wrapper.  tests/test_torch_ops.py mirrors the body in numpy
// f32 (_ifft_schedule).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "fft.cuh"

namespace {

// Threads a block at most; a plan's are a multiple of 128 (whole frames of
// up to 128 threads) up to this.
constexpr int kMaxThreads = 512;

// What a work item reads besides the mixture spectrum.
enum SpecInput : int {
  kSpecOnly = 0,       // K3: the spectrum (B, F, K, 2) alone
  kMagnitudeMask = 1,  // K2: masks (B, S, F, K)
  kComplexMask = 2,    // K2: masks (B, S, F, K, 2)
};

template <int L>
struct Geo : Frame<L> {
  static_assert(Frame<L>::TF <= 32 || kMaxThreads / Frame<L>::TF <= 15,
                "named barriers 1..15");
};

// A call's geometry, its tables and its block shape: built once per
// geometry by the wrapper (ops/masked_istft.py::_Plan mirrors it), filled
// in by synthesis_prepare, and passed to every launch.
struct Plan {
  const float* win;       // (n_fft,) synthesis window
  const float2* tw;       // (H,)   e^{-2πim/H}
  const float2* tws;      // (H+1,) e^{-2πik/N}
  const float2* ptw;      // the pass table (pass_twiddles)
  const float* inv_env;   // (nrows·hop,) or null (env "none")
  int B, S, F, n_fft, hop, input;
  int threads;       // threads a block: G = threads/(n_fft/32) frame slots
  int tile_frames;   // frames a tile (0: as many as a round holds; prepare)
  int sources;       // sources a work item takes (prepare)
  int seg_rows;      // output hop-rows a work item owns (the wrapper)
  int per_sm;        // resident blocks an SM at most
  int device;
  int smem, sms, fit;   // bytes of shared memory, SMs, blocks that fit an SM
  int grid;             // blocks (the wrapper)
};

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int mask_width(int input) {
  return input == kComplexMask ? 2 : input == kMagnitudeMask ? 1 : 0;
}

// The dynamic shared memory, in floats from a 16-byte-aligned base: two
// regions (each the stage of a tile's spectrum and masks, then the
// exchange buffer and windowed frames), the ring accumulators, two stages
// of the inverse envelope over a tile's rows, the window, the split and
// pass twiddles.
struct Layout {
  int spec, mask, region, ring_log2, ring, env, envs, win, tws, ptw, total;
};

__host__ __device__ inline Layout layout(int L, int tile, int sources,
                                         int input, int hop, int threads) {
  const int H = 1 << L, K = H + 1, tf = H / kPoints, g = threads / tf;
  const int r = 2 * H / hop, mw = mask_width(input);
  Layout s;
  s.spec = align4(2 * tile * K + 4);   // + up to 3 floats ahead of a boundary
  s.mask = mw ? align4(mw * tile * K + 4) : 0;
  const int stage = s.spec + sources * s.mask, zbuf = align4(2 * g * (H + H / 16));
  s.region = stage > zbuf ? stage : zbuf;
  s.ring_log2 = 0;
  while ((1 << s.ring_log2) < tile + r - 1) ++s.ring_log2;
  s.ring = 2 * s.region;
  s.env = s.ring + align4(sources * (hop << s.ring_log2));
  s.envs = align4((tile + r - 1) * hop + 4);
  s.win = s.env + 2 * s.envs;
  s.tws = s.win + align4(2 * H);
  s.ptw = s.tws + align4(2 * K);
  s.total = s.ptw + align4(2 * pass_twiddle_count(L));
  return s;
}

// Z[k] from a = X[k], c = X[H-k] and t = e^{-2πik/N}, scaled by s = 1/N.
__device__ __forceinline__ float2 inverse_split(float2 a, float2 c, float2 t,
                                                float s) {
  const float2 e = make_float2(__fmul_rn(s, a.x + c.x), __fmul_rn(s, a.y - c.y));
  const float2 d = make_float2(__fmul_rn(s, a.x - c.x), __fmul_rn(s, a.y + c.y));
  const float2 wd = make_float2(__fmaf_rn(t.x, d.x, __fmul_rn(t.y, d.y)),
                                __fmaf_rn(t.x, d.y, __fmul_rn(-t.y, d.x)));
  return make_float2(e.x - wd.y, e.y + wd.x);   // e + i·conj(t)·d
}

template <int V>
__device__ __forceinline__ void vload(float (&a)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    a[0] = x.x;
    a[1] = x.y;
    a[2] = x.z;
    a[3] = x.w;
  } else {
    a[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void vstore(float* p, const float (&a)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  else
    *p = a[0];
}

// The overlap-add of one source's frames [f0, f1) of a tile (frame l at
// fr + (l - f0)·fs floats, windowed, in time order) into the rows [qa, qb)
// they touch: V samples a thread at a time, each starting from 0 where the
// row's first frame is in this tile and from the ring otherwise, adding the
// frames in increasing order; a row whose last frame is in this tile is
// finished (× the inverse envelope, staged from row qa on at env; null:
// none) and stored, the others go back to the ring.
template <int V>
__device__ __forceinline__ void overlap_add(
    const float* __restrict__ fr, int fs, float* __restrict__ ring,
    int ring_mask, float* __restrict__ out, const float* __restrict__ env,
    int f0, int f1, int qa, int qb, int F, int r, int log2hop) {
  constexpr int log2v = V == 4 ? 2 : 0;
  const int log2g = log2hop - log2v;   // groups of V samples a row
  const int n = (qb - qa) << log2g;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int q = qa + (i >> log2g), o = (i & ((1 << log2g) - 1)) << log2v;
    float acc[V];
    float* slot = ring + ((q & ring_mask) << log2hop) + o;
    if (max(0, q - r + 1) >= f0) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
    } else {
      vload<V>(acc, slot);
    }
    const int l1 = min(f1, q + 1);
    for (int l = max(f0, q - r + 1); l < l1; ++l) {
      float x[V];
      vload<V>(x, fr + (l - f0) * fs + ((q - l) << log2hop) + o);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], x[e]);
    }
    if (min(F - 1, q) < f1) {
      if (env) {
        float g[V];
        vload<V>(g, env + ((q - qa) << log2hop) + o);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = __fmul_rn(acc[e], g[e]);
      }
      vstore<V>(out + ((size_t)q << log2hop) + o, acc);
    } else {
      vstore<V>(slot, acc);
    }
  }
}

template <int L, int kInput>
__global__ void __launch_bounds__(kMaxThreads) istft_ola_kernel(
    const Plan p, const float* __restrict__ spec,
    const float* __restrict__ masks, float* __restrict__ out) {
  using G = Geo<L>;
  constexpr int H = G::H, K = G::K, TF = G::TF, N = 2 * H;
  constexpr int MW = mask_width(kInput);
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int T = p.tile_frames, SG = p.sources, F = p.F, nt = p.threads;
  const int log2hop = __ffs(p.hop) - 1, r = N >> log2hop;
  const Layout lay = layout(L, T, SG, kInput, p.hop, nt);
  const float2* win2 = reinterpret_cast<const float2*>(sm + lay.win);
  const float2* tws = reinterpret_cast<const float2*>(sm + lay.tws);
  const float2* ptw = reinterpret_cast<const float2*>(sm + lay.ptw);
  const int tid = threadIdx.x, group = tid / TF, t = tid - group * TF;
  const int nrows = F + r - 1;
  const int n_seg = (nrows + p.seg_rows - 1) / p.seg_rows;
  const int n_groups = (p.S + SG - 1) / SG;
  const int n_items = p.B * n_groups * n_seg;

  // Work item it: mixture b, sources [g·SG, g·SG + nsrc), rows [q0, q1),
  // frames [fs, fe).
  struct Item {
    int b, g, nsrc, q0, q1, fs, fe;
  };
  auto decode = [&](int it) {
    Item w;
    const int bg = it / n_seg, si = it - bg * n_seg;
    w.b = bg / n_groups;
    w.g = bg - w.b * n_groups;
    w.nsrc = min(SG, p.S - w.g * SG);
    w.q0 = si * p.seg_rows;
    w.q1 = min(w.q0 + p.seg_rows, nrows);
    w.fs = max(0, w.q0 - r + 1);
    w.fe = min(F, w.q1);
    return w;
  };
  auto spec_src = [&](const Item& w, int f0) {
    return spec + ((size_t)w.b * F + f0) * (2 * K);
  };
  auto mask_src = [&](const Item& w, int sl, int f0) {
    return masks + (((size_t)w.b * p.S + w.g * SG + sl) * F + f0) * (MW * K);
  };
  // The rows [qa, qb) that frames [f0, f1) of a tile of item w touch.
  auto rows_of = [&](const Item& w, int f0, int f1, int* qa, int* qb) {
    *qa = max(f0, w.q0);
    *qb = min(f1 + r - 1, w.q1);
  };
  auto env_src = [&](int qa) { return p.inv_env + ((size_t)qa << log2hop); };
  // Starts the copies of tile j of item w into region s: the spectrum, the
  // masks and the inverse envelope over the rows it touches.
  auto stage_tile = [&](const Item& w, int j, int s) {
    float* R = sm + s * lay.region;
    const int f0 = w.fs + j * T, nf = min(T, w.fe - f0);
    prefetch(R, spec_src(w, f0), 2 * nf * K, nt);
    if constexpr (MW > 0)
      for (int sl = 0; sl < w.nsrc; ++sl)
        prefetch(R + lay.spec + sl * lay.mask, mask_src(w, sl, f0), MW * nf * K, nt);
    if (p.inv_env) {
      int qa, qb;
      rows_of(w, f0, f0 + nf, &qa, &qb);
      prefetch(sm + lay.env + s * lay.envs, env_src(qa), (qb - qa) << log2hop, nt);
    }
  };

  int item = blockIdx.x, j = 0;
  Item w = decode(min(item, n_items - 1));
  if (item < n_items) stage_tile(w, 0, 0);
  // The tables (16-byte aligned: synthesis_prepare checks) join the first
  // tile's copies.
  prefetch(sm + lay.win, p.win, N, nt);
  prefetch(sm + lay.tws, reinterpret_cast<const float*>(p.tws), 2 * K, nt);
  prefetch(sm + lay.ptw, reinterpret_cast<const float*>(p.ptw), 2 * G::PTW, nt);
  cp_async_commit();
  const Roots roots = roots_of(p.tw, H);
  constexpr float scale = 1.f / N;   // exact: n_fft is a power of two

  for (int s = 0; item < n_items; s ^= 1) {
    cp_async_wait_all();
    __syncthreads();   // this tile staged (and the tables); the other region free
    int next = item, nj = j + 1;
    Item nw = w;
    if (w.fs + nj * T >= w.fe) {
      next = item + gridDim.x;
      nj = 0;
      if (next < n_items) nw = decode(next);
    }
    if (next < n_items) stage_tile(nw, nj, s ^ 1);
    cp_async_commit();

    float* R = sm + s * lay.region;
    const int f0 = w.fs + j * T, nf = min(T, w.fe - f0), f1 = f0 + nf;
    // Slot g holds frame f0 + g % T of source g / T.  A warp none of
    // whose slots holds a frame skips; one that holds some repeats a
    // frame in the others, not added.
    auto holds = [&](int g) { return g < w.nsrc * T && g % T < nf; };
    bool active = false;
    if constexpr (TF <= 32) {
      const int lead = (tid & ~31) / TF;
      for (int g = lead; g < lead + 32 / TF; ++g) active |= holds(g);
    } else {
      active = holds(group);
    }
    float2 v[kPoints];
    if (active) {
      const int sl = min(group / T, w.nsrc - 1), l = min(group % T, nf - 1);
      const float* xs = R + span_head(spec_src(w, f0)) + 2 * l * K;
      const float2* X = reinterpret_cast<const float2*>(xs);
      const float* M = R + lay.spec + sl * lay.mask + l * MW * K;
      if constexpr (MW > 0) M += span_head(mask_src(w, sl, f0));
#pragma unroll
      for (int q = 0; q < kPoints; ++q) {
        const int k = t + TF * q;
        float2 a = X[k], c = X[H - k];
        if constexpr (kInput == kMagnitudeMask) {
          const float ma = M[k], mc = M[H - k];
          a = make_float2(__fmul_rn(ma, a.x), __fmul_rn(ma, a.y));
          c = make_float2(__fmul_rn(mc, c.x), __fmul_rn(mc, c.y));
        } else if constexpr (kInput == kComplexMask) {
          const float2* M2 = reinterpret_cast<const float2*>(M);
          a = cmul_rn(M2[k], a);
          c = cmul_rn(M2[H - k], c);
        }
        if (k == 0) a.y = c.y = 0.f;   // Im X[0], Im X[H]
        const float2 z = inverse_split(a, c, tws[k], scale);
        v[q] = make_float2(z.x, -z.y);   // conj Z: the forward passes invert
      }
    }
    __syncthreads();   // the stage read: the region is the exchange buffer now
    if (active) {
      float2* z = reinterpret_cast<float2*>(R) + group * G::ZS;
      fft_passes<L>(v, z, t, group, ptw, roots);
      // v[q] = conj z[m], m = t + TF·q: samples 2m and 2m + 1, windowed,
      // in time order.
#pragma unroll
      for (int q = 0; q < kPoints; ++q) {
        const int m = t + TF * q;
        const float2 wm = win2[m];
        z[m] = make_float2(__fmul_rn(wm.x, v[q].x), -__fmul_rn(wm.y, v[q].y));
      }
    }
    __syncthreads();   // the tile's windowed frames in the region
    int qa, qb;
    rows_of(w, f0, f1, &qa, &qb);
    const float* env =
        p.inv_env ? sm + lay.env + s * lay.envs + span_head(env_src(qa)) : nullptr;
    for (int sl = 0; sl < w.nsrc; ++sl) {
      const float* fr = R + sl * T * 2 * G::ZS;
      float* ring = sm + lay.ring + sl * (p.hop << lay.ring_log2);
      float* o = out + ((size_t)w.b * p.S + w.g * SG + sl) * ((size_t)nrows << log2hop);
      if (log2hop >= 2)
        overlap_add<4>(fr, 2 * G::ZS, ring, (1 << lay.ring_log2) - 1, o, env, f0,
                       f1, qa, qb, F, r, log2hop);
      else
        overlap_add<1>(fr, 2 * G::ZS, ring, (1 << lay.ring_log2) - 1, o, env, f0,
                       f1, qa, qb, F, r, log2hop);
    }
    item = next;
    j = nj;
    w = nw;
  }
  cp_async_wait_all();
}

using Kernel = void (*)(const Plan, const float*, const float*, float*);

template <int L>
Kernel kernel_l(int input) {
  switch (input) {
    case kSpecOnly: return istft_ola_kernel<L, kSpecOnly>;
    case kMagnitudeMask: return istft_ola_kernel<L, kMagnitudeMask>;
    default: return istft_ola_kernel<L, kComplexMask>;
  }
}

// The kernel for a plan, or null where its n_fft or input is not taken.
Kernel kernel_of(const Plan& p) {
  if (p.input < kSpecOnly || p.input > kComplexMask) return nullptr;
  switch (p.n_fft) {
    case 64: return kernel_l<5>(p.input);
    case 128: return kernel_l<6>(p.input);
    case 256: return kernel_l<7>(p.input);
    case 512: return kernel_l<8>(p.input);
    case 1024: return kernel_l<9>(p.input);
    case 2048: return kernel_l<10>(p.input);
    case 4096: return kernel_l<11>(p.input);
    default: return nullptr;
  }
}

int launch(const Plan* p, const void* spec, const void* masks, void* out,
           void* stream) {
  const Kernel fn = kernel_of(*p);
  const uintptr_t sp = reinterpret_cast<uintptr_t>(spec),
                  mp = reinterpret_cast<uintptr_t>(masks),
                  op = reinterpret_cast<uintptr_t>(out),
                  ep = reinterpret_cast<uintptr_t>(p->inv_env);
  if (fn == nullptr || p->seg_rows < 1 || p->grid < 1 || p->smem < 1 ||
      (p->input != kSpecOnly) != (masks != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool wide = p->hop % 4 == 0;   // float4 rows of out and inv_env
  if ((sp & 7) || (mp & (p->input == kComplexMask ? 7 : 3)) ||
      (wide && ((op | ep) & 15)) || (op & 3))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(p->device);
  if (err != cudaSuccess) return (int)err;
  fn<<<p->grid, p->threads, p->smem, (cudaStream_t)stream>>>(
      *p, (const float*)spec, (const float*)masks, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Checks a plan's geometry and fills in its block shape: the sources a work
// item takes (all S up to the G slots of a round), the frames a tile (a
// round's worth unless set, halved while the shared memory exceeds the
// card's), the shared memory, the SMs and the blocks that fit an SM.
// Returns a cudaError (0 = ready for the wrapper's segment and grid).
extern "C" int synthesis_prepare(void* plan) {
  Plan* p = static_cast<Plan*>(plan);
  const Kernel fn = kernel_of(*p);
  if (fn == nullptr || p->hop < 1 || p->n_fft % p->hop || p->B < 1 ||
      p->S < 1 || p->F < 1 || p->per_sm < 1 || p->tile_frames < 0 ||
      (p->input == kSpecOnly && p->S != 1) || p->threads < 128 ||
      p->threads % 128 || p->threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const uintptr_t tables = reinterpret_cast<uintptr_t>(p->win) |
                           reinterpret_cast<uintptr_t>(p->tws) |
                           reinterpret_cast<uintptr_t>(p->ptw) |
                           reinterpret_cast<uintptr_t>(p->inv_env);
  if (tables & 15) return (int)cudaErrorMisalignedAddress;   // staged as is
  int L = 0;
  while ((2 << L) < p->n_fft) ++L;
  const int g = p->threads / ((1 << L) / kPoints);
  p->sources = std::min(p->S, g);
  int tile = p->tile_frames ? p->tile_frames : std::max(1, g / p->sources);
  if (tile * p->sources > g) return (int)cudaErrorInvalidValue;   // one round
  cudaError_t err = cudaSetDevice(p->device);
  int optin = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, p->device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 p->device);
  if (err != cudaSuccess) return (int)err;
  for (;; tile = std::max(1, tile / 2)) {
    p->smem = 4 * layout(L, tile, p->sources, p->input, p->hop, p->threads).total;
    if (p->smem <= optin || tile == 1) break;
  }
  if (p->smem > optin) return (int)cudaErrorInvalidConfiguration;
  p->tile_frames = tile;
  // The opt-in maximum, not this plan's bytes: the attribute is the
  // kernel's, shared by every plan that launches it.
  err = cudaFuncSetAttribute((const void*)fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->fit, (const void*)fn,
                                                        p->threads, p->smem);
  if (err != cudaSuccess) return (int)err;
  return p->fit < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

// Each launcher returns cudaGetLastError() after its one launch (0 =
// launched), on a plan that synthesis_prepare filled in and the wrapper
// gave a segment and a grid.

// K2: spec (B, F, K, 2) f32 and masks (B, S, F, K[, 2]) -> out (B, S, T),
// T = (F - 1)·hop + n_fft.
extern "C" int masked_istft_launch(const void* plan, const void* spec,
                                   const void* masks, void* out, void* stream) {
  const Plan* p = static_cast<const Plan*>(plan);
  if (p->input == kSpecOnly) return (int)cudaErrorInvalidValue;
  return launch(p, spec, masks, out, stream);
}

// K3: spec (B, F, K, 2) f32 -> out (B, T).
extern "C" int istft_launch(const void* plan, const void* spec, void* out,
                            void* stream) {
  const Plan* p = static_cast<const Plan*>(plan);
  if (p->input != kSpecOnly) return (int)cudaErrorInvalidValue;
  return launch(p, spec, nullptr, out, stream);
}
