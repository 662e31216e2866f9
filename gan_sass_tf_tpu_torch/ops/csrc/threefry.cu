// jax.random's threefry-2x32 draws for Hopper (sm_90a): a train step's
// batch (its keys, bank rows, shifts, gains, mix and noise) in one launch,
// bits, uniforms, randints and normals from a key a row, flax's dropout and
// the D's instance noise, fused.
//
// Replaces no TPU kernel.  The JAX package draws its bank picks and
// shifts (gan_sass_tf_tpu/data/device_bank.py:41-57), its gains and noise
// (data/mixer.py:31-51) and its eval and bound mixtures through
// jax.random, which XLA compiles into the step; these launches give the
// same numbers from the same keys inside the port's captured step, where
// the plain version (data/threefry.py: 20 rounds of int64 elementwise ops
// on masked words) takes over a hundred launches a draw.
//
//  - threefry_batch_launch: a step's batch.  Per example i the JAX step's
//    keys (gan_sass_tf_tpu/train/step.py:212-237): with a step r =
//    fold_in(key, step), (rng_mix, rng_data) = split(r, 5)[0:2], without
//    one the key is both bases (mix_sources / sample_bank under a given
//    key); (k_pick, k_shift) = split(fold_in(rng_data, offset + i)),
//    (k_gain, k_noise) = split(fold_in(rng_mix, offset + i)).  With the
//    bank (S, N, T) source s is bank row randint(k_pick)[s] rolled by
//    -randint(k_shift)[s], else row s of the example's given sources; it
//    is scaled by 10^(g/20), g = uniform(k_gain, ∓gain)[s] dB, and the
//    scaled sources summed in order into the mixture.  Under noise the
//    mixture gains normal(k_noise, T)·sqrt(mean(mixture²) / 10^(snr/10)):
//    the mean needs the whole row, so each tile's sum of mixture² is
//    written in a fixed order and a second launch adds the noise after
//    all tiles (threefry_batch_noise_kernel).  With d_steps > 0 block (0, 0) also writes the
//    step's dropout and noise keys (step.py:213-228, :317, :178, :372):
//    rng_g, rng_dl, rng_ga = split(r, 5)[2:5], each folded with the
//    shard; rng_g; per D step di split(fold_in(rng_dl, di), 3) (D dropout,
//    noise, R1 dropout); split(rng_ga) (the adversarial call's dropout,
//    noise).  It writes the picks, shifts and gains too (B x S, for the
//    checks).
//  - threefry_sample_launch: R rows of n values, row r under keys[r], the
//    value j from the counter pair (0, j) (jax's partitionable bits: the
//    two output words xored).  kind 0 bits (int64), 1 uniform (float32 on
//    [lo, hi)), 2 randint (int64 in [minval, minval + span), from the bits
//    of split(key)[0] and [1]), 3 normal (float32, √2·erf⁻¹ of a uniform
//    on (nextafter(-1, 0), 1), XLA's float32 polynomial).
//
//  - threefry_dropout_launch: flax's nn.Dropout at one site,
//    select(uniform(k, shape) < keep, x * scale, 0) in x's dtype (float32
//    or bfloat16), k = fold_in(base, fold) the site's make_rng key (fold
//    the SHA-1 of its module path and counter, a host constant, folded in
//    by each thread) and the uniform the float32 one of bernoulli, 32-bit
//    words whatever x's dtype.  scale = float32(1 / keep rounded to x's
//    dtype): jit rewrites flax's division by the constant into that product,
//    and in bfloat16 the two round alike.  The value j of the draw is the
//    element's row-major position in the flax tensor (B, T, F, C) or (B,
//    T, H); the port's tensor is contiguous in its own order (NCHW at the
//    conv sites).  It also writes the keep mask packed, one bit an element
//    in the port's order: element m is bit m % 32 of word m / 32, the bits
//    of the last word past n 0.
//  - dropout_mask_launch: the dropout's VJP, dx = bit ? dy * scale : 0 in
//    dy's dtype, from the words the forward wrote; no cipher.  It is linear
//    in dy, so its own VJP is the same launch (R1's double backward).
//  - threefry_noise_launch: x + std * normal(key, x.shape, x.dtype), x
//    contiguous in the flax layout.  float32: XLA folds std * sqrt2 into
//    one constant and contracts the add, fmaf(f32(std * sqrt2),
//    erf_inv(u), x).  bfloat16 (jax/_src/random.py::_uniform for nmant < 8):
//    8-bit words (the low byte of the two words xored), u = (4 (byte >> 1)
//    - 255) / 256 exactly, erf_inv in float32 rounded to bf16, times
//    bf16(sqrt2) rounded, times bf16(std) rounded, plus x rounded: each op
//    in bf16, as XLA's CPU code rounds them.
//
// Every float op is an explicit round-to-nearest intrinsic, so nvcc
// contracts nothing: the scale-and-shift of a uniform and each Horner step
// of erf⁻¹ are one __fmaf_rn each, as XLA's CPU code contracts them (the
// plain version rounds them once too), the rest __fmul_rn / __fadd_rn /
// __fsqrt_rn.  Uniforms, bits and randints are the plain version's bits;
// normals differ from it by log1pf's last bit at most.
//
// What bounds it on this card: integer issue.  A value costs one cipher
// (a randint two, one for each of its bit arrays, and its key's two splits
// a row): 20 rounds of add, funnel-shift rotate and xor, 5 key injections
// of one add a word (IADD3 folds the round constant in), the key's third
// word and the counter's add, 72 integer instructions, against 4 bytes
// written (8 for int64).  Only the 20 rotates and 20 xors need the integer
// ALU (64 lanes an SM a clock); the adds can issue as IMADs on the FMA pipe
// (ImadAdd).  At the stream_v5e8 b32 step's noise, 32 × 32 000 normals,
// that is ~41 M ALU instructions, about 2.4 µs at 64 lanes × 132 SMs ×
// 1.98 GHz, against 1.2 µs for its 4 MB at 3.35 TB/s (ops/cost.py).
// So each kernel strips what an element pays besides its cipher:
//  - the sampler: a thread owns 4 consecutive values of one row (one
//    value where rows are shorter than that: such draws are launch-bound,
//    so a thread's chain of four ciphers, or the IMADs' longer latency,
//    would only add to it) and finds (row, first value) once, with one
//    32-bit division; a block
//    holds several short rows, or a long row spans blocks on x, rows step
//    on y (a loop past 65 535).  The row's key (a randint's two splits)
//    once a thread; 16-byte stores (a scalar path for a row's tail and an
//    unaligned row).  erf⁻¹ branches on w < 5 instead of selecting each
//    of its nine coefficients: about 0.3 % of values take the long side.
//  - the noise: a thread owns a 16-byte vector of x, 8 bf16 or 4 float32
//    values (a scalar path for the tail and an unaligned tensor), in a
//    grid-stride loop of the wrapper's block count.  A bf16 normal has
//    only 128 values (7 bits of a byte), so each block fills a table of
//    the 128 terms round_bf16(coef · z) once, by the very arithmetic of
//    the plain version; an element pays its cipher, a byte, a load from
//    shared memory and the add.  float32 runs erf⁻¹ a value, branching.
// The batch launch is bytes-bound instead: a sample reads S source values
// and writes S scaled ones and the mixture (under noise the mixture once
// more, with a cipher and erf⁻¹), while the keys and draws are a few
// dozen ciphers an example.  It replaces a keys launch, three or four
// sampler launches and about ten PyTorch passes over (B, S, T) with their
// int64 index of the roll.  A block takes a (tile of kBatchTile samples,
// example), not a whole example (32 examples would fill a quarter of the
// SMs), and derives the example's keys itself in warp 0.  Each of a
// thread's samples sits a block apart (coalesced 4-byte accesses: a
// shift aligns no vector), read through __ldg so the loads need not wait
// for the stores.  The tile is a constant, so the bits do not depend on
// the grid, and the noise's mean is summed in a fixed order (no atomics).
// The dropout forward pays the cipher too, so its design strips the rest
// of an element's instructions: a thread owns a mask word, 32 consecutive
// elements of the port's memory, loaded and stored as 16-byte vectors
// (a scalar path for the last word and for an unaligned tensor); it
// finds the word's coordinates once, then steps j by the innermost
// dim's flax stride, adding a precomputed wrap where a coordinate rolls
// over (no division an element), and moves to its next word by adding
// the grid's stride in mixed radix; the keep test compares b >> 9 with
// ceil(keep * 2^23) in integers (u = (b >> 9) * 2^-23 exactly), and the
// 32 tests are the word's bits.  The site's key is one cipher a thread.
// What is left binds on the integer ALU (the SASS, scripts/kernel_sass.py),
// so the cipher's adds go to the FMA pipe as IMADs (ImadAdd).
// The VJP reads 2 bytes (bf16) or 4 of dy, 1/8 of a byte of mask and
// writes dx: bytes-bound, one 16-byte vector a thread an iteration.  They
// and the noise take their block count from the wrapper; the bits do not
// depend on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDims = 4;
constexpr int kWordBits = 32;        // elements a mask word
constexpr uint32_t kSampleVec = 4;   // a sampler thread's values of a long row
constexpr uint32_t kMaxGridY = 65535;
constexpr int kNormals = 128;        // the bf16 normal's values
// Blocks a dropout or noise launch may take: the dropout forward's grid
// stride in elements, blocks * kThreads * kWordBits, stays below 2^32.
constexpr long long kMaxDropoutBlocks = (1LL << 32) / (kThreads * kWordBits) - 1;
enum Kind { kBits = 0, kUniform = 1, kRandint = 2, kNormal = 3 };

// The port tensor's dims (outermost first, 1-padded at the front); for
// each, the stride of that coordinate in the flax tensor's flat index;
// and, for d >= 1, what j gains where coordinate d rolls over to 0 and
// d - 1 steps on: jstride[d - 1] - size[d] * jstride[d] modulo 2^32
// (ops/threefry.py::walk_wraps).
struct Layout {
  uint32_t size[kDims];
  uint32_t jstride[kDims];
  uint32_t wrap[kDims];
};
static_assert(kDims == 4, "coords(), advance() and step() walk four dims");

// The cipher's adds: a + b, as nvcc picks (IADD3 on the integer ALU, or
// IMAD.IADD on the FMA pipe)...
struct Add {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a + b;
  }
};

// ... or always an IMAD by `one`, a 1 that ptxas cannot fold
// (blockDim.x / kThreads), so each issues on the FMA pipe and the integer
// ALU keeps only the rotates and xors: 40 of a cipher's 72 instructions,
// not about 50 (the dropout forward, which that ALU bounds).
struct ImadAdd {
  uint32_t one;
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const {
    uint32_t d;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(b), "r"(one), "r"(a));
    return d;
  }
};

template <typename A = Add>
__device__ __forceinline__ uint2 threefry(uint2 key, uint2 x, A add = A()) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {key.x, key.y, key.x ^ key.y ^ 0x1BD11BDAu};
  x.x += ks[0];
  x.y += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x.x = add(x.x, x.y);
      x.y = __funnelshift_l(x.y, x.y, kRot[i % 2][j]) ^ x.x;
    }
    x.x = add(x.x, ks[(i + 1) % 3]);
    x.y = add(x.y, ks[(i + 2) % 3] + uint32_t(i + 1));
  }
  return x;
}

// fold_in(key, d) and split(key, n)[d] alike: the key hashing (0, d).
__device__ __forceinline__ uint2 child(uint2 key, uint32_t d) {
  return threefry(key, make_uint2(0u, d));
}

template <typename A = Add>
__device__ __forceinline__ uint32_t bits(uint2 key, uint32_t j, A add = A()) {
  const uint2 y = threefry(key, make_uint2(0u, j), add);
  return y.x ^ y.y;
}

__device__ __forceinline__ uint2 load_key(const long long* k) {
  return make_uint2(uint32_t(k[0]), uint32_t(k[1]));
}

__device__ __forceinline__ void store_key(long long* k, uint2 v) {
  k[0] = v.x;
  k[1] = v.y;
}

// jax.random.uniform's float32 arithmetic: [1, 2) from the top 23 bits,
// minus 1, times (hi - lo) plus lo in one rounding, at least lo.
__device__ __forceinline__ float uniform(uint32_t b, float lo, float span) {
  const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fmaf_rn(f, span, lo));
}

// Horner's rule, one rounding a step, the coefficients immediates.
template <int N>
__device__ __forceinline__ float horner(const float (&c)[N], float w) {
  float p = c[0];
#pragma unroll
  for (int i = 1; i < N; ++i) p = __fmaf_rn(p, w, c[i]);
  return p;
}

// XLA's float32 erf⁻¹ (Giles): w = -log1p(-x²); a degree-8 polynomial in
// w - 2.5 (w < 5) or sqrt(w) - 3, times x; ±1 gives ±inf.  A branch, not a
// select a coefficient: the same operations in the same order, so the same
// bits, and |x| < 0.99662 (w < 5) for all but about 0.3 % of uniforms, so
// a warp mostly runs one side.
__device__ __forceinline__ float erf_inv(float x) {
  constexpr float kSmall[9] = {2.81022636e-08f,  3.43273939e-07f,
                               -3.5233877e-06f,  -4.39150654e-06f,
                               0.00021858087f,   -0.00125372503f,
                               -0.00417768164f,  0.246640727f,
                               1.50140941f};
  constexpr float kLarge[9] = {-0.000200214257f, 0.000100950558f,
                               0.00134934322f,   -0.00367342844f,
                               0.00573950773f,   -0.0076224613f,
                               0.00943887047f,   1.00167406f,
                               2.83297682f};
  const float w = -log1pf(__fmul_rn(x, -x));
  float p;
  if (w < 5.0f)
    p = horner(kSmall, __fsub_rn(w, 2.5f));
  else
    p = horner(kLarge, __fsub_rn(__fsqrt_rn(w), 3.0f));
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000)) : __fmul_rn(p, x);
}

// A normal from its uniform on (nextafter(-1, 0), 1): float32(√2)·erf⁻¹(u).
__device__ __forceinline__ float normal_of(float u) {
  return __fmul_rn(__int_as_float(0x3FB504F3), erf_inv(u));
}

// randint's value j less minval, from the bits of split(key)[0] (hk) and
// [1] (lk): ((hi mod span)·mult + lo mod span) mod span in uint32.
template <typename A = Add>
__device__ __forceinline__ uint32_t randint_offset(uint2 hk, uint2 lk, uint32_t j,
                                                  uint32_t span, uint32_t mult,
                                                  A add = A()) {
  const uint32_t h = bits(hk, j, add) % span;
  const uint32_t l = bits(lk, j, add) % span;
  return (h * mult + l) % span;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bf16 noise of a byte's top 7 bits m, round_bf16(coef · z): jax's
// bf16 uniform u = (4 m - 255) / 256 exactly, z = erf⁻¹(u) in float32
// rounded to bf16, times bf16(√2) rounded (its normal), coef = bf16(std).
__device__ __forceinline__ float bf16_noise(uint32_t m, float coef) {
  const float u = __fmul_rn(float(int(m) * 4 - 255), 0.00390625f);
  const float z = round_bf16(__fmul_rn(round_bf16(erf_inv(u)), 1.4140625f));
  return round_bf16(__fmul_rn(coef, z));
}

// A 16-byte vector of 4 float32 or 8 bfloat16 values as floats, and back
// (each bfloat16 rounded to nearest even); p 16-byte aligned.
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    v[2 * h] = __uint_as_float(u[h] << 16);
    v[2 * h + 1] = __uint_as_float(u[h] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint32_t u[4];
#pragma unroll
  for (int h = 0; h < 4; ++h)
    u[h] = uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * h]))) |
           uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * h + 1]))) << 16;
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// A sampler thread's `count` values (at most V) to p: with V = 4, one
// float4 or two 16-byte int64 pairs where all four go and p is aligned;
// else one at a time.
template <uint32_t V>
__device__ __forceinline__ void store_values(float* p, const float* v, uint32_t count) {
  if constexpr (V == 4) {
    if (count == V && aligned16(p)) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
  for (uint32_t i = 0; i < count; ++i) p[i] = v[i];
}
template <uint32_t V>
__device__ __forceinline__ void store_values(long long* p, const long long* v,
                                             uint32_t count) {
  if constexpr (V == 4) {
    if (count == V && aligned16(p)) {
      *reinterpret_cast<longlong2*>(p) = make_longlong2(v[0], v[1]);
      *reinterpret_cast<longlong2*>(p + 2) = make_longlong2(v[2], v[3]);
      return;
    }
  }
  for (uint32_t i = 0; i < count; ++i) p[i] = v[i];
}

// The coordinates of port offset m (the outermost takes what is left, so
// a count past the tensor's end has digits too): divisions, once a thread.
__device__ __forceinline__ void coords(const Layout& lay, uint32_t m, uint32_t* c) {
#pragma unroll
  for (int d = kDims - 1; d > 0; --d) {
    const uint32_t q = m / lay.size[d];
    c[d] = m - q * lay.size[d];
    m = q;
  }
  c[0] = m;
}

__device__ __forceinline__ uint32_t flax_index(const Layout& lay, const uint32_t* c) {
  uint32_t j = 0;
#pragma unroll
  for (int d = 0; d < kDims; ++d) j += c[d] * lay.jstride[d];
  return j;
}

// One element on in the port's order: j steps by the innermost dim's flax
// stride; where that dim rolls over (`left` counts down to it, a branch
// taken once in size[3] elements), its wrap is added and the next dims
// step, each adding its own wrap where it rolls over in turn (the
// outermost is not kept: a word ends before it would matter).
__device__ __forceinline__ void step(const Layout& lay, uint32_t& left, uint32_t& e2,
                                     uint32_t& e1, uint32_t& j) {
  j += lay.jstride[3];
  if (__builtin_expect(--left == 0, 0)) {
    left = lay.size[3];
    j += lay.wrap[3];
    if (++e2 == lay.size[2]) {
      e2 = 0;
      j += lay.wrap[2];
      if (++e1 == lay.size[1]) {
        e1 = 0;
        j += lay.wrap[1];
      }
    }
  }
}

// c += g in mixed radix (g's digits below the sizes, but the outermost).
__device__ __forceinline__ void advance(const Layout& lay, uint32_t* c, const uint32_t* g) {
  uint32_t carry = 0;
#pragma unroll
  for (int d = kDims - 1; d > 0; --d) {
    c[d] += g[d] + carry;
    carry = c[d] >= lay.size[d];
    if (carry) c[d] -= lay.size[d];
  }
  c[0] += g[0] + carry;
}

// Row r's values j0 .. j0 + V - 1 of kind K a thread (V 4 or 1), for r =
// g * rows + local over the thread's row groups g (blockIdx.y, stepping by
// gridDim.y).  A row is `chunks` threads: with fewer than a block's,
// `rows` of them share a block (blockIdx.x 0); else a row spans blocks on
// x (rows 1).
template <int K, uint32_t V>
__global__ void __launch_bounds__(kThreads)
    threefry_sample_kernel(const long long* __restrict__ keys, uint32_t R, uint32_t n,
                           uint32_t chunks, uint32_t rows, uint32_t groups, float lo,
                           float hi, uint32_t span, uint32_t mult, long long minval,
                           void* __restrict__ out) {
  const uint32_t local = threadIdx.x / chunks;      // the one division
  const uint32_t chunk = blockIdx.x * kThreads + threadIdx.x - local * chunks;
  if (local >= rows || chunk >= chunks) return;
  const uint32_t j0 = chunk * V;
  const uint32_t count = min(n - j0, V);
  const auto add = [] {                // ImadAdd where issue binds, else nvcc's adds
    if constexpr (V == 1) return Add();
    else return ImadAdd{blockDim.x / kThreads};
  }();
  const float span_f = __fsub_rn(hi, lo);
  for (uint32_t g = blockIdx.y; g < groups; g += gridDim.y) {
    const uint32_t row = g * rows + local;
    if (row >= R) return;
    const uint2 row_key = load_key(keys + 2 * size_t(row));
    const size_t at = size_t(row) * n + j0;
    // All V values are drawn (a row's tail's extra ones not stored).
    if constexpr (K == kBits || K == kRandint) {
      long long v[V];
      if constexpr (K == kBits) {
#pragma unroll
        for (uint32_t i = 0; i < V; ++i) v[i] = bits(row_key, j0 + i, add);
      } else {
        const uint2 hk = threefry(row_key, make_uint2(0u, 0u), add);   // split[0]
        const uint2 lk = threefry(row_key, make_uint2(0u, 1u), add);   // split[1]
#pragma unroll
        for (uint32_t i = 0; i < V; ++i)
          v[i] = minval + randint_offset(hk, lk, j0 + i, span, mult, add);
      }
      store_values<V>(static_cast<long long*>(out) + at, v, count);
    } else {
      float v[V];
#pragma unroll
      for (uint32_t i = 0; i < V; ++i) {
        v[i] = uniform(bits(row_key, j0 + i, add), lo, span_f);
        if constexpr (K == kNormal) v[i] = normal_of(v[i]);
      }
      store_values<V>(static_cast<float*>(out) + at, v, count);
    }
  }
}

// The step's dropout or noise key k of the 3 + 3 d_steps that
// ops/threefry.py::train_key_rows names, from r = fold_in(key, step):
// rng_g, rng_dl, rng_ga = split(r, 5)[2:5], each folded with the shard;
// k 0 rng_g, 1 + 3 di + j split(fold_in(rng_dl, di), 3)[j], 1 + 3 D + j
// split(rng_ga)[j].
__device__ __forceinline__ uint2 train_key(uint2 r, uint32_t shard, int d_steps, int k) {
  if (k == 0) return child(child(r, 2u), shard);
  if (k <= 3 * d_steps) {
    const uint2 dl = child(child(r, 3u), shard);
    return child(child(dl, uint32_t((k - 1) / 3)), uint32_t((k - 1) % 3));
  }
  return child(child(child(r, 4u), shard), uint32_t(k - 1 - 3 * d_steps));
}

// threefry_batch_launch's arguments (ops/threefry.py::BatchArgs mirrors
// them field for field).
struct BatchArgs {
  const float* src;        // the bank (S, N, T), or the sources (B, S, T)
  const long long* key;    // (2,)
  const long long* step;   // 0-d; null: the key is the one base
  float* scaled;           // (B, S, T)
  float* mixture;          // (B, T)
  long long* picks;        // (B, S) with the bank; null with sources
  long long* shifts;       // (B, S) with the bank
  float* gains;            // (B, S), dB
  float* partial;          // (B, tiles) sums of mixture² under noise, else null
  long long* noise_keys;   // (B, 2) k_noise under noise
  long long* train_keys;   // (3 + 3 d_steps, 2), or null
  long long offset;        // the first example's global index
  uint32_t B, S, N, T, tiles;
  uint32_t pick_mult, shift_mult;   // randint's multipliers for spans N and T
  float gain_lo, gain_hi;           // ∓ gain_jitter_db
  float inv_t, inv_snr;             // float32 1/T and 1/10^(snr/10)
  uint32_t shard;
  int d_steps;                      // 0: no train keys
};

constexpr uint32_t kMaxSources = 8;
constexpr uint32_t kBatchPer = 4;                      // samples a thread a tile
constexpr uint32_t kBatchTile = kThreads * kBatchPer;  // samples a tile

// Example i's noise std: its tiles' sums of mixture² in tile order, times
// 1/T (the mean), times 1/10^(snr/10), square-rooted.
__device__ __forceinline__ float noise_std(const BatchArgs& a, uint32_t i) {
  const float* p = a.partial + size_t(i) * a.tiles;
  float sum = p[0];
  for (uint32_t t = 1; t < a.tiles; ++t) sum = __fadd_rn(sum, p[t]);
  return __fsqrt_rn(__fmul_rn(__fmul_rn(sum, a.inv_t), a.inv_snr));
}

// A block a (tile, example) on (x, y); x steps by gridDim.x over the
// tiles.  Warp 0 derives the example's keys (every lane alike) and lane s
// draws source s's pick, shift and gain; the block then writes its tiles'
// scaled sources and mixture, the rows read at the roll's two segments.
// Under noise each tile's sum of mixture² goes to `partial` in a fixed
// order (a thread's samples in order, the warp by an xor butterfly, the
// warps in order), and threefry_batch_noise_kernel adds the noise.
__global__ void __launch_bounds__(kThreads) threefry_batch_kernel(const BatchArgs a) {
  __shared__ const float* row[kMaxSources];
  __shared__ uint32_t shift[kMaxSources];
  __shared__ float factor[kMaxSources];
  __shared__ float warp_sum[kThreads / 32];
  const uint32_t i = blockIdx.y, S = a.S, T = a.T;
  const uint32_t lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool first = blockIdx.x == 0;
  if (warp == 0) {
    uint2 data = load_key(a.key), mix = data;
    if (a.step != nullptr) {
      const uint2 r = child(data, uint32_t(*a.step));
      data = child(r, 1u);                     // rng_data
      mix = child(r, 0u);                      // rng_mix
    }
    const uint32_t ex = uint32_t(a.offset + i);
    const uint2 em = child(mix, ex);           // split: (k_gain, k_noise)
    if (lane < S) {
      const float g = uniform(bits(child(em, 0u), lane), a.gain_lo,
                              __fsub_rn(a.gain_hi, a.gain_lo));
      // 10^(g / 20), the division as PyTorch's CUDA op takes it: g · f32(1/20)
      factor[lane] = powf(10.0f, __fmul_rn(g, 0.05f));
      uint32_t pick = 0, sh = 0;
      if (a.picks != nullptr) {
        const uint2 ed = child(data, ex);      // split: (k_pick, k_shift)
        const uint2 kp = child(ed, 0u), ks = child(ed, 1u);
        pick = randint_offset(child(kp, 0u), child(kp, 1u), lane, a.N, a.pick_mult);
        sh = randint_offset(child(ks, 0u), child(ks, 1u), lane, T, a.shift_mult);
        row[lane] = a.src + (size_t(lane) * a.N + pick) * T;
      } else {
        row[lane] = a.src + (size_t(i) * S + lane) * T;
      }
      shift[lane] = sh;
      if (first) {
        a.gains[i * S + lane] = g;
        if (a.picks != nullptr) {
          a.picks[i * S + lane] = pick;
          a.shifts[i * S + lane] = sh;
        }
      }
    }
    if (lane == 0 && first && a.partial != nullptr)
      store_key(a.noise_keys + 2 * size_t(i), child(em, 1u));
  } else if (a.train_keys != nullptr && first && i == 0 &&
             int(threadIdx.x) - 32 < 3 + 3 * a.d_steps) {
    const int k = int(threadIdx.x) - 32;
    store_key(a.train_keys + 2 * k,
              train_key(child(load_key(a.key), uint32_t(*a.step)), a.shard, a.d_steps, k));
  }
  __syncthreads();

  for (uint32_t tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    float m[kBatchPer] = {};
    for (uint32_t s = 0; s < S; ++s) {
      const float* src = row[s];
      const uint32_t sh = shift[s];
      const float f = factor[s];
      float* out = a.scaled + (size_t(i) * S + s) * T;
#pragma unroll
      for (uint32_t q = 0; q < kBatchPer; ++q) {
        const uint32_t t = tile * kBatchTile + q * kThreads + threadIdx.x;
        if (t < T) {
          const float v = __fmul_rn(__ldg(src + (t < T - sh ? t + sh : t + sh - T)), f);
          out[t] = v;
          m[q] = s == 0 ? v : __fadd_rn(m[q], v);
        }
      }
    }
    float sq = 0.0f;
    float* mo = a.mixture + size_t(i) * T;
#pragma unroll
    for (uint32_t q = 0; q < kBatchPer; ++q) {
      const uint32_t t = tile * kBatchTile + q * kThreads + threadIdx.x;
      if (t < T) {
        mo[t] = m[q];
        sq = __fadd_rn(sq, __fmul_rn(m[q], m[q]));
      }
    }
    if (a.partial != nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sq = __fadd_rn(sq, __shfl_xor_sync(0xFFFFFFFFu, sq, off));
      if (lane == 0) warp_sum[warp] = sq;
      __syncthreads();
      if (threadIdx.x == 0) {
        float p = warp_sum[0];
        for (int w = 1; w < kThreads / 32; ++w) p = __fadd_rn(p, warp_sum[w]);
        a.partial[size_t(i) * a.tiles + tile] = p;
      }
      __syncthreads();       // the partial seen by the block; warp_sum free again
    }
  }
}

// The noise of threefry_batch_kernel's mixture, on its grid: mixture[t] +
// normal(k_noise, t) · std, each sample by the thread that wrote it there.
__global__ void __launch_bounds__(kThreads) threefry_batch_noise_kernel(const BatchArgs a) {
  const uint32_t i = blockIdx.y;
  const float std = noise_std(a, i);
  const uint2 k = load_key(a.noise_keys + 2 * size_t(i));
  const ImadAdd imad{blockDim.x / kThreads};
  const float lo = __int_as_float(0xBF7FFFFF);          // nextafter(-1, 0)
  const float span = __fsub_rn(1.0f, lo);
  float* m = a.mixture + size_t(i) * a.T;
  for (uint32_t tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
#pragma unroll
    for (uint32_t q = 0; q < kBatchPer; ++q) {
      const uint32_t t = tile * kBatchTile + q * kThreads + threadIdx.x;
      if (t < a.T)
        m[t] = __fadd_rn(m[t], __fmul_rn(normal_of(uniform(bits(k, t, imad), lo, span)), std));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    threefry_dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                            uint32_t* __restrict__ words,
                            const long long* __restrict__ key, uint32_t fold,
                            uint32_t keep_below, float scale, uint32_t n,
                            Layout lay, bool vec) {
  constexpr int kVec = 16 / sizeof(T);              // elements a 16-byte vector
  const uint32_t nwords = (n - 1) / kWordBits + 1;
  const uint32_t stride = gridDim.x * kThreads;
  uint32_t w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= nwords) return;
  const uint2 site = child(load_key(key), fold);
  const ImadAdd imad{blockDim.x / kThreads};
  // b >> 9 < keep_below where b <= keep_below * 2^9 - 1 (2^32 - 1 at most)
  const uint32_t keep_max = (keep_below << 9) - 1u;
  uint32_t c[kDims], g[kDims];
  coords(lay, w * kWordBits, c);                    // this thread's first word
  coords(lay, stride * kWordBits, g);               // the grid's stride
  for (; w < nwords; w += stride, advance(lay, c, g)) {
    const uint32_t m = w * kWordBits;
    uint32_t left = lay.size[3] - c[3], e2 = c[2], e1 = c[1];
    uint32_t j = flax_index(lay, c);
    uint32_t kept = 0;
    if (vec && m + kWordBits <= n) {
      float v[kWordBits];
#pragma unroll
      for (int k = 0; k < kWordBits; k += kVec) load_vec(x + m + k, v + k);
#pragma unroll
      for (int i = 0; i < kWordBits; ++i) {
        const bool keep = bits(site, j, imad) <= keep_max;
        if (keep) kept |= 1u << i;
        v[i] = keep ? __fmul_rn(v[i], scale) : 0.0f;
        step(lay, left, e2, e1, j);
      }
#pragma unroll
      for (int k = 0; k < kWordBits; k += kVec) store_vec(y + m + k, v + k);
    } else {
      for (uint32_t i = 0; i < kWordBits && m + i < n; ++i) {
        const bool keep = bits(site, j, imad) <= keep_max;
        if (keep) kept |= 1u << i;
        y[m + i] = from_float<T>(keep ? __fmul_rn(to_float(x[m + i]), scale) : 0.0f);
        step(lay, left, e2, e1, j);
      }
    }
    words[w] = kept;
  }
}

// dx = bit ? dy * scale : 0, a 16-byte vector of dy a thread an iteration
// (a scalar path for the tail and an unaligned tensor); a vector's bits
// lie in one word.  No cipher: the forward's words are the mask.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_mask_kernel(const T* __restrict__ dy,
                        const uint32_t* __restrict__ words, T* __restrict__ dx,
                        float scale, uint32_t n, bool vec) {
  constexpr uint32_t kVec = 16 / sizeof(T);
  const uint32_t chunks = (n - 1) / kVec + 1;
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t q = blockIdx.x * kThreads + threadIdx.x; q < chunks; q += stride) {
    const uint32_t m = q * kVec;
    const uint32_t kept = words[m / kWordBits] >> (m % kWordBits);
    if (vec && m + kVec <= n) {
      float v[kVec];
      load_vec(dy + m, v);
#pragma unroll
      for (uint32_t i = 0; i < kVec; ++i)
        v[i] = (kept >> i) & 1u ? __fmul_rn(v[i], scale) : 0.0f;
      store_vec(dx + m, v);
    } else {
      for (uint32_t i = 0; i < kVec && m + i < n; ++i)
        dx[m + i] = from_float<T>((kept >> i) & 1u ? __fmul_rn(to_float(dy[m + i]), scale)
                                                  : 0.0f);
    }
  }
}

// x + noise, a 16-byte vector of x a thread an iteration (a scalar path for
// the tail and an unaligned tensor).  bf16: the element's byte picks one of
// the block's 128 noise terms (bf16_noise), added in float32 and rounded
// once to bf16 as the plain version's bf16 add is; float32: coef = float32(
// float32(std) · float32(√2)), one rounding, fmaf(coef, erf⁻¹(u), x).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    threefry_noise_kernel(const T* __restrict__ x, T* __restrict__ y,
                          const long long* __restrict__ key, float coef,
                          uint32_t n, bool vec) {
  constexpr uint32_t kVec = 16 / sizeof(T);
  __shared__ float table[kNormals];
  if constexpr (sizeof(T) == 2) {
    if (threadIdx.x < kNormals) table[threadIdx.x] = bf16_noise(threadIdx.x, coef);
    __syncthreads();
  }
  const uint2 k = load_key(key);
  const ImadAdd imad{blockDim.x / kThreads};
  const float lo = __int_as_float(0xBF7FFFFF);          // nextafter(-1, 0)
  const float span = __fsub_rn(1.0f, lo);
  const auto noisy = [&](float v, uint32_t j) {
    const uint32_t b = bits(k, j, imad);
    if constexpr (sizeof(T) == 2) return __fadd_rn(v, table[(b & 0xFFu) >> 1]);
    else return __fmaf_rn(coef, erf_inv(uniform(b, lo, span)), v);
  };
  const uint32_t chunks = (n - 1) / kVec + 1;
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t q = blockIdx.x * kThreads + threadIdx.x; q < chunks; q += stride) {
    const uint32_t m = q * kVec;
    if (vec && m + kVec <= n) {
      float v[kVec];
      load_vec(x + m, v);
#pragma unroll
      for (uint32_t i = 0; i < kVec; ++i) v[i] = noisy(v[i], m + i);
      store_vec(y + m, v);
    } else {
      for (uint32_t i = 0; i < kVec && m + i < n; ++i)
        y[m + i] = from_float<T>(noisy(to_float(x[m + i]), m + i));
    }
  }
}

}  // namespace

// keys: int64 (R, 2); out: (R, n) int64 (bits, randint) or float32
// (uniform, normal); lo and hi bound a uniform (a normal's are
// nextafter(-1, 0) and 1); span, mult = (2^16 mod span)² mod span (in
// uint32) and minval a randint's.
extern "C" int threefry_sample_launch(const void* keys, int R, int n, int kind,
                                      float lo, float hi, long long span,
                                      long long mult, long long minval,
                                      void* out, void* stream) {
  if (R < 1 || n < 1 || kind < kBits || kind > kNormal ||
      (kind == kRandint && (span < 1 || span > 0xFFFFFFFFLL)))
    return (int)cudaErrorInvalidValue;
  const bool vec = uint32_t(n) >= kSampleVec;      // else a value a thread
  const uint32_t chunks = vec ? (uint32_t(n) - 1) / kSampleVec + 1 : uint32_t(n);
  const uint32_t rows = chunks >= kThreads ? 1 : kThreads / chunks;
  const uint32_t groups = (uint32_t(R) - 1) / rows + 1;
  const dim3 grid(chunks >= kThreads ? (chunks - 1) / kThreads + 1 : 1,
                  groups < kMaxGridY ? groups : kMaxGridY);
  const auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, uint32_t(R), uint32_t(n), chunks, rows, groups, lo, hi,
        uint32_t(span), uint32_t(mult), minval, out);
  };
  const auto of_kind = [&](auto kernel4, auto kernel1) {
    if (vec) go(kernel4);
    else go(kernel1);
  };
  if (kind == kBits)
    of_kind(threefry_sample_kernel<kBits, kSampleVec>, threefry_sample_kernel<kBits, 1>);
  else if (kind == kUniform)
    of_kind(threefry_sample_kernel<kUniform, kSampleVec>, threefry_sample_kernel<kUniform, 1>);
  else if (kind == kRandint)
    of_kind(threefry_sample_kernel<kRandint, kSampleVec>, threefry_sample_kernel<kRandint, 1>);
  else
    of_kind(threefry_sample_kernel<kNormal, kSampleVec>, threefry_sample_kernel<kNormal, 1>);
  return (int)cudaGetLastError();
}

// args: a BatchArgs; blocks: the grid's tiles a row, 1 to args.tiles (its
// rows are the examples).  Under noise a second launch adds the noise.
extern "C" int threefry_batch_launch(const void* args, int blocks, void* stream) {
  const BatchArgs& a = *static_cast<const BatchArgs*>(args);
  const bool noise = a.partial != nullptr;
  if (a.B < 1 || a.B > kMaxGridY || a.S < 1 || a.S > kMaxSources || a.T < 1 ||
      a.T > 0x7FFFFFFFu || a.tiles != (a.T - 1) / kBatchTile + 1 || blocks < 1 ||
      uint32_t(blocks) > a.tiles || a.src == nullptr || a.key == nullptr ||
      a.scaled == nullptr || a.mixture == nullptr || a.gains == nullptr ||
      (a.picks != nullptr && (a.N < 1 || a.shifts == nullptr)) ||
      (noise && a.noise_keys == nullptr) || a.d_steps < 0 || a.d_steps > 64 ||
      (a.train_keys != nullptr) != (a.d_steps > 0) ||
      (a.train_keys != nullptr && a.step == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, a.B);
  threefry_batch_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  if (noise) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    threefry_batch_noise_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// x, y: n elements, float32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous in
// the port's order; words: int32 ceil(n / 32), the keep mask written; key:
// int64 (2,), the site's base key; keep_below: ceil(keep * 2^23), in [1,
// 2^23]; size/jstride/wrap: kDims each (the port's dims, outermost first,
// their flax strides and wraps); blocks: the grid.
extern "C" int threefry_dropout_launch(const void* x, void* y, void* words,
                                       const void* key, long long fold,
                                       long long keep_below, float scale,
                                       long long n, const long long* size,
                                       const long long* jstride,
                                       const long long* wrap, int bf16,
                                       int blocks, void* stream) {
  if (n < 1 || n > 0xFFFFFFFFLL || fold < 0 || fold > 0xFFFFFFFFLL ||
      keep_below < 1 || keep_below > (1LL << 23) || blocks < 1 ||
      blocks > kMaxDropoutBlocks)
    return (int)cudaErrorInvalidValue;
  Layout lay;
  for (int d = 0; d < kDims; ++d) {
    if (size[d] < 1 || size[d] > 0xFFFFFFFFLL || jstride[d] < 0 ||
        jstride[d] > 0xFFFFFFFFLL || wrap[d] < 0 || wrap[d] > 0xFFFFFFFFLL)
      return (int)cudaErrorInvalidValue;
    lay.size[d] = uint32_t(size[d]);
    lay.jstride[d] = uint32_t(jstride[d]);
    lay.wrap[d] = uint32_t(wrap[d]);
  }
  const bool vec = aligned16(x) && aligned16(y);
  if (bf16)
    threefry_dropout_kernel<__nv_bfloat16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, (uint32_t*)words,
        (const long long*)key, uint32_t(fold), uint32_t(keep_below), scale,
        uint32_t(n), lay, vec);
  else
    threefry_dropout_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, (uint32_t*)words, (const long long*)key,
        uint32_t(fold), uint32_t(keep_below), scale, uint32_t(n), lay, vec);
  return (int)cudaGetLastError();
}

// dy, dx: n elements, float32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous;
// words: int32 ceil(n / 32), a dropout forward's keep mask; blocks: the grid.
extern "C" int dropout_mask_launch(const void* dy, const void* words, void* dx,
                                   float scale, long long n, int bf16, int blocks,
                                   void* stream) {
  if (n < 1 || n > 0xFFFFFFFFLL || blocks < 1 || blocks > kMaxDropoutBlocks)
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(dy) && aligned16(dx);
  if (bf16)
    dropout_mask_kernel<__nv_bfloat16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)dy, (const uint32_t*)words, (__nv_bfloat16*)dx, scale,
        uint32_t(n), vec);
  else
    dropout_mask_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)dy, (const uint32_t*)words, (float*)dx, scale, uint32_t(n), vec);
  return (int)cudaGetLastError();
}

// x, y: n elements, float32 or bfloat16, contiguous in the flax layout;
// key: int64 (2,); coef: float32(std) * sqrt2 in float32, or bf16(std);
// blocks: the grid.
extern "C" int threefry_noise_launch(const void* x, void* y, const void* key,
                                     float coef, long long n, int bf16, int blocks,
                                     void* stream) {
  if (n < 1 || n > 0xFFFFFFFFLL || blocks < 1 || blocks > kMaxDropoutBlocks)
    return (int)cudaErrorInvalidValue;
  const bool noise_vec = aligned16(x) && aligned16(y);
  if (bf16)
    threefry_noise_kernel<__nv_bfloat16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, (const long long*)key, coef,
        uint32_t(n), noise_vec);
  else
    threefry_noise_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, (const long long*)key, coef, uint32_t(n), noise_vec);
  return (int)cudaGetLastError();
}
