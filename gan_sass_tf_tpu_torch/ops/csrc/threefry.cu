// jax.random's threefry-2x32 draws for Hopper (sm_90a): the train step's
// per-example keys, and bits, uniforms, randints and normals from a key a
// row; the step's dropout and instance-noise keys, flax's dropout and the
// D's instance noise, fused.
//
// Replaces no TPU kernel.  The JAX package draws its bank picks and
// shifts (gan_sass_tf_tpu/data/device_bank.py:49-53), its gains and noise
// (data/mixer.py:31-51) and its eval and bound mixtures through
// jax.random, which XLA compiles into the step; these two launches give the
// same numbers from the same keys inside the port's captured step, where
// the plain version (data/threefry.py: 20 rounds of int64 elementwise ops
// on masked words) takes over a hundred launches a draw.
//
//  - threefry_keys_launch: from a key (and, for a train step, the step
//    number on the device) the per-example keys, one thread an example.
//    With a step: r = fold_in(key, step), (rng_mix, rng_data) = split(r,
//    5)[0:2] (gan_sass_tf_tpu/train/step.py:213-214); then for each base
//    b in (rng_data, rng_mix) and example i, split(fold_in(b, offset + i))
//    = (k_pick, k_shift) or (k_gain, k_noise).  Without a step the one
//    base is the key itself (mix_sources / sample_bank under a given key).
//    Out: int64 (bases, 2, B, 2): [b][j][i] = split(...)[j] of example i,
//    so each key array is contiguous; each word < 2^32.
//  - threefry_sample_launch: R rows of n values, row r under keys[r], the
//    value j from the counter pair (0, j) (jax's partitionable bits: the
//    two output words xored).  kind 0 bits (int64), 1 uniform (float32 on
//    [lo, hi)), 2 randint (int64 in [minval, minval + span), from the bits
//    of split(key)[0] and [1]), 3 normal (float32, √2·erf⁻¹ of a uniform
//    on (nextafter(-1, 0), 1), XLA's float32 polynomial).
//
//  - threefry_train_keys_launch: the step's dropout and noise keys, one
//    thread a key, as the JAX step derives them
//    (gan_sass_tf_tpu/train/step.py:213-228, :317, :178, :372): r =
//    fold_in(key, step); rng_g, rng_dl, rng_ga = split(r, 5)[2:5], each
//    folded with the shard index; out[0] = rng_g; out[1 + 3 di + j] =
//    split(fold_in(rng_dl, di), 3)[j] (D dropout, noise, R1 dropout); out[1
//    + 3 D + j] = split(rng_ga)[j] (the adversarial call's dropout, noise).
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

__global__ void __launch_bounds__(kThreads)
    threefry_keys_kernel(const long long* __restrict__ key,
                         const long long* __restrict__ step, long long offset,
                         int B, long long* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  uint2 base[2] = {load_key(key), load_key(key)};
  int bases = 1;
  if (step != nullptr) {
    const uint2 r = child(base[0], uint32_t(*step));
    base[0] = child(r, 1u);   // rng_data
    base[1] = child(r, 0u);   // rng_mix
    bases = 2;
  }
  for (int b = 0; b < bases; ++b) {
    const uint2 e = child(base[b], uint32_t(offset + i));
    store_key(out + (size_t(2 * b) * B + i) * 2, child(e, 0u));
    store_key(out + (size_t(2 * b + 1) * B + i) * 2, child(e, 1u));
  }
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
        for (uint32_t i = 0; i < V; ++i) {
          const uint32_t h = bits(hk, j0 + i, add) % span;
          const uint32_t l = bits(lk, j0 + i, add) % span;
          v[i] = minval + (h * mult + l) % span;
        }
      }
      store_values<V>(static_cast<long long*>(out) + at, v, count);
    } else {
      float v[V];
#pragma unroll
      for (uint32_t i = 0; i < V; ++i) {
        v[i] = uniform(bits(row_key, j0 + i, add), lo, span_f);
        if constexpr (K == kNormal)
          v[i] = __fmul_rn(__int_as_float(0x3FB504F3), erf_inv(v[i]));   // float32(√2)
      }
      store_values<V>(static_cast<float*>(out) + at, v, count);
    }
  }
}

__global__ void threefry_train_keys_kernel(const long long* __restrict__ key,
                                          const long long* __restrict__ step,
                                          uint32_t shard, int d_steps,
                                          long long* __restrict__ out) {
  const int i = threadIdx.x;
  if (i >= 3 + 3 * d_steps) return;
  const uint2 r = child(load_key(key), uint32_t(*step));
  uint2 k;
  if (i == 0) {
    k = child(child(r, 2u), shard);                       // rng_g
  } else if (i <= 3 * d_steps) {                          // rng_dl's
    const uint2 dl = child(child(r, 3u), shard);
    k = child(child(dl, uint32_t((i - 1) / 3)), uint32_t((i - 1) % 3));
  } else {                                                // rng_ga's
    k = child(child(child(r, 4u), shard), uint32_t(i - 1 - 3 * d_steps));
  }
  store_key(out + 2 * i, k);
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

// key: int64 (2,); step: int64 0-d or null; out: int64 (bases, 2, B, 2),
// bases 2 with a step (rng_data's keys, then rng_mix's), else 1.
extern "C" int threefry_keys_launch(const void* key, const void* step,
                                    long long offset, int B, void* out,
                                    void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  threefry_keys_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const long long*)key, (const long long*)step, offset, B,
      (long long*)out);
  return (int)cudaGetLastError();
}

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

// key: int64 (2,); step: int64 0-d; out: int64 (3 + 3 d_steps, 2): rng_g,
// then (D dropout, noise, R1 dropout) per D step, then the adversarial
// call's (dropout, noise); the shard folded in, as the JAX step does.
extern "C" int threefry_train_keys_launch(const void* key, const void* step,
                                         long long shard, int d_steps,
                                         void* out, void* stream) {
  if (d_steps < 1 || d_steps > 64 || shard < 0 || shard > 0xFFFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  threefry_train_keys_kernel<<<1, 3 + 3 * d_steps, 0, (cudaStream_t)stream>>>(
      (const long long*)key, (const long long*)step, uint32_t(shard), d_steps,
      (long long*)out);
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
