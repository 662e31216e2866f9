// jax.random's threefry-2x32 draws for Hopper (sm_90a): the train step's
// per-example keys, and bits, uniforms, randints and normals from a key a
// row.
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
// Every float op is an explicit round-to-nearest intrinsic, so nvcc
// contracts nothing: the scale-and-shift of a uniform and each Horner step
// of erf⁻¹ are one __fmaf_rn each, as XLA's CPU code contracts them (the
// plain version rounds them once too), the rest __fmul_rn / __fadd_rn /
// __fsqrt_rn.  Uniforms, bits and randints are the plain version's bits;
// normals differ from it by log1pf's last bit at most.
//
// What bounds it on this card: integer issue.  A value costs one cipher
// (a randint three: its key's split and its two bit arrays): 20 rounds
// of add, funnel-shift rotate and xor, 5 key injections of one add a
// word (IADD3 folds the round constant in), the key's third word and the
// counter's add, 72 integer instructions, against 4 bytes written (8 for
// int64).  At the stream_v5e8 b32 step's noise, 32 × 32 000 normals,
// that is ~74 M instructions, about 4.4 µs at 64 int32 lanes × 132 SMs ×
// 1.98 GHz, against 1.2 µs for its 4 MB at 3.35 TB/s.
// A simple kernel: one thread a value, keys read from device memory (L1
// serves a row's threads), no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum Kind { kBits = 0, kUniform = 1, kRandint = 2, kNormal = 3 };

__device__ __forceinline__ uint2 threefry(uint2 key, uint2 x) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {key.x, key.y, key.x ^ key.y ^ 0x1BD11BDAu};
  x.x += ks[0];
  x.y += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x.x += x.y;
      x.y = __funnelshift_l(x.y, x.y, kRot[i % 2][j]) ^ x.x;
    }
    x.x += ks[(i + 1) % 3];
    x.y += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
  return x;
}

// fold_in(key, d) and split(key, n)[d] alike: the key hashing (0, d).
__device__ __forceinline__ uint2 child(uint2 key, uint32_t d) {
  return threefry(key, make_uint2(0u, d));
}

__device__ __forceinline__ uint32_t bits(uint2 key, uint32_t j) {
  const uint2 y = child(key, j);
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

// XLA's float32 erf⁻¹ (Giles): w = -log1p(-x²); a degree-8 polynomial in
// w - 2.5 (w < 5) or sqrt(w) - 3, times x; ±1 gives ±inf.
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
  float w = -log1pf(__fmul_rn(x, -x));
  const bool small = w < 5.0f;
  w = small ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = small ? kSmall[0] : kLarge[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, small ? kSmall[i] : kLarge[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000)) : __fmul_rn(p, x);
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

__global__ void __launch_bounds__(kThreads)
    threefry_sample_kernel(const long long* __restrict__ keys, long long total,
                           int n, int kind, float lo, float hi,
                           uint32_t span, uint32_t mult, long long minval,
                           void* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const uint32_t j = uint32_t(idx % n);
  const uint2 key = load_key(keys + 2 * (idx / n));
  if (kind == kRandint) {
    const uint32_t h = bits(child(key, 0u), j) % span;
    const uint32_t l = bits(child(key, 1u), j) % span;
    static_cast<long long*>(out)[idx] = minval + (h * mult + l) % span;
    return;
  }
  const uint32_t b = bits(key, j);
  if (kind == kBits) {
    static_cast<long long*>(out)[idx] = b;
  } else if (kind == kUniform) {
    static_cast<float*>(out)[idx] = uniform(b, lo, __fsub_rn(hi, lo));
  } else {
    const float u = uniform(b, lo, __fsub_rn(hi, lo));
    const float sqrt2 = __int_as_float(0x3FB504F3);   // float32(√2)
    static_cast<float*>(out)[idx] = __fmul_rn(sqrt2, erf_inv(u));
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
  const long long total = (long long)R * n;
  if (R < 1 || n < 1 || kind < kBits || kind > kNormal ||
      (kind == kRandint && (span < 1 || span > 0xFFFFFFFFLL)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (total + kThreads - 1) / kThreads;
  threefry_sample_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const long long*)keys, total, n, kind, lo, hi, uint32_t(span),
      uint32_t(mult), minval, out);
  return (int)cudaGetLastError();
}
