"""JAX's threefry2x32 random numbers in PyTorch: keys, bits and samplers.

The plain version of `ops/csrc/threefry.cu` (which the CUDA tensors of a
train step take, `ops/threefry.py`), and the CPU path.  It gives the bits
of `jax.random` under the JAX package's settings (`jax_threefry_
partitionable` on, the `threefry2x32` implementation):

  * `prng_key(seed)` is `jax.random.PRNGKey(seed)` (`jax/_src/prng.py`
    `threefry_seed`): the seed's high and low 32-bit words;
  * `fold_in(key, d)` and `split(key, n)[j]` both hash the counter pair
    (0, d) or (0, j) under the key (`_threefry_fold_in`,
    `_threefry_split_foldlike`);
  * `random_bits(key, shape)` hashes (0, i) for each flat index i and
    xors the two output words (`_threefry_random_bits_partitionable`);
  * `uniform`, `randint`, `bernoulli`, `normal` and `truncated_normal`
    (`normals` for many keys at once) follow `jax/_src/random.py` op for
    op in float32 (uniform's mantissa trick, randint's two bit arrays and
    its span arithmetic, bernoulli's float32 uniform below p, √2·erf⁻¹ of
    a uniform); `erf_inv` is XLA's float32 polynomial (M. Giles), not
    `torch.special.erfinv`, so that its rounding follows JAX's;
  * `normal(key, shape, torch.bfloat16)` follows `_uniform`'s rule for a
    dtype of fewer than 8 mantissa bits: 8-bit words, the low byte of
    the two output words xored, so 128 values in all (`bf16_uniform`);
  * `fold_in_static` is flax's `_fold_in_static`: the SHA-1 of a module
    path's names and a counter folded in (how `Module.init` keys each
    parameter and `Scope.make_rng` each dropout site).

A key is an int64 tensor of shape (..., 2) holding two uint32 words, on
the caller's device; a leading batch of keys draws a batch of rows, as
`jax.vmap` over keys does.  uint32 arithmetic runs in int64 with masks.
A key built from a 0-d step tensor is computed on that tensor's device,
so a captured CUDA graph reads the step it finds there.
"""

from __future__ import annotations

import hashlib
import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
Int = Union[int, torch.Tensor]


def threefry2x32(k0: Int, k1: Int, x0: Int, x1: Int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 block cipher, 20 rounds, on uint32 words held in
    int64 (broadcast): `jax._src.prng._threefry2x32_lowering`.  After the
    first key injection every op runs in place on the two words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    x0, x1 = torch.broadcast_tensors(torch.as_tensor(x0), torch.as_tensor(x1))
    x0, x1 = x0.clone(), x1.clone()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            low = x1 >> (32 - r)                       # rotate left by r
            x1.bitwise_left_shift_(r).bitwise_and_(_M32).bitwise_or_(low)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_M32)
    return x0, x1


def _hash(key: torch.Tensor, count: Int) -> torch.Tensor:
    """Keys (..., 2) hashing the counter pair (0, count): (..., 2) keys."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, count)
    return torch.stack([y0, y1], dim=-1)


def prng_key(seed: Int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: a (2,) int64 key, the seed's high and
    low words; a 0-d tensor seed gives a key on its device."""
    if isinstance(seed, torch.Tensor):
        return torch.stack([(seed >> 32) & _M32, seed & _M32]).long()
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: Int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`; an int64 `data` tensor folds its
    values into a broadcast batch of keys."""
    return _hash(key, data & _M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: keys (..., 2) -> (..., num, 2)."""
    j = torch.arange(num, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, j)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits a value as int64 in [0, 2^32): keys (..., 2) ->
    (..., *shape), `jax.random.bits(key, shape, uint32)`."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"random_bits: {n} values exceed one 32-bit counter word")
    lead = key.shape[:-1]
    i = torch.arange(n, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, i)
    return (y0 ^ y1).reshape(*lead, *shape)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def fma32(a: torch.Tensor, b: Union[float, torch.Tensor], c) -> torch.Tensor:
    """float32 a·b + c rounded once, as XLA's CPU code contracts a product
    and a sum (and the kernel's `__fmaf_rn`): the product of two float32 is
    exact in float64, and so is the sum where the operands lie within a few
    powers of two of each other, as uniform's do; where they do not (a
    Horner step of erf⁻¹), rounding twice may move the result by an ulp."""
    return (a.double() * b + c).float()


def uniform_from_bits(bits: torch.Tensor, minval, maxval) -> torch.Tensor:
    """jax.random.uniform's float32 arithmetic on given bits: the top 23
    bits as a mantissa of [1, 2), minus 1, times maxval - minval plus
    minval in one rounding, at least minval.  The bounds are numbers, so a
    CUDA graph can capture the draw."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return fma32(f, float(hi - lo), float(lo)).clamp_min(float(lo))


def uniform(key: torch.Tensor, shape: Sequence[int], minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    return uniform_from_bits(random_bits(key, shape), minval, maxval)


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` for a Python float p: a float32
    uniform on [0, 1) below float32(p), whatever dtype the caller then
    masks (flax's `Dropout`)."""
    return uniform(key, shape) < float(np.float32(p))


def randint_span(minval: int, maxval: int) -> Tuple[int, int]:
    """randint's span (1 where maxval <= minval) and its multiplier, 2^32
    mod span as jax computes it: ((2^16 mod span)² in uint32) mod span."""
    if not -(1 << 31) <= minval <= maxval <= (1 << 31) - 1:
        raise ValueError(f"randint: [{minval}, {maxval}) is not an int32 range")
    span = max(maxval - minval, 1)
    return span, ((((1 << 16) % span) ** 2) & _M32) % span


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, minval: int,
                      maxval: int) -> torch.Tensor:
    """jax.random.randint's int32 arithmetic on its two bit arrays (those
    of split(key)[0] and [1]): ((hi mod span)·mult + lo mod span) mod span
    in uint32, plus minval."""
    span, mult = randint_span(minval, maxval)
    offset = (_mul32(higher % span, mult) + lower % span) & _M32
    return minval + offset % span


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32), as int64."""
    k = split(key)
    return randint_from_bits(random_bits(k[..., 0, :], shape),
                             random_bits(k[..., 1, :], shape), minval, maxval)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x·c mod 2^32 for x, c < 2^32, in 16-bit halves of c (no int64
    overflow)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"):
# the coefficients for w = -log1p(-x²) < 5 and for w >= 5.
ERF_INV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
ERF_INV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Float32 erf⁻¹ as XLA computes it: a degree-8 polynomial (Horner
    steps in one rounding each) in w - 2.5 or sqrt(w) - 3, w = -log1p(-x²),
    times x; ±1 -> ±inf.  log1p is torch's, not XLA's own: the two differ
    in the last bit, so the result is within a few ulp of JAX's."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, ERF_INV_SMALL[0], ERF_INV_LARGE[0])
    for cs, cl in zip(ERF_INV_SMALL[1:], ERF_INV_LARGE[1:]):
        p = fma32(p, w, torch.where(small, cs, cl))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


SQRT2 = float(np.float32(np.sqrt(2.0)))
SQRT2_BF16 = float(torch.tensor(np.sqrt(2.0)).bfloat16())        # 1.4140625
NORMAL_LOW = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))   # > -1


def normal_from_uniform(u: torch.Tensor) -> torch.Tensor:
    return SQRT2 * erf_inv(u)


def bf16_uniform(bits: torch.Tensor) -> torch.Tensor:
    """`_uniform`'s bfloat16 arithmetic on (nextafter(-1, 0), 1), as float32:
    bf16 has 7 mantissa bits, fewer than 8, so jax draws 8-bit words (the
    low byte of the two words xored), takes m = byte >> 1 as the mantissa
    of [1, 2), subtracts 1, scales by bf16(1 - lo) = 2 and adds lo =
    -255/256.  Each of those bf16 ops is exact: u = (4m - 255) / 256."""
    m = (bits & 0xFF) >> 1
    return (4 * m - 255).float() / 256.0


def normal(key: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)` for float32 or bfloat16:
    √2·erf⁻¹ of a uniform on (nextafter(-1, 0), 1) of that dtype; in
    bfloat16 XLA's float32 erf⁻¹ of the bf16 uniform, rounded to bf16,
    times bf16(√2) in bf16."""
    if dtype == torch.bfloat16:
        return erf_inv(bf16_uniform(random_bits(key, shape))).bfloat16() * SQRT2_BF16
    if dtype != torch.float32:
        raise ValueError(f"normal: float32 or bfloat16, not {dtype}")
    return normal_from_uniform(uniform(key, shape, NORMAL_LOW, 1.0))


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.truncated_normal(key, lower, upper, shape)` (float32):
    √2·erf⁻¹ of a uniform on (erf(lower/√2), erf(upper/√2)), clamped into
    the open interval."""
    return normals([(key, shape)], lower, upper)[0]


def normals(draws: Sequence[Tuple[torch.Tensor, Sequence[int]]],
            lower: float = None, upper: float = None) -> List[torch.Tensor]:
    """`normal(key, shape)` for each (key, shape) of `draws` or, with
    bounds, `truncated_normal(key, lower, upper, shape)`, through one erf⁻¹
    over all of them (a model's initial weights: one call, not one a
    tensor)."""
    if not draws:
        return []
    a, b, clamp = NORMAL_LOW, 1.0, None
    if lower is not None:
        lo, hi = _f32(lower), _f32(upper)
        a, b = (torch.erf(v / SQRT2).item() for v in (lo, hi))
        clamp = (torch.nextafter(lo, _f32(math.inf)).item(),
                 torch.nextafter(hi, _f32(-math.inf)).item())
    sizes = [math.prod(shape) for _, shape in draws]
    z = normal_from_uniform(torch.cat([uniform(key, (n,), a, b)
                                       for (key, _), n in zip(draws, sizes)]))
    if clamp is not None:
        z = z.clamp(*clamp)
    return [p.reshape(tuple(shape)) for p, (_, shape) in zip(z.split(sizes), draws)]


def static_hash(data: Sequence[Union[str, int]]) -> int:
    """What flax's `_fold_in_static` folds in: the first 4 bytes
    (big-endian) of the SHA-1 of the strings (UTF-8) and ints (big-endian,
    minimal bytes).  A number of the host, computed from names alone."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def fold_in_static(key: torch.Tensor, data: Sequence[Union[str, int]]) -> torch.Tensor:
    """flax's `_fold_in_static` (`flax/core/scope.py`): `static_hash(data)`
    folded into the key (the key itself for no data)."""
    return fold_in(key, static_hash(data)) if data else key
