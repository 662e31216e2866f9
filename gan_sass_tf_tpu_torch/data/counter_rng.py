"""Counter-based random numbers, computed on the tensor's device.

Each draw is a pure function of (seed, step, global example index, stream,
element index): an integer hash (Wellons' "lowbias32") of those counters.
So the numbers an example gets do not depend on how a batch is split
across devices, which is the contract of the JAX package's per-global-
example `fold_in` (`gan_sass_tf_tpu/data/mixer.py:31-32`), and nothing
carries state from one call to the next.  The bits differ from JAX's
threefry streams: tests that compare the two inject the random numbers.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x·c mod 2^32 for x < 2^32, in two 16-bit halves so that no int64
    product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """lowbias32 integer hash on values < 2^32 (Python ints or int64 tensors)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_bits(seed: int, step: int, ids: torch.Tensor, stream: int,
                 n: int) -> torch.Tensor:
    """(len(ids), n) int64 hashes in [0, 2^32) for examples `ids` (int64,
    global indices) at (seed, step), one independent column per element."""
    key = _mix32(_mix32(_mix32(seed & _M32) ^ (step & _M32)) ^ (stream & _M32))
    per_example = _mix32((ids.long() & _M32) ^ key)
    j = torch.arange(n, device=ids.device, dtype=torch.int64)
    return _mix32(_mix32(per_example[:, None] ^ _mix32(j + 0x9E3779B9 & _M32)) ^ key)


def counter_uniform(seed: int, step: int, ids: torch.Tensor, stream: int,
                    n: int) -> torch.Tensor:
    """(len(ids), n) float32 uniforms in [0, 1), 24 random bits each."""
    bits = counter_bits(seed, step, ids, stream, n)
    return (bits >> 8).float() * (1.0 / (1 << 24))


def counter_normal(seed: int, step: int, ids: torch.Tensor, stream: int,
                   n: int) -> torch.Tensor:
    """(len(ids), n) float32 standard normals (Box-Muller on two uniform
    streams, `stream` and `stream + 1`)."""
    u1 = 1.0 - counter_uniform(seed, step, ids, stream, n)       # (0, 1]
    u2 = counter_uniform(seed, step, ids, stream + 1, n)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
