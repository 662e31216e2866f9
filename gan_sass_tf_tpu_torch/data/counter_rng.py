"""Counter-based random numbers, computed on the tensor's device: the
train step's dropout keep-masks and D instance noise (the step's data
draws are the JAX package's threefry streams, `data/threefry.py`).

Each draw is a pure function of (seed, step, global example index, stream,
element index): an integer hash (Wellons' "lowbias32") of those counters.
A draw takes the (seed, step) pair hashed once, `step_key(seed, step)`,
which a train step computes once and hands to each of its draws, so a
draw hashes only its stream on top.  The seed and the step are Python ints
or 0-d int64 tensors on the ids' device: the same int64 arithmetic gives
the same bits either way, and a key built from tensors is read by the
device when it is computed, so a captured CUDA graph that replays the step
hashes the step it finds there (`train/graphed.py`).
So the numbers an example gets do not depend on how a batch is split
across devices, which is the contract of the JAX package's per-global-
example `fold_in` (`gan_sass_tf_tpu/data/mixer.py:31-32`), and nothing
carries state from one call to the next.  The bits differ from JAX's
threefry streams (the JAX step folds the shard index into its dropout and
noise keys instead), and no test compares the two.
"""

from __future__ import annotations

import math
from typing import Union

import torch

_M32 = 0xFFFFFFFF
Counter = Union[int, torch.Tensor]      # a Python int or a 0-d int64 tensor


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


def step_key(seed: Counter, step: Counter) -> Counter:
    """The (seed, step) part of every draw's key, hashed once: an int for
    int counters, else a 0-d int64 tensor on their device."""
    return _mix32(_mix32(seed & _M32) ^ (step & _M32))


def counter_bits(key: Counter, ids: torch.Tensor, stream: int,
                 n: int) -> torch.Tensor:
    """(len(ids), n) int64 hashes in [0, 2^32) for examples `ids` (int64,
    global indices) under `key` (`step_key`), one independent column per
    element."""
    key = _mix32(key ^ (stream & _M32))
    per_example = _mix32((ids.long() & _M32) ^ key)
    j = torch.arange(n, device=ids.device, dtype=torch.int64)
    return _mix32(_mix32(per_example[:, None] ^ _mix32(j + 0x9E3779B9 & _M32)) ^ key)


def counter_uniform(key: Counter, ids: torch.Tensor, stream: int,
                    n: int) -> torch.Tensor:
    """(len(ids), n) float32 uniforms in [0, 1), 24 random bits each."""
    bits = counter_bits(key, ids, stream, n)
    return (bits >> 8).float() * (1.0 / (1 << 24))


def counter_normal(key: Counter, ids: torch.Tensor, stream: int,
                   n: int) -> torch.Tensor:
    """(len(ids), n) float32 standard normals (Box-Muller on two uniform
    streams, `stream` and `stream + 1`)."""
    u1 = 1.0 - counter_uniform(key, ids, stream, n)       # (0, 1]
    u2 = counter_uniform(key, ids, stream + 1, n)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
