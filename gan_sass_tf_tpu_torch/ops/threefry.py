"""The threefry launches: per-example keys and keyed samplers — the CUDA
kernels' wrappers and their plain PyTorch versions.

Not a port of a TPU kernel: the JAX package draws its bank picks and
shifts, gains, noise and eval mixtures with `jax.random`, which XLA
compiles into its step.  `csrc/threefry.cu` draws the same numbers in two
kinds of launch (`data/threefry.py` is the plain version, the bits of
`jax.random`):

    example_keys(key, offset, b, step)  ->  (bases, 2, b, 2) int64
        with a step (a 0-d int64 tensor, the train step's number):
        r = fold_in(key, step); for (rng_data, rng_mix) = split(r, 5)[1],
        [0] and each example i, split(fold_in(base, offset + i), 2), i.e.
        (k_pick, k_shift) and (k_gain, k_noise) (bases 2); without, the
        key is the one base (bases 1).  [base][j] is the (b, 2) array of
        the examples' j-th keys.
    sample(keys (R, 2), n, kind, lo, hi)  ->  (R, n)
        row r drawn under keys[r]: "bits" (int64 in [0, 2^32)),
        "uniform" (float32 on [lo, hi)), "randint" (int64 in [lo, hi)),
        "normal" (float32).

`ops.dispatch.example_keys` / `draw` take the kernel for CUDA tensors and
the plain version for CPU tensors.  Nothing here reads a number on the
host from the device: a step's keys are drawn inside its captured graph.
"""

from __future__ import annotations

from typing import Optional

import torch

from gan_sass_tf_tpu_torch.data import threefry as tf

KINDS = {"bits": 0, "uniform": 1, "randint": 2, "normal": 3}

keys_launches = 0      # kernel launches since the last reset (chip_smoke reads them)
sample_launches = 0


def _check_key(key: torch.Tensor, what: str) -> None:
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise ValueError(f"{what}: keys must be int64 (..., 2), got "
                         f"{key.dtype} {tuple(key.shape)}")


def _bounds(kind: str, lo, hi):
    if kind not in KINDS:
        raise ValueError(f"unknown draw {kind!r}; have {sorted(KINDS)}")
    if kind == "normal":
        return tf.NORMAL_LOW, 1.0
    return lo, hi


def example_keys_reference(key: torch.Tensor, offset: int, b: int,
                           step: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check_key(key, "example_keys")
    if step is not None:
        r = tf.split(tf.fold_in(key, step), 5)
        bases = torch.stack([r[1], r[0]])          # rng_data, rng_mix
    else:
        bases = key[None]
    ids = offset + torch.arange(b, device=key.device)
    return tf.split(tf.fold_in(bases[:, None], ids), 2).transpose(1, 2)


def example_keys_kernel(key: torch.Tensor, offset: int, b: int,
                        step: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of `threefry_keys_launch`."""
    global keys_launches
    from gan_sass_tf_tpu_torch.ops import build

    _check_key(key, "example_keys")
    if not key.is_cuda or key.shape != (2,):
        raise ValueError(f"example_keys kernel: a (2,) CUDA key, got "
                         f"{tuple(key.shape)} on {key.device}")
    if step is not None and (step.device != key.device or step.dtype != torch.int64
                             or step.dim() != 0):
        raise ValueError("example_keys kernel: the step must be a 0-d int64 "
                         "tensor on the key's device")
    if not 1 <= b < 1 << 31:
        raise ValueError(f"example_keys kernel: {b} examples")
    key = key.contiguous()
    out = torch.empty((1 if step is None else 2, 2, b, 2), dtype=torch.int64,
                      device=key.device)
    rc = build.load_library().threefry_keys_launch(
        key.data_ptr(), None if step is None else step.data_ptr(), offset, b,
        out.data_ptr(), torch.cuda.current_stream(key.device).cuda_stream)
    build.check_launch(rc, "threefry_keys")
    keys_launches += 1
    return out


def sample_reference(keys: torch.Tensor, n: int, kind: str, lo=0.0,
                     hi=1.0) -> torch.Tensor:
    _check_key(keys, "sample")
    lo, hi = _bounds(kind, lo, hi)
    if kind == "bits":
        return tf.random_bits(keys, (n,))
    if kind == "randint":
        return tf.randint(keys, (n,), int(lo), int(hi))
    u = tf.uniform(keys, (n,), lo, hi)
    return u if kind == "uniform" else tf.normal_from_uniform(u)


def sample_kernel(keys: torch.Tensor, n: int, kind: str, lo=0.0,
                  hi=1.0) -> torch.Tensor:
    """One launch of `threefry_sample_launch`: (R, 2) keys -> (R, n)."""
    global sample_launches
    from gan_sass_tf_tpu_torch.ops import build

    _check_key(keys, "sample")
    lo, hi = _bounds(kind, lo, hi)
    if not keys.is_cuda or keys.dim() != 2:
        raise ValueError(f"sample kernel: (R, 2) CUDA keys, got "
                         f"{tuple(keys.shape)} on {keys.device}")
    r = keys.shape[0]
    if not (1 <= r and 1 <= n and r * n < 1 << 40 and n < 1 << 31):
        raise ValueError(f"sample kernel: {r} rows of {n}")
    span = mult = minval = 0
    if kind == "randint":
        minval = int(lo)
        span, mult = tf.randint_span(minval, int(hi))
    dtype = torch.float32 if kind in ("uniform", "normal") else torch.int64
    out = torch.empty((r, n), dtype=dtype, device=keys.device)
    keys = keys.contiguous()
    rc = build.load_library().threefry_sample_launch(
        keys.data_ptr(), r, n, KINDS[kind], float(lo), float(hi), span, mult,
        minval, out.data_ptr(), torch.cuda.current_stream(keys.device).cuda_stream)
    build.check_launch(rc, "threefry_sample")
    sample_launches += 1
    return out
