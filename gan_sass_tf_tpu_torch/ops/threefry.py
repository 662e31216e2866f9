"""The threefry launches: a train step's batch, keyed samplers, flax's
dropout and the D's instance noise — the CUDA kernels' wrappers and their
plain PyTorch versions.

Not a port of a TPU kernel: the JAX package draws its bank picks and
shifts, gains, noise and eval mixtures with `jax.random`, which XLA
compiles into its step.  `csrc/threefry.cu` draws the same numbers
(`data/threefry.py` is the plain version, the bits of `jax.random`):

    batch(key, src, b, gain_db, snr_db, offset, step, from_bank, shard,
          d_steps)  ->  Batch(mixture, scaled, train_keys, picks, shifts,
          gains)
        the step's data as the JAX step draws it (gan_sass_tf_tpu/train/
        step.py:212-237, data/device_bank.py:41-57, data/mixer.py:31-51):
        the per-example keys (`example_keys_reference`), with the (S, N, T)
        bank each example's rows picked and rolled (`data.take_rows`), else
        the (b, S, T) sources, scaled by gains in ±gain_db dB and summed
        (`data.mixer.mix`), with snr_db the noise; with d_steps > 0 also
        the step's dropout and noise keys (`train_keys_reference`).  One
        launch, two under noise.
    sample(keys (R, 2), n, kind, lo, hi)  ->  (R, n)
        row r drawn under keys[r]: "bits" (int64 in [0, 2^32)),
        "uniform" (float32 on [lo, hi)), "randint" (int64 in [lo, hi)),
        "normal" (float32).
    dropout(x, key, fold, p, dims)  ->  (y, words)
        flax's `nn.Dropout(p)` at train time under the `dropout` rng
        `key`, at the site whose `make_rng` folds `fold` (`models/
        dropout.py`): y = select(bernoulli(fold_in(key, fold), 1 - p, flax
        shape), x * scale, 0); `dims` lists x's dims in the flax tensor's
        order, whose flat index keys each element.  `words` is the keep
        mask packed (`pack_mask`), which the backward reads.
    dropout_mask(dy, words, scale)  ->  dy's shape and dtype
        the dropout's VJP, select(mask, dy * scale, 0), the mask read from
        the forward's words, not drawn again; its own VJP is itself.
    noise(x, key, std)  ->  x + std * normal(key, x.shape, x.dtype), x in
        the flax layout; the gradient passes as it is.

In float32 a dropout multiplies by float32(1 / keep) and the noise adds
fmaf(std·√2, erf⁻¹(u), x): that is what XLA compiles the reference's
`x / keep` and `x + std * normal` into (a division by a constant becomes a
product, the constants fold, the add contracts).  In bfloat16 every op
rounds to bf16, as XLA's CPU code does, with keep and std rounded to bf16
first (jnp rounds a Python scalar to the array's dtype).

`ops.dispatch` takes the kernel for CUDA tensors and the plain version for
CPU tensors.  Nothing here reads a number on the host from the device: a
step's keys are drawn inside its captured graph.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gan_sass_tf_tpu_torch.data import threefry as tf

KINDS = {"bits": 0, "uniform": 1, "randint": 2, "normal": 3}

sample_launches = 0    # kernel launches since the last reset (chip_smoke reads them)
batch_launches = 0           # threefry_batch_kernel
batch_noise_launches = 0     # threefry_batch_noise_kernel
dropout_launches = 0         # forward calls
dropout_bwd_launches = 0     # backward calls (the mask kernel: no draw)
noise_launches = 0
DROPOUT_DIMS = 4             # the kernel's most dims
DTYPES = (torch.float32, torch.bfloat16)
WORD_BITS = 32               # elements a mask word
THREADS = 256                # the kernels' block (csrc/threefry.cu kThreads)
BLOCKS_PER_SM = 16           # their default grid: at most this many blocks an SM
BATCH_TILE = THREADS * 4     # the batch kernel's samples a tile (kBatchTile)
MAX_SOURCES = 8              # its most sources (kMaxSources)


def _launch(name: str, device: torch.device, *args) -> None:
    """`<name>_launch(*args, stream)` of the library on `device`'s current
    stream, with `device` the thread's current one (a kernel goes to the
    current device, which need not be the tensors'), its return code
    checked."""
    from gan_sass_tf_tpu_torch.ops import build

    with torch.cuda.device(device):
        rc = getattr(build.load_library(), f"{name}_launch")(
            *args, torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(rc, name)


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
    """Per-example keys (bases, 2, b, 2) int64 for examples offset + [0,
    b): with the train step's `step`, r = fold_in(key, step) and the
    bases (rng_data, rng_mix) = split(r, 5)[1], [0] (bases 2), else the key
    (bases 1); [base][j] holds split(fold_in(base, offset + i))[j]."""
    _check_key(key, "example_keys")
    if step is not None:
        r = tf.split(tf.fold_in(key, step), 5)
        bases = torch.stack([r[1], r[0]])          # rng_data, rng_mix
    else:
        bases = key[None]
    ids = offset + torch.arange(b, device=key.device)
    return tf.split(tf.fold_in(bases[:, None], ids), 2).transpose(1, 2)


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
    _launch("threefry_sample", keys.device, keys.data_ptr(), r, n, KINDS[kind],
            float(lo), float(hi), span, mult, minval, out.data_ptr())
    sample_launches += 1
    return out


def train_key_rows(d_steps: int):
    """(rng_g's row, [per D step (dropout, noise, R1 dropout) rows],
    (adversarial dropout, noise) rows) of `train_keys_reference` and of a
    batch's train keys."""
    return (0, [tuple(1 + 3 * di + j for j in range(3)) for di in range(d_steps)],
            (1 + 3 * d_steps, 2 + 3 * d_steps))


def _check_step(key: torch.Tensor, step: torch.Tensor, shard: int, d_steps: int,
                what: str) -> None:
    _check_key(key, what)
    if key.shape != (2,) or step.dim() != 0 or step.dtype != torch.int64 \
            or step.device != key.device:
        raise ValueError(f"{what}: a (2,) key and a 0-d int64 step on its device, "
                         f"got {tuple(key.shape)} and {step.dtype} "
                         f"{tuple(step.shape)} on {step.device}")
    if not (0 <= shard < 1 << 32 and 1 <= d_steps <= 64):
        raise ValueError(f"{what}: shard {shard}, d_steps {d_steps}")


def train_keys_reference(key: torch.Tensor, step: torch.Tensor, shard: int,
                        d_steps: int) -> torch.Tensor:
    """The step's dropout and instance-noise keys as the JAX step derives
    them (gan_sass_tf_tpu/train/step.py:213-228, :317, :178, :372), the
    shard folded in: (3 + 3 d_steps, 2) int64, rows as `train_key_rows`
    names them."""
    _check_step(key, step, shard, d_steps, "train_keys")
    r = tf.split(tf.fold_in(key, step), 5)
    g, dl, ga = (tf.fold_in(r[j], shard) for j in (2, 3, 4))
    per_d = tf.split(tf.fold_in(dl, torch.arange(d_steps, device=key.device)), 3)
    return torch.cat([g[None], per_d.reshape(-1, 2), tf.split(ga, 2)])


class Batch(NamedTuple):
    """A step's batch: the mixture (B, T) and the gain-scaled sources (B, S,
    T), the step's dropout and noise keys (None unless asked for), and the
    draws: the bank picks and shifts (B, S) int64 (None for given
    sources) and the gains (B, S) in dB."""

    mixture: torch.Tensor
    scaled: torch.Tensor
    train_keys: Optional[torch.Tensor]
    picks: Optional[torch.Tensor]
    shifts: Optional[torch.Tensor]
    gains: torch.Tensor


class BatchArgs(ctypes.Structure):
    """`threefry_batch_launch`'s arguments: csrc/threefry.cu's BatchArgs,
    field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "src", "key", "step", "scaled", "mixture", "picks", "shifts", "gains",
        "partial", "noise_keys", "train_keys")]
        + [("offset", ctypes.c_longlong)]
        + [(n, ctypes.c_uint32) for n in (
            "B", "S", "N", "T", "tiles", "pick_mult", "shift_mult")]
        + [(n, ctypes.c_float) for n in ("gain_lo", "gain_hi", "inv_t", "inv_snr")]
        + [("shard", ctypes.c_uint32), ("d_steps", ctypes.c_int)])


def batch_tiles(t: int) -> int:
    """The batch kernel's tiles of a T-sample row, its default grid's x."""
    return -(-t // BATCH_TILE)


def _check_batch(key, src, b, step, from_bank, shard, d_steps) -> Tuple[int, int, int, int]:
    """(B, S, N, T) of a batch call, N the bank's utterances (0 for given
    sources); ValueError on what neither version takes."""
    _check_key(key, "batch")
    if key.shape != (2,) or src.dim() != 3 or src.dtype != torch.float32:
        raise ValueError(f"batch: a (2,) key and float32 sources or bank of 3 dims, got "
                         f"{tuple(key.shape)} and {src.dtype} {tuple(src.shape)}")
    if step is not None and (step.dim() != 0 or step.dtype != torch.int64):
        raise ValueError(f"batch: the step must be a 0-d int64 tensor, got "
                         f"{step.dtype} {tuple(step.shape)}")
    if d_steps and step is None:
        raise ValueError("batch: the train keys need the step")
    if not (0 <= shard < 1 << 32 and 0 <= d_steps <= 64):
        raise ValueError(f"batch: shard {shard}, d_steps {d_steps}")
    if from_bank:
        s, nb, t = src.shape
    else:
        b, (_, s, t), nb = src.shape[0], src.shape, 0
    if b < 1:
        raise ValueError(f"batch: {b} examples")
    return b, s, nb, t


def batch_reference(key: torch.Tensor, src: torch.Tensor, b: int, gain_db: float,
                    snr_db: Optional[float] = None, offset: int = 0,
                    step: Optional[torch.Tensor] = None, from_bank: bool = False,
                    shard: int = 0, d_steps: int = 0) -> Batch:
    from gan_sass_tf_tpu_torch.data.device_bank import take_rows
    from gan_sass_tf_tpu_torch.data.mixer import mix

    b, s, nb, t = _check_batch(key, src, b, step, from_bank, shard, d_steps)
    keys = example_keys_reference(key, offset, b, step)
    data_keys, mix_keys = keys[0], keys[-1]       # without a step one base
    picks = shifts = None
    sources = src
    if from_bank:
        picks = sample_reference(data_keys[0], s, "randint", 0, nb)
        shifts = sample_reference(data_keys[1], s, "randint", 0, t)
        sources = take_rows(src, picks, shifts)
    gains = sample_reference(mix_keys[0], s, "uniform", -gain_db, gain_db)
    noise = None if snr_db is None else sample_reference(mix_keys[1], t, "normal")
    mixture, scaled = mix(sources, gains, noise, snr_db)
    train_keys = train_keys_reference(key, step, shard, d_steps) if d_steps else None
    return Batch(mixture, scaled, train_keys, picks, shifts, gains)


def batch_kernel(key: torch.Tensor, src: torch.Tensor, b: int, gain_db: float,
                 snr_db: Optional[float] = None, offset: int = 0,
                 step: Optional[torch.Tensor] = None, from_bank: bool = False,
                 shard: int = 0, d_steps: int = 0,
                 blocks: Optional[int] = None) -> Batch:
    """`threefry_batch_launch`: one launch of threefry_batch_kernel on a
    grid of `blocks` (default `batch_tiles(T)`) by B blocks, and under
    noise one of threefry_batch_noise_kernel on the same grid; the same
    bits whatever `blocks`."""
    global batch_launches, batch_noise_launches
    b, s, nb, t = _check_batch(key, src, b, step, from_bank, shard, d_steps)
    dev = src.device
    if not (src.is_cuda and key.device == dev and (step is None or step.device == dev)):
        raise ValueError(f"batch kernel: CUDA sources or bank with the key and the step "
                         f"on their device, got {dev}, {key.device} and "
                         f"{None if step is None else step.device}")
    tiles = batch_tiles(t)
    blocks = tiles if blocks is None else blocks
    if not (b <= 65535 and s <= MAX_SOURCES and t < 1 << 31 and 0 <= offset
            and offset + b <= 1 << 32 and 1 <= blocks <= tiles):
        raise ValueError(f"batch kernel: {b} examples of {s} x {t} at offset {offset}, "
                         f"{blocks} blocks of {tiles} tiles")
    src, key = src.contiguous(), key.contiguous()
    f32, i64 = {"dtype": torch.float32, "device": dev}, {"dtype": torch.int64, "device": dev}
    out = Batch(torch.empty((b, t), **f32), torch.empty((b, s, t), **f32),
                torch.empty((3 + 3 * d_steps, 2), **i64) if d_steps else None,
                torch.empty((b, s), **i64) if from_bank else None,
                torch.empty((b, s), **i64) if from_bank else None,
                torch.empty((b, s), **f32))
    noise = snr_db is not None
    partial = torch.empty((b, tiles), **f32) if noise else None
    noise_keys = torch.empty((b, 2), **i64) if noise else None

    def ptr(x):
        return None if x is None else x.data_ptr()
    args = BatchArgs(
        ptr(src), ptr(key), ptr(step), ptr(out.scaled), ptr(out.mixture), ptr(out.picks),
        ptr(out.shifts), ptr(out.gains), ptr(partial), ptr(noise_keys),
        ptr(out.train_keys), offset, b, s, nb, t, tiles,
        tf.randint_span(0, nb)[1] if from_bank else 0, tf.randint_span(0, t)[1],
        float(np.float32(-gain_db)), float(np.float32(gain_db)),
        float(np.float32(1.0) / np.float32(t)),
        float(np.float32(1.0) / np.float32(10.0 ** (snr_db / 10.0))) if noise else 0.0,
        shard, d_steps)
    _launch("threefry_batch", dev, ctypes.addressof(args), blocks)
    batch_launches += 1
    batch_noise_launches += int(noise)
    return out


def dropout_constants(dtype: torch.dtype, p: float) -> Tuple[float, float]:
    """(keep, scale): the float32 bound bernoulli draws below, 1 - p, and
    float32(1 / keep rounded to `dtype`), the factor of a kept value."""
    if dtype not in DTYPES or not 0.0 < p < 1.0:
        raise ValueError(f"dropout: float32 or bfloat16 and 0 < p < 1, got {dtype}, {p}")
    keep_x = np.float32(torch.tensor(1.0 - p, dtype=dtype).item())
    return float(np.float32(1.0 - p)), float(np.float32(1.0) / keep_x)


def keep_below(keep: float) -> int:
    """The kernel's integer keep test: bernoulli's uniform is (b >> 9)·2^-23
    exactly, so u < keep where b >> 9 < ceil(keep·2^23) (float64 holds the
    float32 keep times 2^23 exactly)."""
    return math.ceil(keep * 2.0 ** 23)


def flax_layout(shape: Sequence[int], dims: Sequence[int]) -> Tuple[list, list]:
    """The kernel's view of a contiguous port tensor of `shape` whose dims,
    in the flax tensor's order, are `dims`: its sizes and, for each, its
    coordinate's stride in the flax flat index, 1-padded at the front to
    DROPOUT_DIMS."""
    if sorted(dims) != list(range(len(shape))) or len(shape) > DROPOUT_DIMS:
        raise ValueError(f"dropout: dims {tuple(dims)} for a tensor of shape "
                         f"{tuple(shape)} (at most {DROPOUT_DIMS} dims)")
    jstride, acc = [0] * len(shape), 1
    for d in reversed(dims):
        jstride[d], acc = acc, acc * shape[d]
    pad = DROPOUT_DIMS - len(shape)
    return [1] * pad + list(shape), [0] * pad + jstride


def walk_wraps(size: Sequence[int], jstride: Sequence[int]) -> list:
    """What the flax index gains, modulo 2^32, where the forward kernel's
    walk rolls coordinate d over to 0 and steps d - 1 on:
    jstride[d - 1] - size[d]·jstride[d] (0 for the outermost)."""
    return [0] + [(jstride[d - 1] - size[d] * jstride[d]) & 0xFFFFFFFF
                  for d in range(1, len(size))]


def mask_words(n: int) -> int:
    return -(-n // WORD_BITS)


def pack_mask(kept: torch.Tensor) -> torch.Tensor:
    """A bool tensor's elements, in row-major order, packed into int32 words:
    element m is bit m % 32 of word m // 32; the last word's bits past the
    end are 0."""
    flat = kept.reshape(-1).to(torch.int64)
    flat = torch.nn.functional.pad(flat, (0, mask_words(flat.numel()) * WORD_BITS
                                          - flat.numel()))
    shifts = torch.arange(WORD_BITS, device=kept.device)
    words = (flat.view(-1, WORD_BITS) << shifts).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_mask(words: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """pack_mask's inverse: the bool tensor of `shape`."""
    n = math.prod(shape)
    shifts = torch.arange(WORD_BITS, device=words.device)
    bits = (words.to(torch.int64)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n].view(*shape).bool()


def _check_words(t: torch.Tensor, words: torch.Tensor, what: str) -> None:
    if words.dtype != torch.int32 or words.shape != (mask_words(t.numel()),) \
            or words.device != t.device:
        raise ValueError(f"{what}: int32 ({mask_words(t.numel())},) words on "
                         f"{t.device}, got {words.dtype} {tuple(words.shape)} on "
                         f"{words.device}")


def dropout_blocks(units: int, device: torch.device) -> int:
    """The dropout and noise kernels' default grid for `units` (mask words
    in the dropout forward, 16-byte vectors in its backward and the
    noise), a thread each: at most BLOCKS_PER_SM blocks an SM, each thread
    then walking several."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-units // THREADS), BLOCKS_PER_SM * sms))


def dropout_reference(x: torch.Tensor, key: torch.Tensor, fold: int, p: float,
                      dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_key(key, "dropout")
    keep, scale = dropout_constants(x.dtype, p)
    flax_layout(x.shape, dims)
    kept = tf.bernoulli(tf.fold_in(key, fold), 1.0 - p, [x.shape[d] for d in dims])
    kept = kept.permute(*np.argsort(dims).tolist())
    return torch.where(kept, (x.float() * scale).to(x.dtype), 0.0), pack_mask(kept)


def dropout_kernel(x: torch.Tensor, key: torch.Tensor, fold: int, p: float,
                   dims: Sequence[int], blocks: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of `threefry_dropout_launch`: (y, words), the same bits
    whatever `blocks` (default `dropout_blocks`)."""
    global dropout_launches
    _check_key(key, "dropout kernel")
    keep, scale = dropout_constants(x.dtype, p)
    size, jstride = flax_layout(x.shape, dims)
    if not (x.is_cuda and key.device == x.device and key.shape == (2,)):
        raise ValueError(f"dropout kernel: a CUDA tensor and a (2,) key on its "
                         f"device, got {x.device} and {tuple(key.shape)} on {key.device}")
    if not (1 <= x.numel() < 1 << 32 and 0 <= fold < 1 << 32):
        raise ValueError(f"dropout kernel: {x.numel()} elements, fold {fold}")
    x, key = x.contiguous(), key.contiguous()
    y = torch.empty_like(x)
    words = torch.empty(mask_words(x.numel()), dtype=torch.int32, device=x.device)
    arr = ctypes.c_longlong * DROPOUT_DIMS
    _launch("threefry_dropout", x.device, x.data_ptr(), y.data_ptr(), words.data_ptr(),
            key.data_ptr(), fold, keep_below(keep), scale, x.numel(), arr(*size),
            arr(*jstride), arr(*walk_wraps(size, jstride)),
            int(x.dtype == torch.bfloat16),
            blocks or dropout_blocks(words.numel(), x.device))
    dropout_launches += 1
    return y, words


def dropout_mask_reference(dy: torch.Tensor, words: torch.Tensor,
                           scale: float) -> torch.Tensor:
    _check_words(dy, words, "dropout_mask")
    kept = unpack_mask(words, dy.shape)
    return torch.where(kept, (dy.float() * scale).to(dy.dtype), 0.0)


def dropout_mask_kernel(dy: torch.Tensor, words: torch.Tensor, scale: float,
                        blocks: Optional[int] = None) -> torch.Tensor:
    """One launch of `dropout_mask_launch` (counted as a dropout backward):
    the same bits whatever `blocks` (default `dropout_blocks`)."""
    global dropout_bwd_launches
    _check_words(dy, words, "dropout_mask kernel")
    if not (dy.is_cuda and dy.dtype in DTYPES and 1 <= dy.numel() < 1 << 32):
        raise ValueError(f"dropout_mask kernel: a float32 or bfloat16 CUDA tensor, "
                         f"got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    dy = dy.contiguous()
    dx = torch.empty_like(dy)
    _launch("dropout_mask", dy.device, dy.data_ptr(), words.data_ptr(), dx.data_ptr(),
            scale, dy.numel(), int(dy.dtype == torch.bfloat16),
            blocks or dropout_blocks(-(-(dy.numel() * dy.element_size()) // 16),
                                    dy.device))
    dropout_bwd_launches += 1
    return dx


class Dropout(torch.autograd.Function):
    """dropout(x) -> (y, words) with y's gradient select(mask, dy * scale,
    0) read from the words (`DropoutMask`), which are saved in place of the
    key; the words have no gradient."""

    @staticmethod
    def forward(ctx, x, key, fold, p, dims, kernel):
        fn = dropout_kernel if kernel else dropout_reference
        y, words = fn(x, key, fold, p, dims)
        ctx.mark_non_differentiable(words)
        ctx.save_for_backward(words)
        ctx.args = (dropout_constants(x.dtype, p)[1], kernel)
        return y, words

    @staticmethod
    def backward(ctx, dy, _):
        (words,) = ctx.saved_tensors
        return DropoutMask.apply(dy, words, *ctx.args), None, None, None, None, None


class DropoutMask(torch.autograd.Function):
    """select(mask, dy * scale, 0) from packed words; linear in dy, so its
    gradient is the same again (R1's double backward)."""

    @staticmethod
    def forward(ctx, dy, words, scale, kernel):
        ctx.save_for_backward(words)
        ctx.args = (scale, kernel)
        if kernel:
            return dropout_mask_kernel(dy, words, scale)
        return dropout_mask_reference(dy, words, scale)

    @staticmethod
    def backward(ctx, g):
        (words,) = ctx.saved_tensors
        return DropoutMask.apply(g, words, *ctx.args), None, None, None


def noise_coef(dtype: torch.dtype, std: float) -> float:
    """The noise's factor: float32(std)·float32(√2) rounded once (float32,
    XLA's folded constant), or bf16(std) (bfloat16)."""
    if dtype == torch.float32:
        return float(np.float32(std) * np.float32(tf.SQRT2))
    if dtype == torch.bfloat16:
        return torch.tensor(std, dtype=torch.bfloat16).item()
    raise ValueError(f"noise: float32 or bfloat16, not {dtype}")


def noise_reference(x: torch.Tensor, key: torch.Tensor, std: float) -> torch.Tensor:
    _check_key(key, "noise")
    coef = noise_coef(x.dtype, std)
    if x.dtype == torch.float32:
        e = tf.erf_inv(tf.uniform(key, x.shape, tf.NORMAL_LOW, 1.0))
        return tf.fma32(e, coef, x)
    return x + tf.normal(key, x.shape, torch.bfloat16) * coef


def noise_kernel(x: torch.Tensor, key: torch.Tensor, std: float,
                 blocks: Optional[int] = None) -> torch.Tensor:
    """One launch of `threefry_noise_launch`: the same bits whatever
    `blocks` (default `dropout_blocks` of x's 16-byte vectors)."""
    global noise_launches
    _check_key(key, "noise kernel")
    coef = noise_coef(x.dtype, std)
    if not (x.is_cuda and key.device == x.device and key.shape == (2,)):
        raise ValueError(f"noise kernel: a CUDA tensor and a (2,) key on its "
                         f"device, got {x.device} and {tuple(key.shape)} on {key.device}")
    if not 1 <= x.numel() < 1 << 32:
        raise ValueError(f"noise kernel: {x.numel()} elements")
    x, key = x.contiguous(), key.contiguous()
    y = torch.empty_like(x)
    _launch("threefry_noise", x.device, x.data_ptr(), y.data_ptr(), key.data_ptr(), coef,
            x.numel(), int(x.dtype == torch.bfloat16),
            blocks or dropout_blocks(-(-(x.numel() * x.element_size()) // 16), x.device))
    noise_launches += 1
    return y


class Noise(torch.autograd.Function):
    """noise(x) with the identity gradient: the noise is a constant."""

    @staticmethod
    def forward(ctx, x, key, std, kernel):
        return noise_kernel(x, key, std) if kernel else noise_reference(x, key, std)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None, None
