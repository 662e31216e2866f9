"""What each hand-written kernel moves and computes, from its shapes, and the
card's peaks that bound it.

One place for the reckoning that `chip_smoke.py`'s `kernels` line, the
timing scripts (`scripts/time_analysis.py`, `scripts/time_synthesis.py`)
and the bytes ledger (`scripts/bytes_ledger.py`) read.  A kernel's cost is
its inputs read once and its outputs written once, and the operations its
algorithm needs: an FFT of n points 2.5·n·log2(n) f32 flops, a log-mel
band sum 2·K·M a frame, a mask product 2 flops a (source, bin) for a
magnitude mask and 6 for a complex one, and a threefry2x32 cipher
`CIPHER_INT_OPS` 32-bit integer instructions.  Its bound is the larger of
its bytes over the card's memory rate and its operations over the peak
rate of their type.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

# The H100 SXM's published peaks (NVIDIA's data sheet, dense rates): HBM3
# bytes/s, f32 flops/s outside the tensor cores, and the tensor cores' bf16
# and TF32 rates.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12
TF32_TC_FLOPS_PER_S = 495e12
# threefry2x32 hashing a counter (0, j): 20 rounds x (IADD, SHF rotate,
# LOP xor); 5 key injections x 2 (IADD3 folds the round constant into the
# second word's add); the key's third word (one LOP3) and the counter's
# add to the second key word (the first word's add is a move from 0).
CIPHER_INT_OPS = 20 * 3 + 5 * 2 + 1 + 1
# Of those, only the 20 rotates (SHF) and 20 xors (LOP3) need the integer
# ALU; an add can issue as IMAD.IADD on the FMA pipe (nvcc's SASS of the
# dropout kernel puts about two thirds of them there, scripts/kernel_sass.py).
CIPHER_ALU_OPS = 20 + 20
# 32-bit integer issue: an H100 SXM SM issues 128 lanes a clock, its integer
# ALU 64 of them (NVIDIA's Hopper white paper; 132 SMs at 1.98 GHz).  A
# cipher's ALU share binds: 40 of its 72 instructions at 64 lanes, i.e. its
# 72 at 64 x 72 / 40 lanes an SM a clock.
INT32_OPS_PER_S = 132 * 64 * 1.98e9 * CIPHER_INT_OPS / CIPHER_ALU_OPS
# Bytes a value of each of the sampler's kinds is written in.
SAMPLE_BYTES = {"bits": 8, "uniform": 4, "randint": 8, "normal": 4}
# Ciphers a value of each kind costs (a randint two: one for each of its
# bit arrays), and a row (a randint's key's two splits): the least the
# function needs, whatever csrc/threefry.cu repeats a thread.
SAMPLE_CIPHERS = {"bits": 1, "uniform": 1, "randint": 2, "normal": 1}
SAMPLE_ROW_CIPHERS = {"bits": 0, "uniform": 0, "randint": 2, "normal": 0}


@dataclasses.dataclass(frozen=True)
class Cost:
    """Bytes moved, f32 flops and 32-bit integer instructions."""

    bytes: float = 0.0
    flops: float = 0.0
    int_ops: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.bytes + other.bytes, self.flops + other.flops,
                    self.int_ops + other.int_ops)

    def bound(self) -> Tuple[float, str]:
        """(ms, "bytes" or "operations"): the least time the card could take
        to move the bytes and do the operations."""
        t_bytes = self.bytes / HBM_BYTES_PER_S
        t_ops = self.flops / F32_FLOPS_PER_S + self.int_ops / INT32_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def frames(t: int, n_fft: int, hop: int) -> int:
    """Frames of a T-sample signal, tf.signal's count 1 + (T - n_fft)//hop."""
    return 1 + (t - n_fft) // hop


def fft_flops(n_frames: int, n_fft: int) -> float:
    return n_frames * 2.5 * n_fft * math.log2(n_fft)


def stft_features(rows: int, t: int, n_fft: int, hop: int,
                  emit: Sequence[str] = ("spec",), n_mels: int = 0) -> Cost:
    """K1 (`csrc/stft_features.cu`) on `rows` signals of t samples emitting
    `emit`: the input read once, each output written once, the mel matrix
    read; an FFT a frame, plus the band sums for log-mel."""
    f, k = frames(t, n_fft, hop), n_fft // 2 + 1
    width = {"spec": 8 * k, "mag": 4 * k, "logmag": 4 * k, "logmel": 4 * n_mels}
    nbytes = 4 * rows * t + rows * f * sum(width[e] for e in emit)
    flops = fft_flops(rows * f, n_fft)
    if "logmel" in emit:
        nbytes += 4 * k * n_mels
        flops += 2 * rows * f * k * n_mels
    return Cost(nbytes, flops)


def stft(rows: int, t: int, n_fft: int, hop: int) -> Cost:
    """K4 (`stft_launch`): K1's spectrum alone."""
    return stft_features(rows, t, n_fft, hop, ("spec",))


def masked_istft(b: int, s: int, f: int, n_fft: int, hop: int,
                 mask_type: str = "magnitude") -> Cost:
    """K2 (`csrc/masked_istft.cu`): a (b, F, K) complex64 spectrum and
    (b, S, F, K[, 2]) f32 masks read once, b·S signals of (F-1)·hop + n_fft
    f32 samples written once; an inverse FFT a (signal, frame) and the
    mask product."""
    k = n_fft // 2 + 1
    mask = b * s * f * k
    per = 8 if mask_type == "complex" else 4
    out = 4 * b * s * ((f - 1) * hop + n_fft)
    return Cost(8 * b * f * k + per * mask + out,
                fft_flops(b * s * f, n_fft) + (6 if mask_type == "complex" else 2) * mask)


def istft(rows: int, f: int, n_fft: int, hop: int) -> Cost:
    """K3 (the spectrum-only `istft_launch`): K2 with one source and no
    mask."""
    k = n_fft // 2 + 1
    return Cost(8 * rows * f * k + 4 * rows * ((f - 1) * hop + n_fft),
                fft_flops(rows * f, n_fft))


def istft_adjoint(rows: int, f: int, n_fft: int, hop: int) -> Cost:
    """K3's backward (`istft_adjoint_kernel`): the cotangent of (F-1)·hop +
    n_fft samples read once, the interleaved (F, K, 2) gradient written
    once, an FFT a frame: a spec-only STFT's bytes and flops."""
    return stft(rows, (f - 1) * hop + n_fft, n_fft, hop)


def batch(b: int, s: int, t: int, tiles: int, from_bank: bool, step: bool,
          noise: bool, d_steps: int = 0) -> Cost:
    """`threefry_batch_kernel` on rows of `tiles` tiles: the source rows
    read once (the bank's picked rows or the given sources), the scaled
    sources, the mixture and the draws written once (picks and shifts int64
    with the bank, gains f32; under noise each tile's sum of mixture² and
    the noise keys); ciphers:
    with the step its fold and two splits, then an example's fold under
    rng_mix and its gain key (2; the noise key a third under noise), with
    the bank its fold under rng_data, the pick and shift keys and their
    randints' two splits each (7), and a source's gain (1) and pick and
    shift (2 + 2); the train keys about five a key."""
    per_example = 2 + int(noise) + (7 if from_bank else 0)
    per_source = 1 + (4 if from_bank else 0)
    ciphers = 3 * int(step) + b * (per_example + s * per_source) \
        + (5 * (3 + 3 * d_steps) if d_steps else 0)
    draws = b * s * (4 + (16 if from_bank else 0))
    nbytes = (4 * 2 * b * s * t + 4 * b * t + draws + 16 + 8 * int(step)
              + (4 * b * tiles + 16 * b if noise else 0)
              + 16 * (3 + 3 * d_steps) * int(d_steps > 0))
    return Cost(nbytes, int_ops=CIPHER_INT_OPS * ciphers)


def batch_noise(b: int, t: int, tiles: int) -> Cost:
    """`threefry_batch_noise_kernel`: the mixture read and written once, the
    `tiles` sums of each row and the noise keys read; a cipher a sample."""
    return Cost(8 * b * t + 4 * b * tiles + 16 * b,
                int_ops=CIPHER_INT_OPS * b * t)


def sample(rows: int, n: int, kind: str) -> Cost:
    """`threefry_sample_kernel`: `rows` keys read, rows·n values of `kind`
    written, a cipher a value (a randint two a value and two a row)."""
    ciphers = SAMPLE_CIPHERS[kind] * n + SAMPLE_ROW_CIPHERS[kind]
    return Cost(16 * rows + SAMPLE_BYTES[kind] * rows * n,
                int_ops=CIPHER_INT_OPS * ciphers * rows)


def mask_bytes(numel: int) -> int:
    """A dropout's packed keep mask: a bit an element in 32-bit words."""
    return 4 * -(-numel // 32)


def dropout(numel: int, itemsize: int) -> Cost:
    """`threefry_dropout_kernel`: x read, y and the packed keep mask written
    once, the key read, a cipher an element."""
    return Cost(2 * numel * itemsize + mask_bytes(numel) + 16,
                int_ops=CIPHER_INT_OPS * numel)


def dropout_mask(numel: int, itemsize: int) -> Cost:
    """`dropout_mask_kernel`, the dropout's VJP: dy and the mask read, dx
    written once; no cipher."""
    return Cost(2 * numel * itemsize + mask_bytes(numel))


def noise(numel: int, itemsize: int) -> Cost:
    """`threefry_noise_kernel`: x read and x + noise written, a cipher an
    element."""
    return Cost(2 * numel * itemsize + 16, int_ops=CIPHER_INT_OPS * numel)
