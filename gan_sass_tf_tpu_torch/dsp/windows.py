"""Analysis/synthesis windows and COLA normalization (host-side numpy).

A copy of `gan_sass_tf_tpu/dsp/windows.py`: that package's `dsp/__init__.py`
imports JAX, so the builders cannot be imported from there.  The tests
assert bit-equality with the originals.

tf.signal conventions: periodic windows (denominator N, not N-1), which
satisfy constant-overlap-add for hop = N / 2^k.
"""

from __future__ import annotations

import numpy as np


def get_window(name: str, win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic window of length `win_length`.

    A name of the form "<base>@<support>" (e.g. "hann@400") builds the base
    window over `support` samples and end-pads with zeros to `win_length` —
    the tf.signal `frame_length < fft_length` convention, encoded in the
    name so every window argument carries it without signature changes."""
    support = win_length
    if "@" in name:
        name, s = name.split("@", 1)
        support = int(s)
        if not 0 < support <= win_length:
            raise ValueError(
                f"window support {support} must be in (0, {win_length}]"
            )
    n = np.arange(support, dtype=np.float64)
    if name == "hann":
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / support)
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / support)
    elif name in ("rect", "boxcar", "ones"):
        w = np.ones(support, dtype=np.float64)
    else:
        raise ValueError(f"unknown window {name!r}")
    if support < win_length:
        w = np.concatenate([w, np.zeros(win_length - support)])
    return w.astype(dtype)


def encode_win_length(window: str, n_fft: int, win_length=None):
    """Canonical win_length < n_fft encoding: returns the support-encoded
    window name ("hann@400") and the end-padding that keeps tf.signal's
    frame count (1 + (T - win_length)//hop) when applied to the signal."""
    if win_length is None or win_length == n_fft:
        return window, 0
    if win_length > n_fft:
        raise ValueError(
            f"win_length {win_length} > n_fft {n_fft}: tf.signal zero-pads "
            "the frame to the FFT size, so win_length must be <= n_fft"
        )
    return f"{window}@{win_length}", n_fft - win_length


def safe_inv_env(env: np.ndarray, rel_floor: float = 1e-2) -> np.ndarray:
    """1/env with the envelope clamped to rel_floor·max(env).

    At the signal edges the overlap-added squared-window envelope → 0;
    dividing by it would amplify roundoff into huge outliers.  Clamping
    attenuates those samples toward zero instead, exact everywhere the
    envelope is healthy."""
    env = np.asarray(env, np.float64)
    floor = rel_floor * env.max()
    return (1.0 / np.maximum(env, floor)).astype(np.float32)


def cola_norm(window: np.ndarray, hop: int, n_frames: int) -> np.ndarray:
    """Overlap-added squared-window envelope, length
    (n_frames - 1) * hop + len(window): at each output sample, the sum of
    w²[k] over all frames covering it."""
    win_length = len(window)
    out_len = (n_frames - 1) * hop + win_length
    env = np.zeros(out_len, dtype=np.float64)
    w2 = window.astype(np.float64) ** 2
    for f in range(n_frames):
        env[f * hop : f * hop + win_length] += w2
    return env.astype(window.dtype)
