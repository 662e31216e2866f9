"""Wav file I/O: "mixture wav in, separated source wavs out".

A copy of `gan_sass_tf_tpu/utils/wav_io.py`: that package's
`utils/__init__.py` imports its JAX profiler."""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.io import wavfile


def read_wav(path: str) -> Tuple[int, np.ndarray]:
    """-> (sample_rate, float32 mono waveform in [-1, 1])."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return int(sr), data


def write_wav(path: str, sample_rate: int, wav: np.ndarray) -> None:
    """float waveform -> 16-bit PCM wav (clipped to [-1, 1])."""
    wav = np.asarray(wav, np.float32)
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    wavfile.write(path, sample_rate, pcm)
