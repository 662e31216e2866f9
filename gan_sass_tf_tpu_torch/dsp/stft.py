"""Framing, STFT, iSTFT, overlap-add in plain PyTorch.

Port of `gan_sass_tf_tpu/dsp/stft.py`.  This path is the numerical
reference for the CUDA kernels in `gan_sass_tf_tpu_torch.ops` and the path
CPU tensors take.  Conventions match tf.signal: periodic Hann, no
centering, n_frames = 1 + (T - n_fft)//hop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from gan_sass_tf_tpu_torch.dsp.windows import (
    cola_norm,
    encode_win_length,
    get_window,
    safe_inv_env,
)


def num_frames(n_samples: int, n_fft: int, hop: int) -> int:
    if n_samples < n_fft:
        raise ValueError(f"signal ({n_samples}) shorter than n_fft ({n_fft})")
    return 1 + (n_samples - n_fft) // hop


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., F, n_fft) overlapping frames, tf.signal.frame
    convention (trailing samples beyond the frame grid dropped).  A strided
    view: no copy."""
    num_frames(x.shape[-1], n_fft, hop)
    return x.unfold(-1, n_fft, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., F, N) -> (..., (F-1)*hop + N) overlap-add (tf.signal.overlap_add
    semantics)."""
    *batch, f, n = frames.shape
    out_len = (f - 1) * hop + n
    flat = frames.reshape(-1, f, n).transpose(1, 2)          # (B', N, F)
    y = F.fold(flat, output_size=(1, out_len), kernel_size=(1, n),
               stride=(1, hop))
    return y.reshape(*batch, out_len)


def stft(x: torch.Tensor, n_fft: int, hop: int, window: str = "hann",
         win_length: Optional[int] = None) -> torch.Tensor:
    """(..., T) float -> (..., F, n_fft//2 + 1) complex64 STFT, matching
    tf.signal.stft.  win_length < n_fft: the window is end-padded to n_fft
    and the signal end-padded by n_fft - win_length, which keeps the tf
    frame count 1 + (T - win_length)//hop."""
    window, pad = encode_win_length(window, n_fft, win_length)
    x = x.float()
    if pad:
        x = F.pad(x, (0, pad))
    w = torch.from_numpy(get_window(window, n_fft)).to(x.device)
    frames = frame_signal(x, n_fft, hop) * w
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def irfft(spec: torch.Tensor, n_fft: int) -> torch.Tensor:
    """(..., n_fft//2 + 1) complex -> (..., n_fft) float32 inverse real DFT
    as irfft is defined (numpy, JAX, pocketfft on the CPU): the imaginary
    parts of the DC and Nyquist bins are dropped.  They are dropped here
    before the transform, because cuFFT's C2R transform reads them at some
    batch shapes (seen on an H100 at 16 x 255 frames of 1025 bins, not at
    6 x 12), where a complex mask or a generator's estimate makes them
    non-zero."""
    keep = torch.ones(spec.shape[-1], dtype=spec.real.dtype, device=spec.device)
    keep[0] = 0
    if spec.shape[-1] == n_fft // 2 + 1 and n_fft % 2 == 0:
        keep[-1] = 0
    spec = torch.complex(spec.real, spec.imag * keep)
    return torch.fft.irfft(spec, n=n_fft, dim=-1).float()


def istft(
    spec: torch.Tensor,
    n_fft: int,
    hop: int,
    window: str = "hann",
    length: Optional[int] = None,
    norm: str = "global",
    win_length: Optional[int] = None,
) -> torch.Tensor:
    """(..., F, n_bins) complex -> (..., T) float32 inverse STFT.

    norm="global": overlap-add of windowed frames divided by the clamped
      overlap-added squared-window envelope (`safe_inv_env`).
    norm="tf": per-frame synthesis window w / Σ_k w²[n+k·hop], matching
      tf.signal.inverse_stft with inverse_stft_window_fn.
    """
    f = spec.shape[-2]
    window, pad = encode_win_length(window, n_fft, win_length)
    if pad and length is None:
        length = (f - 1) * hop + win_length
    w = get_window(window, n_fft)
    frames_t = irfft(spec, n_fft)
    dev = spec.device
    if norm == "tf":
        d = np.zeros(hop, dtype=np.float64)
        w64 = w.astype(np.float64)
        for j in range(n_fft // hop):
            d += w64[j * hop : (j + 1) * hop] ** 2
        d_full = np.tile(d, n_fft // hop)
        w_syn = (w64 / np.where(d_full <= 1e-30, 1.0, d_full)).astype(np.float32)
        y = overlap_add(frames_t * torch.from_numpy(w_syn).to(dev), hop)
    elif norm == "global":
        inv_env = torch.from_numpy(safe_inv_env(cola_norm(w, hop, f))).to(dev)
        y = overlap_add(frames_t * torch.from_numpy(w).to(dev), hop) * inv_env
    else:
        raise ValueError(f"unknown istft norm {norm!r}")
    if length is not None:
        y = y[..., :length]
    return y
