"""Spectrogram features: log-magnitude and log-mel.

`mel_filterbank` and `mel_interp_matrix` are numpy copies of the builders in
`gan_sass_tf_tpu/dsp/features.py` (bit-equal, asserted by the tests); the
feature functions are PyTorch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _hertz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_filterbank(
    num_mel_bins: int,
    num_spectrogram_bins: int,
    sample_rate: float,
    lower_edge_hertz: float = 20.0,
    upper_edge_hertz: Optional[float] = None,
    dtype=np.float32,
) -> np.ndarray:
    """(num_spectrogram_bins, num_mel_bins) triangular mel weight matrix,
    numerically matching tf.signal.linear_to_mel_weight_matrix."""
    if upper_edge_hertz is None:
        upper_edge_hertz = sample_rate / 2.0
    nyquist = sample_rate / 2.0
    # tf.signal excludes the DC bin from the triangle computation.
    linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[1:]
    spec_mel = _hertz_to_mel(linear_freqs)[:, None]
    edges = np.linspace(
        _hertz_to_mel(lower_edge_hertz),
        _hertz_to_mel(upper_edge_hertz),
        num_mel_bins + 2,
    )
    lower, center, upper = edges[:-2][None, :], edges[1:-1][None, :], edges[2:][None, :]
    lower_slope = (spec_mel - lower) / (center - lower)
    upper_slope = (upper - spec_mel) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    return np.pad(weights, [[1, 0], [0, 0]]).astype(dtype)


def mel_interp_matrix(
    num_mel_bins: int,
    num_spectrogram_bins: int,
    sample_rate: float,
    lower_edge_hertz: float = 20.0,
    upper_edge_hertz: Optional[float] = None,
    dtype=np.float32,
) -> np.ndarray:
    """(num_spectrogram_bins, num_mel_bins) fixed 2-tap linear-interpolation
    matrix resampling mel-grid features onto the linear STFT-bin grid: bin k
    reads the fractional mel-center index of its own center frequency.  Rows
    sum to 1; bins outside the first/last mel center clamp to the edge."""
    if upper_edge_hertz is None:
        upper_edge_hertz = sample_rate / 2.0
    nyquist = sample_rate / 2.0
    linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)
    edges = np.linspace(
        _hertz_to_mel(lower_edge_hertz),
        _hertz_to_mel(upper_edge_hertz),
        num_mel_bins + 2,
    )
    centers = edges[1:-1]
    pos = np.interp(_hertz_to_mel(linear_freqs), centers,
                    np.arange(num_mel_bins, dtype=np.float64))
    lo = np.clip(np.floor(pos).astype(np.int64), 0, num_mel_bins - 1)
    hi = np.minimum(lo + 1, num_mel_bins - 1)
    frac = pos - lo
    w = np.zeros((num_spectrogram_bins, num_mel_bins), np.float64)
    rows = np.arange(num_spectrogram_bins)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, hi), frac)
    return w.astype(dtype)


def logmag(spec: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """log(|STFT| + eps) on complex spectra, (..., F, K) -> same shape f32."""
    return torch.log(spec.abs() + eps).float()


def logmel(spec: torch.Tensor, mel_matrix: torch.Tensor,
           eps: float = 1e-8) -> torch.Tensor:
    """log(|X| @ M + eps), (..., F, K) complex -> (..., F, n_mels) f32."""
    return torch.log(spec.abs().float() @ mel_matrix + eps)


def spec_features(spec: torch.Tensor, dsp_cfg) -> torch.Tensor:
    """Generator input features per DSPConfig.feature ('logmag' | 'logmel')."""
    if dsp_cfg.feature == "logmag":
        return logmag(spec, dsp_cfg.eps)
    if dsp_cfg.feature == "logmel":
        m = torch.from_numpy(
            mel_filterbank(dsp_cfg.n_mels, dsp_cfg.n_bins, dsp_cfg.sample_rate)
        ).to(spec.device)
        return logmel(spec, m, dsp_cfg.eps)
    raise ValueError(f"unknown feature {dsp_cfg.feature!r}")
