"""On-device mixing: per-source gain jitter, the sum, optional noise.

Port of `gan_sass_tf_tpu/data/mixer.py::mix_sources`, with its draws: for
global example i, (k_gain, k_noise) = split(fold_in(key, i)), gains
`jax.random.uniform(k_gain, (S, 1), -g, g)` in dB and noise
`jax.random.normal(k_noise, (T,))` (threefry, `ops.dispatch.step_batch`),
so a data-parallel split of the batch draws the same numbers.
`mix` takes the draws as arguments: the plain version's mixing, and tests
inject the JAX package's draws through it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gan_sass_tf_tpu_torch.ops import dispatch


def mix(sources: torch.Tensor, gains_db: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        snr_db: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, T) sources, (B, S) gains in dB and (B, T) standard normals,
    added at snr_db (`noise_snr`; None adds no noise) -> (mixture (B, T),
    gain-scaled sources (B, S, T)), as the JAX package's `mix_sources`
    computes them.  The targets are the scaled sources."""
    scaled = sources * torch.pow(10.0, gains_db / 20.0)[..., None]
    mixture = scaled.sum(dim=1)
    if snr_db is not None:
        sig_pow = (mixture ** 2).mean(dim=-1, keepdim=True)
        noise_pow = sig_pow / 10.0 ** (snr_db / 10.0)
        mixture = mixture + noise * torch.sqrt(noise_pow)
    return mixture, scaled


def noise_snr(data_cfg) -> Optional[float]:
    """The mixture's noise SNR in dB, None when the data adds no noise."""
    return float(data_cfg.snr_db) if data_cfg.num_noise > 0 else None


def mix_sources(sources: torch.Tensor, key: torch.Tensor, data_cfg,
                example_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (mixture (B, T), scaled sources (B, S, T)), drawn on the sources'
    device for global examples example_offset + [0, B) under the threefry
    `key` (the JAX package's `mix_sources` under the same key): gains
    uniform in ±gain_jitter_db, noise at snr_db."""
    out = dispatch.step_batch(key.to(sources.device), sources, data_cfg.gain_jitter_db,
                              noise_snr(data_cfg), offset=example_offset)
    return out.mixture, out.scaled
