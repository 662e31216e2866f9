"""On-device mixing: per-source gain jitter, the sum, optional noise.

Port of `gan_sass_tf_tpu/data/mixer.py::mix_sources`, with its draws: for
global example i, (k_gain, k_noise) = split(fold_in(key, i)), gains
`jax.random.uniform(k_gain, (S, 1), -g, g)` in dB and noise
`jax.random.normal(k_noise, (T,))` (threefry, `ops.dispatch.example_keys`
/ `draw`), so a data-parallel split of the batch draws the same numbers.
`apply_mix` takes the draws as arguments, for tests that inject them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gan_sass_tf_tpu_torch.ops import dispatch


def apply_mix(sources: torch.Tensor, gains_db: torch.Tensor,
              noise: Optional[torch.Tensor],
              data_cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, T) sources, (B, S) gains in dB, (B, T) standard-normal noise
    (used when data_cfg.num_noise > 0) -> (mixture (B, T), gain-scaled
    sources (B, S, T)).  The targets are the scaled sources."""
    scaled = sources * torch.pow(10.0, gains_db / 20.0)[..., None]
    mixture = scaled.sum(dim=1)
    if data_cfg.num_noise > 0:
        sig_pow = (mixture ** 2).mean(dim=-1, keepdim=True)
        noise_pow = sig_pow / 10.0 ** (data_cfg.snr_db / 10.0)
        mixture = mixture + noise * torch.sqrt(noise_pow)
    return mixture, scaled


def mix_keyed(sources: torch.Tensor, keys: torch.Tensor,
              data_cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, T) sources, (2, B, 2) per-example keys (k_gain, k_noise) ->
    (mixture (B, T), scaled sources (B, S, T)): gains uniform in
    ±gain_jitter_db, noise at snr_db."""
    _, s, t = sources.shape
    g = data_cfg.gain_jitter_db
    gains_db = dispatch.draw(keys[0], s, "uniform", -g, g)
    noise = (dispatch.draw(keys[1], t, "normal")
             if data_cfg.num_noise > 0 else None)
    return apply_mix(sources, gains_db, noise, data_cfg)


def mix_sources(sources: torch.Tensor, key: torch.Tensor, data_cfg,
                example_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (mixture (B, T), scaled sources (B, S, T)), drawn on the sources'
    device for global examples example_offset + [0, B) under the threefry
    `key` (the JAX package's `mix_sources` under the same key)."""
    keys = dispatch.example_keys(key.to(sources.device), example_offset,
                                 sources.shape[0])
    return mix_keyed(sources, keys[0], data_cfg)
