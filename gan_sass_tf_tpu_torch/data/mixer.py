"""On-device mixing: per-source gain jitter, the sum, optional noise.

Port of `gan_sass_tf_tpu/data/mixer.py::mix_sources`.  The random gains and
noise come from `counter_rng` per global example index under the step's
key (`counter_rng.step_key(seed, step)`), so a data-parallel split of the
batch draws the same numbers;
`apply_mix` takes them as arguments, which is how the tests hand both
packages the same draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gan_sass_tf_tpu_torch.data.counter_rng import (
    Counter,
    counter_normal,
    counter_uniform,
)

STREAM_GAIN, STREAM_NOISE = 21, 22       # the noise uses 22 and 23


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


def mix_sources(sources: torch.Tensor, key: Counter, data_cfg,
                example_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (mixture (B, T), scaled sources (B, S, T)), with gains uniform in
    ±gain_jitter_db and noise at snr_db, drawn on the sources' device."""
    b, s, t = sources.shape
    ids = example_offset + torch.arange(b, device=sources.device)
    g = data_cfg.gain_jitter_db
    gains_db = (2.0 * counter_uniform(key, ids, STREAM_GAIN, s) - 1.0) * g
    noise = (counter_normal(key, ids, STREAM_NOISE, t)
             if data_cfg.num_noise > 0 else None)
    return apply_mix(sources, gains_db, noise, data_cfg)
