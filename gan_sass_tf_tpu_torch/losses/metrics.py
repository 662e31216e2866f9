"""Evaluation metrics — SI-SDR, the separation quality score.

Port of `gan_sass_tf_tpu/losses/metrics.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_sass_tf_tpu_torch.losses.pit import permutations_for


def si_sdr(est: torch.Tensor, tgt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SDR in dB over the last axis; leading dims broadcast
    (zero-mean convention)."""
    est = est - est.mean(dim=-1, keepdim=True)
    tgt = tgt - tgt.mean(dim=-1, keepdim=True)
    dot = (est * tgt).sum(dim=-1, keepdim=True)
    energy = (tgt * tgt).sum(dim=-1, keepdim=True)
    s_target = dot / (energy + eps) * tgt
    e_noise = est - s_target
    ratio = (s_target ** 2).sum(dim=-1) / ((e_noise ** 2).sum(dim=-1) + eps)
    return 10.0 * torch.log10(ratio + eps)


def pit_si_sdr(est: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """(B, S, T) est/tgt -> (B,) best-permutation mean SI-SDR (dB)."""
    s = est.shape[1]
    pw = si_sdr(est[:, :, None], tgt[:, None, :])           # (B, S, S)
    src = np.arange(s)
    per_perm = torch.stack(
        [pw[:, src, p].mean(dim=-1) for p in permutations_for(s)], dim=-1)
    return per_perm.max(dim=-1).values
