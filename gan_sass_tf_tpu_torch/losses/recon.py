"""Reconstruction losses: L1 / MSE on spectrograms or waveforms.

Port of `gan_sass_tf_tpu/losses/recon.py`.
"""

from __future__ import annotations

import torch


def elem_loss(est: torch.Tensor, tgt: torch.Tensor, kind: str,
              batch_dims: int = 1) -> torch.Tensor:
    """Elementwise loss reduced over all but the leading `batch_dims` axes."""
    dims = tuple(range(batch_dims, est.dim()))
    if kind == "l1":
        d = (est - tgt).abs()
    elif kind == "mse":
        d = (est - tgt) ** 2
    else:
        raise ValueError(f"unknown recon loss {kind!r}")
    return d.mean(dim=dims) if dims else d


def recon_loss(est: torch.Tensor, tgt: torch.Tensor, kind: str) -> torch.Tensor:
    """Scalar reconstruction loss (mean over everything)."""
    return elem_loss(est, tgt, kind, batch_dims=0)
