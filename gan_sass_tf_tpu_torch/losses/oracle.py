"""Oracle-mask quality bounds: the SI-SDR improvement that the ideal mask of
the configured family reaches on a batch, the ceiling a trained model's
score is read against.

Port of `gan_sass_tf_tpu/losses/oracle.py`.  One oracle per mask family:

  * magnitude masks, sigmoid head -> the phase-sensitive filter clipped to
    [0, 1]: m_i = clip(Re(S_i · conj(X)) / |X|², 0, 1);
  * magnitude masks, softmax head -> the source-normalized IRM
    m_i = |S_i| / Σ_j |S_j| (softmax masks sum to 1 over sources);
  * complex masks -> the ideal complex mask S_i / X with re and im clipped
    to the generator's tanh range [-1, 1].

The estimates are resynthesized through the masked iSTFT the model's
separation uses (`ops.dispatch.masked_istft`), so window and edge effects
are in the bound.  Spectra stay complex64 and masks f32.
"""

from __future__ import annotations

from typing import Dict

import torch

from gan_sass_tf_tpu_torch.losses.metrics import pit_si_sdr
from gan_sass_tf_tpu_torch.ops import dispatch as ops


def oracle_masks(spec_mix: torch.Tensor, spec_srcs: torch.Tensor,
                 mask_type: str, eps: float = 1e-8,
                 mask_activation: str = "sigmoid") -> torch.Tensor:
    """Ideal masks from the true per-source STFTs, restricted to the
    generator head's representable set.

    spec_mix (B, F, K) and spec_srcs (B, S, F, K) complex -> (B, S, F, K)
    magnitude masks or (B, S, F, K, 2) complex (re, im) masks."""
    if mask_type == "magnitude":
        if mask_activation == "softmax":
            mags = spec_srcs.abs()
            return mags / (mags.sum(dim=1, keepdim=True) + eps)
        denom = spec_mix[:, None]
        psf = (spec_srcs * denom.conj()).real / (denom.abs() ** 2 + eps)
        return psf.clamp(0.0, 1.0)
    if mask_type == "complex":
        denom = spec_mix[:, None]
        m = spec_srcs * denom.conj() / (denom.abs() ** 2 + eps)
        return torch.stack([m.real.clamp(-1.0, 1.0), m.imag.clamp(-1.0, 1.0)],
                           dim=-1)
    raise ValueError(f"unknown mask_type {mask_type!r}")


def oracle_bound_si_sdr(mixture: torch.Tensor, scaled_sources: torch.Tensor,
                        dsp_cfg) -> Dict[str, torch.Tensor]:
    """Separate with the ideal masks and score as the eval step does (PIT
    SI-SDR and its improvement over the mixture).

    mixture (B, T) and scaled_sources (B, S, T), the outputs of
    `mix_sources` -> {si_sdr, si_sdr_mix, si_sdr_improvement}, batch means
    as 0-d tensors."""
    n_fft, hop = dsp_cfg.n_fft, dsp_cfg.hop_length
    kw = dict(window=dsp_cfg.window, win_length=dsp_cfg.win_length)
    spec_mix = ops.stft(mixture, n_fft, hop, **kw)
    spec_srcs = ops.stft(scaled_sources, n_fft, hop, **kw)
    masks = oracle_masks(spec_mix, spec_srcs, dsp_cfg.mask_type, dsp_cfg.eps,
                         mask_activation=dsp_cfg.mask_activation)
    est = ops.masked_istft(spec_mix, masks, n_fft, hop,
                           mask_type=dsp_cfg.mask_type, **kw)
    t = est.shape[-1]
    tgt = scaled_sources[..., :t]
    sisdr = pit_si_sdr(est, tgt).mean()
    baseline = pit_si_sdr(mixture[:, None, :t].expand_as(tgt), tgt).mean()
    return {"si_sdr": sisdr, "si_sdr_mix": baseline,
            "si_sdr_improvement": sisdr - baseline}
