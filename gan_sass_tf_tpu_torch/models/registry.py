"""Model registry: ModelConfig names -> PyTorch modules.

Port of `gan_sass_tf_tpu/models/registry.py` for what the ported slices
(one-shot separation and the train step) run.  Options that are not ported raise
NotImplementedError naming the ROADMAP item that brings them; none falls
through to another path.
"""

from __future__ import annotations

import torch

from gan_sass_tf_tpu_torch.models import discriminator as _d
from gan_sass_tf_tpu_torch.models.generator import ConvUNetGenerator, init_params_

_LATER = ("is not ported yet (ROADMAP.md, 'Modules to port', item 9: "
          "remaining presets and model options)")


def _unported(what: str):
    raise NotImplementedError(f"{what} {_LATER}")


def _check_conv(cfg) -> None:
    m, d = cfg.model, cfg.dsp
    if tuple(m.g_stem_stride) != (1, 1):
        _unported(f"g_stem_stride={tuple(m.g_stem_stride)}")
    if m.g_dec_l0 != "conv":
        _unported(f"g_dec_l0={m.g_dec_l0!r}")
    if m.g_phase_ct:
        _unported("g_phase_ct")
    if d.feature_dim != d.n_bins and m.g_head_mode != "interp":
        _unported(f"g_head_mode={m.g_head_mode!r} on the mel grid")
    if d.feature_dim == d.n_bins and m.g_head_mode in ("film", "fold"):
        _unported(f"g_head_mode={m.g_head_mode!r}")


def build_generator(cfg, device, seed: int = 0) -> ConvUNetGenerator:
    """cfg: full Config.  A seeded-init generator on `device`, in eval mode."""
    if cfg.model.generator != "conv":
        if cfg.model.generator in ("toy", "bilstm"):
            _unported(f"generator {cfg.model.generator!r}")
        raise KeyError(f"unknown generator {cfg.model.generator!r}; have ['conv']")
    _check_conv(cfg)
    g = ConvUNetGenerator(
        num_sources=cfg.data.num_sources,
        n_bins=cfg.dsp.n_bins,
        feature_dim=cfg.dsp.feature_dim,
        mask_type=cfg.dsp.mask_type,
        mask_activation=cfg.dsp.mask_activation,
        noise_slot=cfg.dsp.mask_noise_slot,
        channels=tuple(cfg.model.g_channels),
        leak=cfg.model.leak,
        dropout=cfg.model.dropout,
        dtype=getattr(torch, cfg.model.compute_dtype),
        time_stride=cfg.model.g_time_stride,
        decoder_slim=cfg.model.g_decoder_slim,
        sample_rate=float(cfg.dsp.sample_rate),
        crop_nyquist=cfg.model.g_crop_nyquist,
    )
    init_params_(g, torch.Generator().manual_seed(seed))
    return g.to(device).eval()


def build_discriminator(cfg, device, seed: int = 1) -> _d.ConvDiscriminator:
    """cfg: full Config.  A seeded-init spectral-norm conv D on `device`."""
    m = cfg.model
    if m.discriminator != "conv":
        if m.discriminator == "patch":
            _unported("discriminator 'patch'")
        raise KeyError(f"unknown discriminator {m.discriminator!r}; have ['conv']")
    if m.d_norm != "spectral":
        _unported(f"d_norm={m.d_norm!r}")
    if m.d_input_fold != 1:
        _unported(f"d_input_fold={m.d_input_fold}")
    if m.dropout > 0:
        _unported("dropout in D")
    d = _d.ConvDiscriminator(
        channels=tuple(m.d_channels), leak=m.leak,
        stem_stride=tuple(m.d_stem_stride),
        dtype=getattr(torch, m.compute_dtype))
    _d.init_params_(d, torch.Generator().manual_seed(seed))
    return d.to(device)
