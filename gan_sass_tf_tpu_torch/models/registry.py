"""Model registry: ModelConfig names -> PyTorch modules.

Port of `gan_sass_tf_tpu/models/registry.py` and the builders of
`gan_sass_tf_tpu/models/generator.py`: the conv U-Net G (stride-(1,1)
stem, `dec_l0="conv"`, linear-grid 1x1 and `interp` heads), the BiLSTM G
with its `dense`, `film` and `filmpack` heads, and the spectral-norm conv
D.  The builders validate as the JAX ones do, with the same exception
types.  Options that are not ported raise NotImplementedError naming the
ROADMAP item that brings them; none falls through to another path.
"""

from __future__ import annotations

import torch

from gan_sass_tf_tpu_torch.models import discriminator as _d
from gan_sass_tf_tpu_torch.models.generator import (
    BiLSTMGenerator,
    ConvUNetGenerator,
    init_params_,
)

_LATER = ("is not ported yet (ROADMAP.md, 'Modules to port', item 9: "
          "remaining presets and model options)")


def _unported(what: str):
    raise NotImplementedError(f"{what} {_LATER}")


def _conv_generator(cfg) -> ConvUNetGenerator:
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
    return ConvUNetGenerator(
        num_sources=cfg.data.num_sources,
        n_bins=d.n_bins,
        feature_dim=d.feature_dim,
        mask_type=d.mask_type,
        mask_activation=d.mask_activation,
        noise_slot=d.mask_noise_slot,
        channels=tuple(m.g_channels),
        leak=m.leak,
        dropout=m.dropout,
        dtype=getattr(torch, m.compute_dtype),
        time_stride=m.g_time_stride,
        decoder_slim=m.g_decoder_slim,
        sample_rate=float(d.sample_rate),
        crop_nyquist=m.g_crop_nyquist,
    )


def _bilstm_generator(cfg) -> BiLSTMGenerator:
    m, d = cfg.model, cfg.dsp
    if m.g_crop_nyquist:
        raise ValueError("g_crop_nyquist is only supported by the 'conv' "
                         "generator")
    if m.g_head_mode not in ("dense", "film", "filmpack"):
        raise ValueError("bilstm g_head_mode must be 'dense', 'film' or "
                         f"'filmpack', got {m.g_head_mode!r}")
    if m.g_head_mode in ("film", "filmpack") and d.feature_dim != d.n_bins:
        raise ValueError(
            "g_head_mode='film' needs linear-grid input features "
            f"(feature_dim {d.feature_dim} != n_bins {d.n_bins})")
    return BiLSTMGenerator(
        num_sources=cfg.data.num_sources,
        n_bins=d.n_bins,
        feature_dim=d.feature_dim,
        mask_type=d.mask_type,
        mask_activation=d.mask_activation,
        noise_slot=d.mask_noise_slot,
        hidden=m.g_hidden,
        layers=m.g_layers,
        dropout=m.dropout,
        dtype=getattr(torch, m.compute_dtype),
        head_mode=m.g_head_mode,
        film_channels=m.g_film_channels,
        film_fold=m.g_film_fold,
    )


_GENERATORS = {"conv": _conv_generator, "bilstm": _bilstm_generator}


def build_generator(cfg, device, seed: int = 0) -> torch.nn.Module:
    """cfg: full Config.  A seeded-init generator on `device`, in eval mode."""
    name = cfg.model.generator
    if name not in _GENERATORS:
        if name == "toy":
            _unported("generator 'toy'")
        raise KeyError(f"unknown generator {name!r}; have {sorted(_GENERATORS)}")
    g = _GENERATORS[name](cfg)
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
