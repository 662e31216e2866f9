"""Generator registry: ModelConfig names -> PyTorch modules.

Port of `gan_sass_tf_tpu/models/registry.py` for what the one-shot
separation slice runs.  Options that are not ported raise
NotImplementedError naming the ROADMAP item that brings them; none falls
through to another path.
"""

from __future__ import annotations

import torch

from gan_sass_tf_tpu_torch.models.generator import ConvUNetGenerator, init_params_

_LATER = ("is not ported yet (ROADMAP.md, 'Modules to port': remaining "
          "presets and model options)")


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
    if m.g_crop_nyquist:
        _unported("g_crop_nyquist")
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
    )
    init_params_(g, torch.Generator().manual_seed(seed))
    return g.to(device).eval()
