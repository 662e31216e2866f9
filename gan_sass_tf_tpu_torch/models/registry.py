"""Model registry: ModelConfig names -> PyTorch modules.

Port of `gan_sass_tf_tpu/models/registry.py` and the builders of
`gan_sass_tf_tpu/models/generator.py` and `.../discriminator.py`: the
`toy`, `conv` and `bilstm` generators and the `conv` and `patch`
discriminators, with every option of `ModelConfig`.  The builders validate
as the JAX ones do, with the same exception types (the JAX D raises its
ValueErrors when it is first called; the port's when it is built).

A builder is `fn(cfg) -> nn.Module`, registered under the name that
`cfg.model.generator` or `cfg.model.discriminator` selects, as in the JAX
package:

    @register_generator("mine")
    def _mine(cfg):
        return MyGenerator(cfg.data.num_sources, cfg.dsp.n_bins)

`build_generator` / `build_discriminator` then give the module a seeded
init and move it to the device: the port's own modules as flax draws the
JAX package's (`models/convert.py`), any other the generic rule (see
their docstrings).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from gan_sass_tf_tpu_torch.data import threefry
from gan_sass_tf_tpu_torch.models import discriminator as _d
from gan_sass_tf_tpu_torch.models.convert import (
    flax_init_discriminator_,
    flax_init_generator_,
)
from gan_sass_tf_tpu_torch.models.generator import (
    BiLSTMGenerator,
    ConvUNetGenerator,
    ToyMLPGenerator,
    init_params_,
)

_GENERATORS: Dict[str, Callable] = {}
_DISCRIMINATORS: Dict[str, Callable] = {}


def register_generator(name: str):
    """Decorator: register `fn(cfg) -> nn.Module` as generator `name`."""
    def deco(fn):
        _GENERATORS[name] = fn
        return fn

    return deco


def register_discriminator(name: str):
    """Decorator: register `fn(cfg) -> nn.Module` as discriminator `name`."""
    def deco(fn):
        _DISCRIMINATORS[name] = fn
        return fn

    return deco


def list_generators():
    return tuple(sorted(_GENERATORS))


def list_discriminators():
    return tuple(sorted(_DISCRIMINATORS))


@register_generator("toy")
def _toy_generator(cfg) -> ToyMLPGenerator:
    m, d = cfg.model, cfg.dsp
    if m.g_crop_nyquist:
        raise ValueError("g_crop_nyquist is only supported by the 'conv' "
                         "generator")
    return ToyMLPGenerator(
        num_sources=cfg.data.num_sources,
        n_bins=d.n_bins,
        feature_dim=d.feature_dim,
        mask_type=d.mask_type,
        mask_activation=d.mask_activation,
        noise_slot=d.mask_noise_slot,
        hidden=m.g_hidden,
        dropout=m.dropout,
        dtype=getattr(torch, m.compute_dtype),
    )


@register_generator("conv")
def _conv_generator(cfg) -> ConvUNetGenerator:
    m, d = cfg.model, cfg.dsp
    linear = d.feature_dim == d.n_bins
    if m.g_stem_mode not in ("conv", "fold"):
        raise ValueError(f"g_stem_mode must be 'conv' or 'fold', "
                         f"got {m.g_stem_mode!r}")
    if m.g_head_mode not in ("dense", "interp", "film", "fold"):
        raise ValueError(f"conv g_head_mode must be 'dense', 'interp', 'film' "
                         f"or 'fold', got {m.g_head_mode!r}")
    if m.g_head_mode == "fold" and tuple(m.g_stem_stride) == (1, 1):
        raise ValueError("g_head_mode='fold' emits masks from the stem-folded "
                         "grid: it needs g_stem_stride != (1, 1)")
    if m.g_head_mode in ("fold", "film") and not linear:
        raise ValueError(
            f"conv g_head_mode={m.g_head_mode!r} needs linear-grid input "
            f"features (feature_dim {d.feature_dim} != n_bins {d.n_bins})")
    if m.g_dec_l0 not in ("conv", "subpixel"):
        raise ValueError(f"g_dec_l0 must be 'conv' or 'subpixel', "
                         f"got {m.g_dec_l0!r}")
    if m.g_crop_nyquist and (not linear or d.n_bins % 2 == 0):
        raise ValueError(
            "g_crop_nyquist needs linear-grid features with odd n_bins "
            f"(feature_dim {d.feature_dim}, n_bins {d.n_bins})")
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
        stem_stride=tuple(m.g_stem_stride),
        stem_mode=m.g_stem_mode,
        decoder_slim=m.g_decoder_slim,
        head_mode=m.g_head_mode,
        sample_rate=float(d.sample_rate),
        film_channels=m.g_film_channels,
        film_fold=m.g_film_fold,
        dec_l0=m.g_dec_l0,
        phase_ct=m.g_phase_ct,
        crop_nyquist=m.g_crop_nyquist,
    )


@register_generator("bilstm")
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


def _discriminator(cls, cfg) -> _d.ConvDiscriminator:
    m = cfg.model
    return cls(channels=tuple(m.d_channels), norm=m.d_norm, leak=m.leak,
               dropout=m.dropout, stem_stride=tuple(m.d_stem_stride),
               input_fold=m.d_input_fold, dtype=getattr(torch, m.compute_dtype))


@register_discriminator("conv")
def _conv_discriminator(cfg) -> _d.ConvDiscriminator:
    return _discriminator(_d.ConvDiscriminator, cfg)


@register_discriminator("patch")
def _patch_discriminator(cfg) -> _d.PatchDiscriminator:
    return _discriminator(_d.PatchDiscriminator, cfg)


def init_keys(seed: int) -> torch.Tensor:
    """(rng_g, rng_d) = split(PRNGKey(seed)) on the CPU: the keys the JAX
    package's `create_train_state` initializes G and D from."""
    return threefry.split(threefry.prng_key(seed))


def build_generator(cfg, device, seed: int = 0) -> torch.nn.Module:
    """cfg: full Config.  The generator `cfg.model.generator` names, on
    `device`, in eval mode.  The port's generators (conv, BiLSTM, toy)
    start from the weights flax draws for the JAX G from rng_g of
    `init_keys(seed)` (`models.convert.flax_init_generator_`); any other
    registered G from `models.generator.init_params_` (lecun-normal
    kernels, orthogonal recurrent kernels, zero biases) seeded by `seed`."""
    name = cfg.model.generator
    if name not in _GENERATORS:
        raise KeyError(f"unknown generator {name!r}; have {sorted(_GENERATORS)}")
    g = _GENERATORS[name](cfg)
    if isinstance(g, (ConvUNetGenerator, BiLSTMGenerator, ToyMLPGenerator)):
        flax_init_generator_(g, init_keys(seed)[0])
    else:
        init_params_(g, torch.Generator().manual_seed(seed))
    return g.to(device).eval()


def build_discriminator(cfg, device, seed: int = 0) -> torch.nn.Module:
    """cfg: full Config.  The discriminator `cfg.model.discriminator`
    names, on `device`.  A `ConvDiscriminator` (the `conv` and `patch`
    builders') starts from what flax draws for the JAX D from rng_d of
    `init_keys(seed)` (`models.convert.flax_init_discriminator_`); any
    other registered D from the generators' rule,
    `models.generator.init_params_`, seeded by `seed`."""
    name = cfg.model.discriminator
    if name not in _DISCRIMINATORS:
        raise KeyError(f"unknown discriminator {name!r}; "
                       f"have {sorted(_DISCRIMINATORS)}")
    d = _DISCRIMINATORS[name](cfg)
    if isinstance(d, _d.ConvDiscriminator):
        flax_init_discriminator_(d, init_keys(seed)[1])
    else:
        init_params_(d, torch.Generator().manual_seed(seed))
    return d.to(device)
