"""Separation generator (conv U-Net) and its flax weight converter."""

from gan_sass_tf_tpu_torch.models.convert import (
    convert_generator_params,
    generator_params_to_flax,
    load_flax_npz,
    load_generator,
    save_flax_npz,
)
from gan_sass_tf_tpu_torch.models.generator import ConvUNetGenerator, MaskHead
from gan_sass_tf_tpu_torch.models.registry import build_generator

__all__ = [
    "ConvUNetGenerator", "MaskHead", "build_generator",
    "convert_generator_params", "generator_params_to_flax",
    "load_flax_npz", "load_generator", "save_flax_npz",
]
