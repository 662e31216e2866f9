"""Separation generators (conv U-Net, BiLSTM, toy MLP), the conv and patch
discriminators, and their flax weight converters."""

from gan_sass_tf_tpu_torch.models.convert import (
    convert_discriminator_variables,
    convert_generator_params,
    discriminator_variables_to_flax,
    generator_params_to_flax,
    load_discriminator,
    load_flax_npz,
    load_generator,
    save_flax_npz,
)
from gan_sass_tf_tpu_torch.models.discriminator import ConvDiscriminator
from gan_sass_tf_tpu_torch.models.generator import (
    BiLSTMGenerator,
    ConvUNetGenerator,
    MaskHead,
    ToyMLPGenerator,
)
from gan_sass_tf_tpu_torch.models.registry import build_discriminator, build_generator

__all__ = [
    "ConvUNetGenerator", "MaskHead", "BiLSTMGenerator", "ToyMLPGenerator",
    "ConvDiscriminator", "build_generator",
    "build_discriminator", "convert_generator_params",
    "generator_params_to_flax", "convert_discriminator_variables",
    "discriminator_variables_to_flax", "load_flax_npz", "load_generator",
    "load_discriminator", "save_flax_npz",
]
