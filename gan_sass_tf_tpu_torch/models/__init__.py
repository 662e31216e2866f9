"""Separation generators (conv U-Net, BiLSTM, toy MLP), the conv and patch
discriminators, the registry that builds them by name (and takes more
through `register_generator` / `register_discriminator`), and their flax
weight converters."""

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
from gan_sass_tf_tpu_torch.models.discriminator import (
    ConvDiscriminator,
    PatchDiscriminator,
)
from gan_sass_tf_tpu_torch.models.generator import (
    BiLSTMGenerator,
    ConvUNetGenerator,
    MaskHead,
    ToyMLPGenerator,
)
from gan_sass_tf_tpu_torch.models.registry import (
    build_discriminator,
    build_generator,
    list_discriminators,
    list_generators,
    register_discriminator,
    register_generator,
)

__all__ = [
    "ConvUNetGenerator", "MaskHead", "BiLSTMGenerator", "ToyMLPGenerator",
    "ConvDiscriminator", "PatchDiscriminator", "build_generator",
    "build_discriminator", "list_generators", "list_discriminators",
    "register_generator", "register_discriminator", "convert_generator_params",
    "generator_params_to_flax", "convert_discriminator_variables",
    "discriminator_variables_to_flax", "load_flax_npz", "load_generator",
    "load_discriminator", "save_flax_npz",
]
