"""Data on the device: the synthetic source bank (a numpy copy of the JAX
package's generator), bank sampling and mixing in PyTorch."""

from gan_sass_tf_tpu_torch.data.device_bank import build_bank, sample_bank, take_rows
from gan_sass_tf_tpu_torch.data.mixer import apply_mix, mix_sources
from gan_sass_tf_tpu_torch.data.synthetic import SyntheticDataset

__all__ = ["SyntheticDataset", "build_bank", "sample_bank", "take_rows",
           "apply_mix", "mix_sources"]
