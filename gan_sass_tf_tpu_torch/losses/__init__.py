"""Separation scores (the training losses arrive with the train step)."""

from gan_sass_tf_tpu_torch.losses.metrics import pit_si_sdr, si_sdr
from gan_sass_tf_tpu_torch.losses.pit import permutations_for

__all__ = ["pit_si_sdr", "si_sdr", "permutations_for"]
