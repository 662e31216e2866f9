"""Losses and scores: adversarial G/D losses, L1/MSE reconstruction, PIT
matching, SI-SDR and the oracle-mask bounds."""

from gan_sass_tf_tpu_torch.losses.gan import gan_d_loss, gan_g_loss
from gan_sass_tf_tpu_torch.losses.metrics import pit_si_sdr, si_sdr
from gan_sass_tf_tpu_torch.losses.oracle import oracle_bound_si_sdr, oracle_masks
from gan_sass_tf_tpu_torch.losses.pit import (
    align_to_perm,
    pairwise_losses,
    permutations_for,
    pit_loss,
    pool4,
    pooled_match_perm,
)
from gan_sass_tf_tpu_torch.losses.recon import elem_loss, recon_loss

__all__ = [
    "gan_d_loss", "gan_g_loss", "elem_loss", "recon_loss",
    "pairwise_losses", "pit_loss", "pool4", "pooled_match_perm",
    "align_to_perm", "permutations_for", "si_sdr", "pit_si_sdr",
    "oracle_masks", "oracle_bound_si_sdr",
]
