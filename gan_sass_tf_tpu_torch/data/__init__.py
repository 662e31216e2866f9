"""Data on the device: the synthetic source bank (a numpy copy of the JAX
package's generator), bank sampling and mixing in PyTorch."""

from gan_sass_tf_tpu_torch.data.device_bank import build_bank, sample_bank, take_rows
from gan_sass_tf_tpu_torch.data.mixer import apply_mix, mix_sources
from gan_sass_tf_tpu_torch.data.synthetic import SyntheticDataset


def make_dataset(cfg, seed: int = 0, split: str = "train"):
    """The host dataset of `cfg.data.dataset` (port of the JAX package's
    `data.make_dataset`).  split "train" / "eval" are latent-disjoint
    (held-out f0 and chord-root bins); "all" disables the split."""
    if cfg.data.dataset == "synthetic":
        return SyntheticDataset(cfg, seed=seed, split=split)
    if cfg.data.dataset == "wav_dir":
        raise NotImplementedError(
            "dataset 'wav_dir' is not ported yet (ROADMAP.md, 'Modules to "
            "port', item 6: corpus reader)")
    raise ValueError(f"unknown dataset {cfg.data.dataset!r}")


__all__ = ["SyntheticDataset", "build_bank", "sample_bank", "take_rows",
           "apply_mix", "mix_sources", "make_dataset"]
