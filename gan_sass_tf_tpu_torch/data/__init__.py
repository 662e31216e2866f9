"""Data: the host datasets (numpy copies of the JAX package's synthetic
generator and wav-corpus reader), the device bank, bank sampling and mixing
in PyTorch."""

from gan_sass_tf_tpu_torch.data.corpus import WavDirDataset
from gan_sass_tf_tpu_torch.data.device_bank import build_bank, sample_bank, take_rows
from gan_sass_tf_tpu_torch.data.mixer import mix, mix_sources
from gan_sass_tf_tpu_torch.data.threefry import prng_key
from gan_sass_tf_tpu_torch.data.synthetic import SyntheticDataset


def make_dataset(cfg, seed: int = 0, split: str = "train"):
    """The host dataset of `cfg.data.dataset` (port of the JAX package's
    `data.make_dataset`).  split "train" / "eval" are latent-disjoint
    (synthetic: held-out f0 and chord-root bins; wav_dir: held-out
    speakers); "all" disables the split."""
    if cfg.data.dataset == "synthetic":
        return SyntheticDataset(cfg, seed=seed, split=split)
    if cfg.data.dataset == "wav_dir":
        return WavDirDataset(cfg, seed=seed, split=split)
    raise ValueError(f"unknown dataset {cfg.data.dataset!r}")


__all__ = ["SyntheticDataset", "WavDirDataset", "build_bank", "sample_bank",
           "take_rows", "mix", "mix_sources",
           "make_dataset", "prng_key"]
