"""Separation graph (the train step arrives in a later slice)."""

from gan_sass_tf_tpu_torch.train.step import build_separate_fn

__all__ = ["build_separate_fn"]
