"""One-shot separation (streaming arrives in a later slice)."""

from gan_sass_tf_tpu_torch.infer.separate import separate, separate_file

__all__ = ["separate", "separate_file"]
