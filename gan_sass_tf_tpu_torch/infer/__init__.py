"""Separation: one-shot (`separate`, `separate_file`) and streaming in
overlapping chunks (`separate_streaming`, batched; `separate_streaming_scan`,
one chunk at a time)."""

from gan_sass_tf_tpu_torch.infer.separate import separate, separate_file
from gan_sass_tf_tpu_torch.infer.streaming import (
    separate_streaming,
    separate_streaming_scan,
)

__all__ = ["separate", "separate_file", "separate_streaming",
           "separate_streaming_scan"]
