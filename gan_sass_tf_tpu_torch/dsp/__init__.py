"""Audio DSP frontend in plain PyTorch: framing, windowed STFT/iSTFT,
log-magnitude / log-mel features, mask application, overlap-add.  The
reference for the CUDA kernels in `gan_sass_tf_tpu_torch.ops`."""

from gan_sass_tf_tpu_torch.dsp.windows import (
    cola_norm,
    encode_win_length,
    get_window,
    safe_inv_env,
)
from gan_sass_tf_tpu_torch.dsp.stft import (
    frame_signal,
    istft,
    num_frames,
    overlap_add,
    stft,
)
from gan_sass_tf_tpu_torch.dsp.features import (
    logmag,
    logmel,
    mel_filterbank,
    mel_interp_matrix,
    spec_features,
)
from gan_sass_tf_tpu_torch.dsp.masks import apply_mask, mask_channels

__all__ = [
    "get_window", "cola_norm", "encode_win_length", "safe_inv_env",
    "frame_signal", "num_frames", "overlap_add", "stft", "istft",
    "logmag", "logmel", "mel_filterbank", "mel_interp_matrix",
    "spec_features", "apply_mask", "mask_channels",
]
