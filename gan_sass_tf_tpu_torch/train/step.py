"""The separation graph: fused STFT features -> G masks -> fused masked
iSTFT.  Port of `build_separate_fn` in `gan_sass_tf_tpu/train/step.py`;
the train step joins it here in a later slice."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from gan_sass_tf_tpu_torch.ops import dispatch as ops


def build_separate_fn(cfg, g: torch.nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """separate(mixture (B, T)) -> (B, S, T) wavs: two DSP kernels around G.
    The separated complex spectra never reach device memory."""
    dcfg = cfg.dsp
    feat_key = "logmel" if dcfg.feature == "logmel" else "logmag"

    @torch.inference_mode()
    def separate(mixture: torch.Tensor) -> torch.Tensor:
        out = ops.stft_features(mixture, dcfg, emit=("spec", feat_key))
        masks = g(out[feat_key])
        wavs = ops.masked_istft(
            out["spec"], masks, dcfg.n_fft, dcfg.hop_length,
            window=dcfg.window, mask_type=dcfg.mask_type,
            win_length=dcfg.win_length,
        )
        # Length-stable output: with win_length < n_fft the tf-exact iSTFT
        # is n_fft - win_length samples short; pad with (honest) zeros.
        t = mixture.shape[-1]
        if wavs.shape[-1] < t:
            wavs = F.pad(wavs, (0, t - wavs.shape[-1]))
        return wavs[..., :t]

    return separate
