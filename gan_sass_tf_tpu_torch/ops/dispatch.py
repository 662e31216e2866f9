"""Routing for the DSP hot ops: CUDA kernel or plain PyTorch version.

A tensor on the CPU takes the plain version (how the CPU tests run); a CUDA
tensor takes the kernel, which raises on what it does not take.  There is
no fallback from one to the other.  `force_backend("reference")` sends CUDA
tensors to the plain version, for comparing the two on the card:

    with force_backend("reference"): ...

Port of the routing in `gan_sass_tf_tpu/ops/dispatch.py`.  The TPU-only
parts (VMEM caps, the phased sub-128-hop path) have no counterpart: the
kernels take any hop that divides n_fft and any length.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from gan_sass_tf_tpu_torch.dsp.features import mel_filterbank
from gan_sass_tf_tpu_torch.dsp.stft import istft as _plain_istft
from gan_sass_tf_tpu_torch.dsp.windows import encode_win_length
from gan_sass_tf_tpu_torch.ops.istft import istft_kernel
from gan_sass_tf_tpu_torch.ops.masked_istft import (
    masked_istft_kernel,
    masked_istft_reference,
)
from gan_sass_tf_tpu_torch.ops.stft import stft_kernel, stft_reference
from gan_sass_tf_tpu_torch.ops.stft_features import (
    stft_features_kernel,
    stft_features_reference,
)

_FORCED: Optional[str] = None


@contextlib.contextmanager
def force_backend(name: Optional[str]):
    """Force 'kernel' or 'reference' for all dispatched ops in the context."""
    global _FORCED
    if name not in (None, "kernel", "reference"):
        raise ValueError(f"backend must be 'kernel' or 'reference', got {name!r}")
    prev, _FORCED = _FORCED, name
    try:
        yield
    finally:
        _FORCED = prev


def _use_kernel(x: torch.Tensor) -> bool:
    if _FORCED == "reference":
        return False
    if x.is_cuda or _FORCED == "kernel":
        return True               # the kernel wrapper rejects a CPU tensor
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no DSP path for a tensor on {x.device}")


def _pad_tail(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (0, pad)) if pad else x


@functools.lru_cache(maxsize=8)
def _mel(n_mels: int, n_bins: int, sample_rate: int,
         device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(n_mels, n_bins, sample_rate)).to(device)


def stft(x: torch.Tensor, n_fft: int, hop: int, window: str = "hann",
         win_length: Optional[int] = None) -> torch.Tensor:
    """(..., T) -> (..., F, n_fft//2 + 1) complex64 STFT, tf.signal's frame
    count 1 + (T - win_length)//hop.  On a CUDA tensor this is one launch
    of the K4 kernel."""
    window, pad = encode_win_length(window, n_fft, win_length)
    x = _pad_tail(x.float(), pad).contiguous()
    fn = stft_kernel if _use_kernel(x) else stft_reference
    return fn(x, n_fft, hop, window)


def stft_features(x: torch.Tensor, dsp_cfg, emit=("logmag",)):
    """Fused STFT + features: dict with any subset of {"spec", "mag",
    "logmag", "logmel"}.  On a CUDA tensor this is one kernel launch."""
    n_fft, hop = dsp_cfg.n_fft, dsp_cfg.hop_length
    window, pad = encode_win_length(dsp_cfg.window, n_fft, dsp_cfg.win_length)
    x = _pad_tail(x.float(), pad).contiguous()
    mel = None
    if "logmel" in emit:
        mel = _mel(dsp_cfg.n_mels, dsp_cfg.n_bins, dsp_cfg.sample_rate, x.device)
    fn = stft_features_kernel if _use_kernel(x) else stft_features_reference
    return fn(x, n_fft, hop, window, emit=tuple(emit), mel_matrix=mel,
              eps=dsp_cfg.eps)


def masked_istft(spec: torch.Tensor, masks: torch.Tensor, n_fft: int,
                 hop: int, window: str = "hann", mask_type: str = "magnitude",
                 length: Optional[int] = None,
                 win_length: Optional[int] = None) -> torch.Tensor:
    """Fused mask-apply + iSTFT/overlap-add: mixture STFT (..., F, K) +
    per-source masks -> (..., S, T) wavs."""
    window, pad = encode_win_length(window, n_fft, win_length)
    if pad and length is None:
        length = (spec.shape[-2] - 1) * hop + win_length
    if _use_kernel(spec):
        return masked_istft_kernel(spec.contiguous(), masks.float().contiguous(),
                                   n_fft, hop, window, mask_type, length)
    return masked_istft_reference(spec, masks, n_fft, hop, window, mask_type,
                                  length)


def istft(spec: torch.Tensor, n_fft: int, hop: int, window: str = "hann",
          length: Optional[int] = None,
          win_length: Optional[int] = None) -> torch.Tensor:
    """Differentiable least-squares iSTFT: complex (..., F, K) -> (..., T)
    f32, the train step's waveform-domain path.  On a CUDA tensor the K3
    kernel runs forward and the K1 kernel backward; on a CPU tensor the
    plain `dsp.istft(norm="global")`, differentiated by torch autograd."""
    window, pad = encode_win_length(window, n_fft, win_length)
    if pad and length is None:
        length = (spec.shape[-2] - 1) * hop + win_length
    if _use_kernel(spec):
        return istft_kernel(spec.real.float().contiguous(),
                            spec.imag.float().contiguous(), n_fft, hop,
                            window, length)
    return _plain_istft(spec, n_fft, hop, window, length, norm="global")
