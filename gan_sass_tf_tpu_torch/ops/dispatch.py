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
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from gan_sass_tf_tpu_torch.dsp.features import mel_filterbank
from gan_sass_tf_tpu_torch.dsp.stft import istft as _plain_istft
from gan_sass_tf_tpu_torch.dsp.windows import encode_win_length
from gan_sass_tf_tpu_torch.ops import istft as _k3
from gan_sass_tf_tpu_torch.ops import masked_istft as _k2
from gan_sass_tf_tpu_torch.ops import stft as _k4
from gan_sass_tf_tpu_torch.ops import stft_features as _k1
from gan_sass_tf_tpu_torch.ops import threefry as _rng
from gan_sass_tf_tpu_torch.ops.istft import istft_ri_kernel
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


def backend() -> Optional[str]:
    """The backend `force_backend` forces now: 'kernel', 'reference' or
    None (each tensor's device decides)."""
    return _FORCED


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's count of its launches since the count was last
    set to 0: K1 `stft_features`, K2 `masked_istft`, K3 `istft` and its
    backward `istft_bwd`, K4 `stft`, and the threefry launches
    `threefry_batch` (a step's batch), `threefry_batch_noise` (its noise,
    the second launch under noise), `threefry_sample`,
    `threefry_dropout` (forward), `threefry_dropout_bwd` (its backward,
    the mask kernel, which reads the forward's packed mask and draws
    nothing) and `threefry_noise`.  A wrapper called while a CUDA graph
    is captured counts the launch it records; `train/graphed.py` counts
    the launches that replays of its graphs make."""
    return {"stft_features": _k1.launches, "masked_istft": _k2.launches,
            "istft": _k3.launches, "istft_bwd": _k3.bwd_launches,
            "stft": _k4.launches, "threefry_batch": _rng.batch_launches,
            "threefry_batch_noise": _rng.batch_noise_launches,
            "threefry_sample": _rng.sample_launches,
            "threefry_dropout": _rng.dropout_launches,
            "threefry_dropout_bwd": _rng.dropout_bwd_launches,
            "threefry_noise": _rng.noise_launches}


def reset_launch_counts() -> None:
    """Set every count of `launch_counts` to 0."""
    _k1.launches = _k2.launches = _k3.launches = _k3.bwd_launches = 0
    _k4.launches = _rng.batch_launches = _rng.batch_noise_launches = 0
    _rng.sample_launches = _rng.dropout_launches = 0
    _rng.dropout_bwd_launches = _rng.noise_launches = 0


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
    kernel runs forward on the spectrum's interleaved f32 view (no copy of
    a contiguous complex64 spectrum) and the adjoint kernel backward, whose
    gradient reaches the spectrum as a view; on a CPU tensor the plain
    `dsp.istft(norm="global")`, differentiated by torch autograd."""
    window, pad = encode_win_length(window, n_fft, win_length)
    if pad and length is None:
        length = (spec.shape[-2] - 1) * hop + win_length
    if _use_kernel(spec):
        ri = torch.view_as_real(spec.to(torch.complex64).contiguous())
        return istft_ri_kernel(ri, n_fft, hop, window, length)
    return _plain_istft(spec, n_fft, hop, window, length, norm="global")


def step_batch(key: torch.Tensor, data: torch.Tensor, gain_db: float,
               snr_db: Optional[float] = None, offset: int = 0,
               step: Optional[torch.Tensor] = None, bank_batch: int = 0,
               shard: int = 0, d_steps: int = 0) -> _rng.Batch:
    """A train step's batch under the threefry `key` (`ops/threefry.py`
    `batch`): with bank_batch > 0 that many examples drawn from the (S, N,
    T) bank `data` (picks and circular shifts), else the (B, S, T) sources
    `data`; for global examples offset + [0, B), each source scaled by a
    gain in ±gain_db dB and the mixture summed, with `snr_db` noise added
    at that SNR.  With the train step's 0-d `step` the keys are the JAX
    step's (rng_data, rng_mix of fold_in(key, step)), else the key is both
    bases; d_steps > 0 also derives the step's dropout and noise keys with
    `shard` folded in.  -> `Batch` (mixture, scaled, train_keys, picks,
    shifts, gains).  On CUDA tensors one kernel launch, two under noise."""
    fn = _rng.batch_kernel if _use_kernel(data) else _rng.batch_reference
    return fn(key, data, bank_batch or data.shape[0], gain_db, snr_db, offset, step,
              bank_batch > 0, shard, d_steps)


def draw(keys: torch.Tensor, n: int, kind: str, lo=0.0, hi=1.0) -> torch.Tensor:
    """(R, 2) threefry keys -> (R, n) values of `kind` ("bits", "uniform",
    "randint", "normal"), row r as jax.random draws it under keys[r].  On
    CUDA keys one kernel launch."""
    fn = _rng.sample_kernel if _use_kernel(keys) else _rng.sample_reference
    return fn(keys, n, kind, lo, hi)


def dropout(x: torch.Tensor, key: torch.Tensor, fold: int, p: float,
            dims) -> torch.Tensor:
    """flax's train-time `nn.Dropout(p)` of x at the site keyed by
    fold_in(key, fold), `dims` x's dims in the flax tensor's order;
    differentiable.  On a CUDA tensor one kernel launch forward, which
    also packs the keep mask, and one backward, which reads it."""
    return _rng.Dropout.apply(x, key, fold, p, tuple(dims), _use_kernel(x))[0]


def instance_noise(x: torch.Tensor, key: torch.Tensor, std: float) -> torch.Tensor:
    """x + std·N(0, 1) under `key`, as `jax.random.normal(key, x.shape,
    x.dtype)` draws it for x in the flax layout; the gradient passes as it
    is.  On a CUDA tensor one kernel launch."""
    return _rng.Noise.apply(x, key, std, _use_kernel(x))
