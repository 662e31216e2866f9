"""K1: fused STFT + features — the CUDA kernel's wrapper and its plain
PyTorch version.

Port of `gan_sass_tf_tpu/ops/pallas_stft.py::stft_features_pallas`.  One
call emits any subset of {"spec", "mag", "logmag", "logmel"} as a dict.
`stft_features_kernel` launches `csrc/stft_features.cu` on a CUDA tensor;
`stft_features_reference` composes `dsp.stft` -> abs -> log -> mel matmul.
`ops.dispatch` chooses between them by the tensor's device.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gan_sass_tf_tpu_torch.dsp.stft import stft as _stft
from gan_sass_tf_tpu_torch.dsp.windows import get_window

EMITS = ("spec", "mag", "logmag", "logmel")
_MAX_SMEM = 227 * 1024      # dynamic shared memory a Hopper block may use

launches = 0   # kernel launches since the last reset (chip_smoke reads it)


def _check_emit(emit: Sequence[str], mel: Optional[torch.Tensor]) -> None:
    for e in emit:
        if e not in EMITS:
            raise ValueError(f"unknown emit {e!r}")
    if "logmel" in emit and mel is None:
        raise ValueError("logmel requires mel_matrix")


@functools.lru_cache(maxsize=16)
def _dft_matrices(n_fft: int, window: str,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed rDFT matrices (n_fft, K) on `device`: wc = w[n]·cos(2πnk/N),
    ws = -w[n]·sin(2πnk/N); built in float64, stored f32 (the formulas of
    pallas_stft._dft_matrices, unpadded and unsplit)."""
    n_bins = n_fft // 2 + 1
    w = get_window(window, n_fft).astype(np.float64)
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_bins)[None, :] / n_fft
    wc = (np.cos(ang) * w[:, None]).astype(np.float32)
    ws = (-np.sin(ang) * w[:, None]).astype(np.float32)
    return (torch.from_numpy(wc).to(device), torch.from_numpy(ws).to(device))


def block_threads(n_bins: int) -> int:
    """Threads per block, one bin per thread and pass: the bins rounded up
    to a warp, at most 512.  (Spreading K = 1025 evenly over 3 passes of
    352 threads measured 16-20 % slower on an H100 than 512 threads with a
    last pass of one bin: fewer warps stay resident.)"""
    return min(-(-n_bins // 32) * 32, 512)


def stft_features_reference(x: torch.Tensor, n_fft: int, hop: int,
                            window: str = "hann",
                            emit: Sequence[str] = ("spec",),
                            mel_matrix: Optional[torch.Tensor] = None,
                            eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """Plain version: rfft of framed, windowed input, then abs, log, mel."""
    _check_emit(emit, mel_matrix)
    spec = _stft(x, n_fft, hop, window)
    out = {}
    if "spec" in emit:
        out["spec"] = spec
    if {"mag", "logmag", "logmel"} & set(emit):
        mag = spec.abs()
    if "mag" in emit:
        out["mag"] = mag
    if "logmag" in emit:
        out["logmag"] = torch.log(mag + eps)
    if "logmel" in emit:
        out["logmel"] = torch.log(mag @ mel_matrix + eps)
    return out


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"stft_features kernel: {msg}")


def check_waveform(x: torch.Tensor, n_fft: int, hop: int, require
                   ) -> Tuple[list, int, int, int, int]:
    """The checks both STFT kernels make of a (..., T) waveform, reported
    through `require(cond, msg)`; returns (lead dims, B, T, F, K)."""
    require(not (x.requires_grad and torch.is_grad_enabled()),
            "the kernel has no backward, and the input requires grad; a "
            "gradient would stop here (detach it, or differentiate through "
            "the plain version)")
    require(n_fft % hop == 0, f"needs hop | n_fft, got {n_fft}/{hop}")
    require(x.dtype == torch.float32, f"needs float32, got {x.dtype}")
    require(x.dim() >= 1, "needs a (..., T) waveform")
    *lead, t = x.shape
    require(t >= n_fft, f"signal ({t}) shorter than n_fft ({n_fft})")
    b = int(np.prod(lead)) if lead else 1
    require(0 < b <= 65535, f"batch {b} outside [1, 65535]")
    require(x.is_cuda, f"needs a CUDA tensor, got one on {x.device}")
    require(x.is_contiguous(), "needs a contiguous waveform")
    return lead, b, t, 1 + (t - n_fft) // hop, n_fft // 2 + 1


def stft_features_kernel(x: torch.Tensor, n_fft: int, hop: int,
                         window: str = "hann",
                         emit: Sequence[str] = ("spec",),
                         mel_matrix: Optional[torch.Tensor] = None,
                         eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """(..., T) f32 CUDA waveform -> dict of (..., F, K) / (..., F, M)
    outputs from one launch of the CUDA kernel."""
    global launches
    from gan_sass_tf_tpu_torch.ops import build

    _check_emit(emit, mel_matrix)
    lead, b, t, f, k = check_waveform(x, n_fft, hop, _require)
    dev = x.device
    m = 0
    if "logmel" in emit:
        _require(mel_matrix.device == dev and mel_matrix.dtype == torch.float32
                 and mel_matrix.is_contiguous() and mel_matrix.dim() == 2
                 and mel_matrix.shape[0] == k,
                 f"mel matrix must be contiguous f32 ({k}, M) on {dev}")
        m = mel_matrix.shape[1]
    lib = build.load_library()
    tile = lib.stft_features_tile_frames()
    smem = 4 * ((tile - 1) * hop + n_fft + (tile * k if m else 0))
    _require(smem <= _MAX_SMEM, f"needs {smem} B of shared memory "
             f"(n_fft {n_fft}, hop {hop}); the card has {_MAX_SMEM}")
    wc, ws = _dft_matrices(n_fft, window, dev)

    def new(width, dtype=torch.float32):
        return torch.empty((b, f, width), dtype=dtype, device=dev)

    out = {}
    if "spec" in emit:
        out["spec"] = new(k, torch.complex64)
    for name in ("mag", "logmag"):
        if name in emit:
            out[name] = new(k)
    if m:
        out["logmel"] = new(m)

    def ptr(name):
        if name not in out:
            return None
        a = out[name]
        return (torch.view_as_real(a) if a.is_complex() else a).data_ptr()

    threads = block_threads(k)
    rc = lib.stft_features_launch(
        x.data_ptr(), wc.data_ptr(), ws.data_ptr(),
        mel_matrix.data_ptr() if m else None,
        ptr("spec"), ptr("mag"), ptr("logmag"), ptr("logmel"),
        b, t, f, n_fft, hop, k, m, eps, threads, smem,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    build.check_launch(rc, "stft_features")
    launches += 1
    return {name: a.reshape(*lead, f, a.shape[-1]) for name, a in out.items()}
