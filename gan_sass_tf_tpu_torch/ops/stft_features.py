"""K1: fused STFT + features — the CUDA kernel's wrapper and its plain
PyTorch version.

Port of `gan_sass_tf_tpu/ops/pallas_stft.py::stft_features_pallas`.  One
call emits any subset of {"spec", "mag", "logmag", "logmel"} as a dict.
`stft_features_kernel` launches `csrc/stft_features.cu` (an FFT per frame
in registers, n_fft a power of two from 64 to 4096) on a CUDA tensor;
`stft_features_reference` composes `dsp.stft` -> abs -> log -> mel matmul.
`ops.dispatch` chooses between them by the tensor's device.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gan_sass_tf_tpu_torch.dsp.stft import stft as _stft
from gan_sass_tf_tpu_torch.dsp.windows import get_window

EMITS = ("spec", "mag", "logmag", "logmel")
MIN_FFT, MAX_FFT = 64, 4096   # the kernel's n_fft: a power of two in this range

launches = 0   # kernel launches since the last reset (chip_smoke reads it)

# The analysis body's block shape (K1, K4 and K3's backward): a tile of a
# row is TILE_ROUNDS rounds of 256/(n_fft/32) frames, and at most
# BLOCKS_PER_SM persistent blocks share an SM.  Picked on an H100 among
# rounds 1, 2, 4 × blocks 1-4 (× 128, 256, 512 threads, the kernel's
# compile-time STFT_THREADS) by gan_sass_tf_tpu_torch/scripts/
# time_analysis.py --sweep (PERF.md).
TILE_ROUNDS = 2
BLOCKS_PER_SM = 2


def _check_emit(emit: Sequence[str], mel: Optional[torch.Tensor]) -> None:
    for e in emit:
        if e not in EMITS:
            raise ValueError(f"unknown emit {e!r}")
    if "logmel" in emit and mel is None:
        raise ValueError("logmel requires mel_matrix")


def fft_tables(n_fft: int, window: str
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The FFT kernels' tables, built in float64 and stored f32: the window
    (n_fft,), the Stockham stage twiddles e^{-2πim/H} (H,) and the split
    twiddles e^{-2πik/N} (H + 1,) as complex64, for H = n_fft / 2.  The
    synthesis kernels (K2, K3) read the twiddles conjugated."""
    h = n_fft // 2
    win = get_window(window, n_fft, np.float64).astype(np.float32)
    stage = np.exp(-2j * np.pi * np.arange(h) / h).astype(np.complex64)
    split = np.exp(-2j * np.pi * np.arange(h + 1) / n_fft).astype(np.complex64)
    return win, stage, split


def fft_passes(n_fft: int) -> List[Tuple[int, int]]:
    """(radix, ns) of each Stockham pass of the analysis body's H-point FFT,
    H = n_fft / 2: radix 16 while 16 divides what is left, then one pass
    of radix 2, 4 or 8; ns is the length of the sub-transforms done
    before the pass."""
    h, out, ns = n_fft // 2, [], 1
    while ns < h:
        r = min(16, h // ns)
        out.append((r, ns))
        ns *= r
    return out


def pass_twiddles(n_fft: int, stage: np.ndarray) -> np.ndarray:
    """The analysis body's pass table: for each pass (R, ns) after the first,
    the stage table's e^{-2πi·r·k/(R·ns)} = stage[r·k·H/(R·ns)] for
    r = 1..R-1, k < ns, laid out [pass][r - 1][k] (complex64; the same f32
    values as the stage table, which was built in float64)."""
    h = n_fft // 2
    parts = [stage[np.outer(np.arange(1, r), np.arange(ns)) * (h // (r * ns))].ravel()
             for r, ns in fft_passes(n_fft)[1:]]
    return np.concatenate(parts) if parts else np.zeros(0, np.complex64)


@functools.lru_cache(maxsize=16)
def _device_tables(n_fft: int, window: str,
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(a).to(device) for a in fft_tables(n_fft, window))


@functools.lru_cache(maxsize=16)
def _device_pass_twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    stage = fft_tables(n_fft, "hann")[1]   # the stage table: no window in it
    return torch.from_numpy(pass_twiddles(n_fft, stage)).to(device)


def analysis_tables(n_fft: int, window: str, device: torch.device
                    ) -> Tuple[torch.Tensor, ...]:
    """The analysis body's four tables on `device`: window, stage, split and
    pass twiddles."""
    return (*_device_tables(n_fft, window, device),
            _device_pass_twiddles(n_fft, device))


def mel_bands(mel: torch.Tensor) -> torch.Tensor:
    """The banded log-mel epilogue's table of a (K, M) mel matrix, (3M + 1,)
    int32 on its device: each band's first non-zero bin (K for a band of
    zeros), its last (-1), then the offsets of the bands' weights, their
    widths summed in order.  Built by device ops at the first call for a
    matrix and kept on the tensor, rebuilt when the tensor is changed in
    place (its version counter moves; an inference tensor keeps none, and
    counts as unchanged): no host sync, and no launch beside the kernel's
    in later calls."""
    version = None if mel.is_inference() else mel._version
    cached = getattr(mel, "_gan_sass_mel_bands", None)
    if cached is not None and cached[0] == version:
        return cached[1]
    k = mel.shape[0]
    nz = (mel != 0).int()
    any_ = nz.amax(0) > 0
    lo = torch.where(any_, nz.argmax(0), k)   # argmax: the first maximum
    hi = torch.where(any_, k - 1 - nz.flip(0).argmax(0), -1)
    width = (hi - lo + 1).clamp_min(0)
    table = torch.cat([lo, hi, width.new_zeros(1), width.cumsum(0)]).int()
    mel._gan_sass_mel_bands = (version, table)
    return table


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


def check_n_fft(n_fft: int, hop: int, require) -> None:
    """The geometry every FFT kernel takes (analysis and synthesis), checked
    before a wrapper loads the library: n_fft a power of two in [MIN_FFT,
    MAX_FFT] and hop | n_fft."""
    if not (MIN_FFT <= n_fft <= MAX_FFT and n_fft & (n_fft - 1) == 0):
        require(False, f"needs n_fft a power of two in [{MIN_FFT}, {MAX_FFT}], "
                f"got {n_fft}")
    if n_fft % hop:
        require(False, f"needs hop | n_fft, got {n_fft}/{hop}")


def check_waveform(x: torch.Tensor, n_fft: int, hop: int, require
                   ) -> Tuple[list, int, int, int, int]:
    """The checks both STFT kernels make of a (..., T) waveform, reported
    through `require(cond, msg)`; returns (lead dims, B, T, F, K)."""
    require(not (x.requires_grad and torch.is_grad_enabled()),
            "the kernel has no backward, and the input requires grad; a "
            "gradient would stop here (detach it, or differentiate through "
            "the plain version)")
    check_n_fft(n_fft, hop, require)
    require(x.dtype == torch.float32, f"needs float32, got {x.dtype}")
    require(x.dim() >= 1, "needs a (..., T) waveform")
    *lead, t = x.shape
    require(t >= n_fft, f"signal ({t}) shorter than n_fft ({n_fft})")
    b = math.prod(lead)
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
    win, tw, tws, ptw = analysis_tables(n_fft, window, dev)

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

    rc = lib.stft_features_launch(
        x.data_ptr(), win.data_ptr(), tw.data_ptr(), tws.data_ptr(),
        ptw.data_ptr(), mel_matrix.data_ptr() if m else None,
        mel_bands(mel_matrix).data_ptr() if m else None,
        ptr("spec"), ptr("mag"), ptr("logmag"), ptr("logmel"),
        b, t, f, n_fft, hop, m, eps, TILE_ROUNDS, BLOCKS_PER_SM,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    build.check_launch(rc, "stft_features")
    launches += 1
    return {name: a.reshape(*lead, f, a.shape[-1]) for name, a in out.items()}
