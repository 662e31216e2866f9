"""K3: the differentiable iSTFT of the train step's waveform loss — its
CUDA kernels' autograd wrapper and its plain PyTorch version.

Port of `gan_sass_tf_tpu/ops/pallas_istft.py::istft_pallas` and the custom
VJP `_istft_ri` around `_istft_kernel`: the spectrum's real and imaginary
parts in, (..., T) waveforms out, least-squares normalized as
`dsp.istft(norm="global")`.  Real in and real out, as the JAX package does,
so no complex-cotangent convention enters: the autograd function takes the
f32 (..., F, K, 2) view of the complex spectrum (`torch.view_as_real`, no
copy) and returns its gradient in the same interleaved layout, so autograd
hands the complex spectrum its gradient as a view, with no merge.

Forward: `csrc/masked_istft.cu`'s mask-free instantiation (`istft_launch`).
Backward: the adjoint frames dy·inv_env, windows it and multiplies by
Ciᵀ/Siᵀ.  With Ci[k,n] = a_k·cos(2πkn/N)·w[n] and Si[k,n] =
-a_k·sin(2πkn/N)·w[n] (a_k = 1/N at DC and Nyquist, 2/N elsewhere) that is
an analysis STFT:

    dre[k] = a_k · Re STFT_w(dy·inv_env)[k],  dim[k] = a_k · Im STFT_w(dy·inv_env)[k]

so on CUDA it is one launch of the STFT body's adjoint instantiation
(`istft_adjoint_launch` in `csrc/stft_features.cu`), which multiplies by
inv_env as it stages dy and writes (dre, dim) interleaved.  Im at DC and
Nyquist comes out 0: the forward ignores those imaginary parts.

`istft_ri_kernel` is the autograd wrapper: on CUDA tensors it launches the
kernels (or raises), on CPU tensors it computes the same forward with the
plain iSTFT and the same adjoint with the plain STFT, which is how the CPU
tests hold the adjoint against the JAX VJP.  `istft_kernel` takes the two
planes (stacked into that layout).  `istft_reference` is the plain version
(torch autograd through `dsp.istft`); `ops.dispatch.istft` chooses.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from gan_sass_tf_tpu_torch.dsp.stft import istft as _istft
from gan_sass_tf_tpu_torch.ops import masked_istft as _k2
from gan_sass_tf_tpu_torch.ops.masked_istft import _inv_env
from gan_sass_tf_tpu_torch.ops import stft_features as _k1
from gan_sass_tf_tpu_torch.ops.stft_features import (
    analysis_tables,
    check_n_fft,
    stft_features_reference,
)

launches = 0       # forward kernel launches since the last reset
bwd_launches = 0   # backward (adjoint kernel) launches since the last reset


def istft_reference(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
                    window: str = "hann",
                    length: Optional[int] = None) -> torch.Tensor:
    """Plain version: `dsp.istft(re + i·im, norm="global")`; its gradient is
    torch autograd through irfft, window, fold and envelope."""
    return _istft(torch.complex(re.float(), im.float()), n_fft, hop, window,
                  length, norm="global")


@functools.lru_cache(maxsize=16)
def _bin_weights(n_fft: int, device: torch.device) -> torch.Tensor:
    """(K, 1) hermitian bin weights a_k of the inverse rDFT."""
    a = np.full((n_fft // 2 + 1, 1), 2.0 / n_fft, np.float32)
    a[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        a[-1] = 1.0 / n_fft
    return torch.from_numpy(a).to(device)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"istft kernel: {msg}")


def _launch_forward(ri: torch.Tensor, n_fft: int, hop: int,
                    window: str) -> torch.Tensor:
    """(B, F, K, 2) f32 CUDA spectrum -> (B, (F-1)·hop + n_fft) from one
    launch."""
    global launches
    from gan_sass_tf_tpu_torch.ops import build

    check_n_fft(n_fft, hop, _require)
    b, f = ri.shape[:2]
    _require(b > 0, f"batch {b}: nothing to synthesize")
    dev = ri.device
    _, addr, _ = _k2.plan_for(_k2.SPEC_ONLY, b, 1, f, n_fft, hop, window, "full", dev)
    out = torch.empty((b, (f - 1) * hop + n_fft), dtype=torch.float32, device=dev)
    rc = build.load_library().istft_launch(addr, ri.data_ptr(), out.data_ptr(),
                                           torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(rc, "istft")
    launches += 1
    return out


def istft_adjoint(dy: torch.Tensor, n_fft: int, hop: int, window: str,
                  n_frames: int) -> torch.Tensor:
    """(B, (F-1)·hop + n_fft) cotangent -> (B, F, K, 2) f32, the gradient of
    K3's interleaved input: the STFT of dy·inv_env scaled per bin.  One
    launch of the adjoint kernel on CUDA; the plain STFT on the CPU."""
    global bwd_launches
    inv = _inv_env(n_fft, hop, window, n_frames, dy.device)
    if not dy.is_cuda:
        spec = stft_features_reference(dy.float() * inv, n_fft, hop, window,
                                       emit=("spec",))["spec"]
        return torch.view_as_real(spec) * _bin_weights(n_fft, dy.device)
    from gan_sass_tf_tpu_torch.ops import build

    check_n_fft(n_fft, hop, _require)
    dy = dy.float().contiguous()
    b, t = dy.shape
    _require(t == inv.shape[0], f"cotangent of {t} samples for {n_frames} "
             f"frames (expected {inv.shape[0]})")
    lib = build.load_library()
    dev = dy.device
    win, tw, tws, ptw = analysis_tables(n_fft, window, dev)
    dspec = torch.empty((b, n_frames, n_fft // 2 + 1, 2), dtype=torch.float32,
                        device=dev)
    rc = lib.istft_adjoint_launch(
        dy.data_ptr(), inv.data_ptr(), win.data_ptr(), tw.data_ptr(),
        tws.data_ptr(), ptw.data_ptr(), dspec.data_ptr(), b, t, n_frames, n_fft,
        hop, _k1.TILE_ROUNDS, _k1.BLOCKS_PER_SM,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    build.check_launch(rc, "istft_adjoint")
    bwd_launches += 1
    return dspec


class _IstftRI(torch.autograd.Function):
    """(B, F, K, 2) f32 spectrum -> (B, (F-1)·hop + n_fft): K3 forward, its
    adjoint kernel backward, the gradient in the input's layout."""

    @staticmethod
    def forward(ctx, ri, n_fft, hop, window):
        ctx.geometry = (n_fft, hop, window, ri.shape[1])
        if ri.is_cuda:
            return _launch_forward(ri, n_fft, hop, window)
        return _istft(torch.view_as_complex(ri), n_fft, hop, window, norm="global")

    @staticmethod
    def backward(ctx, dy):
        # In the train step's "dsp" profiler range (utils/profiler.py
        # STEP_RANGES), though it runs inside G's backward.
        with torch.profiler.record_function("dsp"):
            return istft_adjoint(dy, *ctx.geometry), None, None, None


@functools.lru_cache(maxsize=64)
def _k3_call(shape: torch.Size, dtype: torch.dtype, n_fft: int,
             hop: int) -> Tuple[int, int]:
    """(F, K) of a K3 call on a (..., F, K, 2) spectrum, after the checks its
    shape and type need (ValueError otherwise), once per signature."""
    check_n_fft(n_fft, hop, _require)
    _require(dtype == torch.float32, f"needs a float32 spectrum, got {dtype}")
    _require(len(shape) >= 3 and shape[-1] == 2,
             f"needs a (..., F, K, 2) spectrum, got {tuple(shape)}")
    f, k = shape[-3], shape[-2]
    _require(k == n_fft // 2 + 1, f"expected {n_fft // 2 + 1} bins, got {k}")
    return f, k


def istft_ri_kernel(ri: torch.Tensor, n_fft: int, hop: int,
                    window: str = "hann",
                    length: Optional[int] = None) -> torch.Tensor:
    """(..., F, K, 2) f32 spectrum (`torch.view_as_real` of a complex one)
    -> (..., T) waveforms, differentiable in `ri`.  CUDA tensors launch the
    kernels; CPU tensors take the same forward and adjoint on the plain
    STFT/iSTFT."""
    f, k = _k3_call(ri.shape, ri.dtype, n_fft, hop)
    if not (ri.is_cuda or ri.device.type == "cpu"):
        _require(False, f"needs a CUDA (or CPU) tensor, got {ri.device}")
    if not ri.is_contiguous():
        _require(False, "needs a contiguous spectrum")
    y = _IstftRI.apply(ri.reshape(-1, f, k, 2), n_fft, hop, window)
    if length is not None:
        y = y[:, :length]
    return y.reshape(*ri.shape[:-3], y.shape[-1])


def istft_kernel(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
                 window: str = "hann",
                 length: Optional[int] = None) -> torch.Tensor:
    """(..., F, K) f32 planes -> (..., T) waveforms, differentiable in re
    and im: `istft_ri_kernel` of the planes stacked."""
    check_n_fft(n_fft, hop, _require)
    _require(re.dtype == im.dtype == torch.float32,
             f"needs float32 planes, got {re.dtype} and {im.dtype}")
    _require(re.dim() >= 2 and re.shape == im.shape,
             f"needs two (..., F, K) planes of one shape, got "
             f"{tuple(re.shape)} and {tuple(im.shape)}")
    _require(re.shape[-1] == n_fft // 2 + 1,
             f"expected {n_fft // 2 + 1} bins, got {re.shape[-1]}")
    _require(re.device == im.device, f"planes on {re.device} and {im.device}")
    _require(re.is_contiguous() and im.is_contiguous(), "needs contiguous planes")
    return istft_ri_kernel(torch.stack((re, im), -1), n_fft, hop, window, length)
