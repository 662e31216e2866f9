"""K2: fused mask-apply + iSTFT/overlap-add — the CUDA kernel's wrapper and
its plain PyTorch version.

Port of `gan_sass_tf_tpu/ops/pallas_istft.py::masked_istft_pallas`:
mixture STFT (..., F, K) + masks (..., S, F, K[, 2]) -> (..., S, T) wavs.
`masked_istft_kernel` launches `csrc/masked_istft.cu` on CUDA tensors;
`masked_istft_reference` is `apply_mask` followed by `istft(norm="global")`.
`ops.dispatch` chooses between them by the tensors' device.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from gan_sass_tf_tpu_torch.dsp.masks import apply_mask
from gan_sass_tf_tpu_torch.dsp.stft import istft as _istft, overlap_add
from gan_sass_tf_tpu_torch.dsp.windows import cola_norm, get_window, safe_inv_env

_MAX_SMEM = 227 * 1024      # dynamic shared memory a Hopper block may use

launches = 0   # kernel launches since the last reset (chip_smoke reads it)


@functools.lru_cache(maxsize=16)
def _idft_matrices(n_fft: int, window: str,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, n_fft) windowed inverse-rDFT matrices on `device`: frames =
    re @ Ci + im @ Si reproduces irfft (hermitian bin weights) times the
    synthesis window.  Built in float64 by the formulas of
    pallas_istft._idft_matrices (unpadded), stored f32."""
    n_bins = n_fft // 2 + 1
    w = get_window(window, n_fft).astype(np.float64)
    ang = 2.0 * np.pi * np.arange(n_bins)[:, None] * np.arange(n_fft)[None, :] / n_fft
    a = np.full((n_bins, 1), 2.0 / n_fft)
    a[0, 0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        a[-1, 0] = 1.0 / n_fft
    ci = (a * np.cos(ang) * w[None, :]).astype(np.float32)
    si = (-a * np.sin(ang) * w[None, :]).astype(np.float32)
    return (torch.from_numpy(ci).to(device), torch.from_numpy(si).to(device))


@functools.lru_cache(maxsize=16)
def _inv_env(n_fft: int, hop: int, window: str, n_frames: int,
             device: torch.device) -> torch.Tensor:
    """safe_inv_env(cola_norm(w, hop, F)) on `device`, length (F-1)·hop + n_fft."""
    w = get_window(window, n_fft)
    return torch.from_numpy(safe_inv_env(cola_norm(w, hop, n_frames))).to(device)


def _check_mask_type(mask_type: str, env: str) -> None:
    if mask_type not in ("magnitude", "complex"):
        raise ValueError(f"unknown mask_type {mask_type!r}")
    if env not in ("full", "none"):
        raise ValueError(f"unknown env {env!r}")


def masked_istft_reference(spec: torch.Tensor, masks: torch.Tensor,
                           n_fft: int, hop: int, window: str = "hann",
                           mask_type: str = "magnitude",
                           length: Optional[int] = None,
                           env: str = "full") -> torch.Tensor:
    """Plain version: apply_mask then istft(norm="global"); env="none" skips
    the envelope (raw windowed overlap-add)."""
    _check_mask_type(mask_type, env)
    est = apply_mask(spec, masks, mask_type)
    if env == "full":
        return _istft(est, n_fft, hop, window, length, norm="global")
    w = torch.from_numpy(get_window(window, n_fft)).to(spec.device)
    y = overlap_add(torch.fft.irfft(est, n=n_fft, dim=-1).float() * w, hop)
    return y if length is None else y[..., :length]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"masked_istft kernel: {msg}")


def masked_istft_kernel(spec: torch.Tensor, masks: torch.Tensor,
                        n_fft: int, hop: int, window: str = "hann",
                        mask_type: str = "magnitude",
                        length: Optional[int] = None,
                        env: str = "full") -> torch.Tensor:
    """complex64 (..., F, K) spectrum + f32 masks on CUDA -> (..., S, T)
    waveforms from one launch of the CUDA kernel."""
    global launches
    from gan_sass_tf_tpu_torch.ops import build

    _check_mask_type(mask_type, env)
    complex_mask = mask_type == "complex"
    _require(n_fft % hop == 0, f"needs hop | n_fft, got {n_fft}/{hop}")
    _require(spec.dtype == torch.complex64,
             f"needs a complex64 spectrum, got {spec.dtype}")
    _require(masks.dtype == torch.float32, f"needs f32 masks, got {masks.dtype}")
    _require(spec.dim() >= 2, "needs a (..., F, K) spectrum")
    *lead, f, k = spec.shape
    _require(k == n_fft // 2 + 1, f"expected {n_fft // 2 + 1} bins, got {k}")
    nl = len(lead)
    tail = (f, k, 2) if complex_mask else (f, k)
    _require(masks.dim() == nl + 1 + len(tail)
             and tuple(masks.shape[:nl]) == tuple(lead)
             and tuple(masks.shape[nl + 1:]) == tail,
             f"{mask_type} masks must be (..., S) + {tail} for a spectrum "
             f"{tuple(spec.shape)}, got {tuple(masks.shape)}")
    s = masks.shape[nl]
    b = int(np.prod(lead)) if lead else 1
    _require(0 < b * s <= 65535, f"batch·sources {b * s} outside [1, 65535]")
    _require(spec.is_cuda and masks.device == spec.device,
             f"needs CUDA tensors on one device, got {spec.device} "
             f"and {masks.device}")
    _require(spec.is_contiguous() and masks.is_contiguous(),
             "needs contiguous spectrum and masks")
    r = n_fft // hop
    lib = build.load_library()
    rows = lib.masked_istft_tile_rows()
    smem = 8 * (rows + r - 1) * k
    _require(smem <= _MAX_SMEM, f"needs {smem} B of shared memory "
             f"(n_fft {n_fft}, hop {hop}); the card has {_MAX_SMEM}")
    dev = spec.device
    ci, si = _idft_matrices(n_fft, window, dev)
    inv = _inv_env(n_fft, hop, window, f, dev) if env == "full" else None
    out_len = (f - 1) * hop + n_fft
    out = torch.empty((b, s, out_len), dtype=torch.float32, device=dev)
    threads = min(-(-hop // 32) * 32, 256)
    rc = lib.masked_istft_launch(
        torch.view_as_real(spec).data_ptr(), masks.data_ptr(),
        ci.data_ptr(), si.data_ptr(), None if inv is None else inv.data_ptr(),
        out.data_ptr(), b, s, f, n_fft, hop, k, int(complex_mask),
        threads, smem, torch.cuda.current_stream(dev).cuda_stream, dev.index)
    build.check_launch(rc, "masked_istft")
    launches += 1
    if length is not None:
        out = out[..., :length]
    return out.reshape(*lead, s, out.shape[-1])
