"""K2: fused mask-apply + iSTFT/overlap-add — the CUDA kernel's wrapper and
its plain PyTorch version.

Port of `gan_sass_tf_tpu/ops/pallas_istft.py::masked_istft_pallas`:
mixture STFT (..., F, K) + masks (..., S, F, K[, 2]) -> (..., S, T) wavs.
`masked_istft_kernel` launches `csrc/masked_istft.cu` (an inverse FFT per
frame in shared memory, n_fft a power of two from 64 to 4096) on CUDA
tensors; `masked_istft_reference` is `apply_mask` followed by
`istft(norm="global")`.  `ops.dispatch` chooses between them by the
tensors' device.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from gan_sass_tf_tpu_torch.dsp.masks import apply_mask
from gan_sass_tf_tpu_torch.dsp.stft import irfft, istft as _istft, overlap_add
from gan_sass_tf_tpu_torch.dsp.windows import cola_norm, get_window, safe_inv_env
from gan_sass_tf_tpu_torch.ops.stft_features import _device_tables, check_n_fft

_MAX_SMEM = 227 * 1024      # dynamic shared memory a Hopper block may use
# The synthesis block (K2 and K3): it owns ROWS output hop-rows and inverts
# the frames that touch them TILE_SAMPLES // n_fft at a time.  Picked on an
# H100 as the least device ms summed over the main path's three synthesis
# shapes among ROWS 4-32 x TILE_SAMPLES 2048-16384
# (gan_sass_tf_tpu_torch/scripts/time_synthesis.py --sweep; PERF.md).
ROWS = 8
TILE_SAMPLES = 4096

launches = 0   # kernel launches since the last reset (chip_smoke reads it)


def synthesis_block(n_fft: int, hop: int, require) -> Tuple[int, int]:
    """(rows, tile) of a synthesis block for this geometry, after checking
    its shared memory (two (tile, n_fft/2) float2 buffers and a (rows, hop)
    f32 accumulator, as `csrc/masked_istft.cu` lays it out) against the
    card's; `require(cond, msg)` reports a failure."""
    tile = max(1, min(TILE_SAMPLES // n_fft, ROWS + n_fft // hop - 1))
    smem = 8 * n_fft * tile + 4 * ROWS * hop
    require(smem <= _MAX_SMEM, f"needs {smem} B of shared memory "
            f"(n_fft {n_fft}, hop {hop}); the card has {_MAX_SMEM}")
    return ROWS, tile


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
    y = overlap_add(irfft(est, n_fft) * w, hop)
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
    check_n_fft(n_fft, hop, _require)
    complex_mask = mask_type == "complex"
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
    rows, tile = synthesis_block(n_fft, hop, _require)
    lib = build.load_library()
    dev = spec.device
    win, tw, tws = _device_tables(n_fft, window, dev)
    inv = _inv_env(n_fft, hop, window, f, dev) if env == "full" else None
    out_len = (f - 1) * hop + n_fft
    out = torch.empty((b, s, out_len), dtype=torch.float32, device=dev)
    rc = lib.masked_istft_launch(
        torch.view_as_real(spec).data_ptr(), masks.data_ptr(), win.data_ptr(),
        tw.data_ptr(), tws.data_ptr(), None if inv is None else inv.data_ptr(),
        out.data_ptr(), b, s, f, n_fft, hop, int(complex_mask), rows, tile,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    build.check_launch(rc, "masked_istft")
    launches += 1
    if length is not None:
        out = out[..., :length]
    return out.reshape(*lead, s, out.shape[-1])
