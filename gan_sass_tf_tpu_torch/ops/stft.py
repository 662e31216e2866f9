"""K4: the complex STFT — the CUDA kernel's wrapper and its plain PyTorch
version.

Port of `gan_sass_tf_tpu/ops/pallas_stft.py::stft_pallas` (the oracle
bounds' STFT): (..., T) f32 -> (..., F, n_fft//2 + 1) complex64.
`stft_kernel` launches the spec-only instantiation of the K1 kernel body in
`csrc/stft_features.cu` (`stft_launch`: the same FFT, no |X|, log or mel
epilogue);
`stft_reference` is `dsp.stft`.  `ops.dispatch.stft` chooses between them
by the tensor's device.
"""

from __future__ import annotations

import torch

from gan_sass_tf_tpu_torch.dsp.stft import stft as stft_reference  # noqa: F401
from gan_sass_tf_tpu_torch.ops.stft_features import _device_tables, check_waveform

launches = 0   # kernel launches since the last reset (chip_smoke reads it)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"stft kernel: {msg}")


def stft_kernel(x: torch.Tensor, n_fft: int, hop: int,
                window: str = "hann") -> torch.Tensor:
    """(..., T) f32 CUDA waveform -> (..., F, K) complex64 spectrum from one
    launch of the CUDA kernel."""
    global launches
    from gan_sass_tf_tpu_torch.ops import build

    lead, b, t, f, k = check_waveform(x, n_fft, hop, _require)
    lib = build.load_library()
    dev = x.device
    win, tw, tws = _device_tables(n_fft, window, dev)
    out = torch.empty((b, f, k), dtype=torch.complex64, device=dev)
    rc = lib.stft_launch(
        x.data_ptr(), win.data_ptr(), tw.data_ptr(), tws.data_ptr(),
        torch.view_as_real(out).data_ptr(), b, t, f, n_fft, hop,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    build.check_launch(rc, "stft")
    launches += 1
    return out.reshape(*lead, f, k)
