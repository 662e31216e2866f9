"""How far K1's log|X| lies from its plain version's on many inputs, and
which of the two lies closer to float64, on one CUDA card.

    python -m gan_sass_tf_tpu_torch.scripts.k1_logmag_spread [CASES]

At the streaming group shape (8 chunks of 16 000 samples at n_fft 512, hop
128, the last two chunks silent, as `chip_smoke.py`'s stream phase checks
K1) it draws CASES (default 400) inputs of two harmonic tones and -34 dB
noise each, from seeds 0, 1, ..., and prints one JSON line: how many cases
differ by more than 1e-3 at some bin (the stream phase's tolerance, which
it holds at every bin), the largest and the median difference, the level
of the bin where each case differs most (|X| over its frame's RMS |X|),
and at that bin how far each f32 version lies from log|X| computed in
float64 on the same f32 window.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from gan_sass_tf_tpu_torch.dsp.windows import get_window
from gan_sass_tf_tpu_torch.ops import stft_features as k1

B, T, SR, N_FFT, HOP, SILENT = 8, 16000, 16000, 512, 128, 2
TOL = 1e-3


def tones(rng, b: int, t: int, sr: int) -> np.ndarray:
    """Two harmonic tones per signal plus noise (chip_smoke.mixtures)."""
    n = np.arange(t) / sr
    out = []
    for _ in range(b):
        f1, f2 = rng.uniform(100, 300), rng.uniform(400, 1200)
        s1 = sum(np.sin(2 * np.pi * h * f1 * n) / h for h in (1, 2, 3))
        s2 = sum(np.sin(2 * np.pi * h * f2 * n) / h for h in (1, 2))
        out.append(0.3 * s1 + 0.2 * s2 + 0.02 * rng.standard_normal(t))
    return np.stack(out).astype(np.float32)


def case(seed: int, dev, window64) -> dict:
    x = torch.from_numpy(tones(np.random.default_rng(seed), B, T, SR)).to(dev)
    x[-SILENT:] = 0.0
    ker = k1.stft_features_kernel(x, N_FFT, HOP, emit=("logmag",))["logmag"]
    ref = k1.stft_features_reference(x, N_FFT, HOP, emit=("logmag",))["logmag"]
    exact = torch.stft(x.double(), N_FFT, HOP, window=window64, center=False,
                       return_complex=True).abs().transpose(-1, -2)
    diff = (ker - ref).abs()
    b, f, k = np.unravel_index(int(diff.argmax()), diff.shape)
    log64 = torch.log(exact[b, f, k] + 1e-8)
    rms = exact[b, f].square().mean().sqrt()
    return {"seed": seed, "max_err": float(diff.max()),
            "mag_over_frame_rms": float(exact[b, f, k] / rms),
            "kernel_vs_f64": float((ker[b, f, k] - log64).abs()),
            "plain_vs_f64": float((ref[b, f, k] - log64).abs())}


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device is visible")
    cases = int(argv[0]) if argv else 400
    dev = torch.device("cuda", 0)
    window64 = torch.from_numpy(get_window("hann", N_FFT)).to(dev).double()
    rows = [case(seed, dev, window64) for seed in range(cases)]
    over = [r for r in rows if r["max_err"] > TOL]
    errs = [r["max_err"] for r in rows]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "shape": [B, T], "n_fft": N_FFT,
        "hop": HOP, "cases": cases, "tol": TOL, "over_tol": len(over),
        "max_err_max": max(errs), "max_err_median": float(np.median(errs)),
        "over_tol_mag_over_frame_rms_max": max(
            (r["mag_over_frame_rms"] for r in over), default=None),
        "over_tol_kernel_closer_to_f64": sum(
            r["kernel_vs_f64"] < r["plain_vs_f64"] for r in over),
        "over_tol_kernel_vs_f64_max": max((r["kernel_vs_f64"] for r in over), default=None),
        "over_tol_plain_vs_f64_max": max((r["plain_vs_f64"] for r in over), default=None),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
