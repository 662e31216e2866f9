#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
  1 device    the card's name; nvidia-smi's name and power limit line
  2 build     nvcc builds both CUDA kernels from ops/csrc (seconds)
  3 k1        stft_features kernel vs its plain version at the shapes of
              the wsj0_logmel path, a 60 s input and two other geometries
  4 k2        masked_istft kernel vs its plain version (magnitude and
              complex masks, 60 s input, STFT -> iSTFT round trip)
  5 main_path the CLI `separate` on a 3 s and a 60 s wav and `separate()`
              on 16 x 3 s mixtures, with seeded-random weights at the full
              wsj0_logmel width; both kernels must have launched, and the
              same call on the plain DSP path must agree (SI-SDR >= 40 dB)
  6 timing    median per-call time of each kernel's wrapper beside its plain
              version (CUDA events around back-to-back calls), and
              separate() throughput on both paths
Then a `kernels` summary line and, last, the result line.  Any failed
check exits non-zero before the result line.  Needs one CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gan_sass_tf_tpu_torch import cli, config
from gan_sass_tf_tpu_torch.dsp.features import mel_filterbank
from gan_sass_tf_tpu_torch.infer import separate
from gan_sass_tf_tpu_torch.losses import si_sdr
from gan_sass_tf_tpu_torch.models import (
    build_generator,
    load_flax_npz,
    load_generator,
    save_flax_npz,
)
from gan_sass_tf_tpu_torch.ops import build, dispatch
from gan_sass_tf_tpu_torch.ops import masked_istft as k2
from gan_sass_tf_tpu_torch.ops import stft_features as k1
from gan_sass_tf_tpu_torch.utils.wav_io import read_wav, write_wav

SEED = 0
SR, N_FFT, HOP, N_MELS = 8000, 512, 128, 80
B_MAIN, T_MAIN = 16, 23936          # wsj0_logmel segment: F = 184
T_LONG = 480000                      # 60 s at 8 kHz: F = 3747
TIMING_SAMPLES = 20                  # per path; each the mean of CALLS_PER_SAMPLE
CALLS_PER_SAMPLE = 10


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def mixtures(rng, b: int, t: int) -> np.ndarray:
    """Two harmonic tones per mixture plus noise."""
    n = np.arange(t) / SR
    out = []
    for _ in range(b):
        f1, f2 = rng.uniform(100, 300), rng.uniform(400, 1200)
        s1 = sum(np.sin(2 * np.pi * h * f1 * n) / h for h in (1, 2, 3))
        s2 = sum(np.sin(2 * np.pi * h * f2 * n) / h for h in (1, 2))
        out.append(0.3 * s1 + 0.2 * s2 + 0.02 * rng.standard_normal(t))
    return np.stack(out).astype(np.float32)


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 parity is the point
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return kind


def phase_build() -> None:
    t0 = time.perf_counter()
    build.load_library()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=build.build_seconds,
         library=build.library_path().name, ptxas=ptxas)


def k1_case(x, n_fft, hop, emits, mel):
    ker = k1.stft_features_kernel(x, n_fft, hop, emit=emits, mel_matrix=mel)
    ref = k1.stft_features_reference(x, n_fft, hop, emit=emits, mel_matrix=mel)
    torch.cuda.synchronize()
    scale = float(ref["spec"].abs().max()) if "spec" in ref else 1.0
    errs = {}
    for key in emits:
        errs[key] = max_err(ker[key], ref[key])
        tol = 3e-4 * scale if key in ("spec", "mag") else 1e-3
        check(ker[key].shape == ref[key].shape, f"k1 {key} shape")
        check(errs[key] <= tol, f"k1 {key} at n_fft {n_fft} hop {hop} shape "
              f"{tuple(x.shape)}: max err {errs[key]} > {tol}")
    return errs, ker


def phase_k1(rng, dev):
    mel = torch.from_numpy(mel_filterbank(N_MELS, N_FFT // 2 + 1, SR)).to(dev)
    x = torch.from_numpy(rng.standard_normal((B_MAIN, T_MAIN), np.float32)).to(dev)
    main_errs, ker = k1_case(x, N_FFT, HOP, ("spec", "logmel"), mel)
    emit("k1", shape=[B_MAIN, T_MAIN], frames=ker["spec"].shape[-2],
         max_abs_err=main_errs, tol="spec 3e-4*max|X|, logmel 1e-3")
    xl = torch.from_numpy(rng.standard_normal((1, T_LONG), np.float32)).to(dev)
    errs, kl = k1_case(xl, N_FFT, HOP, ("spec", "logmel"), mel)
    emit("k1", shape=[1, T_LONG], frames=kl["spec"].shape[-2], max_abs_err=errs)
    for n_fft, hop, sr in ((256, 64, 8000), (2048, 512, 44100)):
        m = torch.from_numpy(mel_filterbank(N_MELS, n_fft // 2 + 1, sr)).to(dev)
        xs = torch.from_numpy(rng.standard_normal((2, 8000), np.float32)).to(dev)
        errs, _ = k1_case(xs, n_fft, hop, ("spec", "mag", "logmag", "logmel"), m)
        emit("k1", n_fft=n_fft, hop=hop, shape=[2, 8000], max_abs_err=errs)
    return x, ker["spec"], main_errs["spec"]


def k2_case(spec, masks, n_fft, hop, mask_type):
    ker = k2.masked_istft_kernel(spec, masks, n_fft, hop, mask_type=mask_type)
    ref = k2.masked_istft_reference(spec, masks, n_fft, hop, mask_type=mask_type)
    torch.cuda.synchronize()
    check(ker.shape == ref.shape, f"k2 shape {ker.shape} != {ref.shape}")
    interior = (ker - ref)[..., hop:-hop].abs()
    ok_in = bool((interior <= 3e-4 + 1e-3 * ref[..., hop:-hop].abs()).all())
    full = max_err(ker, ref)
    tol_full = 1e-3 * float(ref.abs().max())
    check(ok_in, f"k2 {mask_type} interior at n_fft {n_fft}: max err "
          f"{float(interior.max())} over atol 3e-4 rtol 1e-3")
    check(full <= tol_full, f"k2 {mask_type} full length: {full} > {tol_full}")
    return float(interior.max()), full


def phase_k2(rng, dev, x, spec):
    f, k = spec.shape[-2:]
    errs = {}
    for mask_type in ("magnitude", "complex"):
        shape = (B_MAIN, 2, f, k) + ((2,) if mask_type == "complex" else ())
        lo = 0.0 if mask_type == "magnitude" else -1.0
        masks = torch.from_numpy(rng.uniform(lo, 1, shape).astype(np.float32)).to(dev)
        interior, full = k2_case(spec, masks, N_FFT, HOP, mask_type)
        errs[mask_type] = full
        emit("k2", mask_type=mask_type, masks=list(shape),
             max_abs_err_interior=interior, max_abs_err_full=full,
             tol="interior atol 3e-4 rtol 1e-3; full 1e-3*max|y|")
    xl = torch.from_numpy(rng.standard_normal((1, T_LONG), np.float32)).to(dev)
    sl = k1.stft_features_reference(xl, N_FFT, HOP)["spec"]
    ml = torch.from_numpy(rng.uniform(0, 1, (1, 2) + tuple(sl.shape[-2:]))
                          .astype(np.float32)).to(dev)
    interior, full = k2_case(sl, ml, N_FFT, HOP, "magnitude")
    emit("k2", mask_type="magnitude", frames=sl.shape[-2],
         max_abs_err_interior=interior, max_abs_err_full=full)
    for n_fft, hop in ((256, 64), (2048, 512)):
        xs = torch.from_numpy(rng.standard_normal((2, 8000), np.float32)).to(dev)
        ss = k1.stft_features_reference(xs, n_fft, hop)["spec"]
        ms = torch.from_numpy(rng.uniform(-1, 1, (2, 3) + tuple(ss.shape[-2:]) + (2,))
                              .astype(np.float32)).to(dev)
        interior, full = k2_case(ss, ms, n_fft, hop, "complex")
        emit("k2", n_fft=n_fft, hop=hop, max_abs_err_interior=interior,
             max_abs_err_full=full)
    # Round trip: K2(K1(x).spec, masks = 1) gives x back on the interior.
    ones = torch.ones((B_MAIN, 1, f, k), device=dev)
    y = k2.masked_istft_kernel(spec, ones, N_FFT, HOP)[:, 0]
    t_grid = y.shape[-1]
    rt = max_err(y[:, HOP:t_grid - HOP], x[:, HOP:t_grid - HOP])
    check(rt <= 2e-4, f"k1 -> k2 round trip: max err {rt} > 2e-4")
    emit("k2", round_trip_max_abs_err=rt, tol=2e-4)
    return errs["magnitude"]


def phase_main_path(rng, dev, tmp: Path):
    cfg = config.get_config("wsj0_logmel")
    g0 = build_generator(cfg, "cpu", seed=SEED)
    params = tmp / "g.npz"
    save_flax_npz(str(params), g0.state_dict())
    n_params = sum(p.numel() for p in g0.parameters())
    wav3, wav60 = tmp / "mix3s.wav", tmp / "mix60s.wav"
    write_wav(str(wav3), SR, mixtures(rng, 1, 3 * SR)[0])
    write_wav(str(wav60), SR, mixtures(rng, 1, 60 * SR)[0])
    batch = mixtures(rng, B_MAIN, 3 * SR)
    g = load_generator(cfg, load_flax_npz(str(params)), dev)

    k1.launches = k2.launches = 0
    for wav in (wav3, wav60):
        rc = cli.main(["separate", "--config", "wsj0_logmel", "--params",
                       str(params), "--input", str(wav), "--output-dir",
                       str(tmp / "out")])
        check(rc == 0, f"cli separate {wav.name} exited {rc}")
    out = separate(g, cfg, batch, dev)
    torch.cuda.synchronize()
    counts = {"stft_features": k1.launches, "masked_istft": k2.launches}
    check(min(counts.values()) > 0, f"a kernel never launched: {counts}")

    for wav in (wav3, wav60):
        t = read_wav(str(wav))[1].shape[0]
        srcs = np.stack([read_wav(str(tmp / "out" / f"{wav.stem}_src{i}.wav"))[1]
                         for i in range(cfg.data.num_sources)])
        check(srcs.shape == (cfg.data.num_sources, t), f"{wav.name}: {srcs.shape}")
        check(np.isfinite(srcs).all(), f"{wav.name}: non-finite output")
    check(out.shape == (B_MAIN, cfg.data.num_sources, 3 * SR), f"batch {out.shape}")
    check(np.isfinite(out).all(), "batch: non-finite output")

    long_mix = read_wav(str(wav60))[1]
    out_long = separate(g, cfg, long_mix, dev)
    with dispatch.force_backend("reference"):
        ref = separate(g, cfg, batch, dev)
        ref_long = separate(g, cfg, long_mix, dev)
    agree = si_sdr(torch.from_numpy(out), torch.from_numpy(ref))
    agree_long = si_sdr(torch.from_numpy(out_long), torch.from_numpy(ref_long))
    worst = min(float(agree.min()), float(agree_long.min()))
    check(worst >= 40.0, f"kernel vs plain DSP path: SI-SDR {worst} dB < 40")
    emit("main_path", params=n_params, launches=counts,
         outputs={"cli_3s": [2, 3 * SR], "cli_60s": [2, 60 * SR],
                  "batch": list(out.shape)},
         si_sdr_kernel_vs_plain_db={"batch_min": float(agree.min()),
                                    "long_min": float(agree_long.min())},
         tol_db=40.0)
    return cfg, g, batch, counts


def time_pair(plain, kernel, samples=TIMING_SAMPLES, calls=CALLS_PER_SAMPLE):
    """Median per-call ms of each: CUDA events around `calls` back-to-back
    calls make one sample; samples alternate plain, kernel, kernel, plain."""
    fns = {"plain": plain, "kernel": kernel}
    for _ in range(3):
        plain()
        kernel()
    torch.cuda.synchronize()
    times = {"plain": [], "kernel": []}
    for i in range(2 * samples):
        name = ("plain", "kernel", "kernel", "plain")[i % 4]
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fns[name]()
        b.record()
        b.synchronize()
        times[name].append(a.elapsed_time(b) / calls)
    return statistics.median(times["plain"]), statistics.median(times["kernel"])


def phase_timing(rng, dev, x, spec, cfg, g, batch):
    mel = torch.from_numpy(mel_filterbank(N_MELS, N_FFT // 2 + 1, SR)).to(dev)
    emits = ("spec", "logmel")
    k1_plain, k1_ms = time_pair(
        lambda: k1.stft_features_reference(x, N_FFT, HOP, emit=emits, mel_matrix=mel),
        lambda: k1.stft_features_kernel(x, N_FFT, HOP, emit=emits, mel_matrix=mel))
    masks = torch.from_numpy(rng.uniform(0, 1, (B_MAIN, 2) + tuple(spec.shape[-2:]))
                             .astype(np.float32)).to(dev)
    k2_plain, k2_ms = time_pair(
        lambda: k2.masked_istft_reference(spec, masks, N_FFT, HOP),
        lambda: k2.masked_istft_kernel(spec, masks, N_FFT, HOP))

    def run_sep(path):
        def go():
            with dispatch.force_backend(path):
                separate(g, cfg, batch, dev)
        return go

    sep_plain, sep_kernel = time_pair(run_sep("reference"), run_sep(None))
    audio_s = batch.shape[0] * batch.shape[1] / SR
    emit("timing", shape=[B_MAIN, T_MAIN], samples=TIMING_SAMPLES,
         calls_per_sample=CALLS_PER_SAMPLE,
         stft_features_ms={"kernel": k1_ms, "plain": k1_plain},
         masked_istft_ms={"kernel": k2_ms, "plain": k2_plain},
         separate_ms={"kernel": sep_kernel, "plain": sep_plain},
         separate_mix_sec_per_sec={"kernel": audio_s / sep_kernel * 1e3,
                                   "plain": audio_s / sep_plain * 1e3},
         note="separate() includes host->device copy and the result's copy back")
    return {"stft_features": (k1_ms, k1_plain), "masked_istft": (k2_ms, k2_plain)}


def main() -> int:
    kind = phase_device()
    phase_build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    x, spec, k1_err = phase_k1(rng, dev)
    k2_err = phase_k2(rng, dev, x, spec)
    with tempfile.TemporaryDirectory() as tmp:
        cfg, g, batch, counts = phase_main_path(rng, dev, Path(tmp))
    times = phase_timing(rng, dev, x, spec, cfg, g, batch)
    kernels = [
        {"name": "stft_features", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/stft_features.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_stft.py:63",
         "launches": counts["stft_features"], "max_abs_err": k1_err,
         "ms": times["stft_features"][0], "plain_ms": times["stft_features"][1]},
        {"name": "masked_istft", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/masked_istft.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_istft.py:175",
         "launches": counts["masked_istft"], "max_abs_err": k2_err,
         "ms": times["masked_istft"][0], "plain_ms": times["masked_istft"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
