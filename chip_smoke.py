#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
  1 device    the card's name; nvidia-smi's name and power limit line
  2 build     nvcc builds the CUDA kernels from ops/csrc (seconds)
  3 k1        stft_features kernel vs its plain version at the shapes of
              the wsj0_logmel path, a 60 s input and two other geometries
  4 k2        masked_istft kernel vs its plain version (magnitude and
              complex masks, 60 s input, STFT -> iSTFT round trip)
  5 main_path the CLI `separate` on a 3 s and a 60 s wav and `separate()`
              on 16 x 3 s mixtures, with seeded-random weights at the full
              wsj0_logmel width; both kernels must have launched, and the
              same call on the plain DSP path must agree (SI-SDR >= 40 dB)
  6 k3        the differentiable iSTFT (forward kernel, backward on the
              stft_features kernel) vs its plain version and autograd, at
              the stream_v5e8 train shape and two other geometries
  7 train     Experiment(stream_v5e8).train() at full width, batch 32: the
              losses finite, G and D moved, the three kernels of the step
              launched; one step from one state on the kernel and the plain
              DSP path agrees; evaluate(); the CLI trains wsj0_logmel
  8 k4        the complex STFT kernel vs its plain version at the
              stream_v5e8 oracle shapes (32 mixtures, 32 x 2 sources), the
              music_complex_44k shape (8 x 2 sources, n_fft 2048), a 60 s
              input and an encoded win_length < n_fft window
  9 bounds    scripts.recompute_bounds for stream_v5e8, wsj0_logmel,
              3src_pit and music_complex_44k, easy and --hard: the stft and
              masked_istft kernels launched; the bound on the kernel path
              within 0.01 dB of the plain path and within 1.0 dB of the JAX
              package's number on the CPU
 10 quality   scripts.quality_protocol at full width: stream_v5e8 --hard
              --seeds 0,7 and music_complex_44k (batch 8, G (64, 64, 128,
              256)); the JAX script's keys, finite values, the kernels of
              each path launched; the music train step's wall ms and peak
              device memory
 11 timing    median per-call time of each kernel's wrapper beside its plain
              version (CUDA events around back-to-back calls), separate()
              throughput, the stream_v5e8 train step on both DSP paths and
              the wall seconds of one recompute_bounds per preset
Then a `kernels` summary line and, last, the result line.  Any failed
check exits non-zero before the result line.  Needs one CUDA device.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
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
from gan_sass_tf_tpu_torch.ops import istft as k3
from gan_sass_tf_tpu_torch.ops import masked_istft as k2
from gan_sass_tf_tpu_torch.ops import stft as k4
from gan_sass_tf_tpu_torch.ops import stft_features as k1
from gan_sass_tf_tpu_torch.scripts import quality_protocol, recompute_bounds
from gan_sass_tf_tpu_torch.train import Experiment
from gan_sass_tf_tpu_torch.utils.wav_io import read_wav, write_wav

SEED = 0
SR, N_FFT, HOP, N_MELS = 8000, 512, 128, 80
B_MAIN, T_MAIN = 16, 23936          # wsj0_logmel segment: F = 184
T_LONG = 480000                      # 60 s at 8 kHz: F = 3747
TIMING_SAMPLES = 20                  # per path; each the mean of CALLS_PER_SAMPLE
CALLS_PER_SAMPLE = 10
B_TRAIN, T_TRAIN = 64, 32000         # stream_v5e8 step: B·S signals, 2 s at 16 kHz
TRAIN_STEPS = 6
STEP_SAMPLES = 12                    # timed train steps per DSP path
MUSIC_N_FFT, MUSIC_HOP = 2048, 512
B_MUSIC, T_MUSIC = 8, 132300         # music_complex_44k: 3 s at 44.1 kHz, F = 255
PRESETS = ("stream_v5e8", "wsj0_logmel", "3src_pit", "music_complex_44k")
# The JAX package's oracle bounds (dB) on the CPU, from
#   JAX_PLATFORMS=cpu python scripts/recompute_bounds.py PRESET [--hard] --cpu
# keyed (preset, hard).  The port mixes with its counter RNG, not
# jax.random, so its bounds differ by that sampling alone (0.09 dB at
# most, both on the CPU).
JAX_CPU_BOUNDS = {
    ("stream_v5e8", False): 24.06, ("stream_v5e8", True): 13.29,
    ("wsj0_logmel", False): 25.11, ("wsj0_logmel", True): 14.79,
    ("3src_pit", False): 24.37, ("3src_pit", True): 9.85,
    ("music_complex_44k", False): 23.71, ("music_complex_44k", True): 23.73,
}
BOUND_TOL_DB, JAX_BOUND_TOL_DB = 0.01, 1.0
QUALITY_STREAM_STEPS, QUALITY_MUSIC_STEPS = 10, 4
# The keys of scripts/quality_protocol.py's JSON line (tests/test_torch_oracle.py
# holds the port's key set equal to the JAX script's).
QUALITY_KEYS = {
    "preset", "hard", "steps", "seeds", "si_sdr_improvement",
    "si_sdr_improvement_per_seed", "si_sdr_improvement_half_range",
    "si_sdr_improvement_train_dist", "oracle_bound", "headroom", "d_loss",
    "d_loss_traj_per_seed", "d_norm", "throughput",
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).detach().abs().max())


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


def k3_case(rng, dev, b, t, n_fft, hop):
    """Forward and gradient of the kernel path against the plain path on the
    STFT planes of noise; returns the errors and the tensors for timing."""
    x = torch.from_numpy(rng.standard_normal((b, t), np.float32)).to(dev)
    spec = k1.stft_features_reference(x, n_fft, hop)["spec"]
    re = spec.real.contiguous().requires_grad_()
    im = spec.imag.contiguous().requires_grad_()
    y = k3.istft_kernel(re, im, n_fft, hop)
    ref = k3.istft_reference(re, im, n_fft, hop)
    dy = torch.randn_like(ref)
    g_ker = torch.autograd.grad(y, (re, im), dy, retain_graph=True)
    g_ref = torch.autograd.grad(ref, (re, im), dy, retain_graph=True)
    torch.cuda.synchronize()
    check(y.shape == ref.shape, f"k3 shape {y.shape} != {ref.shape}")
    inner = (y - ref)[..., hop:-hop].abs()
    ok_in = bool((inner <= 2e-4 + 1e-3 * ref[..., hop:-hop].abs()).all())
    full, tol_full = max_err(y, ref), 1e-3 * float(ref.abs().max())
    check(ok_in, f"k3 forward interior at n_fft {n_fft}: max err "
          f"{float(inner.max())} over atol 2e-4 rtol 1e-3")
    check(full <= tol_full, f"k3 forward full length: {full} > {tol_full}")
    grad_errs = []
    for a, r in zip(g_ker, g_ref):
        scale = float(r.abs().max())
        ok = bool(((a - r).abs() <= 5e-4 * scale + 1e-3 * r.abs()).all())
        grad_errs.append(max_err(a, r))
        check(ok, f"k3 backward at n_fft {n_fft}: max err {grad_errs[-1]} "
              f"over atol 5e-4*{scale} rtol 1e-3")
    errs = {"forward_interior": float(inner.max()), "forward_full": full,
            "grad_re": grad_errs[0], "grad_im": grad_errs[1]}
    return errs, (re, im, y, ref, dy)


def phase_k3(rng, dev):
    errs, tensors = k3_case(rng, dev, B_TRAIN, T_TRAIN, N_FFT, HOP)
    f = tensors[0].shape[-2]
    emit("k3", signals=B_TRAIN, frames=f, bins=N_FFT // 2 + 1, max_abs_err=errs,
         tol="forward interior atol 2e-4 rtol 1e-3, full 1e-3*max|y|; "
             "grad atol 5e-4*max|grad| rtol 1e-3")
    for n_fft, hop in ((256, 64), (2048, 512)):
        e, _ = k3_case(rng, dev, 3, 8000, n_fft, hop)
        emit("k3", n_fft=n_fft, hop=hop, signals=3, max_abs_err=e)
    return errs, tensors


def phase_train(dev):
    cfg = config.get_config("stream_v5e8")
    exp = Experiment(cfg, device=dev)
    g0 = [p.detach().clone() for p in exp.state.g.parameters()]
    d0 = [p.detach().clone() for p in exp.state.d.parameters()]
    k1.launches = k3.launches = k3.bwd_launches = 0
    t0 = time.perf_counter()
    last = exp.train(num_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"stft_features": k1.launches, "istft": k3.launches,
              "istft_bwd": k3.bwd_launches}
    check(min(counts.values()) > 0, f"a kernel of the train step never "
          f"launched: {counts}")
    check(all(np.isfinite(v) for v in last.values()), f"non-finite: {last}")
    moved = {"g": max(max_err(a, p) for a, p in zip(g0, exp.state.g.parameters())),
             "d": max(max_err(a, p) for a, p in zip(d0, exp.state.d.parameters()))}
    check(min(moved.values()) > 0, f"a net did not move: {moved}")

    # One step from one state and one batch on each DSP path.
    step = exp._train_step
    out = {}
    for path in (None, "reference"):
        state = copy.deepcopy(exp.state)
        with dispatch.force_backend(path):
            _, m = step(state, exp._bank, exp._train_seed)
        out[path or "kernel"] = {k: float(v) for k, v in m.items()}
    gaps = {}
    for key in ("g_recon", "d_loss"):
        a, b = out["kernel"][key], out["reference"][key]
        # -SI-SDR is in dB and may sit near 0, so the relative gap has a
        # floor of 1 (0.01 dB); d_loss is O(1).
        gaps[key] = abs(a - b) / max(abs(b), 1.0)
        check(gaps[key] <= 1e-2, f"train step {key}: kernel {a} vs plain {b}")
    ev = exp.evaluate(num_batches=2)
    check(all(np.isfinite(v) for v in ev.values()), f"eval non-finite: {ev}")
    rc = cli.main(["train", "--config", "wsj0_logmel", "--steps", "2"])
    check(rc == 0, f"cli train wsj0_logmel exited {rc}")
    emit("train", config="stream_v5e8", batch=cfg.train.batch_size,
         segment_samples=cfg.segment_samples, steps=TRAIN_STEPS,
         g_params=sum(p.numel() for p in exp.state.g.parameters()),
         d_params=sum(p.numel() for p in exp.state.d.parameters()),
         wall_s=wall, last=last, launches=counts, moved_max_abs=moved,
         one_step={"kernel": out["kernel"], "plain": out["reference"]},
         gap=gaps, tol="|kernel - plain| <= 1e-2 * max(|plain|, 1)",
         eval=ev, cli_wsj0_logmel_rc=rc)
    return exp, counts


def k4_check(ker, ref, what):
    """K4 kernel vs plain: complex64, one shape, and |ker - ref| within
    atol 3e-4·max|X| + rtol 1e-3 (tests/test_pallas.py)."""
    check(ker.dtype == torch.complex64, f"k4 {what}: dtype {ker.dtype}")
    check(ker.shape == ref.shape, f"k4 {what}: shape {ker.shape} != {ref.shape}")
    err = (ker - ref).abs()
    atol = 3e-4 * float(ref.abs().max())
    ok = bool((err <= atol + 1e-3 * ref.abs()).all())
    check(ok, f"k4 {what}: max err {float(err.max())} over atol {atol} rtol 1e-3")
    return float(err.max())


def phase_k4(rng, dev):
    def noise(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)

    stream_srcs = noise(B_TRAIN // 2, 2, T_TRAIN)
    music_srcs = noise(B_MUSIC, 2, T_MUSIC)
    cases = [
        ("stream_v5e8 mixtures", noise(B_TRAIN // 2, T_TRAIN), N_FFT, HOP),
        ("stream_v5e8 sources", stream_srcs, N_FFT, HOP),
        ("music_complex_44k sources", music_srcs, MUSIC_N_FFT, MUSIC_HOP),
        ("60 s at 8 kHz", noise(1, T_LONG), N_FFT, HOP),
    ]
    errs = {}
    for what, x, n_fft, hop in cases:
        ker = k4.stft_kernel(x, n_fft, hop)
        ref = k4.stft_reference(x, n_fft, hop)
        torch.cuda.synchronize()
        errs[what] = k4_check(ker, ref, what)
        emit("k4", case=what, shape=list(x.shape), n_fft=n_fft, hop=hop,
             out=list(ker.shape), max_abs_err=errs[what],
             tol="atol 3e-4*max|X|, rtol 1e-3")
    x = noise(4, 8000)
    ker = dispatch.stft(x, N_FFT, HOP, win_length=400)
    with dispatch.force_backend("reference"):
        ref = dispatch.stft(x, N_FFT, HOP, win_length=400)
    torch.cuda.synchronize()
    check(ker.shape[-2] == 1 + (8000 - 400) // HOP, f"k4 win_length: {ker.shape}")
    errs["win_length 400"] = k4_check(ker, ref, "win_length 400 via dispatch")
    emit("k4", case="win_length 400 < n_fft 512 via dispatch.stft",
         out=list(ker.shape), max_abs_err=errs["win_length 400"])
    return max(errs.values()), stream_srcs, music_srcs


def captured_json(fn, argv):
    """Run an entry point's main(argv) and parse the JSON line it prints
    last on stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    check(rc == 0, f"{fn.__module__}.main({argv}) returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_bounds(dev):
    """recompute_bounds on the kernel path for each preset and protocol,
    then the same batches on both DSP paths, unrounded."""
    launches, walls = {"stft": 0, "masked_istft": 0}, {}
    for preset in PRESETS:
        for hard in (False, True):
            argv = [preset, "--device", str(dev)] + (["--hard"] if hard else [])
            k4.launches = k2.launches = 0
            t0 = time.perf_counter()
            line = captured_json(recompute_bounds.main, argv)
            wall = time.perf_counter() - t0
            counts = {"stft": k4.launches, "masked_istft": k2.launches}
            check(min(counts.values()) > 0, f"bounds {argv}: a kernel never "
                  f"launched: {counts}")
            for k, v in counts.items():
                launches[k] += v
            walls[f"{preset}{' --hard' if hard else ''}"] = wall
            cfg = recompute_bounds.protocol_config(preset, hard)
            kernel = recompute_bounds.oracle_bound(cfg, dev)
            with dispatch.force_backend("reference"):
                plain = recompute_bounds.oracle_bound(cfg, dev)
            jax_db = JAX_CPU_BOUNDS[(preset, hard)]
            check(line["oracle_bound"] == round(kernel, 2),
                  f"bounds {argv}: printed {line['oracle_bound']}, kernel "
                  f"path {kernel}")
            check(abs(kernel - plain) <= BOUND_TOL_DB,
                  f"bounds {argv}: kernel {kernel} vs plain {plain} dB")
            check(abs(kernel - jax_db) <= JAX_BOUND_TOL_DB,
                  f"bounds {argv}: {kernel} dB vs the JAX package's {jax_db}")
            emit("bounds", preset=preset, hard=hard, line=line,
                 kernel_db=kernel, plain_db=plain, jax_cpu_db=jax_db,
                 kernel_minus_plain_db=kernel - plain,
                 port_minus_jax_db=kernel - jax_db, launches=counts,
                 wall_s=wall, tol_db={"plain": BOUND_TOL_DB,
                                      "jax_cpu": JAX_BOUND_TOL_DB})
    return launches, walls


def finite(value) -> bool:
    if isinstance(value, list):
        return all(finite(v) for v in value)
    return not isinstance(value, float) or math.isfinite(value)


def phase_quality(dev):
    """The quality protocol through its main() at full width, then the
    music train step's wall time on both DSP paths and its peak memory."""
    def reset():
        k1.launches = k2.launches = k3.launches = k3.bwd_launches = 0
        k4.launches = 0

    def counts():
        return {"stft_features": k1.launches, "masked_istft": k2.launches,
                "istft": k3.launches, "istft_bwd": k3.bwd_launches,
                "stft": k4.launches}

    runs = {}
    for name, argv, need in (
        ("stream_v5e8 --hard", ["stream_v5e8", str(QUALITY_STREAM_STEPS),
                                "--hard", "--seeds", "0,7", "--device", str(dev)],
         ("stft_features", "masked_istft", "istft", "istft_bwd", "stft")),
        ("music_complex_44k", ["music_complex_44k", str(QUALITY_MUSIC_STEPS),
                               "--device", str(dev)],
         ("stft_features", "masked_istft", "stft")),
    ):
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = captured_json(quality_protocol.main, argv)
        wall = time.perf_counter() - t0
        got = counts()
        check(set(out) == QUALITY_KEYS, f"quality {name}: keys {sorted(out)}")
        check(all(finite(v) for v in out.values()), f"quality {name}: {out}")
        check(all(got[k] > 0 for k in need), f"quality {name}: a kernel of "
              f"the path never launched: {got}")
        runs[name] = {"line": out, "launches": got, "wall_s": wall,
                      "peak_mib": torch.cuda.max_memory_allocated() / 2**20}

    cfg = quality_protocol.protocol_config("music_complex_44k", False)
    exp = Experiment(cfg, device=dev)
    step_kernel, step_plain = time_steps(exp)
    torch.cuda.reset_peak_memory_stats()
    exp._train_step(exp.state, exp._bank, exp._train_seed)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    mix_s = cfg.train.batch_size * cfg.segment_samples / cfg.dsp.sample_rate
    emit("quality", runs=runs, music_step={
        "batch": cfg.train.batch_size, "segment_samples": cfg.segment_samples,
        "g_channels": list(cfg.model.g_channels),
        "g_params": sum(p.numel() for p in exp.state.g.parameters()),
        "d_params": sum(p.numel() for p in exp.state.d.parameters()),
        "wall_ms": {"kernel": step_kernel, "plain": step_plain},
        "mixture_sec_per_sec": {"kernel": mix_s / step_kernel * 1e3,
                                "plain": mix_s / step_plain * 1e3},
        "peak_device_mib": peak})
    return runs


def time_steps(exp):
    """Median wall ms of one train step (synchronized) on each DSP path,
    samples alternating kernel, plain, plain, kernel."""
    def one(path):
        with dispatch.force_backend(path):
            t0 = time.perf_counter()
            exp._train_step(exp.state, exp._bank, exp._train_seed)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        one(None)
        one("reference")
    times = {None: [], "reference": []}
    for i in range(2 * STEP_SAMPLES):
        path = (None, "reference", "reference", None)[i % 4]
        times[path].append(one(path))
    return statistics.median(times[None]), statistics.median(times["reference"])


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


def phase_timing(rng, dev, x, spec, cfg, g, batch, k3_tensors, exp, k4_inputs,
                 bound_walls):
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
    re, im, y, ref, dy = k3_tensors
    with torch.no_grad():
        k3_plain, k3_ms = time_pair(
            lambda: k3.istft_reference(re, im, N_FFT, HOP),
            lambda: k3.istft_kernel(re, im, N_FFT, HOP))
    bwd_plain, bwd_ms = time_pair(
        lambda: torch.autograd.grad(ref, (re, im), dy, retain_graph=True),
        lambda: torch.autograd.grad(y, (re, im), dy, retain_graph=True))
    stream_srcs, music_srcs = k4_inputs
    k4_plain, k4_ms = time_pair(lambda: k4.stft_reference(stream_srcs, N_FFT, HOP),
                                lambda: k4.stft_kernel(stream_srcs, N_FFT, HOP))
    k4_music_plain, k4_music_ms = time_pair(
        lambda: k4.stft_reference(music_srcs, MUSIC_N_FFT, MUSIC_HOP),
        lambda: k4.stft_kernel(music_srcs, MUSIC_N_FFT, MUSIC_HOP))
    step_kernel, step_plain = time_steps(exp)
    mix_s = exp.cfg.train.batch_size * exp.cfg.segment_samples / exp.cfg.dsp.sample_rate
    emit("timing", shape=[B_MAIN, T_MAIN], samples=TIMING_SAMPLES,
         calls_per_sample=CALLS_PER_SAMPLE,
         stft_features_ms={"kernel": k1_ms, "plain": k1_plain},
         masked_istft_ms={"kernel": k2_ms, "plain": k2_plain},
         separate_ms={"kernel": sep_kernel, "plain": sep_plain},
         separate_mix_sec_per_sec={"kernel": audio_s / sep_kernel * 1e3,
                                   "plain": audio_s / sep_plain * 1e3},
         istft_shape=list(re.shape),
         istft_ms={"kernel": k3_ms, "plain": k3_plain},
         istft_bwd_ms={"kernel": bwd_ms, "plain": bwd_plain},
         train_step_samples=STEP_SAMPLES,
         train_step_ms={"kernel": step_kernel, "plain": step_plain},
         train_mix_sec_per_sec={"kernel": mix_s / step_kernel * 1e3,
                                "plain": mix_s / step_plain * 1e3},
         stft_shape=list(stream_srcs.shape),
         stft_ms={"kernel": k4_ms, "plain": k4_plain},
         stft_music_shape=list(music_srcs.shape),
         stft_music_ms={"kernel": k4_music_ms, "plain": k4_music_plain},
         recompute_bounds_wall_s=bound_walls,
         note="separate() includes host->device copy and the result's copy "
              "back; a train step is timed on the host clock to a synchronize")
    return {"stft_features": (k1_ms, k1_plain), "masked_istft": (k2_ms, k2_plain),
            "istft": (k3_ms, k3_plain), "istft_bwd": (bwd_ms, bwd_plain),
            "stft": (k4_ms, k4_plain)}


def main() -> int:
    kind = phase_device()
    phase_build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    x, spec, k1_err = phase_k1(rng, dev)
    k2_err = phase_k2(rng, dev, x, spec)
    with tempfile.TemporaryDirectory() as tmp:
        cfg, g, batch, counts = phase_main_path(rng, dev, Path(tmp))
    k3_errs, k3_tensors = phase_k3(rng, dev)
    k4_err, *k4_inputs = phase_k4(rng, dev)
    exp, train_counts = phase_train(dev)
    bound_launches, bound_walls = phase_bounds(dev)
    quality_runs = phase_quality(dev)
    times = phase_timing(rng, dev, x, spec, cfg, g, batch, k3_tensors, exp,
                         k4_inputs, bound_walls)
    k4_launches = bound_launches["stft"] + sum(
        r["launches"]["stft"] for r in quality_runs.values())
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
        {"name": "istft", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/masked_istft.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_istft.py:71",
         "launches": train_counts["istft"], "max_abs_err": k3_errs["forward_full"],
         "ms": times["istft"][0], "plain_ms": times["istft"][1]},
        {"name": "istft_bwd", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/stft_features.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_istft.py:151",
         "launches": train_counts["istft_bwd"],
         "max_abs_err": max(k3_errs["grad_re"], k3_errs["grad_im"]),
         "ms": times["istft_bwd"][0], "plain_ms": times["istft_bwd"][1]},
        {"name": "stft", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/stft_features.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_stft.py:228",
         "launches": k4_launches, "max_abs_err": k4_err,
         "ms": times["stft"][0], "plain_ms": times["stft"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
