#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
  1 device    the card's name; nvidia-smi's name and power limit line
  2 build     nvcc builds the CUDA kernels from ops/csrc (seconds)
  3 k1        stft_features kernel vs its plain version at the shapes of
              the wsj0_logmel path, a 60 s input, two other geometries, the
              music_complex_44k step's two launches (8 mixtures: spec, mag,
              logmag; 16 targets: logmag, spec) and a near-silent signal
  4 k2        masked_istft kernel vs its plain version (magnitude and
              complex masks, 60 s input, STFT -> iSTFT round trip, the
              music_complex_44k bound batch at n_fft 2048, and one frame
              and ROWS + 1 frames, the block's edges)
  5 main_path the CLI `separate` on a 3 s and a 60 s wav and `separate()`
              on 16 x 3 s mixtures, with seeded-random weights at the full
              wsj0_logmel width; both kernels must have launched, and the
              same call on the plain DSP path must agree (SI-SDR >= 40 dB)
  6 k3        the differentiable iSTFT (forward kernel, backward on the
              adjoint kernel) vs its plain version and autograd, at the
              stream_v5e8 train shape, two other geometries and the edges
              of k2
  7 train     Experiment(stream_v5e8).train() at full width, batch 32: the
              losses finite, G and D moved, the three kernels of the step
              launched; one step from one state on the kernel and the plain
              DSP path agrees; the step's device ms by kernel family
              (torch.profiler); evaluate(); the CLI trains wsj0_logmel
    workdir   `cli train --config stream_v5e8 --workdir W` for 4 steps
              (checkpoints and evals every 2) then 2 more that resume at
              step 4: config.json, the checkpoints, best/, best.json and
              metrics.jsonl written, a new Experiment restores a state equal
              to the saved one (save and load wall ms), `cli eval --best`,
              K3 and its backward launched; 2 steps from host batches and 2
              from the device bank on a fixture wav corpus, losses finite
    stream    `cli separate --workdir W --streaming` on a 60 s, 16 kHz wav in
              batch and scan mode: (2, 960 000) finite sources, K1 and K2
              launched exactly once a chunk group (8) and once a chunk
              (62); the kernel path against the plain one, per chunk after
              the best source permutation (SI-SDR >= 40 dB), and whether the
              chained permutations agree; wall ms a stream per mode and
              path, ms a chunk in scan mode, the device-busy share of a
              batch-mode stream; K1 and K2 at the chunk shapes
    dp        data parallel over W = torch.cuda.device_count() NCCL ranks,
              through `python -m torch.distributed.run --standalone
              --nproc_per_node W`: `cli train --config stream_v5e8 --set
              mesh.data_axis_size=-1 --workdir D` for 4 steps (checkpoints
              and evals every 2; each rank runs this script's worker mode,
              which calls cli.main and records the kernels it launched),
              then 2 more resumed at 4 by `-m gan_sass_tf_tpu_torch.cli`
              itself: finite losses, the workdir written once by rank 0,
              K1, K3 and K3's backward launched; one step from one state
              over the group and in this process without one (metrics,
              every state tensor and evaluate(2) within 1e-5 relative at
              W = 1; the ranks' states bitwise equal at W >= 2), the step's
              profile over the group (one NCCL all-reduce a D step, one of
              G's gradients, one of the metrics; NCCL kernels at W >= 2,
              where at W = 1 NCCL completes an in-place SUM without one),
              both steps' wall and device ms, the host ms of the all-reduce
              of G's gradients; `cli separate --streaming`
              (batch mode) of the stream phase's 60 s wav over the group
              against this process's (>= 40 dB a segment after the best
              permutation, the same chained permutations).  At W = 1 the
              line names what only two or more GPUs would run
    pit3     3src_pit at full width (the BiLSTM G 2 x 300 with the film head,
              S = 3 softmax masks, batch 16 x 3 s): whether cuDNN takes the
              LSTM in bf16 and the kernels it runs; the step's device ms by
              kernel family; Experiment.train() for 5 steps (losses finite,
              G and D moved, K1 exactly 2 launches a step), one step on the
              kernel and the plain DSP path, the step's wall ms on both,
              evaluate(); separate() on 16 x 3 s and `cli separate` on a 60 s
              wav (K1 and K2 launched; kernel vs plain SI-SDR >= 40 dB after
              the best of the 6 permutations) and their wall ms; `cli
              train`; quality_protocol 3src_pit --hard --seeds 0 (K1, K2, K4
              launched); K1 at the step's mixture, target and separation
              shapes and K2 on the trained G's masks, against their plain
              versions and timed
    options  the model options at full width: music_complex_44k with the fold
              stem (1, 2) and fold head (one step on each DSP path from one
              state; its step profile, wall ms and peak memory beside the
              default music step's in this process; `cli train` into a
              workdir, 4 steps then 2 resumed; `cli eval`; `cli separate`
              of a 30 s 44.1 kHz wav, kernel vs plain >= 40 dB after the
              best permutation; the quality protocol, K1, K2 and K4
              launched); stream_v5e8 with the patch BN D on the
              frame-folded input, dropout 0.1, the conv stem (1, 2), the
              packed film head, subpixel dec_l0, PhaseConvTranspose and
              g_remat (2 steps, K3 and its backward once a step, one step
              on each DSP path, its step profile and wall ms beside the
              default stream_v5e8 step's, BN statistics finite and moved, G's
              gradients with and without remat within 1e-2 max|g|) and
              one step with the group-norm D; `cli train` 2src_toy_cpu
              with the conv and the toy G
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
              each path launched; the music train step's wall ms, device
              ms by kernel family and peak device memory
 11 timing    median per-call time of each kernel's wrapper beside its plain
              version and, where one PyTorch call computes the same function
              (torch.stft for the STFT kernels), that call (CUDA events
              around back-to-back calls), and the kernels' device ms (CUDA
              events around a replayed CUDA graph of back-to-back calls;
              torch.profiler's reading beside it); K1 at the separation,
              stream step and music step shapes, K2 at the separation and
              music bound shapes, K3's
              whole backward and its adjoint launch alone, K4
              at the stream and music shapes; separate() throughput, the
              stream_v5e8 train step on both DSP paths and the wall seconds
              of one recompute_bounds per preset
 12 tools     the CLI's train flags and the tools at full width: `cli train
              --config stream_v5e8 --workdir W --steps 6 --profile-steps
              2:4 --tensorboard --debug-nans --debug-leaks` in a process of
              its own (a trace is whole only early in its process): the
              Chrome trace under W/profile holds 2 profiled steps and K1,
              K2/K3's synthesis kernel and K3's backward (recorded against
              4/2/2 made), W/tb read back by the port's own reader equals
              W/metrics.jsonl at every logged step, K1, K3 and its backward
              launched exactly 2, 1, 1 a step; the step's wall ms and
              memory_allocated with the debug tripwires and without (in
              turns, reported); entry(): (4, 2, T) finite, the kernel path
              against the plain one >= 40 dB; `profile_step stream_v5e8
              32` in a process of its own: the step's ranges hold >= 95 %
              of the profiled device time; stream_quality at 20 steps
              (finite); bench_presets over the five presets and streaming
              at 1 warm-up and 3 timed steps (every value > 0);
              bench_streaming_compute at 10 s; the quickstart at 4 steps;
              train_wavdir_fixture at its 500 steps (finite, SI-SDRi > 0)
Then a `kernels` summary line (each kernel's launches, summed over the
paths that drive it and by path, each path's counts set to 0 just before
it and read just after, a dp_* path's summed over its ranks; its error; its time beside its plain version's,
the library call's and its bound from the shapes; K1 and K2 also at the
streaming chunk shapes) and, last, the result line.  Any failed check
exits non-zero before the result line, and so does a failed NCCL init or
a rank that exits non-zero.  Needs one CUDA device; the dp phase takes
every visible one.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gan_sass_tf_tpu_torch import cli, config
from gan_sass_tf_tpu_torch import entry as port_entry
from gan_sass_tf_tpu_torch.examples import quickstart
from gan_sass_tf_tpu_torch.data import mix_sources, sample_bank
from gan_sass_tf_tpu_torch.data.fixtures import write_fixture_corpus
from gan_sass_tf_tpu_torch.dsp.features import mel_filterbank
from gan_sass_tf_tpu_torch.dsp.windows import get_window
from gan_sass_tf_tpu_torch.infer import (
    separate,
    separate_streaming,
    separate_streaming_scan,
    streaming,
)
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
from gan_sass_tf_tpu_torch.scripts import (
    bench_presets,
    bench_streaming_compute,
    quality_protocol,
    recompute_bounds,
    stream_quality,
    train_wavdir_fixture,
)
from gan_sass_tf_tpu_torch.losses.pit import permutations_for
from gan_sass_tf_tpu_torch.train import Experiment, build_train_step
from gan_sass_tf_tpu_torch.utils import profiler, tb_events
from gan_sass_tf_tpu_torch.utils.wav_io import read_wav, write_wav

T_START = time.perf_counter()
SCRIPT = Path(__file__).resolve()
ROOT = SCRIPT.parent
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
S_MUSIC = 2                          # its sources: the step's K1 targets are 16
SEED_MUSIC = 44100                   # the K1 music-shape cases' own generator
SEED_SYNTH = 5                       # the K2/K3 music-shape and edge cases' own
LOGMAG_FLOOR = 1e-3                  # -60 dB re the frame's RMS |X| (k1_case)
# The H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s and
# f32 flops/s outside the tensor cores.  A kernel's bound is the larger of
# its bytes and its flops over these.
HBM_BYTES_PER_S, F32_FLOPS_PER_S = 3.35e12, 67e12
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
PROFILE_STEPS = 5                    # train steps traced for the step profile
PROFILE_PAD_S = 0.05                 # idle seconds at each end of a profile window
FILL_LAUNCHES = 4000                 # small kernels after the calls (profiler check)
SR_STREAM = 16000                    # stream_v5e8
B_PIT3, S_PIT3 = 16, 3               # 3src_pit: 16 x 3 s at 8 kHz (F = 184), 3 sources
PIT3_STEPS, PIT3_QUALITY_STEPS = 5, 4
SEP_SAMPLES, SEP_CALLS = 5, 2        # separate() timing: samples of calls per path
T_STREAM = 60 * SR_STREAM            # the streamed mixture: 62 chunks of 16 000
STREAM_SAMPLES = 3                   # timed streams per mode and DSP path
DP_STEP_SAMPLES = 12                 # timed train steps, dp phase, each side
DP_REDUCE_SAMPLES = 20               # timed all-reduces of G's gradients
DP_TIMEOUT_S = 400                   # one torchrun call of the dp phase
SEED_TOOLS = 12                      # the tools phase's own generator
TOOLS_TIMEOUT_S = 300                # one subprocess of the tools phase
TOOLS_STEPS, TOOLS_PROFILE = 6, (2, 4)          # cli train --profile-steps 2:4
DEBUG_STEP_SAMPLES = 6               # timed steps with and without the tripwires
STREAM_QUALITY_STEPS = 20
BENCH_STEPS = "1:3"                  # bench_presets: warm-up 1, timed 3
STREAMING_COMPUTE_SECONDS = 10
QUICKSTART_STEPS = 4
WAVDIR_STEPS = 500                   # train_wavdir_fixture's own default
# A train step's device time by kernel family: substrings of the lower-cased
# kernel name, first match wins.  cuDNN's layout transposes are
# nchwToNhwc/nhwcToNchw kernels; its conv kernels carry "nhwc" too.
KERNEL_FAMILIES = (
    ("LSTM (cuDNN RNN)", ("rnn", "lstm")),
    ("K3 backward istft_adjoint", ("istft_adjoint_kernel",)),
    ("K1 stft_features", ("stft_features_kernel",)),
    ("K2/K3 istft_ola", ("istft_ola_kernel",)),
    ("layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("convs and GEMMs", ("conv", "gemm", "xmma", "cutlass", "wgrad", "dgrad")),
    ("cuFFT", ("fft",)),
    ("optimizers", ("multi_tensor", "foreach")),
    ("reductions", ("reduce",)),
    ("copies, cat, gather", ("copy", "cat", "gather", "index", "scatter")),
    ("elementwise", ("elementwise",)),
)
# The keys of scripts/quality_protocol.py's JSON line (tests/test_torch_oracle.py
# holds the port's key set equal to the JAX script's).
QUALITY_KEYS = {
    "preset", "hard", "steps", "seeds", "si_sdr_improvement",
    "si_sdr_improvement_per_seed", "si_sdr_improvement_half_range",
    "si_sdr_improvement_train_dist", "oracle_bound", "headroom", "d_loss",
    "d_loss_traj_per_seed", "d_norm", "throughput",
}


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - T_START, **kw}),
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).detach().abs().max())


def mixtures(rng, b: int, t: int, sr: int = SR) -> np.ndarray:
    """Two harmonic tones per mixture plus noise."""
    n = np.arange(t) / sr
    out = []
    for _ in range(b):
        f1, f2 = rng.uniform(100, 300), rng.uniform(400, 1200)
        s1 = sum(np.sin(2 * np.pi * h * f1 * n) / h for h in (1, 2, 3))
        s2 = sum(np.sin(2 * np.pi * h * f2 * n) / h for h in (1, 2))
        out.append(0.3 * s1 + 0.2 * s2 + 0.02 * rng.standard_normal(t))
    return np.stack(out).astype(np.float32)


def near_silent(sr: int, t: int, seed: int = 1) -> np.ndarray:
    """One signal: a tone of amplitude 1 with -20 dB noise over the first
    40 %, -120 dB noise alone to 80 %, digital silence after.  Each
    frame's log|X| can be held to 1e-3 only if the FFT's error follows the
    frame's own level (tests/test_torch_ops.py runs the same signal through
    the kernel's schedule on the CPU)."""
    r = np.random.default_rng(seed)
    n = np.arange(t)
    x = (np.sin(2 * np.pi * 440.3 * n / sr) + 0.1 * r.standard_normal(t)) * (n < 0.4 * t)
    x += 1e-6 * r.standard_normal(t) * (n >= 0.4 * t) * (n < 0.8 * t)
    return x.astype(np.float32)[None]


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `nbytes` and do `flops` f32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def fft_flops(frames: int, n_fft: int) -> float:
    return frames * 2.5 * n_fft * math.log2(n_fft)


def stft_bound(x, n_fft, hop, emits=("spec",), n_mels=0):
    """The bound of an STFT of x (..., T) emitting `emits`: the input read
    once, each output written once, the mel matrix; an FFT a frame, plus
    2·K·M flops a frame for log-mel."""
    t = x.shape[-1]
    b, f, k = x.numel() // t, 1 + (t - n_fft) // hop, n_fft // 2 + 1
    width = {"spec": 8 * k, "mag": 4 * k, "logmag": 4 * k, "logmel": 4 * n_mels}
    nbytes = 4 * b * t + b * f * sum(width[e] for e in emits)
    flops = fft_flops(b * f, n_fft)
    if "logmel" in emits:
        nbytes += 4 * k * n_mels
        flops += 2 * b * f * k * n_mels
    return bound(nbytes, flops)


def istft_bound(spec_bytes, b, s, f, n_fft, hop, mask_bytes=0, mask_flops=0):
    """The bound of an overlap-added inverse STFT of b·s signals of f frames
    from `spec_bytes` of spectrum (and `mask_bytes` of masks): an inverse
    FFT a frame, the f32 output written once."""
    out = 4 * b * s * ((f - 1) * hop + n_fft)
    return bound(spec_bytes + mask_bytes + out,
                 fft_flops(b * s * f, n_fft) + mask_flops)


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


def k1_case(x, n_fft, hop, emits, mel, logmag_floor=None):
    """K1 against its plain version on x.  With `logmag_floor`, logmag is
    held to 1e-3 only at bins whose plain |X| reaches that fraction of
    their frame's RMS |X|; spec and mag are held at every bin."""
    ker = k1.stft_features_kernel(x, n_fft, hop, emit=emits, mel_matrix=mel)
    ref = k1.stft_features_reference(x, n_fft, hop, emit=emits, mel_matrix=mel)
    torch.cuda.synchronize()
    mag = ref["mag"] if "mag" in ref else (
        ref["spec"].abs() if "spec" in ref
        else k1.stft_features_reference(x, n_fft, hop, emit=("mag",))["mag"])
    scale = float(mag.max())
    errs = {}
    for key in emits:
        check(ker[key].shape == ref[key].shape, f"k1 {key} shape")
        a, b = ker[key], ref[key]
        if key == "logmag" and logmag_floor is not None:
            keep = mag >= logmag_floor * mag.square().mean(-1, keepdim=True).sqrt()
            errs["logmag_all_bins"] = max_err(a, b)
            errs["logmag_bins_under_floor"] = int((~keep).sum())
            a, b = a[keep], b[keep]
        errs[key] = max_err(a, b)
        tol = 3e-4 * scale if key in ("spec", "mag") else 1e-3
        check(errs[key] <= tol, f"k1 {key} at n_fft {n_fft} hop {hop} shape "
              f"{tuple(x.shape)}: max err {errs[key]} > {tol}")
    if "logmag" in emits:
        # Not a check: how far each f32 version's log|X| lies from the same
        # function (the same f32 window) computed in float64.
        w = torch.from_numpy(get_window("hann", n_fft)).to(x.device).double()
        exact = torch.stft(x.reshape(-1, x.shape[-1]).double(), n_fft, hop, window=w,
                           center=False, return_complex=True)
        exact = torch.log(exact.abs() + 1e-8).transpose(-1, -2).reshape(ref["logmag"].shape)
        errs["logmag_vs_f64"] = {"kernel": max_err(ker["logmag"], exact),
                                 "plain": max_err(ref["logmag"], exact)}
    return errs, ker


def phase_k1(rng, dev):
    mel = torch.from_numpy(mel_filterbank(N_MELS, N_FFT // 2 + 1, SR)).to(dev)
    x = torch.from_numpy(rng.standard_normal((B_MAIN, T_MAIN), np.float32)).to(dev)
    main_errs, ker = k1_case(x, N_FFT, HOP, ("spec", "logmel"), mel)
    emit("k1", shape=[B_MAIN, T_MAIN], frames=ker["spec"].shape[-2],
         max_abs_err=main_errs, tol="spec 3e-4*max|X|, logmel 1e-3",
         profiler_launches_per_call=profiler_window_check(
             lambda: k1.stft_features_kernel(x, N_FFT, HOP, emit=("spec", "logmel"),
                                             mel_matrix=mel)))
    xl = torch.from_numpy(rng.standard_normal((1, T_LONG), np.float32)).to(dev)
    errs, kl = k1_case(xl, N_FFT, HOP, ("spec", "logmel"), mel)
    emit("k1", shape=[1, T_LONG], frames=kl["spec"].shape[-2], max_abs_err=errs)
    for n_fft, hop, sr in ((256, 64, 8000), (2048, 512, 44100)):
        m = torch.from_numpy(mel_filterbank(N_MELS, n_fft // 2 + 1, sr)).to(dev)
        xs = torch.from_numpy(rng.standard_normal((2, 8000), np.float32)).to(dev)
        errs, _ = k1_case(xs, n_fft, hop, ("spec", "mag", "logmag", "logmel"), m)
        emit("k1", n_fft=n_fft, hop=hop, shape=[2, 8000], max_abs_err=errs)
    # The music_complex_44k step's two launches: mixtures, then targets, on
    # a generator of their own.  Among their 6.3 M white-noise bins the
    # Rayleigh tail puts a few near |X| = 0, where log|X| of two f32
    # versions differs by their spec gap (~1e-5) over |X|: logmag is held
    # where |X| is at least LOGMAG_FLOOR of the frame's RMS |X|.
    music, rng_music = {}, np.random.default_rng(SEED_MUSIC)
    for what, shape, emits in (
            ("mixtures", (B_MUSIC, T_MUSIC), ("spec", "mag", "logmag")),
            ("targets", (B_MUSIC * S_MUSIC, T_MUSIC), ("logmag", "spec"))):
        xm = torch.from_numpy(rng_music.standard_normal(shape, np.float32)).to(dev)
        errs, _ = k1_case(xm, MUSIC_N_FFT, MUSIC_HOP, emits, None, LOGMAG_FLOOR)
        music[what] = (xm, emits)
        emit("k1", case=f"music_complex_44k {what}", shape=list(shape),
             n_fft=MUSIC_N_FFT, hop=MUSIC_HOP, max_abs_err=errs,
             tol=f"spec, mag 3e-4*max|X|; logmag 1e-3 where |X| >= "
                 f"{LOGMAG_FLOOR} * frame RMS |X|")
    for n_fft, hop, sr, emits in ((N_FFT, HOP, SR, ("spec", "logmag", "logmel")),
                                  (MUSIC_N_FFT, MUSIC_HOP, 44100, ("spec", "logmag"))):
        m = torch.from_numpy(mel_filterbank(N_MELS, n_fft // 2 + 1, sr)).to(dev)
        xq = torch.from_numpy(near_silent(sr, 2 * sr)).to(dev)
        errs, _ = k1_case(xq, n_fft, hop, emits, m)
        emit("k1", case="near-silent: tone, then -120 dB noise, then zeros",
             n_fft=n_fft, hop=hop, shape=list(xq.shape), max_abs_err=errs,
             tol="spec 3e-4*max|X|, logmag and logmel 1e-3")
    return x, ker["spec"], main_errs["spec"], music


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
    # The music_complex_44k bound batch, then one frame and ROWS + 1
    # frames (a second, partial block), on a generator of their own.
    rs = np.random.default_rng(SEED_SYNTH)

    def spectrum_and_masks(b, t, n_fft, hop, mask_type):
        xs = torch.from_numpy(rs.standard_normal((b, t), np.float32)).to(dev)
        ss = k1.stft_features_reference(xs, n_fft, hop)["spec"]
        shape = (b, 2) + tuple(ss.shape[-2:]) + ((2,) if mask_type == "complex" else ())
        lo = 0.0 if mask_type == "magnitude" else -1.0
        return ss, torch.from_numpy(rs.uniform(lo, 1, shape).astype(np.float32)).to(dev)

    music = spectrum_and_masks(B_MUSIC, T_MUSIC, MUSIC_N_FFT, MUSIC_HOP, "complex")
    interior, full = k2_case(*music, MUSIC_N_FFT, MUSIC_HOP, "complex")
    emit("k2", case="music_complex_44k bound batch", mask_type="complex",
         masks=list(music[1].shape), n_fft=MUSIC_N_FFT, hop=MUSIC_HOP,
         max_abs_err_interior=interior, max_abs_err_full=full)
    for n_fft, hop, mask_type in ((N_FFT, HOP, "magnitude"),
                                  (MUSIC_N_FFT, MUSIC_HOP, "complex")):
        for frames in (1, k2.ROWS + 1):
            ss, ms = spectrum_and_masks(3, (frames - 1) * hop + n_fft, n_fft, hop,
                                        mask_type)
            check(ss.shape[-2] == frames, f"k2 edge: {ss.shape}")
            interior, full = k2_case(ss, ms, n_fft, hop, mask_type)
            emit("k2", case=f"edge: {frames} frames", mask_type=mask_type,
                 n_fft=n_fft, hop=hop, masks=list(ms.shape),
                 max_abs_err_interior=interior, max_abs_err_full=full)
    return errs["magnitude"], music


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
    rs = np.random.default_rng(SEED_SYNTH + 1)
    for n_fft, hop in ((N_FFT, HOP), (MUSIC_N_FFT, MUSIC_HOP)):
        for frames in (1, k2.ROWS + 1):
            e, (re, *_) = k3_case(rs, dev, 3, (frames - 1) * hop + n_fft, n_fft, hop)
            check(re.shape[-2] == frames, f"k3 edge: {re.shape}")
            emit("k3", case=f"edge: {frames} frames", n_fft=n_fft, hop=hop,
                 signals=3, max_abs_err=e)
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
    profile = step_profile(exp)
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
         step_profile=profile, eval=ev, cli_wsj0_logmel_rc=rc)
    return exp, counts


def best_perm_agreement(ker: np.ndarray, ref: np.ndarray) -> float:
    """Min SI-SDR (dB) of (B, S, T) kernel-path outputs against the plain
    path's, each example after its best source permutation."""
    return min(segment_agreement(k, r, r.shape[-1])[0] for k, r in zip(ker, ref))


def lstm_probe(dev) -> dict:
    """The kernels one forward and backward of the 3src_pit BiLSTM trunk in
    bf16 (with a dense head) launches: whether cuDNN's RNN kernels ran in
    bf16 (`torch.backends.cudnn.is_acceptable` answers False for a bf16
    tensor, yet torch.lstm calls cuDNN with it), the trunk's device ms,
    and its 8 longest kernels (device ms and launches a call)."""
    from gan_sass_tf_tpu_torch.models.generator import BiLSTMGenerator
    g = BiLSTMGenerator(S_PIT3, N_FFT // 2 + 1, N_FFT // 2 + 1, "magnitude", "softmax",
                        hidden=300, layers=2, dtype=torch.bfloat16,
                        head_mode="dense").to(dev)
    for p in g.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
    feats = torch.randn(B_PIT3, 184, N_FFT // 2 + 1, device=dev)
    kernels = device_kernels(lambda: g(feats, train=True).sum().backward(), calls=2)
    cudnn_bf16 = sorted(name[:60] for name in kernels
                        if "RNN" in name and "__nv_bfloat16" in name)
    check(bool(cudnn_bf16), f"no cuDNN RNN kernel ran in bf16: {sorted(kernels)[:10]}")
    return {"cudnn_rnn_kernels_bf16": cudnn_bf16,
            "cudnn_is_acceptable_bf16": torch.backends.cudnn.is_acceptable(
                feats.to(torch.bfloat16)),
            "cudnn_version": torch.backends.cudnn.version(),
            "fwd_bwd_device_ms": sum(ms for ms, _ in kernels.values()),
            "longest": {name[:100]: [ms, n] for name, (ms, n) in sorted(
                kernels.items(), key=lambda kv: -kv[1][0])[:8]}}


def phase_pit3(rng, dev, tmp: Path):
    """3src_pit at full width: the BiLSTM G (2 x 300, film head), S = 3
    softmax masks, log-magnitude L1 with PIT over 6 permutations, batch
    16 x 3 s.  Training, separation, the CLI and the quality protocol on
    the kernel path; K1 and K2 at the shapes this path gives them."""
    probe = lstm_probe(dev)
    cfg = config.get_config("3src_pit")
    exp = Experiment(cfg, device=dev)
    g0 = [p.detach().clone() for p in exp.state.g.parameters()]
    d0 = [p.detach().clone() for p in exp.state.d.parameters()]
    profile = step_profile(exp)       # early in the phase: fewer dropped records
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    last = exp.train(num_steps=PIT3_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_counts = {"stft_features": k1.launches, "masked_istft": k2.launches}
    check(train_counts == {"stft_features": 2 * PIT3_STEPS, "masked_istft": 0},
          f"3src_pit train launches {train_counts}, expected K1 2 a step")
    check(all(np.isfinite(v) for v in last.values()), f"3src_pit non-finite: {last}")
    moved = {"g": max(max_err(a, p) for a, p in zip(g0, exp.state.g.parameters())),
             "d": max(max_err(a, p) for a, p in zip(d0, exp.state.d.parameters()))}
    check(min(moved.values()) > 0, f"3src_pit: a net did not move: {moved}")
    out = {}
    for path in (None, "reference"):
        state = copy.deepcopy(exp.state)
        with dispatch.force_backend(path):
            _, m = exp._train_step(state, exp._bank, exp._train_seed)
        out[path or "kernel"] = {k: float(v) for k, v in m.items()}
    gaps = {}
    for key in ("g_recon", "d_loss"):
        a, b = out["kernel"][key], out["reference"][key]
        gaps[key] = abs(a - b) / max(abs(b), 1.0)
        check(gaps[key] <= 1e-2, f"3src_pit step {key}: kernel {a} vs plain {b}")
    step_kernel, step_plain = time_steps(exp)
    k1.launches = k2.launches = 0
    ev = exp.evaluate(num_batches=2)
    eval_counts = {"stft_features": k1.launches, "masked_istft": k2.launches}
    check(all(np.isfinite(v) for v in ev.values()), f"3src_pit eval: {ev}")
    check(eval_counts == {"stft_features": 2, "masked_istft": 2},
          f"3src_pit eval launches {eval_counts}")

    # Separation: separate() on 16 x 3 s and `cli separate` on 60 s, with
    # the trained G, then each on the plain DSP path.
    g = exp.eval_generator()
    params, wav60 = tmp / "g3.npz", tmp / "mix60s_3src.wav"
    save_flax_npz(str(params), g.state_dict())
    sources = torch.from_numpy(np.stack([mixtures(rng, B_PIT3, T_MAIN)
                                         for _ in range(S_PIT3)], axis=1))
    batch = sources.sum(dim=1).numpy()
    write_wav(str(wav60), SR, mixtures(rng, 1, T_LONG)[0])
    long_mix = read_wav(str(wav60))[1]
    k1.launches = k2.launches = 0
    est = separate(g, cfg, batch, dev)
    captured(cli.main, ["separate", "--config", "3src_pit", "--params", str(params),
                        "--input", str(wav60), "--output-dir", str(tmp / "out3")])
    torch.cuda.synchronize()
    sep_counts = {"stft_features": k1.launches, "masked_istft": k2.launches}
    check(sep_counts == {"stft_features": 2, "masked_istft": 2},
          f"3src_pit separation launches {sep_counts}")
    srcs = np.stack([read_wav(str(tmp / "out3" / f"{wav60.stem}_src{i}.wav"))[1]
                     for i in range(S_PIT3)])
    check(srcs.shape == (S_PIT3, T_LONG) and np.isfinite(srcs).all(),
          f"3src_pit cli separate: {srcs.shape}")
    check(est.shape == (B_PIT3, S_PIT3, T_MAIN) and np.isfinite(est).all(),
          f"3src_pit separate: {est.shape}")
    est_long = separate(g, cfg, long_mix, dev)
    with dispatch.force_backend("reference"):
        ref = separate(g, cfg, batch, dev)
        ref_long = separate(g, cfg, long_mix, dev)
    agree = {"batch_min_db": best_perm_agreement(est, ref),
             "long_min_db": best_perm_agreement(est_long[None], ref_long[None])}
    check(min(agree.values()) >= 40.0, f"3src_pit kernel vs plain: {agree}")

    def run_sep(path, mix):
        def go():
            with dispatch.force_backend(path):
                separate(g, cfg, mix, dev)
        return go

    sep_ms = {what: time_fns(SEP_SAMPLES, SEP_CALLS, plain=run_sep("reference", mix),
                             kernel=run_sep(None, mix))
              for what, mix in (("16 x 3 s", batch), ("60 s", long_mix))}

    # The entry points: cli train and the quality protocol.
    rc = cli.main(["train", "--config", "3src_pit", "--steps", "2"])
    check(rc == 0, f"cli train 3src_pit exited {rc}")
    k1.launches = k2.launches = k4.launches = 0
    quality = captured_json(quality_protocol.main, [
        "3src_pit", str(PIT3_QUALITY_STEPS), "--hard", "--seeds", "0",
        "--device", str(dev)])
    q_counts = {"stft_features": k1.launches, "masked_istft": k2.launches,
                "stft": k4.launches}
    check(set(quality) == QUALITY_KEYS, f"3src_pit quality keys {sorted(quality)}")
    check(all(finite(v) for v in quality.values()), f"3src_pit quality: {quality}")
    check(min(q_counts.values()) > 0, f"3src_pit quality launches {q_counts}")

    # K1 at the train step's two launches and the separation launch, on the
    # step's own mixtures and targets; K2 on the trained G's masks.
    with torch.no_grad():
        picked = sample_bank(exp._bank, exp._train_seed, 0, B_PIT3)
        mixture, scaled = mix_sources(picked, exp._train_seed, 0, cfg.data)
    k1_shapes = {"mixtures": (mixture, ("mag", "logmag")),
                 "targets": (scaled.reshape(-1, scaled.shape[-1]), ("logmag",)),
                 "separation": (mixture, ("spec", "logmag"))}
    k1_rows, k1_errs = {}, {}
    for what, (x, emits) in k1_shapes.items():
        k1_errs[what], _ = k1_case(x.contiguous(), N_FFT, HOP, emits, None, LOGMAG_FLOOR)
        k1_rows[what] = k1_timing(x.contiguous(), N_FFT, HOP, emits)
    spec = k1.stft_features_reference(mixture, N_FFT, HOP)["spec"]
    with torch.inference_mode():
        masks = g(k1.stft_features_reference(mixture, N_FFT, HOP,
                                              emit=("logmag",))["logmag"])
    check(masks.shape == (B_PIT3, S_PIT3, spec.shape[-2], N_FFT // 2 + 1),
          f"3src_pit masks {masks.shape}")
    interior, full = k2_case(spec, masks, N_FFT, HOP, "magnitude")
    k2_row = time_kernel(
        lambda: k2.masked_istft_kernel(spec, masks, N_FFT, HOP),
        lambda: k2.masked_istft_reference(spec, masks, N_FFT, HOP),
        istft_bound(spec.numel() * 8, B_PIT3, S_PIT3, spec.shape[-2], N_FFT, HOP,
                    masks.numel() * 4, 2 * masks.numel()))
    mix_s = cfg.train.batch_size * cfg.segment_samples / cfg.dsp.sample_rate
    emit("pit3", config="3src_pit", batch=cfg.train.batch_size,
         segment_samples=cfg.segment_samples, frames=spec.shape[-2],
         g_params=sum(p.numel() for p in exp.state.g.parameters()),
         d_params=sum(p.numel() for p in exp.state.d.parameters()),
         lstm=probe, steps=PIT3_STEPS, wall_s=wall, last=last,
         launches={"train": train_counts, "eval": eval_counts,
                   "separation": sep_counts, "quality": q_counts},
         moved_max_abs=moved, one_step={"kernel": out["kernel"],
                                        "plain": out["reference"]},
         gap=gaps, tol="|kernel - plain| <= 1e-2 * max(|plain|, 1)",
         step_ms={"kernel": step_kernel, "plain": step_plain},
         train_mix_sec_per_sec={"kernel": mix_s / step_kernel * 1e3,
                                "plain": mix_s / step_plain * 1e3},
         step_profile=profile, eval=ev, separation_kernel_vs_plain=agree, tol_db=40.0,
         separate_ms=sep_ms, cli_train_rc=rc, quality=quality,
         k1_max_abs_err=k1_errs, k2_max_abs_err={"interior": interior, "full": full},
         k1_timing=k1_rows, k2_timing=k2_row)
    counts = {"train": train_counts, "eval": eval_counts, "separation": sep_counts,
              "quality": q_counts}
    return counts, {"stft_features": {w: row(t) for w, t in k1_rows.items()},
                    "masked_istft": row(k2_row)}


def flat_state(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_state(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def cli_losses(out: str, step: int) -> dict:
    """The g, d and recon losses `cli train` printed for `step`."""
    m = re.search(rf"step {step}: g=(\S+) d=(\S+) recon=(\S+)", out)
    check(m is not None, f"cli train printed no step {step}: {out[-300:]}")
    return dict(zip(("g", "d", "recon"), map(float, m.groups())))


def phase_workdir(dev, tmp: Path):
    """The workdir lifecycle of stream_v5e8 at full width through the CLI,
    then host batches and the device bank from a fixture wav corpus."""
    wd = tmp / "run"
    common = ["--config", "stream_v5e8", "--workdir", str(wd), "--device", str(dev)]
    sets = ["--set", "train.ckpt_every=2", "--set", "train.eval_every=2",
            "--set", "train.eval_batches=1"]
    k1.launches = k3.launches = k3.bwd_launches = 0
    out = captured(cli.main, ["train", *common, "--steps", "4", *sets])
    counts = {"stft_features": k1.launches, "istft": k3.launches,
              "istft_bwd": k3.bwd_launches}
    check(counts["istft"] == 4 and counts["istft_bwd"] == 4
          and counts["stft_features"] >= 8, f"workdir train launches {counts}")
    losses = {4: cli_losses(out, 4)}
    best = json.loads((wd / "best.json").read_text())
    written = sorted(str(p.relative_to(wd)) for p in wd.rglob("*") if p.is_file())
    for name in ("config.json", "checkpoints/2.pt", "checkpoints/4.pt", "best.json",
                 "metrics.jsonl", f"best/{best['step']}.pt"):
        check(name in written, f"workdir: {name} missing from {written}")
    out = captured(cli.main, ["train", *common, "--steps", "2", *sets])
    check("resumed from step 4" in out, f"second cli train did not resume: {out}")
    losses[6] = cli_losses(out, 6)
    check(all(math.isfinite(v) for m in losses.values() for v in m.values()),
          f"workdir losses {losses}")
    cfg = config.Config.from_json((wd / "config.json").read_text())
    exp = Experiment(cfg, workdir=str(wd), device=dev)
    check(exp.state.step == 6, f"workdir resumed at {exp.state.step}, not 6")
    saved = torch.load(wd / "checkpoints" / "6.pt", map_location="cpu",
                       weights_only=True)
    live = dict(flat_state(exp.state.state_dict()))
    stored = dict(flat_state(saved["state"]))
    check(live.keys() == stored.keys(), "restored state has other keys")
    differ = [k for k, v in live.items()
              if not (torch.equal(v.cpu(), stored[k]) if torch.is_tensor(v)
                      else v == stored[k])]
    check(not differ, f"restored state differs from the saved one: {differ[:5]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp.save()
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    exp.restore()
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    ev = captured(cli.main, ["eval", *common, "--best", "--batches", "1"])
    check("using best checkpoint" in ev and "si_sdr_improvement" in ev,
          f"cli eval --best: {ev}")

    corpus = tmp / "corpus"
    write_fixture_corpus(str(corpus), n_speakers=6, utts_per_speaker=4,
                         seconds=3.0, sample_rate=SR_STREAM, seed=SEED)
    corpus_runs = {}
    for mode, bank in (("host_batches", "False"), ("device_bank", "True")):
        t0 = time.perf_counter()
        out = captured(cli.main, [
            "train", "--config", "stream_v5e8", "--steps", "2", "--device", str(dev),
            "--set", "data.dataset=wav_dir", "--set", f"data.data_dir={corpus}",
            "--set", f"data.device_bank={bank}"])
        m = cli_losses(out, 2)
        check(all(math.isfinite(v) for v in m.values()), f"{mode}: {m}")
        corpus_runs[mode] = {"losses_step_2": m, "wall_s": time.perf_counter() - t0}
    emit("workdir", config="stream_v5e8", batch=cfg.train.batch_size,
         files=written, best=best, losses=losses, launches_first_run=counts,
         resumed_at=4, ended_at=6, restored_equals_saved=True,
         state_tensors=sum(torch.is_tensor(v) for v in live.values()),
         checkpoint_mib=(wd / "checkpoints" / "6.pt").stat().st_size / 2**20,
         save_ms=save_ms, load_ms=load_ms, wav_corpus=corpus_runs)
    return wd, counts


def segment_agreement(ker: np.ndarray, ref: np.ndarray, stride: int):
    """(min SI-SDR over stride-long segments and sources, segments whose best
    source permutation is the identity, segments): the kernel path's
    stream against the plain path's, each segment after its own best
    permutation, so that a chained permutation picked differently on a
    near-tie costs that segment alone."""
    s, t = ref.shape
    perms = permutations_for(s)
    worst, same, n = float("inf"), 0, 0
    for a in range(0, t - stride + 1, stride):
        k = torch.from_numpy(ker[:, a:a + stride])
        r = torch.from_numpy(ref[:, a:a + stride])
        scores = torch.stack([si_sdr(k[list(p)], r) for p in perms])   # (P, S)
        best = int(scores.mean(dim=1).argmax())
        worst = min(worst, float(scores[best].min()))
        same += best == 0
        n += 1
    return worst, same, n


def phase_stream(rng, dev, tmp: Path, wd: Path):
    """Streaming separation of a 60 s mixture through the CLI with G from
    the workdir, in both modes; kernel against plain path; timings."""
    cfg = config.Config.from_json((wd / "config.json").read_text())
    chunk, stride, _, n_chunks, _, _ = streaming._chunk_geometry(cfg, T_STREAM)
    n_groups = -(-n_chunks // cfg.stream.batch_chunks)
    expect = {"batch": n_groups, "scan": n_chunks}
    wav = tmp / "stream60s.wav"
    write_wav(str(wav), SR_STREAM, mixtures(rng, 1, T_STREAM, SR_STREAM)[0])
    mix = read_wav(str(wav))[1]
    launches = {}
    for mode in ("batch", "scan"):
        out_dir = tmp / f"stream_{mode}"
        k1.launches = k2.launches = 0
        captured(cli.main, [
            "separate", "--config", "stream_v5e8", "--workdir", str(wd), "--device",
            str(dev), "--input", str(wav), "--output-dir", str(out_dir),
            "--streaming", "--streaming-mode", mode])
        launches[mode] = {"stft_features": k1.launches, "masked_istft": k2.launches}
        check(launches[mode] == {"stft_features": expect[mode],
                                 "masked_istft": expect[mode]},
              f"stream {mode}: launches {launches[mode]}, expected {expect[mode]} each")
        srcs = np.stack([read_wav(str(out_dir / f"stream60s_src{i}.wav"))[1]
                         for i in range(cfg.data.num_sources)])
        check(srcs.shape == (2, T_STREAM) and np.isfinite(srcs).all(),
              f"stream {mode}: {srcs.shape}")

    exp = Experiment(cfg, workdir=str(wd), device=dev)
    g = exp.eval_generator()
    fns = {"batch": separate_streaming, "scan": separate_streaming_scan}
    agree = {}
    chained, inner = [], streaming._chain_permutations

    def recording_chain(*args, **kwargs):
        chained.append(inner(*args, **kwargs))
        return chained[-1]

    streaming._chain_permutations = recording_chain
    try:
        for mode, fn in fns.items():
            ker = fn(g, cfg, mix, dev)
            with dispatch.force_backend("reference"):
                ref = fn(g, cfg, mix, dev)
            check(ker.shape == ref.shape == (2, T_STREAM) and np.isfinite(ker).all(),
                  f"stream {mode}: kernel path {ker.shape}")
            worst, same, n = segment_agreement(ker, ref, stride)
            agree[mode] = {"min_si_sdr_db": worst, "segments_same_permutation": same,
                           "segments": n}
            check(worst >= 40.0, f"stream {mode}: kernel vs plain SI-SDR {worst} dB < 40")
    finally:
        streaming._chain_permutations = inner
    perm_equal = bool(np.array_equal(chained[0], chained[1]))

    def run(mode, path):
        def go():
            with dispatch.force_backend(path):
                t0 = time.perf_counter()
                fns[mode](g, cfg, mix, dev)
                return (time.perf_counter() - t0) * 1e3
        return go

    walls = {}
    for mode in fns:
        times = {None: [], "reference": []}
        for i in range(2 * STREAM_SAMPLES):
            path = (None, "reference", "reference", None)[i % 4]
            times[path].append(run(mode, path)())
        walls[mode] = {"kernel": statistics.median(times[None]),
                       "plain": statistics.median(times["reference"])}
    busy = {}
    for mode in fns:
        dk = device_kernels(run(mode, None), calls=1)
        busy[mode] = {"device_ms": sum(ms for ms, _ in dk.values()),
                      "wall_ms": walls[mode]["kernel"],
                      "k1_launches_recorded": sum(
                          n for name, (_, n) in dk.items()
                          if "stft_features_kernel" in name)}
        busy[mode]["busy_share"] = busy[mode]["device_ms"] / walls[mode]["kernel"]

    # K1 and K2 at the chunk shapes: a group of batch_chunks chunks and one.
    shapes = {}
    n_fft, hop = cfg.dsp.n_fft, cfg.dsp.hop_length
    for b in (cfg.stream.batch_chunks, 1):
        x = torch.from_numpy(mixtures(rng, b, chunk, SR_STREAM)).to(dev)
        if b > 1:       # the last group's zero chunks: log|X| = log(eps)
            x[-(n_groups * b - n_chunks):] = 0.0
        emits = ("spec", "logmag")
        # As the k1 phase's music cases: at bins below LOGMAG_FLOOR of their
        # frame's RMS |X|, two f32 FFTs' log|X| differ by their spec gap over
        # |X| (up to 0.015 there on other inputs of this shape, the kernel
        # the closer to float64 at most): logmag is held above the floor.
        k1_errs, k1_out = k1_case(x, n_fft, hop, emits, None, LOGMAG_FLOOR)
        check(bool(torch.isfinite(k1_out["logmag"]).all()),
              f"k1 logmag at {tuple(x.shape)} not finite")
        k1_t = k1_timing(x, n_fft, hop, emits)
        spec = k1.stft_features_reference(x, n_fft, hop)["spec"]
        masks = torch.from_numpy(rng.uniform(0, 1, (b, 2) + tuple(spec.shape[-2:]))
                                 .astype(np.float32)).to(dev)
        interior, full = k2_case(spec, masks, n_fft, hop, "magnitude")
        k2_t = time_kernel(
            lambda: k2.masked_istft_kernel(spec, masks, n_fft, hop),
            lambda: k2.masked_istft_reference(spec, masks, n_fft, hop),
            istft_bound(spec.numel() * 8, b, 2, spec.shape[-2], n_fft, hop,
                        masks.numel() * 4, 2 * masks.numel()))
        shapes[b] = {"stft_features": k1_t, "masked_istft": k2_t,
                     "stft_features_max_abs_err": k1_errs,
                     "masked_istft_max_abs_err": full,
                     "masks": list(masks.shape)}
    emit("stream", config="stream_v5e8", seconds=T_STREAM / SR_STREAM,
         chunk=chunk, stride=stride, chunks=n_chunks, groups=n_groups,
         launches=launches, kernel_vs_plain=agree, tol_db=40.0,
         batch_chained_permutations_equal=perm_equal,
         wall_ms=walls, ms_per_chunk_scan={
             p: walls["scan"][p] / n_chunks for p in ("kernel", "plain")},
         mixture_sec_per_sec={m: {p: T_STREAM / SR_STREAM / w[p] * 1e3
                                  for p in ("kernel", "plain")}
                              for m, w in walls.items()},
         device_busy=busy, chunk_shapes={str(b): v for b, v in shapes.items()},
         chunk_shapes_tol=f"k1 spec 3e-4*max|X|; logmag 1e-3 where |X| >= "
                          f"{LOGMAG_FLOOR} * frame RMS |X|",
         note="wall: host array in, host array out; busy: torch.profiler "
              "device ms of one stream over the median kernel-path wall")
    return launches, shapes


def launch_counts() -> dict:
    return {"stft_features": k1.launches, "masked_istft": k2.launches,
            "istft": k3.launches, "istft_bwd": k3.bwd_launches}


def reset_launch_counts() -> None:
    k1.launches = k2.launches = k3.launches = k3.bwd_launches = 0


def flat_tensors(state) -> dict:
    """{name: tensor} of a TrainState's state_dict, on the host."""
    return {k: v.detach().cpu().clone() for k, v in flat_state(state.state_dict())
            if torch.is_tensor(v)}


def dp_step_report(exp) -> dict:
    """The data-parallel phase's step on `exp`, run alike by this process
    (no process group) and by every torchrun rank: one step (metrics,
    launches, the state it leaves), evaluate(2) and its launches; then,
    against the same step built without the group in the same process, a
    profiled step each (device ms; NCCL kernels and collectives) and the
    median wall ms of DP_STEP_SAMPLES synchronized steps each, in turns;
    over a group, the median host ms (until the call returns) and wall ms
    (synchronized) of DP_REDUCE_SAMPLES all-reduces of tensors shaped as
    G's gradients.  Returns (report, state tensors after the one step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solo = build_train_step(exp.cfg, from_bank=exp._use_bank,
                            local_batch=exp.dp.local_batch)
    steps = {"group": exp._train_step, "solo": solo}

    def run(name):
        steps[name](exp.state, exp._bank, exp._train_seed)

    def sync():
        if exp.device.type == "cuda":
            torch.cuda.synchronize()

    reset_launch_counts()
    _, m = exp._train_step(exp.state, exp._bank, exp._train_seed)
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "step_launches": launch_counts()}
    params = flat_tensors(exp.state)
    reset_launch_counts()
    out["eval"] = exp.evaluate(num_batches=2)
    out["eval_launches"] = launch_counts()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if exp.device.type == "cuda" else [])
    out["device_ms"], out["nccl_kernels"], out["collectives"] = {}, {}, {}
    for name in steps:
        run(name)
        sync()
        with profile(activities=activities) as prof:
            run(name)
            sync()
        events = prof.key_averages()
        kernels = profiler.device_work(prof)      # not the ranges' or NCCL ops' spans
        out["device_ms"][name] = sum(e.self_device_time_total for e in kernels) / 1e3
        out["nccl_kernels"][name] = {e.key[:100]: e.count for e in kernels if any(
            s in e.key.lower() for s in ("nccl", "onerankreduce"))}
        out["collectives"][name] = {e.key: e.count for e in events
                                    if e.device_type == DeviceType.CPU
                                    and e.key.startswith(("nccl:", "gloo:"))}
    walls = {name: [] for name in steps}
    for i in range(2 * DP_STEP_SAMPLES):
        name = ("group", "solo", "solo", "group")[i % 4]
        t0 = time.perf_counter()
        run(name)
        sync()
        walls[name].append((time.perf_counter() - t0) * 1e3)
    out["wall_ms"] = {name: statistics.median(w) for name, w in walls.items()}
    out["all_reduce_g"] = None
    if exp.dp.group is not None:
        grads = [p.detach().clone() for p in exp.state.g_opt.params]
        host, wall = [], []
        for _ in range(DP_REDUCE_SAMPLES):
            sync()
            t0 = time.perf_counter()
            exp.dp.all_reduce_mean(grads)
            host.append((time.perf_counter() - t0) * 1e3)
            sync()
            wall.append((time.perf_counter() - t0) * 1e3)
        out["all_reduce_g"] = {"numel": sum(g.numel() for g in grads),
                               "host_ms": statistics.median(host),
                               "wall_ms": statistics.median(wall)}
    return out, params


def dp_worker(spec_path: str) -> int:
    """One torchrun rank of the dp phase, from the JSON spec the phase
    wrote: join the group, then `cli.main(spec["train"])`, dp_step_report
    on the workdir spec["step_workdir"] (resumed from its checkpoint) and
    `cli.main(spec["separate"])` (cli.main is the function `python -m
    gan_sass_tf_tpu_torch.cli` runs; it leaves a group it did not join
    alone), each with the kernels it launched on this rank.  Writes
    spec["out"].rank<r>.json and spec["out"].rank<r>.pt, the state after
    the step."""
    from gan_sass_tf_tpu_torch.parallel import (
        initialize_distributed,
        rank_device,
        shutdown_distributed,
    )

    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False       # as phase_device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True           # as phase_dp's reference
    initialize_distributed(device=spec["device"])
    rank = torch.distributed.get_rank()
    res = {"rank": rank, "world": torch.distributed.get_world_size(),
           "backend": torch.distributed.get_backend()}
    try:
        reset_launch_counts()
        res["train_rc"] = cli.main(spec["train"])
        res["train_launches"] = launch_counts()
        cfg = config.Config.from_json((Path(spec["step_workdir"]) / "config.json").read_text())
        exp = Experiment(cfg, workdir=spec["step_workdir"],
                         device=rank_device(spec["device"]))
        report, params = dp_step_report(exp)
        exp.close()
        res.update(report)
        torch.save(params, f"{spec['out']}.rank{rank}.pt")
        chained, inner = [], streaming._chain_permutations

        def recording_chain(*a, **kw):
            chained.append(inner(*a, **kw))
            return chained[-1]

        streaming._chain_permutations = recording_chain
        reset_launch_counts()
        res["separate_rc"] = cli.main(spec["separate"])
        res["separate_launches"] = launch_counts()
        res["chained"] = [c.tolist() for c in chained]
    finally:
        shutdown_distributed()
    Path(f"{spec['out']}.rank{rank}.json").write_text(json.dumps(res))
    return res["train_rc"] or res["separate_rc"]


def torchrun(world: int, *argv) -> tuple:
    """`python -m torch.distributed.run --standalone --nproc_per_node world
    argv...` from the repo root: (wall ms, stdout); a non-zero exit (a
    failed NCCL init, a failed rank) fails the run."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), *argv]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=DP_TIMEOUT_S, env={**os.environ, "PYTHONPATH": str(ROOT)})
    wall = (time.perf_counter() - t0) * 1e3
    if res.returncode != 0:
        print(res.stdout[-3000:], res.stderr[-6000:], sep="\n", file=sys.stderr)
    check(res.returncode == 0, f"torchrun {' '.join(argv[:6])} exited {res.returncode}")
    return wall, res.stdout


def summed(ranks: list, key: str) -> dict:
    return {k: sum(r[key][k] for r in ranks) for k in ranks[0][key]}


def phase_dp(dev, tmp: Path, sets=()):
    """Data parallel over torch.cuda.device_count() NCCL ranks through
    torchrun.  One torchrun call runs on every rank: `cli train` of
    stream_v5e8 at full width for 4 steps (checkpoints and evals every 2),
    one step from one checkpoint over the group (against this process's
    step without one: equal within 1e-5 relative at world 1; the NCCL
    kernels of its profile; wall and device ms beside the same step
    without the group in the same rank), and `cli separate --streaming`
    (batch mode) of the stream phase's 60 s wav (against this process's:
    >= 40 dB a segment after the best permutation, the same chained
    permutations).  A second call, `-m gan_sass_tf_tpu_torch.cli train`
    itself, resumes at 4 for 2 more steps.  `sets` are extra --set
    overrides, "sec.key=val" (smaller sizes for a rehearsal on the CPU)."""
    world = torch.cuda.device_count() if dev.type == "cuda" else 2
    t_phase = time.perf_counter()
    overrides = ["mesh.data_axis_size=-1", *sets]
    cfg = cli._apply_overrides(config.get_config("stream_v5e8"), overrides)
    wd, ref_wd, out = tmp / "dp_run", tmp / "dp_step", tmp / "dp"
    common = ["--config", "stream_v5e8", "--workdir", str(wd), "--device", dev.type,
              *(a for o in overrides for a in ("--set", o))]
    periods = ["--set", "train.ckpt_every=2", "--set", "train.eval_every=2",
               "--set", "train.eval_batches=1"]
    wav = tmp / "stream60s.wav"
    separate_args = ["separate", "--config", "stream_v5e8", "--workdir", str(wd),
                     "--device", dev.type, "--input", str(wav), "--streaming",
                     "--streaming-mode", "batch"]

    # This process's step from the checkpoint the ranks start from, with
    # the ranks' cuDNN settings (deterministic algorithms, no TF32).
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        exp = Experiment(cfg, workdir=str(ref_wd), device=dev)
        exp.save()                                          # checkpoints/0.pt
        one, one_params = dp_step_report(exp)
        exp.close()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    spec = tmp / "dp_spec.json"
    spec.write_text(json.dumps({
        "device": dev.type, "out": str(out), "step_workdir": str(ref_wd),
        "train": ["train", *common, "--steps", "4", *periods],
        "separate": [*separate_args, "--output-dir", str(tmp / "dp_stream_w")]}))
    walls = {}
    walls["ranks"], log = torchrun(world, str(SCRIPT), "--dp-worker", str(spec))
    ranks = [json.loads(Path(f"{out}.rank{r}.json").read_text()) for r in range(world)]
    losses = {4: cli_losses(log, 4)}
    for r in ranks:
        c = r["train_launches"]
        check(c["stft_features"] >= 8 and c["istft"] == 4 and c["istft_bwd"] == 4,
              f"dp train rank {r['rank']} launches {c}")

    # The step over the group against this process's; every rank's state
    # bitwise equal to rank 0's (a missing or wrong all-reduce breaks it).
    dp_params = torch.load(f"{out}.rank0.pt", weights_only=True)
    for r in range(1, world):
        other = torch.load(f"{out}.rank{r}.pt", weights_only=True)
        unequal = [k for k, v in dp_params.items() if not torch.equal(v, other[k])]
        check(not unequal, f"dp step: rank {r}'s state differs from rank 0's in {unequal[:5]}")
    step = ranks[0]
    # Relative differences (floor 1 for the metrics and the eval, in dB or
    # O(1)); every parameter, moment, buffer and EMA tensor by its max |.|.
    rel = {"metrics": max(abs(step["metrics"][k] - v) / max(abs(v), 1.0)
                          for k, v in one["metrics"].items()),
           "params": max(float((dp_params[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                         for k, v in one_params.items()),
           "eval": max(abs(step["eval"][k] - v) / max(abs(v), 1.0)
                       for k, v in one["eval"].items())}
    # At W >= 2 the ranks sum in another order than one process: 1e-2 is a
    # guess that no run with two or more GPUs has read yet.
    tol = 1e-5 if world == 1 else 1e-2
    check(max(rel.values()) <= tol, f"dp step at world {world} vs one process: {rel}")
    reduces = sum(n for k, n in step["collectives"]["group"].items()
                  if k.startswith(("nccl:all_reduce", "gloo:all_reduce")))
    want = cfg.train.d_steps + 2               # D's grads a D step, G's grads, metrics
    check(reduces == want, f"dp step: {reduces} all-reduces, not {want}: "
                           f"{step['collectives']['group']}")
    if world > 1 and dev.type == "cuda":
        check(sum(step["nccl_kernels"]["group"].values()) > 0,
              f"no NCCL kernel in the profiled dp step: {step['nccl_kernels']}")

    # Batch-mode streaming over the group against this process's.
    chained, inner = [], streaming._chain_permutations

    def recording_chain(*a, **kw):
        chained.append(inner(*a, **kw))
        return chained[-1]

    streaming._chain_permutations = recording_chain
    try:
        t0 = time.perf_counter()
        captured(cli.main, [*separate_args, "--output-dir", str(tmp / "dp_stream_1")])
        walls["stream_one_process"] = (time.perf_counter() - t0) * 1e3
    finally:
        streaming._chain_permutations = inner
    got, ref = (np.stack([read_wav(str(tmp / d / f"{wav.stem}_src{i}.wav"))[1]
                          for i in range(cfg.data.num_sources)])
                for d in ("dp_stream_w", "dp_stream_1"))
    _, stride, *_ = streaming._chunk_geometry(cfg, ref.shape[-1])
    worst, same, n = segment_agreement(got, ref, stride)
    check(worst >= 40.0, f"dp stream vs one process: {worst} dB < 40")
    perm_equal = all(r["chained"] == [c.tolist() for c in chained] for r in ranks)
    check(perm_equal, "dp stream: chained permutations differ from one process's")
    stream_counts = summed(ranks, "separate_launches")
    check(stream_counts["stft_features"] > 0 and stream_counts["masked_istft"] > 0,
          f"dp stream launches {stream_counts}")

    # The resumed run through the module itself, as a user starts it.
    walls["resumed"], log = torchrun(
        world, "-m", "gan_sass_tf_tpu_torch.cli", "train", *common, "--steps", "2", *periods)
    check("resumed from step 4" in log, f"dp train did not resume: {log[-500:]}")
    check(log.count("step 6:") == 1, f"dp train: step 6 printed {log.count('step 6:')} times")
    losses[6] = cli_losses(log, 6)
    check(all(math.isfinite(v) for m in losses.values() for v in m.values()),
          f"dp losses {losses}")
    files = sorted(str(p.relative_to(wd)) for p in wd.rglob("*") if p.is_file())
    rows = [json.loads(line) for line in (wd / "metrics.jsonl").read_text().splitlines()]
    logged = [r["step"] for r in rows if "g_loss" in r]
    check(logged == sorted(set(logged)) and logged[-1] == 6,
          f"dp metrics.jsonl train rows at steps {logged}")
    for name in ("config.json", "checkpoints/4.pt", "checkpoints/6.pt", "best.json"):
        check(name in files, f"dp workdir: {name} missing from {files}")
    counts = {"dp_train": summed(ranks, "train_launches"),
              "dp_eval": summed(ranks, "eval_launches"), "dp_stream": stream_counts}
    keys = ("metrics", "eval", "wall_ms", "device_ms", "step_launches", "nccl_kernels",
            "collectives", "all_reduce_g")
    emit("dp", world=world, backend=step["backend"], config="stream_v5e8",
         batch=cfg.train.batch_size, local_batch=cfg.train.batch_size // world,
         wall_ms={**walls, "phase": (time.perf_counter() - t_phase) * 1e3},
         losses=losses, workdir_files=files, metrics_rows_train=logged,
         launches={**counts, "dp_train_by_rank": [r["train_launches"] for r in ranks]},
         step={"one_process": {k: one[k] for k in keys},
               "world": {k: step[k] for k in keys},
               "max_rel_diff": rel, "tol": tol,
               "tol_read_on_the_card": world == 1},
         stream={"min_si_sdr_db": worst, "segments_same_permutation": same,
                 "segments": n, "max_abs_diff": float(np.abs(got - ref).max()),
                 "chained_permutations_equal": perm_equal},
         note="step wall_ms: median of DP_STEP_SAMPLES synchronized steps over "
              "the group ('group') and of the same step built without it "
              "('solo'), in turns in one process; device_ms: torch.profiler, "
              "one step each; walls of the torchrun calls include process "
              "start, CUDA and NCCL init",
         not_run=None if world > 1 else
         "two or more ranks (one GPU visible): an all-reduce across cards, NCCL's "
         "ring or tree kernels and a split batch; at world 1 NCCL completes each "
         "in-place SUM all-reduce without a kernel")
    return counts


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


def captured(fn, argv) -> str:
    """Run an entry point's main(argv), check that it returns 0, and return
    what it printed on stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    check(rc == 0, f"{fn.__module__}.main({argv}) returned {rc}")
    return buf.getvalue()


def captured_json(fn, argv):
    """The JSON line an entry point's main(argv) prints last on stdout."""
    return json.loads(captured(fn, argv).strip().splitlines()[-1])


class TimedDataset:
    """A dataset whose batch() calls add their host seconds to `seconds`."""

    def __init__(self, dataset):
        self.dataset, self.seconds = dataset, 0.0

    def batch(self, *args):
        t0 = time.perf_counter()
        out = self.dataset.batch(*args)
        self.seconds += time.perf_counter() - t0
        return out


def bound_split(cfg, dev) -> tuple:
    """recompute_bounds.oracle_bound(cfg) on the kernel path, its wall split
    into the host's synthesis of the batches (dataset.batch()) and the
    rest (copies, launches, the device), with the device ms torch.profiler
    recorded and the K4 launches it recorded against those made."""
    from torch.profiler import ProfilerActivity, profile

    made, inner = [], recompute_bounds.make_dataset

    def timed(*args, **kwargs):
        made.append(TimedDataset(inner(*args, **kwargs)))
        return made[-1]

    recompute_bounds.make_dataset = timed
    k4.launches = 0
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            value = recompute_bounds.oracle_bound(cfg, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        recompute_bounds.make_dataset = inner
    dev_events = profiler.device_work(prof)
    return value, {
        "wall_s": wall, "host_synthesis_s": made[0].seconds,
        "rest_s": wall - made[0].seconds,
        "device_ms_recorded": sum(e.self_device_time_total for e in dev_events) / 1e3,
        "k4_launches": {"made": k4.launches, "recorded": sum(
            e.count for e in dev_events if "stft_features_kernel" in e.key)}}


def phase_bounds(dev):
    """recompute_bounds on the kernel path for each preset and protocol,
    then the same batches on both DSP paths, unrounded; the kernel path's
    wall split into host synthesis and the rest."""
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
            kernel, split = bound_split(cfg, dev)
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
                 wall_s=wall, kernel_path_split=split, tol_db={"plain": BOUND_TOL_DB,
                                      "jax_cpu": JAX_BOUND_TOL_DB})
    return launches, walls


def finite(value) -> bool:
    if isinstance(value, list):
        return all(finite(v) for v in value)
    return not isinstance(value, float) or math.isfinite(value)


# The options phase: music_complex_44k with the fold stem and fold head,
# and stream_v5e8 with every other model option on.
MUSIC_FOLD = ("model.g_stem_mode=fold", "model.g_stem_stride=1,2",
              "model.g_head_mode=fold")
STREAM_OPTIONS = ("model.discriminator=patch", "model.d_norm=batch",
                  "model.d_input_fold=2", "model.dropout=0.1",
                  "model.g_stem_mode=conv", "model.g_stem_stride=1,2",
                  "model.g_head_mode=film", "model.g_dec_l0=subpixel",
                  "model.g_phase_ct=true", "model.g_remat=true")
OPTIONS_STEPS, OPTIONS_STEP_SAMPLES = 4, 8
SEED_OPTIONS = 9                     # the options phase's own generator
SR_MUSIC, T_MUSIC_SEP = 44100, 30 * 44100      # the separated music wav: 30 s


def set_args(overrides) -> list:
    return [a for o in overrides for a in ("--set", o)]


def counted(fn):
    """(fn(), the launches of every kernel it made), each count set to 0
    just before and read just after (the device synchronized)."""
    reset_launch_counts()
    k4.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {**launch_counts(), "stft": k4.launches}


def both_paths(exp, keys=("g_loss", "g_recon", "d_loss")):
    """One step from one state on the kernel and on the plain DSP path: the
    metrics, the states after, and the relative gaps, checked."""
    out, states = {}, {}
    for path in (None, "reference"):
        states[path or "kernel"] = state = copy.deepcopy(exp.state)
        with dispatch.force_backend(path):
            _, m = exp._train_step(state, exp._bank, exp._train_seed)
        out[path or "kernel"] = {k: float(v) for k, v in m.items()}
    gaps = {}
    for key in keys:
        a, b = out["kernel"][key], out["reference"][key]
        gaps[key] = abs(a - b) / max(abs(b), 1.0)
        check(gaps[key] <= 1e-2, f"{exp.cfg.name} options step {key}: kernel {a} "
              f"vs plain {b}")
    return out, gaps, states


def g_grads(step, exp) -> list:
    """G's gradients (as the optimizer receives them) of one step of
    `step` from a copy of exp's state."""
    state = copy.deepcopy(exp.state)
    got = []
    inner = state.g_opt.step
    state.g_opt.step = lambda grads: (got.append([g.detach().clone() for g in grads]),
                                      inner(grads))
    step(state, exp._bank, exp._train_seed)
    return got[0]


def paired_walls(exps: dict) -> dict:
    """Median wall ms (synchronized) of one train step of each Experiment,
    OPTIONS_STEP_SAMPLES each, in turns (a, b, b, a, ...)."""
    names = list(exps)
    walls = {n: [] for n in names}
    for n in names:
        exps[n]._train_step(exps[n].state, exps[n]._bank, exps[n]._train_seed)
    for i in range(2 * OPTIONS_STEP_SAMPLES):
        n = (names + names[::-1])[i % (2 * len(names))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exps[n]._train_step(exps[n].state, exps[n]._bank, exps[n]._train_seed)
        torch.cuda.synchronize()
        walls[n].append((time.perf_counter() - t0) * 1e3)
    return {n: statistics.median(w) for n, w in walls.items()}


def phase_options(dev, tmp: Path):
    """The model options at full width.  (a) music_complex_44k with the fold
    stem (1, 2) and fold head: one step on each DSP path from one state;
    the step profiled and timed beside the default music step in this
    process; `cli train` into a workdir (4 steps, then 2 resumed), `cli
    eval`, `cli separate` of a 30 s wav (kernel vs plain >= 40 dB), the
    quality protocol.  (b) stream_v5e8 with the patch BN D on the folded
    input, dropout, the conv stem, film head, subpixel dec_l0,
    PhaseConvTranspose and g_remat: 2 steps (K3 and its backward once a
    step), one step on each path, its step profile and wall beside the
    default stream_v5e8 step's, BN statistics finite and moved, G's
    gradients with and without remat; one step with the group-norm D.
    (c) `cli train` 2src_toy_cpu as shipped and with the toy G.  Its own
    generator leaves the later phases' inputs as they were."""
    rng = np.random.default_rng(SEED_OPTIONS)
    counts = {}
    dev_args = ["--device", str(dev)]

    # (a) music, fold head.
    music_sets = set_args(MUSIC_FOLD)
    cfg = cli._apply_overrides(config.get_config("music_complex_44k"), list(MUSIC_FOLD))
    exp = Experiment(cfg, device=dev)
    default = Experiment(config.get_config("music_complex_44k"), device=dev)
    check(exp.state.g.fold_head and not hasattr(exp.state.g, "head"),
          "music options: G has no fold head")
    one_step, gaps, _ = both_paths(exp)
    profiles = {"fold_head": step_profile(exp), "default": step_profile(default)}
    for name, prof in profiles.items():
        k1_fam = prof["by_family"].get("K1 stft_features", {}).get("launches")
        prof["k1_launches_per_step_recorded"] = k1_fam
    walls = paired_walls({"fold_head": exp, "default": default})
    peaks = {}
    for name, e in (("fold_head", exp), ("default", default)):
        torch.cuda.reset_peak_memory_stats()
        e._train_step(e.state, e._bank, e._train_seed)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**20
    g_params = {n: sum(p.numel() for p in e.state.g.parameters())
                for n, e in (("fold_head", exp), ("default", default))}
    del exp, default
    wd = tmp / "music_fold"
    common = ["--config", "music_complex_44k", "--workdir", str(wd), *dev_args, *music_sets]
    out, counts["options_music_train"] = counted(
        lambda: captured(cli.main, ["train", *common, "--steps", str(OPTIONS_STEPS)]))
    check(counts["options_music_train"]["stft_features"] == 2 * OPTIONS_STEPS,
          f"music options train launches {counts['options_music_train']}")
    losses = {OPTIONS_STEPS: cli_losses(out, OPTIONS_STEPS)}
    out = captured(cli.main, ["train", *common, "--steps", "2"])
    check(f"resumed from step {OPTIONS_STEPS}" in out, f"music options resume: {out}")
    losses[OPTIONS_STEPS + 2] = cli_losses(out, OPTIONS_STEPS + 2)
    check(all(math.isfinite(v) for m in losses.values() for v in m.values()),
          f"music options losses {losses}")
    ev, counts["options_music_eval"] = counted(lambda: captured(
        cli.main, ["eval", *common, "--batches", "1"]))
    check("si_sdr_improvement" in ev and counts["options_music_eval"]["masked_istft"] == 1
          and counts["options_music_eval"]["stft_features"] == 1,
          f"music options eval: {ev} {counts['options_music_eval']}")
    wav = tmp / "music30s.wav"
    write_wav(str(wav), SR_MUSIC, mixtures(rng, 1, T_MUSIC_SEP, SR_MUSIC)[0])
    _, counts["options_music_separation"] = counted(lambda: captured(cli.main, [
        "separate", *common, "--input", str(wav), "--output-dir", str(tmp / "music_out")]))
    check(counts["options_music_separation"]["stft_features"] == 1
          and counts["options_music_separation"]["masked_istft"] == 1,
          f"music options separation launches {counts['options_music_separation']}")
    srcs = np.stack([read_wav(str(tmp / "music_out" / f"{wav.stem}_src{i}.wav"))[1]
                     for i in range(S_MUSIC)])
    check(srcs.shape == (S_MUSIC, T_MUSIC_SEP) and np.isfinite(srcs).all(),
          f"music options cli separate: {srcs.shape}")
    trained = Experiment(config.Config.from_json((wd / "config.json").read_text()),
                         workdir=str(wd), device=dev)
    check(trained.state.step == OPTIONS_STEPS + 2, f"music options workdir at "
          f"step {trained.state.step}")
    g, mix = trained.eval_generator(), read_wav(str(wav))[1]
    est = separate(g, trained.cfg, mix, dev)
    with dispatch.force_backend("reference"):
        ref = separate(g, trained.cfg, mix, dev)
    sep_db = best_perm_agreement(est[None], ref[None])
    check(sep_db >= 40.0, f"music options separation kernel vs plain {sep_db} dB")
    del trained, g
    quality, counts["options_music_quality"] = counted(lambda: captured_json(
        quality_protocol.main, ["music_complex_44k", str(QUALITY_MUSIC_STEPS),
                                *music_sets, *dev_args]))
    check(set(quality) == QUALITY_KEYS and all(finite(v) for v in quality.values()),
          f"music options quality: {quality}")
    check(all(counts["options_music_quality"][k] > 0
              for k in ("stft_features", "masked_istft", "stft")),
          f"music options quality launches {counts['options_music_quality']}")
    emit("options", path="music_complex_44k fold head", sets=list(MUSIC_FOLD),
         batch=cfg.train.batch_size, segment_samples=cfg.segment_samples,
         g_params=g_params, one_step=one_step, gap=gaps,
         tol="|kernel - plain| <= 1e-2 * max(|plain|, 1)",
         step_wall_ms=walls, peak_device_mib=peaks, step_profile=profiles,
         cli_losses=losses, resumed_at=OPTIONS_STEPS, eval=ev.strip().splitlines(),
         separation_kernel_vs_plain_min_db=sep_db, quality=quality,
         launches={k: v for k, v in counts.items() if k.startswith("options_music")})

    # (b) stream_v5e8, every other option.
    cfg = cli._apply_overrides(config.get_config("stream_v5e8"), list(STREAM_OPTIONS))
    exp = Experiment(cfg, device=dev)
    d, g = exp.state.d, exp.state.g
    check(d.patch and d.norm == "batch" and g.phase_ct and g.dec_l0 == "subpixel"
          and g.head.mode == "pack", "stream options: the modules lack an option")
    bn0 = [t.detach().clone() for n in d.norms for t in (n.mean, n.var)]
    last, counts["options_stream_train"] = counted(lambda: exp.train(num_steps=2))
    c = counts["options_stream_train"]
    check(c["istft"] == 2 and c["istft_bwd"] == 2 and c["stft_features"] == 4,
          f"stream options train launches {c}")
    check(all(np.isfinite(v) for v in last.values()), f"stream options: {last}")
    bn = [t.detach() for n in d.norms for t in (n.mean, n.var)]
    bn_moved = max(max_err(a, b) for a, b in zip(bn0, bn))
    check(all(bool(torch.isfinite(t).all()) for t in bn) and bn_moved > 0,
          f"stream options BN statistics: moved {bn_moved}")
    one_step_s, gaps_s, _ = both_paths(exp)
    default = Experiment(config.get_config("stream_v5e8"), device=dev)
    profiles_s = {"every_option": step_profile(exp), "default": step_profile(default)}
    walls_s = paired_walls({"every_option": exp, "default": default})
    del default
    no_remat = build_train_step(
        cfg.replace(model=dataclasses.replace(cfg.model, g_remat=False)),
        from_bank=True, local_batch=exp.dp.local_batch)
    ga, gb = g_grads(exp._train_step, exp), g_grads(no_remat, exp)
    g_max = max(float(t.abs().max()) for t in gb)
    remat_err = max(max_err(a, b) for a, b in zip(ga, gb))
    check(remat_err <= 1e-2 * g_max, f"g_remat G gradients {remat_err} vs max {g_max}")
    group_cfg = cli._apply_overrides(config.get_config("stream_v5e8"),
                                     ["model.d_norm=group"])
    group_last = Experiment(group_cfg, device=dev).train(num_steps=1)
    check(all(np.isfinite(v) for v in group_last.values()), f"group D: {group_last}")
    emit("options", path="stream_v5e8 every option", sets=list(STREAM_OPTIONS),
         batch=cfg.train.batch_size, last=last, one_step=one_step_s, gap=gaps_s,
         step_wall_ms=walls_s, step_profile=profiles_s,
         bn_running_stats_moved_max_abs=bn_moved,
         remat_g_grad_max_abs_err=remat_err, g_grad_max_abs=g_max,
         remat_tol="<= 1e-2 * max|g|", group_norm_step=group_last,
         launches=counts["options_stream_train"])
    del exp, d, g

    # (c) 2src_toy_cpu with both generators.
    toy = {}
    for name, sets in (("conv", []), ("toy", ["--set", "model.generator=toy"])):
        out, counts[f"options_toy_{name}"] = counted(lambda: captured(cli.main, [
            "train", "--config", "2src_toy_cpu", "--steps", "2", *dev_args, *sets]))
        toy[name] = cli_losses(out, 2)
        check(all(math.isfinite(v) for v in toy[name].values())
              and counts[f"options_toy_{name}"]["stft_features"] == 4,
              f"2src_toy_cpu {name}: {toy[name]} {counts[f'options_toy_{name}']}")
    emit("options", path="2src_toy_cpu", losses_step_2=toy,
         launches={k: v for k, v in counts.items() if k.startswith("options_toy")})
    return counts


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
    profile = step_profile(exp)
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
        "peak_device_mib": peak, "step_profile": profile})
    return runs


def tool_worker(out: str, module: str, *argv) -> int:
    """A tools-phase process: `module.main(argv)`, what `python -m module
    argv...` runs, then the kernels it launched and its exit code written
    to `out` as JSON."""
    reset_launch_counts()
    k4.launches = 0
    rc = importlib.import_module(module).main(list(argv))
    Path(out).write_text(json.dumps({"rc": rc, "launches": {
        **launch_counts(), "stft": k4.launches}}))
    return rc


def tool_process(tmp: Path, name: str, module: str, *argv) -> tuple:
    """(wall s, stdout, launches) of `module.main(argv)` in a process of its
    own (tool_worker); a non-zero exit fails the run."""
    out = tmp / f"{name}.json"
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(SCRIPT), "--tool-worker", str(out),
                          module, *argv], cwd=ROOT, capture_output=True, text=True,
                         timeout=TOOLS_TIMEOUT_S,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-3000:], res.stderr[-6000:], sep="\n", file=sys.stderr)
    check(res.returncode == 0, f"tools: {module} {' '.join(argv[:4])} exited "
          f"{res.returncode}")
    return wall, res.stdout, json.loads(out.read_text())["launches"]


def trace_report(logdir: Path) -> dict:
    """The profiled steps and the DSP kernels a --profile-steps trace
    recorded (each against the launches its steps made), and its device
    ms a step by the step's ranges."""
    traces = profiler.trace_files(str(logdir))
    check(len(traces) == 1, f"tools: {len(traces)} traces under {logdir}")
    events = profiler.load_trace(traces[0])
    steps = sorted(e["name"] for e in profiler.annotations(events, profiler.STEP_PREFIX))
    n = TOOLS_PROFILE[1] - TOOLS_PROFILE[0]
    check(steps == [f"{profiler.STEP_PREFIX}{i}" for i in range(*TOOLS_PROFILE)],
          f"tools: the trace's steps {steps}")
    kernels = [e["name"] for e in profiler.device_events(events)]
    recorded = {k: sum(k in name for name in kernels) for k in (
        "stft_features_kernel", "istft_ola_kernel", "istft_adjoint_kernel")}
    check(min(recorded.values()) > 0, f"tools: a DSP kernel missing from the "
          f"trace: {recorded}")
    buckets = profiler.attribute(events, profiler.STEP_RANGES,
                                 profiler.annotations(events, profiler.STEP_PREFIX))
    return {"file": Path(traces[0]).name, "steps": steps, "kernels_recorded": recorded,
            "kernels_made": {"stft_features_kernel": 2 * n, "istft_ola_kernel": n,
                             "istft_adjoint_kernel": n},
            "device_us_per_step": {k: v / n for k, v in buckets.items()}}


def debug_walls(dev) -> dict:
    """stream_v5e8 train steps (synchronized wall ms and memory_allocated
    after each) with and without debug_nans and debug_leaks, in turns;
    anomaly mode off again after."""
    exp = Experiment(config.get_config("stream_v5e8"), device=dev)
    exp._step(exp._bank)
    walls = {False: [], True: []}
    mib = {False: [], True: []}
    for i in range(2 * DEBUG_STEP_SAMPLES):
        debug = (False, True, True, False)[i % 4]
        exp.debug_nans = exp.debug_leaks = debug
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp._step(exp._bank)
        torch.cuda.synchronize()
        walls[debug].append((time.perf_counter() - t0) * 1e3)
        mib[debug].append(torch.cuda.memory_allocated() / 2**20)
    check(not torch.is_anomaly_enabled(), "tools: anomaly mode left on")
    return {"step_wall_ms": {"debug": statistics.median(walls[True]),
                             "plain": statistics.median(walls[False])},
            "memory_allocated_mib": {"debug": mib[True], "plain": mib[False]},
            "steps_each": DEBUG_STEP_SAMPLES}


def phase_tools(dev, tmp: Path):
    """The CLI's train flags and the tools at full width, each path's kernel
    launches counted (counts set to 0 just before, read just after)."""
    rng = np.random.default_rng(SEED_TOOLS)
    paths, report = {}, {}

    # cli train with every new flag, in a process of its own.
    wd = tmp / "run"
    wall, out, paths["tools_cli_train"] = tool_process(
        tmp, "cli_train", "gan_sass_tf_tpu_torch.cli", "train", "--config",
        "stream_v5e8", "--workdir", str(wd), "--steps", str(TOOLS_STEPS),
        "--profile-steps", "{}:{}".format(*TOOLS_PROFILE), "--tensorboard",
        "--debug-nans", "--debug-leaks", "--device", str(dev), "--set",
        "train.log_every=1")
    got = paths["tools_cli_train"]
    check((got["stft_features"], got["istft"], got["istft_bwd"]) ==
          (2 * TOOLS_STEPS, TOOLS_STEPS, TOOLS_STEPS), f"tools cli train launches {got}")
    rows = [json.loads(ln) for ln in (wd / "metrics.jsonl").read_text().splitlines()]
    scalars = {(step, tag): v for step, tag, v in tb_events.read_dir(str(wd / "tb"))}
    want = {(r["step"], k): v for r in rows for k, v in r.items()
            if k not in ("step", "time") and isinstance(v, float)}
    check(len(rows) == TOOLS_STEPS and set(scalars) == set(want)
          and all(scalars[k] == float(np.float32(v)) for k, v in want.items()),
          f"tools: W/tb does not equal W/metrics.jsonl ({len(scalars)} scalars, "
          f"{len(want)} values)")
    check(all(math.isfinite(v) for v in want.values()), f"tools: {rows[-1]}")
    report["cli_train"] = {"wall_s": wall, "launches": got, "trace": trace_report(
        wd / "profile"), "tensorboard_scalars": len(scalars), "logged_steps": len(rows),
        "last": cli_losses(out, TOOLS_STEPS)}
    report["debug_tripwires"] = debug_walls(dev)

    # entry(): the zero example mixture, then kernel vs plain on a seeded one.
    def run_entry():
        fn, (g, mix0) = port_entry.entry()
        x = torch.from_numpy(mixtures(rng, 4, mix0.shape[1], SR_STREAM)).to(dev)
        with dispatch.force_backend("reference"):
            ref = fn(g, x)
        return fn(g, mix0), fn(g, x), ref

    (out0, ker, ref), got = counted(run_entry)
    paths["tools_entry"] = got
    agree = float(si_sdr(ker.float().cpu(), ref.float().cpu()).min())
    check(tuple(out0.shape) == (4, 2, out0.shape[-1]) and bool(torch.isfinite(out0).all())
          and got["stft_features"] == 2 and got["masked_istft"] == 2 and agree >= 40.0,
          f"tools entry(): {tuple(out0.shape)}, launches {got}, {agree} dB")
    report["entry"] = {"out": list(out0.shape), "launches": got,
                       "si_sdr_kernel_vs_plain_db_min": agree, "tol_db": 40.0}

    # profile_step in a process of its own, early in it.
    wall, out, paths["tools_profile_step"] = tool_process(
        tmp, "profile_step", "gan_sass_tf_tpu_torch.scripts.profile_step",
        "stream_v5e8", "32", "--device", str(dev))
    line = json.loads(out.strip().splitlines()[-1])
    buckets = line["buckets_us_per_step"]
    named = sum(v for k, v in buckets.items() if k != "other")
    total = line["device_ms_per_step"] * 1e3
    check(named >= 0.95 * total, f"tools profile_step: the step's ranges hold "
          f"{named} of {total} device us")
    report["profile_step"] = {"wall_s": wall, "line": line, "ranges_share": named / total,
                              "launches": paths["tools_profile_step"]}

    line, paths["tools_stream_quality"] = counted(lambda: captured_json(
        stream_quality.main, [str(STREAM_QUALITY_STEPS), "--device", str(dev)]))
    check(all(finite(v) for v in line.values()) and len(line) == 11,
          f"tools stream_quality: {line}")
    report["stream_quality"] = {"line": line, "launches": paths["tools_stream_quality"]}

    t0 = time.perf_counter()
    out, paths["tools_bench_presets"] = counted(lambda: captured(
        bench_presets.main, ["--steps", BENCH_STEPS, "--device", str(dev),
                             *bench_presets.PRESET_STEPS, "streaming"]))
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    check(len(rows) == len(bench_presets.PRESET_STEPS) + 2
          and all(r["value"] > 0 for r in rows), f"tools bench_presets: {rows}")
    report["bench_presets"] = {"rows": rows, "steps": BENCH_STEPS,
                               "wall_s": time.perf_counter() - t0,
                               "launches": paths["tools_bench_presets"]}

    out, paths["tools_bench_streaming_compute"] = counted(lambda: captured(
        bench_streaming_compute.main, [str(STREAMING_COMPUTE_SECONDS), "5",
                                       "--device", str(dev)]))
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    check([r["mode"] for r in rows] == ["scan", "batch"]
          and all(r["ms_per_chunk"] > 0 for r in rows),
          f"tools bench_streaming_compute: {rows}")
    report["bench_streaming_compute"] = {"rows": rows}

    qs = tmp / "quickstart"
    out, paths["tools_quickstart"] = counted(lambda: captured(
        quickstart.main, [str(qs), str(QUICKSTART_STEPS), "--device", str(dev)]))
    wavs = [read_wav(str(qs / f"{n}.wav"))[1] for n in ("mixture", "source_0", "source_1")]
    check(all(w.shape == wavs[0].shape and np.isfinite(w).all() for w in wavs)
          and f"step {QUICKSTART_STEPS}:" in out, f"tools quickstart: {out[-300:]}")
    report["quickstart"] = {"eval": out.strip().splitlines()[-3]}

    t0 = time.perf_counter()
    res, paths["tools_wavdir"] = counted(lambda: train_wavdir_fixture.run(
        WAVDIR_STEPS, dev, log=lambda *_: None))
    check(res["ok"], f"tools train_wavdir_fixture: {res}")
    report["train_wavdir_fixture"] = {**res, "wall_s": time.perf_counter() - t0}

    for path, got in paths.items():
        check(got["stft_features"] > 0, f"tools {path}: K1 never launched: {got}")
    for path in ("tools_stream_quality", "tools_bench_presets",
                 "tools_bench_streaming_compute", "tools_quickstart", "tools_wavdir"):
        check(paths[path]["masked_istft"] > 0, f"tools {path}: K2 never launched")
    for path in ("tools_profile_step", "tools_stream_quality", "tools_bench_presets",
                 "tools_quickstart"):
        check(paths[path]["istft"] > 0 and paths[path]["istft_bwd"] > 0,
              f"tools {path}: K3 or its backward never launched: {paths[path]}")
    emit("tools", **report)
    return paths


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


def time_fns(samples=TIMING_SAMPLES, calls=CALLS_PER_SAMPLE, **fns):
    """Median per-call ms of each function: CUDA events around `calls`
    back-to-back calls make one sample; the samples take the functions in
    turn, forward then backward (plain, kernel, kernel, plain, ...)."""
    for _ in range(3):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    order = list(fns) + list(fns)[::-1]
    times = {name: [] for name in fns}
    for i in range(samples * len(fns)):
        name = order[i % len(order)]
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fns[name]()
        b.record()
        b.synchronize()
        times[name].append(a.elapsed_time(b) / calls)
    return {name: statistics.median(t) for name, t in times.items()}


def time_pair(plain, kernel):
    """(plain ms, kernel ms), timed in turns."""
    t = time_fns(plain=plain, kernel=kernel)
    return t["plain"], t["kernel"]


def library_stft(x, n_fft, hop):
    """torch.stft on the same frames and window: the one PyTorch call that
    computes the same function as the STFT kernels (its layout is (K, F)),
    timed beside them and used nowhere in the port."""
    w = torch.from_numpy(get_window("hann", n_fft)).to(x.device)
    flat = x.reshape(-1, x.shape[-1])
    return lambda: torch.stft(flat, n_fft, hop, window=w, center=False,
                              return_complex=True)


def device_kernels(fn, calls=CALLS_PER_SAMPLE) -> dict:
    """{kernel name: (device ms, launches) per call} of the kernels `fn`
    launches, from torch.profiler (CPU and CUDA activities) after one
    warm-up call.  In short windows the profiler may miss launches (late
    in a run, sometimes all of a 10-call window: PERF.md), so callers hold
    the launches it recorded to the launches made."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / calls / 1e3, e.count / calls)
            for e in profiler.device_work(prof)}


def device_ms(fn, calls=CALLS_PER_SAMPLE):
    """Device ms per call of the kernels `fn` launches (the card's time
    without the wrapper's host time), or None where the profiler recorded
    some kernel a fractional number of times a call, or none: then it
    missed launches, and the sum would read low."""
    dk = device_kernels(fn, calls)
    if not dk or any(n != round(n) for _, n in dk.values()):
        return None
    return sum(ms for ms, _ in dk.values())


def graph_ms(fn, calls=CALLS_PER_SAMPLE) -> float:
    """Median device ms a call of `fn`: CUDA events around a replayed CUDA
    graph of `calls` back-to-back calls, so every launch is timed and no
    host time falls between them (as scripts/time_synthesis.py)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_SAMPLES):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def launch_ms(fn, graph=True) -> dict:
    """Device ms of the one kernel a wrapper launches: `ms` a call from a
    replayed CUDA graph (graph=False: torch.profiler's per-call sum, given
    only when it recorded every launch), beside the profiler's mean per
    recorded launch and its launches recorded per call."""
    dk = device_kernels(fn)
    check(len(dk) <= 1, f"one wrapper call launched {sorted(dk)}")
    ms, n = next(iter(dk.values()), (0.0, 0.0))
    per_call = graph_ms(fn) if graph else (ms if n == 1.0 else None)
    return {"ms": per_call, "profiler_ms_per_launch": ms / n if n else None,
            "launches_per_call": n}


def profiler_window_check(fn, name="stft_features_kernel", reps=4) -> dict:
    """Launches per call of `name` that torch.profiler records over
    CALLS_PER_SAMPLE calls of `fn`, `reps` times each: in a window padded
    with idle time at both ends (as device_kernels), and in one where the
    calls are followed by FILL_LAUNCHES small kernels before the window
    closes (if the recorder holds a short window's records back until its
    buffers fill, these push them out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def recorded(fill):
        fn()
        torch.cuda.synchronize()
        filler = torch.zeros(1, device="cuda")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(CALLS_PER_SAMPLE):
                fn()
            for _ in range(fill):
                filler.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and name in e.key) / CALLS_PER_SAMPLE

    return {"padded": [recorded(0) for _ in range(reps)],
            f"filled_{FILL_LAUNCHES}": [recorded(FILL_LAUNCHES) for _ in range(reps)]}


def step_profile(exp) -> dict:
    """Device ms (and launches) a train step by kernel family, over
    PROFILE_STEPS steps on the kernel path, and the busy total."""
    fams = {}
    for name, (ms, n) in device_kernels(
            lambda: exp._train_step(exp.state, exp._bank, exp._train_seed),
            PROFILE_STEPS).items():
        low = name.lower()
        fam = next((f for f, keys in KERNEL_FAMILIES if any(k in low for k in keys)),
                   "other")
        ms0, n0 = fams.get(fam, (0.0, 0.0))
        fams[fam] = (ms0 + ms, n0 + n)
    return {"steps": PROFILE_STEPS, "device_busy_ms": sum(ms for ms, _ in fams.values()),
            "by_family": {f: {"ms": ms, "launches": n} for f, (ms, n)
                          in sorted(fams.items(), key=lambda kv: -kv[1][0])}}


def time_stft(kernel, plain, x, n_fft, hop, emits=("spec",), n_mels=0):
    """A K1 or K4 call timed beside its plain version and torch.stft, with
    its bound; the dict the timing line and the kernels line read."""
    fns = {"plain": plain, "kernel": kernel, "library": library_stft(x, n_fft, hop)}
    t = time_fns(**fns)
    ms, by = stft_bound(x, n_fft, hop, emits, n_mels)
    return {"shape": list(x.shape), "n_fft": n_fft, "emit": list(emits),
            "kernel": t["kernel"], "plain": t["plain"], "library": t["library"],
            "device": {"kernel": launch_ms(kernel), "plain": device_ms(plain),
                       "library": device_ms(fns["library"])},
            "bound": ms, "bound_by": by}


def time_kernel(kernel, plain, bound_ms_by, graph=True):
    """A kernel call timed beside its plain version, through the wrapper
    and on the device, with its bound; no one PyTorch call computes it."""
    t = time_fns(plain=plain, kernel=kernel)
    return {"kernel": t["kernel"], "plain": t["plain"],
            "device": {"kernel": launch_ms(kernel, graph), "plain": device_ms(plain)},
            "bound": bound_ms_by[0], "bound_by": bound_ms_by[1]}


def k1_timing(x, n_fft, hop, emits, mel=None):
    n_mels = mel.shape[1] if mel is not None else 0
    return time_stft(
        lambda: k1.stft_features_kernel(x, n_fft, hop, emit=emits, mel_matrix=mel),
        lambda: k1.stft_features_reference(x, n_fft, hop, emit=emits, mel_matrix=mel),
        x, n_fft, hop, emits, n_mels)


def phase_timing(rng, dev, x, spec, cfg, g, batch, k3_tensors, exp, k4_inputs,
                 k1_music, k2_music, bound_walls):
    mel = torch.from_numpy(mel_filterbank(N_MELS, N_FFT // 2 + 1, SR)).to(dev)
    k1_sep = k1_timing(x, N_FFT, HOP, ("spec", "logmel"), mel)
    k1_steps = {what: k1_timing(xm, MUSIC_N_FFT, MUSIC_HOP, emits)
                for what, (xm, emits) in k1_music.items()}
    masks = torch.from_numpy(rng.uniform(0, 1, (B_MAIN, 2) + tuple(spec.shape[-2:]))
                             .astype(np.float32)).to(dev)
    k2_sep = time_kernel(
        lambda: k2.masked_istft_kernel(spec, masks, N_FFT, HOP),
        lambda: k2.masked_istft_reference(spec, masks, N_FFT, HOP),
        istft_bound(spec.numel() * 8, B_MAIN, 2, spec.shape[-2], N_FFT, HOP,
                    masks.numel() * 4, 2 * masks.numel()))
    sm, mm = k2_music     # complex masks: 6 flops a (source, bin)
    k2_mus = time_kernel(
        lambda: k2.masked_istft_kernel(sm, mm, MUSIC_N_FFT, MUSIC_HOP, mask_type="complex"),
        lambda: k2.masked_istft_reference(sm, mm, MUSIC_N_FFT, MUSIC_HOP,
                                          mask_type="complex"),
        istft_bound(sm.numel() * 8, B_MUSIC, 2, sm.shape[-2], MUSIC_N_FFT, MUSIC_HOP,
                    mm.numel() * 4, 3 * mm.numel()))

    def run_sep(path):
        def go():
            with dispatch.force_backend(path):
                separate(g, cfg, batch, dev)
        return go

    sep_plain, sep_kernel = time_pair(run_sep("reference"), run_sep(None))
    audio_s = batch.shape[0] * batch.shape[1] / SR
    re, im, y, ref, dy = k3_tensors
    f = re.shape[-2]
    with torch.no_grad():
        k3_t = time_kernel(lambda: k3.istft_kernel(re, im, N_FFT, HOP),
                           lambda: k3.istft_reference(re, im, N_FFT, HOP),
                           istft_bound(re.numel() * 8, re.shape[0], 1, f, N_FFT, HOP))
    # The backward reads the cotangent once and writes both planes once,
    # with an FFT a frame: the bytes and flops of a spec-only STFT of it.
    bwd_bound = stft_bound(ref, N_FFT, HOP)
    bwd_t = time_kernel(
        lambda: torch.autograd.grad(y, (re, im), dy, retain_graph=True),
        lambda: torch.autograd.grad(ref, (re, im), dy, retain_graph=True), bwd_bound,
        graph=False)
    # Its one launch alone, on a cotangent of the same shape, beside the
    # plain adjoint (the STFT of dy·inv_env scaled per bin).
    z = torch.randn_like(ref).contiguous()
    inv, a_k = k2._inv_env(N_FFT, HOP, "hann", f, dev), k3._bin_weights(N_FFT, dev)
    adjoint = time_kernel(
        lambda: k3.istft_adjoint(z, N_FFT, HOP, "hann", f),
        lambda: torch.view_as_real(
            k1.stft_features_reference(z * inv, N_FFT, HOP)["spec"]) * a_k, bwd_bound)
    stream_srcs, music_srcs = k4_inputs
    # K1 at the stream_v5e8 step's shape, spec only: torch.stft computes the
    # same function there.
    k1_stream_step = k1_timing(stream_srcs.reshape(-1, stream_srcs.shape[-1]),
                               N_FFT, HOP, ("spec",))
    prof_check = profiler_window_check(
        lambda: k1.stft_features_kernel(x, N_FFT, HOP, emit=("spec", "logmel"),
                                        mel_matrix=mel))
    k4_times = {what: time_stft(lambda: k4.stft_kernel(xs, n, h),
                                lambda: k4.stft_reference(xs, n, h), xs, n, h)
                for what, xs, n, h in (("stream", stream_srcs, N_FFT, HOP),
                                       ("music", music_srcs, MUSIC_N_FFT, MUSIC_HOP))}
    step_kernel, step_plain = time_steps(exp)
    mix_s = exp.cfg.train.batch_size * exp.cfg.segment_samples / exp.cfg.dsp.sample_rate
    emit("timing", shape=[B_MAIN, T_MAIN], samples=TIMING_SAMPLES,
         calls_per_sample=CALLS_PER_SAMPLE,
         stft_features_ms=k1_sep, stft_features_music_step_ms=k1_steps,
         stft_features_stream_step_ms=k1_stream_step,
         profiler_launches_per_call=prof_check,
         masked_istft_ms=k2_sep, masked_istft_music_ms=k2_mus,
         separate_ms={"kernel": sep_kernel, "plain": sep_plain},
         separate_mix_sec_per_sec={"kernel": audio_s / sep_kernel * 1e3,
                                   "plain": audio_s / sep_plain * 1e3},
         istft_shape=list(re.shape),
         istft_ms=k3_t, istft_bwd_ms=bwd_t, istft_adjoint_launch_ms=adjoint,
         train_step_samples=STEP_SAMPLES,
         train_step_ms={"kernel": step_kernel, "plain": step_plain},
         train_mix_sec_per_sec={"kernel": mix_s / step_kernel * 1e3,
                                "plain": mix_s / step_plain * 1e3},
         stft_ms=k4_times, recompute_bounds_wall_s=bound_walls,
         note="separate() includes host->device copy and the result's copy "
              "back; a train step is timed on the host clock to a synchronize; "
              "istft_bwd_ms is the whole autograd backward; a kernel's device "
              "ms from CUDA events around a replayed CUDA graph (the whole "
              "backward: torch.profiler), a plain version's from "
              "torch.profiler, null where it recorded a kernel a fractional "
              "number of times a call")
    return {"stft_features": {**row(k1_sep), "library_ms": None,
                              "stream_step_shape": row(k1_stream_step)},
            "masked_istft": {**row(k2_sep), "music_shape": row(k2_mus)},
            "istft": row(k3_t),
            "istft_bwd": {**row(bwd_t), "adjoint_launch": row(adjoint)},
            "stft": row(k4_times["stream"])}


def row(t) -> dict:
    """A `kernels` line entry from a time_stft or time_kernel dict."""
    return {"ms": t["kernel"], "device_ms": t["device"]["kernel"]["ms"],
            "plain_ms": t["plain"], "plain_device_ms": t["device"]["plain"],
            "bound_ms": t["bound"], "bound_by": t["bound_by"],
            "library_ms": t.get("library"),
            **({"shape": t["shape"]} if "shape" in t else {})}


def main() -> int:
    kind = phase_device()
    phase_build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    x, spec, k1_err, k1_music = phase_k1(rng, dev)
    k2_err, k2_music = phase_k2(rng, dev, x, spec)
    with tempfile.TemporaryDirectory() as tmp:
        cfg, g, batch, counts = phase_main_path(rng, dev, Path(tmp))
    k3_errs, k3_tensors = phase_k3(rng, dev)
    k4_err, *k4_inputs = phase_k4(rng, dev)
    exp, train_counts = phase_train(dev)
    with tempfile.TemporaryDirectory() as tmp:
        pit3_counts, pit3_rows = phase_pit3(rng, dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        opt = phase_options(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        wd, workdir_counts = phase_workdir(dev, Path(tmp))
        stream_launches, stream_shapes = phase_stream(rng, dev, Path(tmp), wd)
        dp_counts = phase_dp(dev, Path(tmp))
    bound_launches, bound_walls = phase_bounds(dev)
    quality_runs = phase_quality(dev)
    times = phase_timing(rng, dev, x, spec, cfg, g, batch, k3_tensors, exp,
                         k4_inputs, k1_music, k2_music, bound_walls)
    with tempfile.TemporaryDirectory() as tmp:
        tools = phase_tools(dev, Path(tmp))
    quality_launches = {"stft": sum(r["launches"]["stft"] for r in quality_runs.values())}

    def by_path(name, **paths):
        got = {p: c[name] for p, c in paths.items()}
        return {"launches": sum(got.values()), "launches_by_path": got}

    def stream_rows(name):
        return {f"{b} x {SR_STREAM} chunk{'s' if b > 1 else ''}": row(v[name])
                for b, v in stream_shapes.items()}

    kernels = [
        {"name": "stft_features", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/stft_features.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_stft.py:63",
         **by_path("stft_features", main_path=counts,
                   stream_batch=stream_launches["batch"],
                   stream_scan=stream_launches["scan"],
                   pit3_train=pit3_counts["train"], pit3_eval=pit3_counts["eval"],
                   pit3_separation=pit3_counts["separation"],
                   pit3_quality=pit3_counts["quality"], **dp_counts, **opt,
                   **tools),
         "max_abs_err": k1_err, **times["stft_features"],
         "stream_shape": stream_rows("stft_features"),
         "pit3_shape": pit3_rows["stft_features"]},
        {"name": "masked_istft", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/masked_istft.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_istft.py:175",
         **by_path("masked_istft", main_path=counts,
                   stream_batch=stream_launches["batch"],
                   stream_scan=stream_launches["scan"],
                   pit3_eval=pit3_counts["eval"],
                   pit3_separation=pit3_counts["separation"],
                   pit3_quality=pit3_counts["quality"], **dp_counts,
                   **{k: opt[k] for k in ("options_music_eval",
                                          "options_music_separation",
                                          "options_music_quality")}, **tools),
         "max_abs_err": k2_err, **times["masked_istft"],
         "stream_shape": stream_rows("masked_istft"),
         "pit3_shape": pit3_rows["masked_istft"]},
        {"name": "istft", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/masked_istft.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_istft.py:71",
         **by_path("istft", train=train_counts, workdir=workdir_counts,
                   dp_train=dp_counts["dp_train"],
                   options_stream_train=opt["options_stream_train"], **tools),
         "max_abs_err": k3_errs["forward_full"], **times["istft"]},
        {"name": "istft_bwd", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/stft_features.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_istft.py:151",
         **by_path("istft_bwd", train=train_counts, workdir=workdir_counts,
                   dp_train=dp_counts["dp_train"],
                   options_stream_train=opt["options_stream_train"], **tools),
         "max_abs_err": max(k3_errs["grad_re"], k3_errs["grad_im"]),
         **times["istft_bwd"]},
        {"name": "stft", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/stft_features.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_stft.py:228",
         **by_path("stft", bounds=bound_launches, quality=quality_launches,
                   pit3_quality=pit3_counts["quality"],
                   options_music_quality=opt["options_music_quality"]),
         "max_abs_err": k4_err, **times["stft"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--tool-worker"]:
        sys.exit(tool_worker(*sys.argv[2:]))
    sys.exit(main())
