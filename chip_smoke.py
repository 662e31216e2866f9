#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
  1 device    the card's name; nvidia-smi's name and power limit line
  2 build     nvcc builds the CUDA kernels from ops/csrc (seconds)
  3 k1        stft_features kernel vs its plain version at the shapes of
              the wsj0_logmel path, a 60 s input, two other geometries, the
              music_complex_44k step's two launches (8 mixtures: spec, mag,
              logmag; 16 targets: logmag, spec) and a near-silent signal;
              K1's, K4's and K3's adjoint's outputs at
              scripts/time_analysis.py's shapes against ANALYSIS_DIGESTS
  4 k2        masked_istft kernel vs its plain version (magnitude and
              complex masks, 60 s input, STFT -> iSTFT round trip, the
              music_complex_44k bound batch at n_fft 2048, and one frame,
              two (fewer than n_fft/hop) and nine, past a tile's edge); the
              output bit-equal at three segment lengths and on a repeat call
  5 main_path the CLI `separate` on a 3 s and a 60 s wav and `separate()`
              on 16 x 3 s mixtures, with seeded-random weights at the full
              wsj0_logmel width; both kernels must have launched, and the
              same call on the plain DSP path must agree (SI-SDR >= 40 dB)
  6 k3        the differentiable iSTFT through ops.dispatch.istft (forward
              kernel on the interleaved spectrum, backward on the adjoint
              kernel) vs its plain version and autograd, at the stream_v5e8
              train shape, two other geometries and the edges of k2; the
              forward bit-equal at three segment lengths and on a repeat
              call
    rng       the threefry kernels (ops/csrc/threefry.cu) against their
              plain versions.  The batch kernel (a step's keys, bank rows,
              shifts, gains, mix and noise in one launch, the noise in a
              second) at the stream_v5e8 --hard b32 and wsj0_logmel b128
              steps' shapes, also at offset 3·b and on host-batch sources:
              picks, shifts, gains and train keys bit for bit, scaled
              within 1 ulp, the mixture within 1 ulp (under noise within
              1e-6·max|mixture|), the same bits at three grids; the
              step's batch keyed from the device step inside a captured
              CUDA graph against eager calls over 3 replays; the sampler
              (on no path since; its device code is the batch's) at the
              step's noise keys and its four kinds at R x n in
              SAMPLE_SHAPES (bits, uniforms, randints bit-equal, normals
              within NORMAL_ULP); device ms of the batch and of each of
              its kernels, the one-launch variant under noise, the plain
              version, the bound and a yardstick (take_rows and the mix
              on the kernel's draws); the sampler's beside torch.randn,
              torch.randint and torch.rand (yardsticks, used nowhere in
              the port).
              Then the step's dropout and noise keys (the batch
              kernel's), flax's dropout
              (forward, its packed mask, the backward that reads it and
              the double backward) at every dropout site of the
              every-option stream_v5e8 step and its instance noise at the
              D inputs, in bf16 (the step's dtype) and f32: keys, outputs,
              masks, gradients and bf16 noise bit-equal to the plain
              versions, f32 noise within NORMAL_ULP of the normal; the
              largest site and the largest D input's noise the same bits
              at three grids; a captured graph
              of keys, dropout, its backward and noise keyed from the
              device step against eager launches over 3 replays; device
              ms at the largest site and the D input beside the plain
              versions, torch.nn.functional.dropout and aten's dropout
              backward; the step's dropout launches' device ms summed
  7 train     Experiment(stream_v5e8).train() at full width, batch 32: the
              losses finite, G and D moved, the four kernels of the step
              (K1, K3, its backward, the threefry batch) launched, no
              sampler; one step from one state on the kernel and the plain
              DSP path agrees; the step's device ms by kernel family
              (torch.profiler); evaluate(); the CLI trains wsj0_logmel
    graph     the train step captured as a CUDA graph (train/graphed.py)
              for the five presets, the every-option stream_v5e8 and the
              bench's wsj0_logmel at batch 128: from one checkpoint,
              replays and eager steps reach the same bits (after the
              warm-up and capture, the first replay is the eager run's
              next step; then 4 more), or, where two eager runs differ
              too (cuDNN backward algorithms with atomics), the same bits
              with torch.backends.cudnn.deterministic; wall ms a step
              both ways, device ms and the device-busy share both ways
              (the union of kernel intervals), the launches of K1-K4's
              and the threefry kernels a traced step held to those the
              capture recorded; a
              dispatch of 4 replays and a short one of 2 run exactly 6
              steps; a reseed captures anew; a checkpoint loaded into
              the captured state is what the next replay trains on.
              Then the same in host-batch mode (data.device_bank off) for
              wsj0_logmel b16 and b128 (synthetic) and stream_v5e8 b32 on
              a fixture wav corpus: every step copies a host batch into
              the static batch the graph was captured on, replays and
              eager steps from one checkpoint take the same batches;
              train(6) is 6 dispatches of one replay, no new capture; a
              batch of another shape or dtype raises; the producer's ms a
              batch on the host alone; train()'s mixture-s/s against the
              same config graphed in bank mode
    bench     `python -m gan_sass_tf_tpu_torch.bench` as a process at 30
              timed steps: one JSON line with the root bench.py's four
              keys, value > 0, printed again on a line of its own
    roofline  the bytes ledger (scripts/bytes_ledger.py): the narrow
              wsj0_logmel and stream_v5e8 f32 steps of
              tests/test_torch_train.py counted on the CPU and on the card,
              equal in FLOPs and bytes; in each counted step the kernels'
              charged launches equal the launch counters'; then
              scripts/roofline.py's line for wsj0_logmel at the bench's b128
              and stream_v5e8 at b32, full width, each on a line of its
              own, every share in (0, 1]
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
              every state tensor and evaluate(4), whose last two batches
              replay the eval graph, within 1e-5 relative at W = 1; at
              W >= 2 the metrics and eval within DP_REL_TOL, Adam's first
              move of every weight held as dp_state_gaps says, the moments
              and buffers within DP_REL_TOL, and the ranks' states bitwise
              equal), the step's
              profile over the group (one NCCL all-reduce a D step, one of
              G's gradients, one of the metrics; NCCL kernels at W >= 2,
              where at W = 1 NCCL completes an in-place SUM without one),
              both steps' wall and device ms, the host ms of the all-reduce
              of G's gradients; at W >= 2 also, on every rank and for the
              meshes (dcn 1 x data W) and (dcn 2 x data W/2): the first
              group step from the seeded init bit-equal to that step,
              graphed group replays bit-equal to eager group steps from
              one checkpoint (the capture holds the NCCL all-reduces), the
              wall ms of a replayed step, a traced replay's device ms and
              NCCL kernels; on the first mesh the eval graph (its
              all-reduce captured) against the eager group eval, and the
              same replays against eager steps in host-batch mode, each
              rank copying its rows of one global batch; `cli
              separate --streaming`
              (batch mode) of the stream phase's 60 s wav over the group
              against this process's (>= 40 dB a segment after the best
              permutation, the same chained permutations); at W >= 2 also
              one-shot and scan-mode `cli separate` under torchrun, which
              rank 0 runs alone (each call within DP_SEPARATE_TIMEOUT_S,
              rank 0's sources >= 40 dB a segment against this process's).
              At W = 1 the line names what only two or more GPUs would
              run.  `python3 chip_smoke.py --dp` (a shortcut for working on
              this phase, not part of the smoke's contract) runs it alone
              after the device and build lines
    serve_graph  serving and eval as replays of CUDA graphs captured after
              WARMUP_CALLS eager calls of a shape and memoised per (cfg, G)
              and shape (train/graphed.py GraphedCall, GeneratorMemo):
              wsj0_logmel separate() on 16 x 3 s and 60 s, stream_v5e8 batch
              and scan streaming of two 60 s streams and a 30 s one,
              3src_pit separate() on 16 x 3 s (cuDNN's LSTM in the capture)
              and Experiment.evaluate() on wsj0_logmel, each on a new G with
              seeded weights and cudnn.deterministic: each against the same
              entry point with the eager function (the same bits, else
              >= 40 dB a row, eval scores within 1e-3 dB); K1 and K2
              launched once a call, group or chunk, eager or replayed, and
              a replay's traced launches equal to the capture's and to the
              eager call's; one capture, which later streams and calls
              reuse; weights loaded into G in place are what the next replay
              uses; wall ms graphed and eager in turns, mixture-s/s, ms a
              chunk in scan mode and the device-busy share; the phase's
              generators gone after it (the memos hold them weakly) and the
              device memory allocated before and after.  Separation, streaming and evaluate() in
              every phase go through such memos
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
              frame-folded input, dropout 0.1, instance noise 0.1, the
              conv stem (1, 2), the packed film head, subpixel dec_l0,
              PhaseConvTranspose and g_remat (2 steps, K3 and its backward
              once a step, the step keys once a step, dropout forward and
              backward and the noise launched, one step
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
              (torch.stft for the STFT kernels, the mask product and
              torch.istft for K2, torch.istft for K3 and the backward of one
              torch.istft call for K3's backward), that call (CUDA events
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
              of the profiled device time, its graphed and eager wall,
              device and busy ms finite; stream_quality at 20 steps
              (finite); bench_presets over the five presets and streaming
              at 1 warm-up and 3 timed steps (every value > 0);
              bench_streaming_compute at 10 s; the quickstart at 4 steps;
              train_wavdir_fixture at its 500 steps, held to its `ok`
              (finite, SI-SDRi >= 10 dB on the training speakers; the
              held-out speakers' reported)
 13 install   the port as a user installs it: `pip wheel` of a copy of
              the checkout (the wheel holds every ops/csrc source and
              header, no library, the gan-sass-torch console script, and
              no requirement of jax, flax, optax or orbax in the torch
              extra; the base requirements that name them are reported,
              an open fault),
              `pip install --target T/site`, the package made read-only;
              each process below runs from T with `python -P`,
              PYTHONPATH=T/site and XDG_CACHE_HOME=T/cache, nothing of the
              checkout on its path.  A worker (`--install-worker`) checks
              that the port and its build directory lie there, builds the
              library under T/cache and holds K1, K2, K3 with its backward
              and K4 through ops.dispatch against their plain versions;
              `gan-sass-torch configs` runs as a process; the console
              script trains stream_v5e8 2 steps into a workdir (K1, K3 and
              its backward exactly 4, 2, 2) and separates a 3 s wav with
              it (K1, K2 once; a finite 3 s wav a source); the installed
              recompute_bounds runs stream_v5e8's bound (K4)
Then a `kernels` summary line (each kernel's launches, summed over the
paths that drive it and by path, each path's counts set to 0 just before
it and read just after, a dp_* path's summed over its ranks and, for K1,
K2, K3 and K3's backward, by rank under `dp_launches_by_rank`; a path that
trains on the card in bank mode, separates, streams or evaluates replays
captured graphs, whose launches count as the launches a capture recorded
times its replays, beside the eager warm-up calls before each capture
(`launch_counts()`); its error; its time beside its plain version's,
the library call's and its bound from the shapes; K1 and K2 also at the
streaming chunk shapes) and, last, the result line.  Any failed check
exits non-zero before the result line, and so does a failed NCCL init or
a rank that exits non-zero.  Needs one CUDA device; the dp phase takes
every visible one.

    python3 chip_smoke.py --installed MODULE [ARGS...]

runs `python -m MODULE ARGS` on the port installed as the install phase
installs it (for jobs too long for this script, e.g. the quality
protocol at 10 000 steps).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import faulthandler
import gc
import importlib
import io
import json
import math
import os
import re
import runpy
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import weakref
import zipfile
from pathlib import Path

import numpy as np
import torch

from gan_sass_tf_tpu_torch import cli, config
from gan_sass_tf_tpu_torch.bench import bench_config
from gan_sass_tf_tpu_torch import entry as port_entry
from gan_sass_tf_tpu_torch.examples import quickstart
from gan_sass_tf_tpu_torch.data import make_dataset, mix_sources, prng_key, sample_bank
from gan_sass_tf_tpu_torch.data.device_bank import take_rows
from gan_sass_tf_tpu_torch.data.mixer import mix, noise_snr
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
from gan_sass_tf_tpu_torch.models.dropout import DropoutKey
from gan_sass_tf_tpu_torch.ops import build, cost, dispatch
from gan_sass_tf_tpu_torch.ops import istft as k3
from gan_sass_tf_tpu_torch.ops import masked_istft as k2
from gan_sass_tf_tpu_torch.ops import stft as k4
from gan_sass_tf_tpu_torch.ops import stft_features as k1
from gan_sass_tf_tpu_torch.ops import threefry as rng_ops
from gan_sass_tf_tpu_torch.scripts import (
    bench_presets,
    bench_streaming_compute,
    bytes_ledger,
    quality_protocol,
    recompute_bounds,
    roofline,
    stream_quality,
    time_dropout,
    train_wavdir_fixture,
)
from gan_sass_tf_tpu_torch.losses.pit import permutations_for
from gan_sass_tf_tpu_torch.train import Experiment, build_train_step, graphed
from gan_sass_tf_tpu_torch.train import step as train_step
from gan_sass_tf_tpu_torch.train.experiment import HostBatches
from gan_sass_tf_tpu_torch.utils import profiler, tb_events
from gan_sass_tf_tpu_torch.utils.wav_io import read_wav, write_wav

T_START = time.perf_counter()
SCRIPT = Path(__file__).resolve()
ROOT = SCRIPT.parent
SEED = 0
SR, N_FFT, HOP, N_MELS = 8000, 512, 128, 80
B_MAIN, T_MAIN = 16, 23936          # wsj0_logmel segment: F = 184
B_BENCH = 128                        # bench.py's wsj0_logmel batch a GPU
K1_N_FFTS = (64, 128, 256, 512, 1024, 2048, 4096)   # every n_fft the FFT bodies take
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
SEGMENTS = (1, 5, 10 ** 6)           # segment rows the k2/k3 bit checks also run
NORMAL_ULP = 4               # a threefry normal, kernel vs plain (log1pf's bit)
RNG_REPLAYS = 3
SEED_RNG_DROPOUT = 16                # the dropout and noise checks' own generator
SEED_RNG_SAMPLER = 17                # the sampler shapes' key
SEED_RNG_BATCH = 18                  # the batch checks' banks and sources
# R x n the sampler is held to its plain version at: one value, short rows
# with a tail, the bench step's picks and shifts, the stream step's noise.
SAMPLE_SHAPES = ((1, 1), (3, 5), (128, 2), (32, 32000))
PRESETS = ("stream_v5e8", "wsj0_logmel", "3src_pit", "music_complex_44k")
# The JAX package's oracle bounds (dB) on the CPU, from
#   JAX_PLATFORMS=cpu python scripts/recompute_bounds.py PRESET [--hard] --cpu
# keyed (preset, hard).  The port mixes with jax.random's draws under the
# JAX script's keys, so on the card its bounds differ from these by float
# rounding alone.
JAX_CPU_BOUNDS = {
    ("stream_v5e8", False): 24.06, ("stream_v5e8", True): 13.29,
    ("wsj0_logmel", False): 25.11, ("wsj0_logmel", True): 14.79,
    ("3src_pit", False): 24.37, ("3src_pit", True): 9.85,
    ("music_complex_44k", False): 23.71, ("music_complex_44k", True): 23.73,
}
BOUND_TOL_DB, JAX_BOUND_TOL_DB = 0.01, 1.0
QUALITY_STREAM_STEPS, QUALITY_MUSIC_STEPS = 10, 4
QUALITY_WSJ0_STEPS = 10              # the main path's preset, --hard, seeds 0 and 7
PROFILE_STEPS = 5                    # train steps traced for the step profile
PROFILE_PAD_S = 0.05                 # idle seconds at each end of a profile window
FILL_LAUNCHES = 4000                 # small kernels after the calls (profiler check)
TRACE_OPEN_FILLS = 8                 # small kernels opening a device_spans trace
SR_STREAM = 16000                    # stream_v5e8
B_PIT3, S_PIT3 = 16, 3               # 3src_pit: 16 x 3 s at 8 kHz (F = 184), 3 sources
PIT3_STEPS, PIT3_QUALITY_STEPS = 5, 4
GRAPH_STEPS, GRAPH_TIMED, GRAPH_SPD = 4, 4, 4   # the graph phase, each config
HOST_RATE_STEPS = 24                 # train() steps timed, host-batch against bank
PRODUCER_SAMPLES = 5                 # timed host_batch() calls, host-batch cases
BENCH_STEPS_SMOKE, BENCH_TIMEOUT_S = 30, 300     # the bench phase
# The roofline phase: wsj0_logmel at the bench's batch, stream_v5e8 at its own.
ROOFLINE_RUNS, ROOFLINE_STEPS = (("wsj0_logmel", B_BENCH), ("stream_v5e8", 32)), 30
SEP_SAMPLES, SEP_CALLS = 5, 2        # separate() timing: samples of calls per path
T_STREAM = 60 * SR_STREAM            # the streamed mixture: 62 chunks of 16 000
STREAM_SAMPLES = 3                   # timed streams per mode and DSP path
SEED_SERVE = 19                      # the serve_graph phase's own generator
SERVE_SAMPLES = 3                    # timed calls a side and path, in turns
SERVE_TRACE_CALLS = 3                # traced calls a side and path (device_spans)
SERVE_EVAL_BATCHES = 2
SERVE_EVAL_TOL_DB = 1e-3             # graphed vs eager eval scores, where not bit-equal
DP_STEP_SAMPLES = 12                 # timed train steps, dp phase, each side
DP_REDUCE_SAMPLES = 20               # timed all-reduces of G's gradients
DP_TIMEOUT_S = 400                   # one torchrun call of the dp phase
DP_EVAL_BATCHES = 4                  # evaluate() in the dp step: 2 eager, 2 replays
DP_SEPARATE_TIMEOUT_S = 120          # one torchrun call of rank 0's separation
# A step over W >= 2 ranks against one process's on the same global batch
# from the same seeded init (the ranks sum in another order; dp_state_gaps).
# Read on four H100s (NVIDIA H100 80GB HBM3, 700 W), each limit above its
# reading: metrics and eval scores relative, floor 1, 2.7e-5 and 1.5e-4;
# the gradients, as the first moment and the root of the second, by
# their optimizer's largest (`moments`), G 4.0e-3 and D 1.1e-3; buffers
# (D's spectral-norm u and sigma) by each tensor's own largest, 0.
# Adam's first move is lr g/(|g| + eps): every weight's group move within
# lr (Adam's bound, plus the rounding of the weight), and where one
# process moved a weight by >= 0.99 lr the group's move within 1e-2 lr,
# unless the weight's gradient is under the `moments` limit of its
# optimizer's largest: one within the summation's rounding of 0, whose
# sign the order decides (315 of G's weights and 4 of D's moved +-lr
# apart, each gradient under 2.6e-4 of the largest).
DP_REL_TOL = {"metrics": 1e-4, "eval": 1e-3, "moments": 1e-2, "buffers": 1e-5}
SEED_TOOLS = 12                      # the tools phase's own generator
TOOLS_TIMEOUT_S = 300                # one subprocess of the tools phase
TOOLS_STEPS, TOOLS_PROFILE = 6, (2, 4)          # cli train --profile-steps 2:4
DEBUG_STEP_SAMPLES = 6               # timed steps with and without the tripwires
STREAM_QUALITY_STEPS = 20
BENCH_STEPS = "1:3"                  # bench_presets: warm-up 1, timed 3
STREAMING_COMPUTE_SECONDS = 10
QUICKSTART_STEPS = 4
WAVDIR_STEPS = 500                   # train_wavdir_fixture's own default
SEED_INSTALL = 13                    # the install phase's own generator
INSTALL_TIMEOUT_S = 300              # one pip call or process of the install phase
INSTALL_STEPS = 2                    # the installed console script's train
# The kernels by the names a trace knows them, and the launch counters
# (ops.dispatch.launch_counts) whose launches run each: K1 and K4 share
# stft_features_kernel, K2 and K3 istft_ola_kernel.
TRACE_KERNELS = {"stft_features_kernel": ("stft_features", "stft"),
                 "istft_ola_kernel": ("istft", "masked_istft"),
                 "istft_adjoint_kernel": ("istft_bwd",),
                 "threefry_batch_kernel": ("threefry_batch",),
                 "threefry_batch_noise_kernel": ("threefry_batch_noise",),
                 "threefry_sample_kernel": ("threefry_sample",),
                 "threefry_dropout_kernel": ("threefry_dropout",),
                 "dropout_mask_kernel": ("threefry_dropout_bwd",),
                 "threefry_noise_kernel": ("threefry_noise",)}
TRACE_SPAN = "chip_smoke.traced_calls"   # the calls device_spans counts
TRACE_CLOSE = "chip_smoke.trace_close"   # the fills closing a device_spans trace
# A train step's device time by kernel family: substrings of the lower-cased
# kernel name, first match wins.  cuDNN's layout transposes are
# nchwToNhwc/nhwcToNchw kernels; its conv kernels carry "nhwc" too.
KERNEL_FAMILIES = (
    ("LSTM (cuDNN RNN)", ("rnn", "lstm")),
    ("K3 backward istft_adjoint", ("istft_adjoint_kernel",)),
    ("K1 stft_features", ("stft_features_kernel",)),
    ("K2/K3 istft_ola", ("istft_ola_kernel",)),
    ("threefry keys, draws, dropout, noise", ("threefry", "dropout_mask")),
    ("layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("convs and GEMMs", ("conv", "gemm", "xmma", "cutlass", "wgrad", "dgrad")),
    ("cuFFT", ("fft",)),
    ("optimizers", ("multi_tensor", "foreach")),
    ("reductions", ("reduce",)),
    ("copies, cat, gather", ("copy", "cat", "gather", "index", "scatter")),
    ("elementwise", ("elementwise",)),
)
# sha256 digests (16 hex digits, scripts/time_analysis.py's digest) of the
# outputs of K1, K4 and K3's adjoint (its (dre, dim) planes) at
# time_analysis.py's shapes and seeded inputs, as the analysis body gave
# them on an NVIDIA H100 80GB HBM3 before its passes moved to csrc/fft.cuh
# to be shared with the synthesis body (PERF.md §6): the move keeps its bits.
ANALYSIS_DIGESTS = {
    "stft_features wsj0_logmel step mixtures": "0af115b9addd8222",
    "stft_features wsj0_logmel step targets": "203d3f6fd0da74a8",
    "stft_features wsj0_logmel separate()": "f858816a3c1a50b6",
    "stft_features stream_v5e8 step": "b243ebcccda4e7ca",
    "stft_features music_complex_44k step mixtures": "b4b0473717ef5b8e",
    "stft_features music_complex_44k step targets": "65cf48271cffe5fb",
    "stft stream_v5e8 sources": "e1030d044a1334f7",
    "stft music_complex_44k sources": "cce4279ca02e42da",
    "istft_adjoint stream_v5e8 step": "e0dab3253e214990",
    "stft_features stream_v5e8 streaming group": "5f7a35d35f2d6a6b",
    "stft_features stream_v5e8 one chunk": "6f49ceb143040b65",
    "stft_features 3src_pit step mixtures": "af4466b4fe596038",
    "stft_features 3src_pit step targets": "976d43e5739c9c87",
    "stft_features 3src_pit separation": "f5cffd60dfe4c728",
}
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


def k1_case(x, n_fft, hop, emits, mel, logmag_floor=None, logmag_vs_f64=False):
    """K1 against its plain version on x.  With `logmag_floor`, logmag is
    held to 1e-3 only at bins whose plain |X| reaches that fraction of
    their frame's RMS |X|; spec and mag are held at every bin.  With
    `logmag_vs_f64`, logmag is held to the same function computed in
    float64 instead of to the plain version (whose gap is then recorded,
    not checked)."""
    ker = k1.stft_features_kernel(x, n_fft, hop, emit=emits, mel_matrix=mel)
    ref = k1.stft_features_reference(x, n_fft, hop, emit=emits, mel_matrix=mel)
    torch.cuda.synchronize()
    mag = ref["mag"] if "mag" in ref else (
        ref["spec"].abs() if "spec" in ref
        else k1.stft_features_reference(x, n_fft, hop, emit=("mag",))["mag"])
    scale = float(mag.max())
    errs = {}
    if "logmag" in emits:
        # How far each f32 version's log|X| lies from the same function
        # (the same f32 window) computed in float64.
        w = torch.from_numpy(get_window("hann", n_fft)).to(x.device).double()
        exact = torch.stft(x.reshape(-1, x.shape[-1]).double(), n_fft, hop, window=w,
                           center=False, return_complex=True)
        exact = torch.log(exact.abs() + 1e-8).transpose(-1, -2).reshape(ref["logmag"].shape)
        errs["logmag_vs_f64"] = {"kernel": max_err(ker["logmag"], exact),
                                 "plain": max_err(ref["logmag"], exact)}
    for key in emits:
        check(ker[key].shape == ref[key].shape, f"k1 {key} shape")
        a, b = ker[key], ref[key]
        if key == "logmag" and logmag_vs_f64:
            errs["logmag_vs_plain"] = max_err(a, b)
            b = exact
        if key == "logmag" and logmag_floor is not None:
            keep = mag >= logmag_floor * mag.square().mean(-1, keepdim=True).sqrt()
            errs["logmag_all_bins"] = max_err(a, b)
            errs["logmag_bins_under_floor"] = int((~keep).sum())
            if logmag_vs_f64:
                errs["logmag_vs_plain_above_floor"] = max_err(a[keep], ref[key][keep])
                errs["logmag_vs_f64_above_floor"] = {
                    "kernel": max_err(a[keep], b[keep]),
                    "plain": max_err(ref[key][keep], b[keep])}
            a, b = a[keep], b[keep]
        errs[key] = max_err(a, b)
        tol = 3e-4 * scale if key in ("spec", "mag") else 1e-3
        check(errs[key] <= tol, f"k1 {key} at n_fft {n_fft} hop {hop} shape "
              f"{tuple(x.shape)}: max err {errs[key]} > {tol}")
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
    # The main path's bench step (bench.py: wsj0_logmel at batch 128 a
    # card): K1's two launches a step with train/step.py's emit sets, the
    # mixtures with log-mel and the 2 x 128 target rows, each called twice
    # for its bits.  The mixtures are tones over -34 dB noise: at bins
    # near 1e-4 of such a frame's peak (above LOGMAG_FLOOR of its RMS),
    # f32 roundoff at the peak's scale moves log|X| by up to ~1e-3 in any
    # f32 FFT, cuFFT's (the plain path) included, so two correct f32
    # versions can differ there by more than 1e-3; the kernel's log|X| is
    # held to the same function in float64 instead, and its gap to the
    # plain version is recorded (PERF.md, the analysis body's findings).
    bench = {}
    for what, xb, emits, m, vs_f64 in (
            ("mixtures", mixtures(rng, B_BENCH, T_MAIN), ("mag", "logmag", "logmel"), mel,
             True),
            ("targets", rng.standard_normal((2 * B_BENCH, T_MAIN), np.float32),
             ("mag", "logmag"), None, False)):
        xb = torch.from_numpy(xb).to(dev)
        errs, ker_b = k1_case(xb, N_FFT, HOP, emits, m, LOGMAG_FLOOR, vs_f64)
        again = k1.stft_features_kernel(xb, N_FFT, HOP, emit=emits, mel_matrix=m)
        same = all(torch.equal(ker_b[e], again[e]) for e in emits)
        check(same, f"k1 bench step {what}: two calls gave different bits")
        bench[what] = (xb, emits, m)
        emit("k1", case=f"wsj0_logmel bench step {what}", shape=list(xb.shape),
             n_fft=N_FFT, hop=HOP, emit=list(emits), max_abs_err=errs,
             repeat_bit_equal=same,
             tol=f"mag 3e-4*max|X|; logmel 1e-3; logmag 1e-3 where |X| >= "
                 f"{LOGMAG_FLOOR} * frame RMS |X|, against "
                 f"{'float64' if vs_f64 else 'the plain version'}")
    phase_k1_geometry(rng, dev)
    got = analysis_digests(dev)
    differ = sorted(name for name, d in ANALYSIS_DIGESTS.items() if got.get(name) != d)
    check(not differ, f"analysis body's bits changed at {differ}")
    emit("k1", case="digests at scripts/time_analysis.py's shapes", digests=got,
         equal_to_recorded=not differ)
    return x, ker["spec"], main_errs["spec"], music, bench


def analysis_digests(dev) -> dict:
    """{shape: digest} of K1's, K4's and K3's adjoint's outputs (the
    adjoint's as its two planes) at scripts/time_analysis.py's shapes."""
    from gan_sass_tf_tpu_torch.scripts import time_analysis

    return {name: time_analysis.digest(kernel())
            for name, (kernel, *_) in time_analysis.cases(dev).items()}


def segment_bits(call) -> dict:
    """Whether `call` (a synthesis kernel's) gives its output at the
    wrapper's segment bit for bit at each of SEGMENTS output hop-rows a
    work item, and on a repeat call."""
    base = call()
    same = {}
    try:
        for seg in SEGMENTS:
            k2.SEGMENT_ROWS = seg
            same[f"segment {seg}"] = torch.equal(call(), base)
    finally:
        k2.SEGMENT_ROWS = 0
    same["repeat"] = torch.equal(call(), base)
    check(all(same.values()), f"synthesis bits changed with the segment: {same}")
    return same


def phase_k1_geometry(rng, dev):
    """The analysis body at every n_fft it takes (each with its own split
    into radix passes): K1 with every output, K4, and K3 with its backward
    (the adjoint launch) against their plain versions at their phases'
    tolerances, on rows of 7·n_fft + 3 samples whose first starts 4 bytes
    past a 16-byte boundary, so that every tile's span takes the kernel's
    unaligned copy path; each kernel called twice for its bits.  Bands of
    the 40-band filterbank that hold no bin at small n_fft are all zero."""
    for n_fft in K1_N_FFTS:
        hop, t = n_fft // 4, 7 * n_fft + 3
        flat = torch.from_numpy(rng.standard_normal(3 * t + 1, np.float32)).to(dev)
        x = flat[1:].view(3, t)
        check(x.data_ptr() % 16 == 4, f"k1 geometry: data at {x.data_ptr() % 16}")
        m = torch.from_numpy(mel_filterbank(40, n_fft // 2 + 1, 16000)).to(dev)
        emits = ("spec", "mag", "logmag", "logmel")
        errs, ker = k1_case(x, n_fft, hop, emits, m, LOGMAG_FLOOR)
        again = k1.stft_features_kernel(x, n_fft, hop, emit=emits, mel_matrix=m)
        s4 = k4.stft_kernel(x, n_fft, hop)
        k4_err = k4_check(s4, k4.stft_reference(x, n_fft, hop), f"n_fft {n_fft}")
        k3_errs, (spec, y, ref, dy) = k3_case(rng, dev, 3, t, n_fft, hop)
        f = spec.shape[-2]
        adj = k3.istft_adjoint(dy, n_fft, hop, "hann", f)
        adj2 = k3.istft_adjoint(dy, n_fft, hop, "hann", f)
        same = {"k1": all(torch.equal(ker[e], again[e]) for e in emits),
                "k4": torch.equal(s4, k4.stft_kernel(x, n_fft, hop)),
                "adjoint": torch.equal(adj, adj2)}
        check(all(same.values()), f"n_fft {n_fft}: two calls gave different bits {same}")
        emit("k1", case="every n_fft: rows off 16-byte boundaries", n_fft=n_fft,
             hop=hop, shape=[3, t], frames=f, max_abs_err=errs, k4_max_abs_err=k4_err,
             k3_max_abs_err=k3_errs, repeat_bit_equal=same,
             empty_mel_bands=int((m.abs().sum(0) == 0).sum()),
             tol="k1 as the k1 phase (logmag above LOGMAG_FLOOR); k4 atol "
                 "3e-4*max|X| rtol 1e-3; k3 as the k3 phase")


def k2_check(ker, ref, hop, what):
    """K2 kernel vs plain: (interior max err, full max err), the interior
    within atol 3e-4 rtol 1e-3, the whole signal within 1e-3·max|y|."""
    check(ker.shape == ref.shape, f"k2 shape {ker.shape} != {ref.shape}")
    interior = (ker - ref)[..., hop:-hop].abs()
    ok_in = bool((interior <= 3e-4 + 1e-3 * ref[..., hop:-hop].abs()).all())
    full = max_err(ker, ref)
    tol_full = 1e-3 * float(ref.abs().max())
    check(ok_in, f"k2 {what} interior: max err "
          f"{float(interior.max())} over atol 3e-4 rtol 1e-3")
    check(full <= tol_full, f"k2 {what} full length: {full} > {tol_full}")
    return float(interior.max()), full


def k2_case(spec, masks, n_fft, hop, mask_type):
    ker = k2.masked_istft_kernel(spec, masks, n_fft, hop, mask_type=mask_type)
    ref = k2.masked_istft_reference(spec, masks, n_fft, hop, mask_type=mask_type)
    torch.cuda.synchronize()
    return k2_check(ker, ref, hop, f"{mask_type} at n_fft {n_fft}")


def phase_k2(rng, dev, x, spec):
    f, k = spec.shape[-2:]
    errs = {}
    for mask_type in ("magnitude", "complex"):
        shape = (B_MAIN, 2, f, k) + ((2,) if mask_type == "complex" else ())
        lo = 0.0 if mask_type == "magnitude" else -1.0
        masks = torch.from_numpy(rng.uniform(lo, 1, shape).astype(np.float32)).to(dev)
        interior, full = k2_case(spec, masks, N_FFT, HOP, mask_type)
        errs[mask_type] = full
        same = segment_bits(lambda: k2.masked_istft_kernel(spec, masks, N_FFT, HOP,
                                                           mask_type=mask_type))
        emit("k2", mask_type=mask_type, masks=list(shape),
             max_abs_err_interior=interior, max_abs_err_full=full,
             bit_equal=same, tol="interior atol 3e-4 rtol 1e-3; full 1e-3*max|y|")
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
    # The music_complex_44k bound batch, then one frame, two (fewer than
    # n_fft/hop) and nine (past the edge of a tile), on a generator of
    # their own.
    rs = np.random.default_rng(SEED_SYNTH)

    def spectrum_and_masks(b, t, n_fft, hop, mask_type):
        xs = torch.from_numpy(rs.standard_normal((b, t), np.float32)).to(dev)
        ss = k1.stft_features_reference(xs, n_fft, hop)["spec"]
        shape = (b, 2) + tuple(ss.shape[-2:]) + ((2,) if mask_type == "complex" else ())
        lo = 0.0 if mask_type == "magnitude" else -1.0
        return ss, torch.from_numpy(rs.uniform(lo, 1, shape).astype(np.float32)).to(dev)

    music = spectrum_and_masks(B_MUSIC, T_MUSIC, MUSIC_N_FFT, MUSIC_HOP, "complex")
    interior, full = k2_case(*music, MUSIC_N_FFT, MUSIC_HOP, "complex")
    same = segment_bits(lambda: k2.masked_istft_kernel(*music, MUSIC_N_FFT, MUSIC_HOP,
                                                       mask_type="complex"))
    emit("k2", case="music_complex_44k bound batch", mask_type="complex",
         masks=list(music[1].shape), n_fft=MUSIC_N_FFT, hop=MUSIC_HOP,
         max_abs_err_interior=interior, max_abs_err_full=full, bit_equal=same)
    for n_fft, hop, mask_type in ((N_FFT, HOP, "magnitude"),
                                  (MUSIC_N_FFT, MUSIC_HOP, "complex")):
        for frames in (1, 2, 9):
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

    cap = graphed.captures()
    reset_launch_counts()
    cli_ms = {}
    for wav in (wav3, wav60):
        t0 = time.perf_counter()
        rc = cli.main(["separate", "--config", "wsj0_logmel", "--params",
                       str(params), "--input", str(wav), "--output-dir",
                       str(tmp / "out")])
        cli_ms[wav.stem] = (time.perf_counter() - t0) * 1e3
        check(rc == 0, f"cli separate {wav.name} exited {rc}")
    out = separate(g, cfg, batch, dev)
    torch.cuda.synchronize()
    counts = k12_since()
    captures = graphed.captures() - cap
    check(counts == served(3),
          f"main path: launches {counts}, expected {served(3)} ({captures} captures)")

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
    emit("main_path", params=n_params, launches=counts, captures=captures,
         cli_separate_wall_ms=cli_ms,
         outputs={"cli_3s": [2, 3 * SR], "cli_60s": [2, 60 * SR],
                  "batch": list(out.shape)},
         si_sdr_kernel_vs_plain_db={"batch_min": float(agree.min()),
                                    "long_min": float(agree_long.min())},
         tol_db=40.0)
    return cfg, g, batch, counts


def k3_case(rng, dev, b, t, n_fft, hop):
    """Forward and gradient of ops.dispatch.istft on the kernel path (K3 on
    the interleaved spectrum, the adjoint's gradient) against the plain path
    on the STFT of noise; returns the errors and the tensors for timing."""
    x = torch.from_numpy(rng.standard_normal((b, t), np.float32)).to(dev)
    spec = k1.stft_features_reference(x, n_fft, hop)["spec"].requires_grad_()
    y = dispatch.istft(spec, n_fft, hop)
    with dispatch.force_backend("reference"):
        ref = dispatch.istft(spec, n_fft, hop)
    dy = torch.randn_like(ref)
    return k3_check(y, ref, (spec,), dy, hop, f"at n_fft {n_fft}"), (spec, y, ref, dy)


def k3_check(y, ref, leaves, dy, hop, what):
    """K3 forward and backward, kernel vs plain: the forward's interior
    within atol 2e-4 rtol 1e-3 and the whole within 1e-3·max|y|, the
    gradients w.r.t. `leaves` (from upstream `dy`) within atol
    5e-4·max|g| rtol 1e-3."""
    g_ker = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    g_ref = torch.autograd.grad(ref, leaves, dy, retain_graph=True)
    torch.cuda.synchronize()
    check(y.shape == ref.shape, f"k3 shape {y.shape} != {ref.shape}")
    inner = (y - ref)[..., hop:-hop].abs()
    ok_in = bool((inner <= 2e-4 + 1e-3 * ref[..., hop:-hop].abs()).all())
    full, tol_full = max_err(y, ref), 1e-3 * float(ref.abs().max())
    check(ok_in, f"k3 forward interior {what}: max err "
          f"{float(inner.max())} over atol 2e-4 rtol 1e-3")
    check(full <= tol_full, f"k3 forward full length {what}: {full} > {tol_full}")
    grad_errs = []
    if len(leaves) == 1:   # a complex spectrum: its real and imaginary parts
        g_ker, g_ref = (torch.view_as_real(g[0]).unbind(-1) for g in (g_ker, g_ref))
    for a, r in zip(g_ker, g_ref):
        scale = float(r.abs().max())
        ok = bool(((a - r).abs() <= 5e-4 * scale + 1e-3 * r.abs()).all())
        grad_errs.append(max_err(a, r))
        check(ok, f"k3 backward {what}: max err {grad_errs[-1]} "
              f"over atol 5e-4*{scale} rtol 1e-3")
    return {"forward_interior": float(inner.max()), "forward_full": full,
            "grad_re": grad_errs[0], "grad_im": grad_errs[1]}


def phase_k3(rng, dev):
    errs, tensors = k3_case(rng, dev, B_TRAIN, T_TRAIN, N_FFT, HOP)
    f = tensors[0].shape[-2]
    ri = torch.view_as_real(tensors[0].detach())
    with torch.no_grad():
        same = segment_bits(lambda: k3.istft_ri_kernel(ri, N_FFT, HOP))
    emit("k3", signals=B_TRAIN, frames=f, bins=N_FFT // 2 + 1, max_abs_err=errs,
         bit_equal=same,
         tol="forward interior atol 2e-4 rtol 1e-3, full 1e-3*max|y|; "
             "grad atol 5e-4*max|grad| rtol 1e-3")
    for n_fft, hop in ((256, 64), (2048, 512)):
        e, _ = k3_case(rng, dev, 3, 8000, n_fft, hop)
        emit("k3", n_fft=n_fft, hop=hop, signals=3, max_abs_err=e)
    rs = np.random.default_rng(SEED_SYNTH + 1)
    for n_fft, hop in ((N_FFT, HOP), (MUSIC_N_FFT, MUSIC_HOP)):
        for frames in (1, 2, 9):
            e, (spec, *_) = k3_case(rs, dev, 3, (frames - 1) * hop + n_fft, n_fft, hop)
            check(spec.shape[-2] == frames, f"k3 edge: {spec.shape}")
            emit("k3", case=f"edge: {frames} frames", n_fft=n_fft, hop=hop,
                 signals=3, max_abs_err=e)
    return errs, tensors


def phase_train(dev):
    cfg = config.get_config("stream_v5e8")
    exp = Experiment(cfg, device=dev)
    g0 = [p.detach().clone() for p in exp.state.g.parameters()]
    d0 = [p.detach().clone() for p in exp.state.d.parameters()]
    reset_launch_counts()
    t0 = time.perf_counter()
    last = exp.train(num_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items()
              if k in ("stft_features", "istft", "istft_bwd", "threefry_batch",
                       "threefry_batch_noise", "threefry_sample")}
    check(min(counts[k] for k in ("stft_features", "istft", "istft_bwd",
                                  "threefry_batch")) > 0
          and counts["threefry_sample"] == 0 and counts["threefry_batch_noise"] == 0,
          f"the train step's kernels: {counts}")
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
            _, m = step(state, exp._bank, exp._train_key)
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


def graph_ready(c):
    """A graph-phase config: `c` in dispatches of GRAPH_SPD steps, with no
    log, eval or checkpoint of its own, on one device's mesh."""
    quiet = {"steps_per_dispatch": GRAPH_SPD, "log_every": 10 ** 9,
             "eval_every": 10 ** 9, "ckpt_every": 10 ** 9}
    return c.replace(mesh=dataclasses.replace(c.mesh, data_axis_size=-1),
                     train=dataclasses.replace(c.train, **quiet))


def graph_configs() -> list:
    """(name, config) of each train step the graph phase captures in
    device-bank mode: the five presets at their own batch, the every-option
    stream_v5e8 of the options phase and the bench's wsj0_logmel at batch
    B_BENCH, on synthetic data (graph_ready)."""
    out = [(n, config.get_config(n)) for n in ("2src_toy_cpu",) + PRESETS]
    opts = config.get_config("stream_v5e8")
    out.append(("stream_v5e8 every option",
                cli._apply_overrides(opts, list(STREAM_OPTIONS))))
    out.append((f"wsj0_logmel b{B_BENCH} (bench)", bench_config(B_BENCH, 1)))
    return [(n, graph_ready(c.replace(data=dataclasses.replace(c.data, dataset="synthetic"))))
            for n, c in out]


def host_graph_configs(corpus: Path) -> list:
    """(name, config) of each host-batch case of the graph phase
    (data.device_bank off, full width, graph_ready): (a) the main path,
    wsj0_logmel at its own batch 16 on synthetic data (K1, the threefry
    draws); (b) the bench's workload, wsj0_logmel b128 of 3 s; (c) a wav
    corpus, stream_v5e8 at its own batch 32 on the fixture corpus at
    `corpus` (K1, K3, K3's backward, the threefry draws)."""
    stream = config.get_config("stream_v5e8")
    out = [("wsj0_logmel b16 host", config.get_config("wsj0_logmel")),
           (f"wsj0_logmel b{B_BENCH} host (bench)", bench_config(B_BENCH, 1)),
           ("stream_v5e8 b32 wav_dir host", stream.replace(data=dataclasses.replace(
               stream.data, dataset="wav_dir", data_dir=str(corpus))))]
    return [(n, graph_ready(c.replace(data=dataclasses.replace(c.data, device_bank=False))))
            for n, c in out]


def save_point(exp, where: Path, batches=None) -> None:
    """A checkpoint of `exp` at `where` and, in host-batch mode, the place
    in `batches` (a HostBatches) that its steps go on from."""
    exp._write(str(where), int(exp.state.step), 1)
    if batches is not None:
        (where / "batches_at").write_text(str(batches.at))


def load_point(exp, where: Path, step: int, batches=None) -> None:
    """Back to a save_point: the state and the next host batch."""
    exp._read(str(where), step)
    if batches is not None:
        batches.at = int((where / "batches_at").read_text())


def state_gap(a: dict, b: dict) -> dict:
    """Whether two flat_tensors() of a train state hold the same bits, the
    largest |a - b| and the tensor it is in."""
    gaps = {k: float((v.double() - b[k].double()).abs().max()) if v.numel() else 0.0
            for k, v in a.items()}
    worst = max(gaps, key=gaps.get)
    return {"same_bits": all(torch.equal(v, b[k]) for k, v in a.items()),
            "max_abs": gaps[worst], "in": worst}


def device_spans(fn, calls=PROFILE_STEPS, open_calls=0) -> dict:
    """torch.profiler's Chrome trace of `calls` calls of `fn` (after one
    untimed): a call's device ms summed over its kernels, copies and fills,
    the ms a call the device was busy (the union of their intervals, so
    work a CUDA graph runs side by side counts once), the device events a
    call and the launches of each of TRACE_KERNELS a call, as the trace
    saw them.  The trace may drop the device records of the first kernels
    it sees, and its last ones, and a kernel's device start may read up
    to a millisecond before its host launch: TRACE_OPEN_FILLS fills, a
    synchronize and PROFILE_PAD_S idle open the trace ahead of the calls,
    a synchronize, that idle and as many fills (TRACE_CLOSE) close it
    after them, and what the device started from half that pad before the
    calls' span to half that pad before the closing fills is timed (by
    its own start: a replay's kernels run past the span's host window).
    The launches of TRACE_KERNELS are counted by the host time of their
    launch (a replay's kernels by their graph launch's) within the
    calls' span, so a device record whose start the trace misplaces still
    counts with its call; a record with no launch in the trace counts by
    its own start in the timed window.  "kernels_off_window" counts the
    launches so counted whose device start lay outside that window.
    "kernels_in_trace" counts TRACE_KERNELS over the
    whole trace; "span_ms" the host's ms a call over the traced calls;
    "nccl_kernels" and "nccl_ms" the NCCL kernels a call and their
    device ms.
    `open_calls` calls of `fn` follow the fills, before the pad and out of
    the count: a trace may drop the records of a kernel the first time it
    sees it."""
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiler.profile_trace(tmp):
            fill = torch.zeros(1, device="cuda")
            for _ in range(TRACE_OPEN_FILLS):
                fill.add_(1.0)
            for _ in range(open_calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            with torch.profiler.record_function(TRACE_SPAN):
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            with torch.profiler.record_function(TRACE_CLOSE):
                for _ in range(TRACE_OPEN_FILLS):
                    fill.add_(1.0)
        trace = profiler.load_trace(profiler.trace_files(tmp)[-1])
    marks = {e["name"]: e for e in profiler.annotations(trace)
             if e["name"] in (TRACE_SPAN, TRACE_CLOSE)}
    span, close = marks[TRACE_SPAN], marks[TRACE_CLOSE]
    every = profiler.device_events(trace)

    def timed(e):
        return span["ts"] - PROFILE_PAD_S * 0.5e6 <= e["ts"] < close["ts"] - PROFILE_PAD_S * 0.5e6

    def launched(e):
        if e["launch_ts"] == e["ts"]:           # no launch record: its own start
            return timed(e)
        return span["ts"] <= e["launch_ts"] <= span["ts"] + span["dur"]

    events = [e for e in every if timed(e)]
    counted = [e for e in every if launched(e) and any(n in e["name"] for n in TRACE_KERNELS)]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy, end = busy + b - max(a, end), b
    nccl = [e for e in events if "nccl" in e["name"].lower()]
    return {"sum_ms": sum(e["dur"] for e in events) / calls / 1e3,
            "busy_ms": busy / calls / 1e3, "span_ms": span["dur"] / calls / 1e3,
            "events": len(events) / calls,
            "nccl_kernels": len(nccl) / calls,
            "nccl_ms": sum(e["dur"] for e in nccl) / calls / 1e3,
            "kernels": {n: sum(n in e["name"] for e in counted) / calls
                        for n in TRACE_KERNELS},
            "kernels_off_window": sum(not timed(e) for e in counted),
            "kernels_in_trace": {n: sum(n in e["name"] for e in every)
                                 for n in TRACE_KERNELS}}


def eager_steps(exp, n: int, batches=None) -> dict:
    """n eager steps of exp (in host-batch mode on the next host batches of
    `batches`, each copied to the device): the last metrics, the state, the
    step."""
    for _ in range(n):
        m = exp._step(exp._step_data(batches))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": flat_tensors(exp.state), "step": int(exp.state.step)}


def replays_vs_eager(name: str, exp, tmp: Path, batches=None) -> dict:
    """(1) A checkpoint of the fresh state; WARMUP_STEPS + 1 steps through
    run_steps (the eager warm-up, the capture, one replay), then the
    checkpoint loaded into the captured state and as many eager steps: the
    capture moved nothing and its first replay is the eager run's next
    step when the two states hold the same bits.  (2) A checkpoint,
    GRAPH_STEPS replays, the checkpoint loaded again, GRAPH_STEPS eager
    steps: the states and the metrics after them.  In host-batch mode
    (`batches`, a HostBatches) both sides of (1) and of (2) take the same
    host batches, the graphed side copied into the static batch."""
    w = graphed.WARMUP_STEPS
    save_point(exp, tmp / "a", batches)
    exp.run_steps(w + 1, batches)
    torch.cuda.synchronize()
    g = exp._graphed
    check(g is not None and g.graph is not None and g.replays == 1
          and int(exp.state.step) == w + 1,
          f"graph {name}: after {w + 1} steps: captured {g and g.graph is not None}, "
          f"replays {g and g.replays}, step {int(exp.state.step)}")
    first = flat_tensors(exp.state)
    load_point(exp, tmp / "a", 0, batches)
    check(exp._graphed is g and int(exp.state.step) == 0,
          f"graph {name}: loading a checkpoint replaced the capture")
    first_gap = state_gap(first, eager_steps(exp, w + 1, batches)["state"])
    save_point(exp, tmp / "b", batches)
    m = exp.run_steps(GRAPH_STEPS, batches)
    got = {"metrics": {k: float(v) for k, v in m.items()},
           "state": flat_tensors(exp.state), "step": int(exp.state.step)}
    load_point(exp, tmp / "b", w + 1, batches)
    want = eager_steps(exp, GRAPH_STEPS, batches)
    check(got["step"] == want["step"] == w + 1 + GRAPH_STEPS,
          f"graph {name}: steps {got['step']} graphed, {want['step']} eager")
    check(all(np.isfinite(v) for v in got["metrics"].values()),
          f"graph {name}: non-finite {got['metrics']}")
    return {"first_replay_vs_eager": first_gap,
            "replays_vs_eager": state_gap(got["state"], want["state"]),
            "metrics": {"graphed": got["metrics"], "eager": want["metrics"]}}


def synced_walls(fns: dict, samples: int) -> dict:
    """The median wall ms of `samples` synchronized calls of each of `fns`,
    in turns (a, b, b, a)."""
    names = list(fns)
    walls = {k: [] for k in names}
    for i in range(len(names) * samples):
        k = (names + names[::-1])[i % (2 * len(names))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[k]()
        torch.cuda.synchronize()
        walls[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in walls.items()}


def host_batch_report(name: str, exp, cfg, dev) -> dict:
    """Host-batch mode's own checks and readings, after the capture: a
    batch of another shape or dtype raises ValueError with no step, replay
    or capture; the ms of the producer's work for one batch on the host
    alone (PRODUCER_SAMPLES calls of host_batch: the dataset's draw and
    the page-locked copy, and the draw alone); train()'s mixture-s/s over
    HOST_RATE_STEPS steps against the same config in device-bank mode,
    graphed and captured first, with its replay's wall ms, and the
    launches of that bank-mode run ("bank_launches", which phase_graph
    keeps out of the host-batch path's counts)."""
    g = exp._graphed
    shape = tuple(exp._batch.shape)
    refused = {}
    for kind, bad in (("shape", torch.zeros(shape[:-1] + (shape[-1] - 1,))),
                      ("dtype", torch.zeros(shape, dtype=torch.float64))):
        before = (int(exp.state.step), g.replays, graphed.captures())
        try:
            exp.run_steps(1, lambda: bad)
            refused[kind] = "no error"
        except ValueError as exc:
            refused[kind] = str(exc)
        check("captured on" in refused[kind]
              and before == (int(exp.state.step), g.replays, graphed.captures()),
              f"graph {name}: a host batch of another {kind}: {refused[kind]}, "
              f"(step, replays, captures) {before} -> "
              f"{(int(exp.state.step), g.replays, graphed.captures())}")
    timed = {"host_batch": exp.host_batch, "draw": exp.dataset.batch}
    producer = {}
    for k, fn in timed.items():
        ms = []
        for _ in range(PRODUCER_SAMPLES):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        producer[k] = statistics.median(ms)
    rate = {"host": exp.train(num_steps=HOST_RATE_STEPS)["mixture_sec_per_sec"]}
    check(exp._graphed is g, f"graph {name}: train({HOST_RATE_STEPS}) recaptured")
    before = launch_counts()
    bank = Experiment(cfg.replace(data=dataclasses.replace(cfg.data, device_bank=True)),
                      device=dev)
    bank.run_steps(graphed.WARMUP_STEPS + 1)
    rate["bank"] = bank.train(num_steps=HOST_RATE_STEPS)["mixture_sec_per_sec"]
    bank_wall = synced_walls({"bank": lambda: bank.run_steps(1)}, GRAPH_TIMED)["bank"]
    check(all(math.isfinite(v) and v > 0 for v in rate.values()),
          f"graph {name}: train() rates {rate}")
    del bank
    after = launch_counts()
    return {"refused": refused, "producer_ms": producer,
            "train_mixture_s_per_s": rate, "train_steps": HOST_RATE_STEPS,
            "host_over_bank": rate["host"] / rate["bank"],
            "bank_replay_wall_ms": bank_wall,
            "bank_launches": {k: v - before[k] for k, v in after.items()},
            "batch_mb": math.prod(shape) * 4 / 1e6}


def graph_case(name: str, cfg, dev, tmp: Path) -> dict:
    """One train step captured and replayed, held against the eager step
    (replays_vs_eager): the same bits.  Where they differ, two eager runs
    of GRAPH_STEPS from one checkpoint must differ too (an algorithm that
    is not deterministic run to run: cuDNN picks such backward algorithms
    for some shapes), and a fresh capture with
    torch.backends.cudnn.deterministic must hold the same bits.  Then
    (3) wall ms a step both ways (synchronized, in turns) and the device
    ms and busy ms a step both ways (device_spans), and the kernel
    launches that the trace of replays shows a step held to those the
    capture recorded, from which the launch counts of replays are
    inferred (graphed.launch_correction); (4) train() of
    GRAPH_SPD + 2 steps: exactly that many steps and replays, no new
    capture (in bank mode a dispatch of GRAPH_SPD replays and a short one
    of 2, in host-batch mode as many dispatches of one, each on a batch of
    the prefetch thread); (5) in host-batch mode host_batch_report;
    (6) reseed, then WARMUP_STEPS + 1 steps: a new capture on the new
    state (and the same static batch), finite.

    In host-batch mode every step takes a host batch of a HostBatches:
    replays and eager steps from one checkpoint the same batches, the
    timed steps (each with its batch's copy to the device) the kept ones
    again."""
    w = graphed.WARMUP_STEPS
    exp = Experiment(cfg, device=dev)
    check(exp.graphed, f"graph {name}: Experiment.graphed is False")
    host = not exp._use_bank
    batches = HostBatches(exp, w + 1 + GRAPH_STEPS) if host else None
    out = {"config": name, "batch": cfg.train.batch_size,
           "data": "host" if host else "bank",
           **replays_vs_eager(name, exp, tmp, batches)}
    g = exp._graphed
    if not (out["first_replay_vs_eager"]["same_bits"]
            and out["replays_vs_eager"]["same_bits"]):
        load_point(exp, tmp / "b", w + 1, batches)
        once = eager_steps(exp, GRAPH_STEPS, batches)["state"]
        load_point(exp, tmp / "b", w + 1, batches)
        out["eager_vs_eager"] = state_gap(once, eager_steps(exp, GRAPH_STEPS, batches)["state"])
        check(not out["eager_vs_eager"]["same_bits"],
              f"graph {name}: replays differ from eager steps that agree with "
              f"each other: {out}")
        torch.backends.cudnn.deterministic = True
        try:
            (tmp / "det").mkdir()
            det_exp = Experiment(cfg, device=dev)
            det = replays_vs_eager(name, det_exp, tmp / "det", HostBatches(
                det_exp, w + 1 + GRAPH_STEPS) if host else None)
            del det_exp
        finally:
            torch.backends.cudnn.deterministic = False
        out["cudnn_deterministic"] = {k: det[k] for k in ("first_replay_vs_eager",
                                                          "replays_vs_eager")}
        check(all(v["same_bits"] for v in out["cudnn_deterministic"].values()),
              f"graph {name}: with cudnn.deterministic: {out['cudnn_deterministic']}")

    steps = {"graphed": lambda: exp.run_steps(1, batches),
             "eager": lambda: exp._step(exp._step_data(batches))}
    wall = synced_walls(steps, GRAPH_TIMED)
    device = {"eager": device_spans(steps["eager"]),
              "graphed": device_spans(steps["graphed"])}
    recorded = {n: sum(g.per_replay[k] for k in keys)
                for n, keys in TRACE_KERNELS.items()}
    check(device["graphed"]["kernels"] == device["eager"]["kernels"] == recorded,
          f"graph {name}: kernel launches a step, traced replays "
          f"{device['graphed']['kernels']}, traced eager steps "
          f"{device['eager']['kernels']}, recorded by the capture {recorded}; "
          f"in the whole traces (fill and {PROFILE_STEPS} calls): replays "
          f"{device['graphed']['kernels_in_trace']}, eager "
          f"{device['eager']['kernels_in_trace']}; counted by launch with a device start "
          f"outside the window: replays {device['graphed']['kernels_off_window']}, "
          f"eager {device['eager']['kernels_off_window']}")

    step0, replays0, captures0 = int(exp.state.step), g.replays, graphed.captures()
    exp.train(num_steps=GRAPH_SPD + 2)
    dispatched = {"steps": int(exp.state.step) - step0,
                  "replays": g.replays - replays0,
                  "captures": graphed.captures() - captures0}
    check(exp._graphed is g and dispatched == {"steps": GRAPH_SPD + 2,
                                               "replays": GRAPH_SPD + 2, "captures": 0},
          f"graph {name}: train({GRAPH_SPD + 2}) at {GRAPH_SPD} a dispatch: "
          f"{dispatched}, recaptured {exp._graphed is not g}")
    if host:
        out["host_batches"] = host_batch_report(name, exp, cfg, dev)

    static = exp._batch
    exp.reseed(cfg.train.seed + 1)
    m = exp.run_steps(w + 1)
    g2 = exp._graphed
    check(g2 is not g and g2.state is exp.state and g2.replays == 1
          and g2.data is (exp._bank if not host else static)
          and all(np.isfinite(float(v)) for v in m.values()),
          f"graph {name}: no new capture after reseed")
    out.update(wall_ms=wall, device_ms=device,
               busy={k: device[k]["busy_ms"] / wall[k] for k in wall},
               wall_ratio_eager_over_graphed=wall["eager"] / wall["graphed"],
               launches_per_replay=g.per_replay,
               launches_per_replay_traced=device["graphed"]["kernels"],
               replays=g.replays,
               dispatch=dispatched)
    del exp, g, g2, batches, steps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_graph(dev, tmp: Path) -> tuple:
    """Each train step of graph_configs() (device bank) and of
    host_graph_configs() (host batches, the wav corpus written under
    `tmp`) as a captured CUDA graph against the eager step (graph_case);
    returns the launches of the bank cases, those of the host-batch
    cases' own runs, and those of the bank-mode runs that the host-batch
    cases' train() rates are compared with (host_batch_report).  The
    host-batch cases must record K1 twice a replay, (c) also K3 and its
    backward once; every case the batch kernel once a replay (and its
    noise launch where the data adds noise) and no sampler launch."""
    corpus = tmp / "corpus"
    write_fixture_corpus(str(corpus), n_speakers=6, utts_per_speaker=4,
                         seconds=3.0, sample_rate=SR_STREAM, seed=SEED)
    counts = {}
    for mode, configs in (("bank", graph_configs()), ("host", host_graph_configs(corpus))):
        cases = []
        reset_launch_counts()
        for i, (name, cfg) in enumerate(configs):
            (tmp / mode / str(i)).mkdir(parents=True)
            cases.append(graph_case(name, cfg, dev, tmp / mode / str(i)))
            emit("graph", **cases[-1])
            per = cases[-1]["launches_per_replay"]
            noise = int(cfg.data.num_noise > 0)
            check(per["threefry_batch"] == 1 and per["threefry_batch_noise"] == noise
                  and per["threefry_sample"] == 0,
                  f"graph {name}: the data path's launches a replay {per}")
            if mode == "host":
                wav = cfg.loss.recon_domain == "wav"
                check(per["stft_features"] == 2
                      and per["istft"] == per["istft_bwd"] == int(wav),
                      f"graph {name}: launches a replay {per}")
        torch.cuda.synchronize()
        counts[mode] = launch_counts()
        if mode == "host":
            counts["host_bank_rate"] = {k: sum(c["host_batches"]["bank_launches"][k]
                                               for c in cases) for k in counts[mode]}
            counts[mode] = {k: v - counts["host_bank_rate"][k]
                            for k, v in counts[mode].items()}
        emit("graph", data=mode, warmup_steps=graphed.WARMUP_STEPS, steps=GRAPH_STEPS,
             timed=GRAPH_TIMED, configs=[c["config"] for c in cases],
             launches=counts[mode],
             **({"bank_rate_launches": counts["host_bank_rate"]} if mode == "host" else {}),
             note="launches: the wrappers' counts plus launches per capture x replays "
                  "(graphed.launch_correction), each config's per capture held to "
                  "its traced replays (launches_per_replay_traced); busy: the union "
                  "of the device's "
                  "kernel, copy and fill intervals a step (torch.profiler) over the "
                  "median synchronized wall ms a step; host-batch steps, graphed and "
                  "eager, each copy a page-locked host batch drawn ahead; host "
                  "launches leave out the bank-mode runs of the train() rate "
                  "comparison (bank_rate_launches)")
    return counts["bank"], counts["host"], counts["host_bank_rate"]


def phase_bench(dev) -> dict:
    """`python -m gan_sass_tf_tpu_torch.bench` as a process at
    BENCH_STEPS_SMOKE timed steps: one JSON line with the four keys and a
    value > 0, printed again on a line of its own."""
    gc.collect()
    torch.cuda.empty_cache()
    env = {**os.environ, "BENCH_STEPS": str(BENCH_STEPS_SMOKE)}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "gan_sass_tf_tpu_torch.bench",
                          "--device", str(dev)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"bench exited {res.returncode}: {res.stderr[-3000:]}")
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    check(len(lines) == 1, f"bench printed {lines}")
    row = json.loads(lines[0])
    check(set(row) == {"metric", "value", "unit", "vs_baseline"} and row["value"] > 0
          and row["vs_baseline"] > 0, f"bench row {row}")
    print(f"bench: {row['value']} {row['unit']}", flush=True)
    emit("bench", row=row, steps=BENCH_STEPS_SMOKE, wall_s=wall,
         stderr=[ln for ln in res.stderr.splitlines() if ln.startswith("bench:")])
    return row


def counted_step(cfg, dev):
    """(Experiment, its second train step counted by the bytes ledger, the
    kernel launches that step made): the first step is the warm-up."""
    exp = Experiment(cfg, workdir=None, device=dev)
    exp._train_step(exp.state, exp._step_data(), exp._train_key)
    reset_launch_counts()
    ledger = bytes_ledger.step_ledger(exp, warm=False)
    return exp, ledger, {k: v for k, v in launch_counts().items() if v}


def ledger_gap(a, b) -> dict:
    """The (range, op) entries whose bytes or flops differ between two
    ledgers (the first 20)."""
    keys = set(a.op_bytes) | set(b.op_bytes)
    gap = {f"{r} {op}": [(a.op_bytes[(r, op)], a.op_flops[(r, op)]),
                         (b.op_bytes[(r, op)], b.op_flops[(r, op)])]
           for r, op in sorted(keys)
           if (a.op_bytes[(r, op)], a.op_flops[(r, op)]) != (b.op_bytes[(r, op)],
                                                              b.op_flops[(r, op)])}
    return dict(list(gap.items())[:20])


def phase_roofline(dev) -> dict:
    """The bytes ledger and the roofline (scripts/bytes_ledger.py,
    scripts/roofline.py): the narrow wsj0_logmel and stream_v5e8 steps of
    tests/test_torch_train.py counted on the CPU and on the card, equal in
    FLOPs and bytes; in every counted step each hand-written kernel launch
    charged once (the ledger's launches equal the launch counters'); the
    roofline line of wsj0_logmel at the bench's b128 and stream_v5e8 at b32
    at full width, printed on lines of their own, every share in (0, 1]."""
    gc.collect()
    torch.cuda.empty_cache()
    narrow = {}
    for preset, overrides in bytes_ledger.NARROW.items():
        cfg = bytes_ledger.experiment_config(preset, None, overrides)
        cpu = bytes_ledger.step_ledger(Experiment(cfg, workdir=None, device="cpu"))
        _, card, launched = counted_step(cfg, dev)
        check(card.launches() == launched,
              f"roofline {preset} narrow: charged {card.launches()}, launched {launched}")
        same = (cpu.total_flops(), cpu.total_bytes()) == (card.total_flops(),
                                                          card.total_bytes())
        check(same, f"roofline {preset} narrow: CPU {cpu.total_flops()} flops "
              f"{cpu.total_bytes()} bytes, card {card.total_flops()} flops "
              f"{card.total_bytes()} bytes; (range op): [CPU, card] "
              f"{ledger_gap(cpu, card)}")
        narrow[preset] = {"flops": card.total_flops(), "bytes": card.total_bytes(),
                          "launches": launched, "cpu_equals_card": same}
    lines = {}
    for preset, batch in ROOFLINE_RUNS:
        exp, ledger, launched = counted_step(bytes_ledger.experiment_config(preset, batch),
                                             dev)
        check(ledger.launches() == launched,
              f"roofline {preset} b{batch}: charged {ledger.launches()}, "
              f"launched {launched}")
        line = roofline.report(exp, ledger, ROOFLINE_STEPS)
        print(json.dumps(line), flush=True)
        shares = {k: line[k] for k in roofline.SHARE_KEYS}
        check(all(v is not None and 0 < v <= 1 for v in shares.values()),
              f"roofline {preset} b{batch}: shares {shares} not in (0, 1]")
        lines[f"{preset} b{batch}"] = line
        del exp
        gc.collect()
        torch.cuda.empty_cache()
    emit("roofline", narrow=narrow, lines=lines, steps=ROOFLINE_STEPS,
         note="narrow: one f32 step of each configuration counted on the CPU "
              "and on the card, equal; lines: scripts/roofline.py's at full width")
    return lines


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
    reset_launch_counts()
    t0 = time.perf_counter()
    last = exp.train(num_steps=PIT3_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_counts = {k: v for k, v in launch_counts().items()
                    if k in ("stft_features", "masked_istft")}
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
            _, m = exp._train_step(state, exp._bank, exp._train_key)
        out[path or "kernel"] = {k: float(v) for k, v in m.items()}
    gaps = {}
    for key in ("g_recon", "d_loss"):
        a, b = out["kernel"][key], out["reference"][key]
        gaps[key] = abs(a - b) / max(abs(b), 1.0)
        check(gaps[key] <= 1e-2, f"3src_pit step {key}: kernel {a} vs plain {b}")
    step_kernel, step_plain = time_steps(exp)
    cap = graphed.captures()
    reset_launch_counts()
    ev = exp.evaluate(num_batches=2)
    eval_counts = k12_since()
    check(all(np.isfinite(v) for v in ev.values()), f"3src_pit eval: {ev}")
    check(eval_counts == served(2),
          f"3src_pit eval launches {eval_counts}, captures {graphed.captures() - cap}")

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
    cap = graphed.captures()
    reset_launch_counts()
    est = separate(g, cfg, batch, dev)
    captured(cli.main, ["separate", "--config", "3src_pit", "--params", str(params),
                        "--input", str(wav60), "--output-dir", str(tmp / "out3")])
    torch.cuda.synchronize()
    sep_counts = k12_since()
    check(sep_counts == served(2),
          f"3src_pit separation launches {sep_counts}, captures "
          f"{graphed.captures() - cap}")
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
    reset_launch_counts()
    quality = captured_json(quality_protocol.main, [
        "3src_pit", str(PIT3_QUALITY_STEPS), "--hard", "--seeds", "0",
        "--device", str(dev)])
    q_counts = {k: v for k, v in launch_counts().items()
                if k in ("stft_features", "masked_istft", "stft")}
    check(set(quality) == QUALITY_KEYS, f"3src_pit quality keys {sorted(quality)}")
    check(all(finite(v) for v in quality.values()), f"3src_pit quality: {quality}")
    check(min(q_counts.values()) > 0, f"3src_pit quality launches {q_counts}")

    # K1 at the train step's two launches and the separation launch, on the
    # step's own mixtures and targets; K2 on the trained G's masks.
    with torch.no_grad():
        picked = sample_bank(exp._bank, exp._train_key, B_PIT3)
        mixture, scaled = mix_sources(picked, exp._train_key, cfg.data)
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
        cost.masked_istft(B_PIT3, S_PIT3, spec.shape[-2], N_FFT, HOP).bound(),
        **library_masked_istft(spec, masks, N_FFT, HOP))
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
    reset_launch_counts()
    out = captured(cli.main, ["train", *common, "--steps", "4", *sets])
    counts = {k: v for k, v in launch_counts().items()
              if k in ("stft_features", "istft", "istft_bwd", "threefry_batch",
                       "threefry_batch_noise", "threefry_sample")}
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
        cap = graphed.captures()
        reset_launch_counts()
        captured(cli.main, [
            "separate", "--config", "stream_v5e8", "--workdir", str(wd), "--device",
            str(dev), "--input", str(wav), "--output-dir", str(out_dir),
            "--streaming", "--streaming-mode", mode])
        launches[mode] = k12_since()
        want = served(expect[mode])
        check(launches[mode] == want and graphed.captures() - cap == 1,
              f"stream {mode}: launches {launches[mode]}, captures "
              f"{graphed.captures() - cap}, expected {want} and one capture")
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
            cost.masked_istft(b, 2, spec.shape[-2], n_fft, hop).bound(),
            **library_masked_istft(spec, masks, n_fft, hop))
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


def k12(counts: dict) -> dict:
    """K1's and K2's entries of a launch count."""
    return {k: counts[k] for k in ("stft_features", "masked_istft")}


def k12_since(before: dict = None) -> dict:
    """K1's and K2's launches since launch_counts() read `before` (since
    reset_launch_counts() without it)."""
    now, before = launch_counts(), before or {}
    return {k: now[k] - before.get(k, 0) for k in ("stft_features", "masked_istft")}


def served(calls: int) -> dict:
    """K1's and K2's launches for `calls` separations: once each a call,
    whether it ran eagerly (a shape's first WARMUP_CALLS calls) or replayed
    a capture."""
    return {"stft_features": calls, "masked_istft": calls}


@contextlib.contextmanager
def eager_serving():
    """The public serving and eval entry points with the eager functions
    (`build_separate_fn`, `build_streaming_scan_fn`, `build_eval_step`)
    in place of their memoised graphs: the same host code around them."""
    sep = importlib.import_module("gan_sass_tf_tpu_torch.infer.separate")
    exp = importlib.import_module("gan_sass_tf_tpu_torch.train.experiment")
    saved = (sep.separate_fn_for, streaming.separate_fn_for,
             streaming.streaming_scan_fn_for, exp.eval_fn_for)
    sep.separate_fn_for = streaming.separate_fn_for = train_step.build_separate_fn
    streaming.streaming_scan_fn_for = streaming.build_streaming_scan_fn
    exp.eval_fn_for = train_step.build_eval_step
    try:
        yield
    finally:
        (sep.separate_fn_for, streaming.separate_fn_for,
         streaming.streaming_scan_fn_for, exp.eval_fn_for) = saved


def serve_agreement(got, want) -> dict:
    """A graphed result against the eager one: the same bits, or else
    SI-SDR >= 40 dB a row (waveforms) or within SERVE_EVAL_TOL_DB (eval
    scores)."""
    if isinstance(got, dict):
        gap = max(abs(got[k] - want[k]) for k in want)
        same = all(got[k] == want[k] for k in want)
        return {"same_bits": same, "max_abs_db": gap,
                "ok": same or gap <= SERVE_EVAL_TOL_DB}
    same = bool(np.array_equal(got, want))
    out = {"same_bits": same, "max_abs": float(np.abs(got - want).max())}
    if not same:
        rows = [torch.from_numpy(np.ascontiguousarray(a.reshape(-1, a.shape[-1])))
                for a in (got, want)]
        out["min_si_sdr_db"] = float(si_sdr(*rows).min())
    out["ok"] = same or out["min_si_sdr_db"] >= 40.0
    return out


def serve_walls(fns: dict, samples=SERVE_SAMPLES) -> dict:
    """Median wall ms of a call of each of {"eager", "graphed"}, host array
    in and out, in turns (eager, graphed, graphed, eager, ...), each
    synchronized."""
    times = {"eager": [], "graphed": []}
    for i in range(2 * samples):
        side = ("eager", "graphed", "graphed", "eager")[i % 4]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[side]()
        torch.cuda.synchronize()
        times[side].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def serve_path(name, run, inputs, calls_of, load_weights, captured_calls, seconds_of):
    """One serving or eval path, `run(x)` its public entry point on input
    x (host arrays in and out), on a G that no earlier call has seen:
    (1) the first call on inputs[0], K1 and K2 launched calls_of(x) times
    each (a one-shot call runs eagerly, a stream captures after its first
    WARMUP_CALLS groups or chunks), against the same entry point with the
    eager function; (2) calls on
    inputs[0] until the path has captured, at most WARMUP_CALLS + 1, one
    capture in all; (3) the other inputs and inputs[0] replay that
    capture, K1 and K2 launched calls_of(x) times each, no capture made;
    (4) new weights loaded into G in place: the replay follows them, again
    against eager; (5) the walls graphed and eager in turns, mixture-s/s
    and the device-busy share (the device's busy ms a call in a trace of
    SERVE_TRACE_CALLS calls, over a call's host ms there), and each
    TRACE_KERNELS kernel's launches a call in that trace held to the
    capture's per-replay launches times the replays a call makes and to
    the traced eager calls'.  `captured_calls()`
    the path's GraphedCalls."""
    def eager(x):
        with eager_serving():
            return run(x)

    def graphs():
        return [c for c in captured_calls() if c.graph is not None]

    x0 = inputs[0]
    cap, before = graphed.captures(), launch_counts()
    got = run(x0)
    first = {"captures": graphed.captures() - cap, "launches": k12_since(before)}
    check(first["launches"] == served(calls_of(x0)),
          f"serve_graph {name}: first call {first}, expected {served(calls_of(x0))}")
    agree = serve_agreement(got, eager(x0))
    check(agree["ok"], f"serve_graph {name}: graphed vs eager {agree}")

    warm_calls = 0
    while not graphs() and warm_calls <= graphed.WARMUP_CALLS:
        run(x0)
        warm_calls += 1
    made = graphed.captures() - cap
    check(len(graphs()) == 1 and made == 1,
          f"serve_graph {name}: {made} captures after {warm_calls} more calls, "
          f"expected one within {graphed.WARMUP_CALLS + 1}")

    cap, before = graphed.captures(), launch_counts()
    for x in inputs[1:] + [x0]:
        run(x)
    reuse = {"calls": len(inputs), "captures": graphed.captures() - cap,
             "launches": k12_since(before)}
    want = served(sum(calls_of(x) for x in inputs))
    check(reuse["captures"] == 0 and reuse["launches"] == want,
          f"serve_graph {name}: later calls {reuse}, expected {want} and no capture")

    cap = graphed.captures()
    load_weights()
    after = run(x0)
    follow = serve_agreement(after, eager(x0))
    moved = not serve_agreement(after, got)["same_bits"]
    check(follow["ok"] and moved and graphed.captures() == cap,
          f"serve_graph {name}: after a load_state_dict: graphed vs eager "
          f"{follow}, output moved {moved}, captures {graphed.captures() - cap}")

    walls = serve_walls({"eager": lambda: eager(x0), "graphed": lambda: run(x0)})
    (call,) = graphs()
    replays = call.replays
    run(x0)
    per_call = call.replays - replays
    spans = {"graphed": device_spans(lambda: run(x0), SERVE_TRACE_CALLS, open_calls=1),
             "eager": device_spans(lambda: eager(x0), SERVE_TRACE_CALLS, open_calls=1)}
    recorded = {n: sum(call.per_replay[k] for k in keys) * per_call
                for n, keys in TRACE_KERNELS.items()}
    check(spans["graphed"]["kernels"] == spans["eager"]["kernels"] == recorded,
          f"serve_graph {name}: kernel launches a call, traced replays "
          f"{spans['graphed']['kernels']}, traced eager call "
          f"{spans['eager']['kernels']}, recorded by the capture ({per_call} "
          f"replays) {recorded}; in the whole traces: replays "
          f"{spans['graphed']['kernels_in_trace']}, eager "
          f"{spans['eager']['kernels_in_trace']}; counted by launch with a device start "
          f"outside the window: replays {spans['graphed']['kernels_off_window']}, "
          f"eager {spans['eager']['kernels_off_window']}")
    busy = {side: {"busy_ms": sp["busy_ms"], "traced_call_ms": sp["span_ms"],
                   "share": sp["busy_ms"] / sp["span_ms"], "kernel_sum_ms": sp["sum_ms"],
                   "launches_off_window": sp["kernels_off_window"]}
            for side, sp in spans.items()}
    return {"first_call": first, "graphed_vs_eager": agree,
            "calls_to_capture": 1 + warm_calls, "later_calls": reuse,
            "weights_loaded_in_place": {"graphed_vs_eager": follow, "output_moved": moved},
            "per_replay_launches": {k: v for k, v in call.per_replay.items() if v},
            "replays_a_call": per_call,
            "traced_launches_a_call": {k: v for k, v in recorded.items() if v},
            "wall_ms": walls,
            "mixture_sec_per_sec": {k: seconds_of(x0) / w * 1e3 for k, w in walls.items()},
            "device_busy_share": busy}


def serve_graph_paths(dev, gen) -> tuple:
    """The serve_graph phase's paths: (their rows, weak references to the
    generators they served)."""
    sep_mod = importlib.import_module("gan_sass_tf_tpu_torch.infer.separate")
    paths, gs = {}, []

    def reload(g, cfg, seed):
        return lambda: g.load_state_dict(build_generator(cfg, dev, seed=seed).state_dict())

    def last_graph(fn):         # the GraphedCall used last
        return lambda: list(fn.graphs.values())[-1:]

    for preset, b, t in (("wsj0_logmel", B_MAIN, 3 * SR), ("wsj0_logmel", 1, T_LONG),
                         ("3src_pit", B_PIT3, T_MAIN)):
        cfg = config.get_config(preset)
        g = build_generator(cfg, dev, seed=SEED)
        gs.append(weakref.ref(g))
        inputs = [mixtures(gen, b, t) for _ in range(2)]
        paths[f"{preset} separate() {b} x {t / SR:g} s"] = serve_path(
            preset, lambda x, g=g, cfg=cfg: separate(g, cfg, x, dev), inputs,
            lambda x: 1, reload(g, cfg, SEED + 1),
            last_graph(sep_mod.separate_fn_for(cfg, g)),
            lambda x: x.size / SR)

    cfg = config.get_config("stream_v5e8")
    streams = [mixtures(gen, 1, n, SR_STREAM)[0]
               for n in (T_STREAM, T_STREAM, T_STREAM // 2)]
    chunks = {x.size: streaming._chunk_geometry(cfg, x.size)[3] for x in streams}
    bc = cfg.stream.batch_chunks
    for mode in ("batch", "scan"):
        g = build_generator(cfg, dev, seed=SEED)    # a G of its own: the first call is its first
        gs.append(weakref.ref(g))
        if mode == "batch":
            fn, calls_of = separate_streaming, lambda x: -(-chunks[x.size] // bc)
            calls = last_graph(sep_mod.separate_fn_for(cfg, g))
        else:
            fn, calls_of = separate_streaming_scan, lambda x: chunks[x.size]
            calls = last_graph(streaming.streaming_scan_fn_for(cfg, g).body)
        row = serve_path(f"stream {mode}", lambda x, fn=fn, g=g: fn(g, cfg, x, dev),
                         streams, calls_of, reload(g, cfg, SEED + 2 + (mode == "scan")),
                         calls, lambda x: x.size / SR_STREAM)
        row["chunks"] = chunks[T_STREAM]
        row["ms_per_chunk"] = {k: w / chunks[T_STREAM] for k, w in row["wall_ms"].items()}
        paths[f"stream_v5e8 {mode} 60 s"] = row

    cfg = config.get_config("wsj0_logmel")
    exp = Experiment(cfg, device=dev)
    g = exp.eval_generator()
    gs.append(weakref.ref(g))
    segment = cfg.train.batch_size * cfg.segment_samples / cfg.dsp.sample_rate
    row = paths["wsj0_logmel Experiment.evaluate()"] = serve_path(
        "evaluate", lambda seed: exp.evaluate(SERVE_EVAL_BATCHES, dataset=make_dataset(
            cfg, seed=seed, split=cfg.data.eval_split)),
        [SEED_SERVE, SEED_SERVE + 1], lambda seed: SERVE_EVAL_BATCHES,
        reload(g, cfg, SEED + 4), last_graph(train_step.eval_fn_for(cfg, g, exp.dp)),
        lambda seed: SERVE_EVAL_BATCHES * segment)
    # The scores alone, on one batch already on the device: the replay
    # against build_eval_step, without the host's batch.
    batch = torch.from_numpy(make_dataset(cfg, seed=SEED_SERVE, split=cfg.data.eval_split)
                             .batch()).to(dev)
    seed = torch.tensor(10_000, dtype=torch.int64, device=dev)
    scores = train_step.eval_fn_for(cfg, g, exp.dp)
    eager_scores = train_step.build_eval_step(cfg, g, exp.dp)
    row["scores_wall_ms"] = serve_walls({"eager": lambda: eager_scores(batch, seed),
                                         "graphed": lambda: scores(batch, seed)})
    exp.close()
    return paths, gs


def phase_serve_graph(dev) -> dict:
    """Serving and eval as replays of captured CUDA graphs (train/graphed.py
    GraphedCall, memoised per (cfg, G) and shape) against the same entry
    points with the eager functions, at full width with seeded weights and
    cudnn.deterministic: wsj0_logmel separate() on B_MAIN x 3 s and on
    60 s, stream_v5e8 batch and scan streaming of two 60 s streams and a
    30 s one (one capture serves them all), 3src_pit separate() on 16 x
    3 s (cuDNN's LSTM inside the capture) and Experiment.evaluate() on
    wsj0_logmel.  Then the phase's generators are dropped: the memos hold
    them weakly, so they go with their graphs, and the device memory
    allocated returns to what it was before the phase.  Returns the launch
    counts of the whole phase."""
    gen = np.random.default_rng(SEED_SERVE)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    gc.collect()
    torch.cuda.synchronize()
    mib_before = torch.cuda.memory_allocated() / 2**20
    reset_launch_counts()
    try:
        paths, gs = serve_graph_paths(dev, gen)
        counts = launch_counts()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gc.collect()
    torch.cuda.synchronize()
    held = {"generators_alive": sum(r() is not None for r in gs),
            "allocated_mib_before": mib_before,
            "allocated_mib_after": torch.cuda.memory_allocated() / 2**20}
    check(held["generators_alive"] == 0,
          f"serve_graph: the memos kept a generator alive after the phase: {held}")
    emit("serve_graph", cudnn_deterministic=True, warmup_calls=graphed.WARMUP_CALLS,
         tolerance="same bits, else SI-SDR >= 40 dB a row (waveforms) or "
                   f"{SERVE_EVAL_TOL_DB} dB (eval scores)",
         samples=SERVE_SAMPLES, paths=paths, memory_after_the_phase=held,
         note="wall: host array in, host array out, synchronized, median of "
              "SERVE_SAMPLES a side in turns; eager: the same entry point with "
              "build_separate_fn / build_streaming_scan_fn / build_eval_step; "
              "busy: the union of the device's kernel, copy and fill intervals "
              "of one call in a torch.profiler trace over that call's host ms "
              "(traced_call_ms); the evaluate() walls include drawing the host "
              "batches, its "
              "scores_wall_ms one batch's scores on the device")
    return counts


def launch_counts() -> dict:
    """Each kernel's launches since reset_launch_counts(): its wrapper's
    count, plus the launches that replays of a captured train step made,
    less the calls counted while capturing (train/graphed.py)."""
    fix = graphed.launch_correction()
    return {k: v + fix[k] for k, v in dispatch.launch_counts().items()}


def reset_launch_counts() -> None:
    dispatch.reset_launch_counts()
    graphed.reset_launch_correction()


def flat_tensors(state) -> dict:
    """{name: tensor} of a TrainState's state_dict, on the host."""
    return {k: v.detach().cpu().clone() for k, v in flat_state(state.state_dict())
            if torch.is_tensor(v)}


def dp_step_report(exp) -> dict:
    """The data-parallel phase's step on `exp`, run alike by this process
    (no process group) and by every torchrun rank: one step (metrics,
    launches, the state it leaves), evaluate(DP_EVAL_BATCHES) (eager for
    the first WARMUP_CALLS batches, then replays of the eval graph) and
    its launches; then,
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
        steps[name](exp.state, exp._bank, exp._train_key)

    def sync():
        if exp.device.type == "cuda":
            torch.cuda.synchronize()

    reset_launch_counts()
    _, m = exp._train_step(exp.state, exp._bank, exp._train_key)
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "step_launches": launch_counts()}
    params = flat_tensors(exp.state)
    reset_launch_counts()
    out["eval"] = exp.evaluate(num_batches=DP_EVAL_BATCHES)
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


def dp_graphs(world: int, device: str) -> bool:
    """Whether the dp phase's ranks run dp_graph_report: on CUDA at W >= 2."""
    return world > 1 and device == "cuda"


def dp_eval_report(exp) -> dict:
    """The eval graph of `exp`'s eval G over its group (`eval_fn_for`: the
    all-reduce of the means captured with the scores) against the eager
    group eval (`build_eval_step`) on this rank's rows of one held-out
    batch, call by call under seeds 10 000 + i: WARMUP_CALLS eager calls,
    then two replays, each the same bits as the eager step or within
    SERVE_EVAL_TOL_DB (serve_agreement)."""
    g = exp.eval_generator()
    graph = train_step.eval_fn_for(exp.cfg, g, exp.dp)
    eager = train_step.build_eval_step(exp.cfg, g, exp.dp)
    batch = exp.eval_dataset.batch()
    sources = torch.from_numpy(batch[exp.dp.batch_rows(batch.shape[0])]).to(exp.device)
    calls = []
    for i in range(graphed.WARMUP_CALLS + 2):
        seed = torch.tensor(10_000 + i, dtype=torch.int64, device=exp.device)
        with torch.inference_mode():
            got, want = graph(sources, seed), eager(sources, seed)
        calls.append(serve_agreement({k: float(v) for k, v in got.items()},
                                     {k: float(v) for k, v in want.items()}))
    call = graph.graph_for(sources, seed)
    check(call.graph is not None and call.replays == 2
          and all(c["ok"] for c in calls),
          f"dp eval: the eval graph over the group against the eager group eval: "
          f"captured {call.graph is not None}, replays {call.replays}, {calls}")
    return {"replays": call.replays, "calls": calls}


def dp_graph_report(cfg, dev, tmp: Path, stepped: dict) -> dict:
    """At W >= 2, alike on every rank, for the meshes (dcn 1 x data W) and
    (dcn 2 x data W/2): an Experiment over the group from the seeded init
    (the state checkpoint 0 holds); its first eager step bit-equal to
    dp_step_report's group step (`stepped`: the ranks flatten (dcn, data)
    row-major, as the JAX `_shard_offset` does, so both meshes run that
    step); graphed group replays against eager group steps from one
    checkpoint, bit for bit (replays_vs_eager: the capture holds the NCCL
    all-reduces); the median wall ms of DP_STEP_SAMPLES synchronized
    replays; a traced replay's device ms and NCCL kernels (device_spans);
    on the first mesh the eval graph against the eager group eval."""
    world = torch.distributed.get_world_size()
    out = {}
    for dcn in (1, 2):
        if world % dcn:
            continue
        name = f"dcn{dcn}xdata{world // dcn}"
        exp = Experiment(cfg.replace(mesh=dataclasses.replace(
            cfg.mesh, dcn_axis_size=dcn, data_axis_size=world // dcn)), device=dev)
        (tmp / name).mkdir(parents=True)
        exp._write(str(tmp / name / "init"), 0, 1)
        first = state_gap(eager_steps(exp, 1)["state"], stepped)
        check(first["same_bits"], f"dp {name}: the first group step from the seeded "
                                  f"init differs from dp_step_report's: {first}")
        exp._read(str(tmp / name / "init"), 0)
        row = {"first_step_vs_group_step": first,
               **replays_vs_eager(f"dp {name}", exp, tmp / name)}
        check(row["first_replay_vs_eager"]["same_bits"]
              and row["replays_vs_eager"]["same_bits"],
              f"dp {name}: graphed group replays differ from eager group steps: {row}")
        row["graphed_wall_ms"] = synced_walls({"graphed": lambda: exp.run_steps(1)},
                                              DP_STEP_SAMPLES)["graphed"]
        row["replay"] = device_spans(lambda: exp.run_steps(1))
        check(row["replay"]["nccl_kernels"] > 0,
              f"dp {name}: no NCCL kernel in a traced replay: {row['replay']}")
        row["launches_per_replay"] = exp._graphed.per_replay
        if dcn == 1:
            row["eval"] = dp_eval_report(exp)
        out[name] = row
        del exp
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dp_host_graph_report(cfg, dev, tmp: Path) -> dict:
    """At W >= 2, alike on every rank: `cfg` in host-batch mode over the
    (dcn 1 x data W) mesh, each rank copying its rows of one global batch
    (every rank's dataset draws the same batches) into its static batch;
    graphed group replays against eager group steps from one checkpoint on
    the same batches, bit for bit (replays_vs_eager), and the median wall
    ms of DP_STEP_SAMPLES synchronized replays, each with its copy."""
    world = torch.distributed.get_world_size()
    exp = Experiment(cfg.replace(
        data=dataclasses.replace(cfg.data, device_bank=False),
        mesh=dataclasses.replace(cfg.mesh, dcn_axis_size=1, data_axis_size=world)),
        device=dev)
    tmp.mkdir(parents=True)
    batches = HostBatches(exp, graphed.WARMUP_STEPS + 1 + GRAPH_STEPS)
    row = {"rows": [exp._rows.start, exp._rows.stop],
           **replays_vs_eager("dp host batches", exp, tmp, batches)}
    check(row["first_replay_vs_eager"]["same_bits"] and row["replays_vs_eager"]["same_bits"],
          f"dp host batches: graphed group replays differ from eager group steps: {row}")
    row["graphed_wall_ms"] = synced_walls(
        {"graphed": lambda: exp.run_steps(1, batches)}, DP_STEP_SAMPLES)["graphed"]
    del exp, batches
    gc.collect()
    torch.cuda.empty_cache()
    return row


def dp_worker(spec_path: str) -> int:
    """One torchrun rank of the dp phase, from the JSON spec the phase
    wrote: join the group, then `cli.main(spec["train"])`, dp_step_report
    on the workdir spec["step_workdir"] (resumed from its checkpoint) and
    `cli.main(spec["separate"])` (cli.main is the function `python -m
    gan_sass_tf_tpu_torch.cli` runs; it leaves a group it did not join
    alone), each with the kernels it launched on this rank.  Writes
    spec["out"].rank<r>.json and spec["out"].rank<r>.pt, the state after
    the step.  At W >= 2 on CUDA, dp_graph_report between the step and
    the separation.  Each stage is noted on stderr.  A rank that fails
    exits at once, leaving the group as it is (destroying it would wait on
    the ranks still in a collective); one that is still running
    spec["timeout_s"] - 60 s after it began prints every thread's stack
    and exits, so torchrun ends the others."""
    from gan_sass_tf_tpu_torch.parallel import (
        initialize_distributed,
        rank_device,
        shutdown_distributed,
    )

    spec = json.loads(Path(spec_path).read_text())
    faulthandler.dump_traceback_later(spec["timeout_s"] - 60, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False       # as phase_device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True           # as phase_dp's reference
    initialize_distributed(device=spec["device"])
    rank = torch.distributed.get_rank()
    res = {"rank": rank, "world": torch.distributed.get_world_size(),
           "backend": torch.distributed.get_backend()}

    def note(stage: str) -> None:
        print(f"dp rank {rank}: {stage} at {time.perf_counter() - T_START:.1f} s",
              file=sys.stderr, flush=True)

    try:
        note("cli train")
        reset_launch_counts()
        res["train_rc"] = cli.main(spec["train"])
        res["train_launches"] = launch_counts()
        cfg = config.Config.from_json((Path(spec["step_workdir"]) / "config.json").read_text())
        exp = Experiment(cfg, workdir=spec["step_workdir"],
                         device=rank_device(spec["device"]))
        note("step report")
        report, params = dp_step_report(exp)
        exp.close()
        res.update(report)
        torch.save(params, f"{spec['out']}.rank{rank}.pt")
        if dp_graphs(res["world"], spec["device"]):
            note("graph report")
            res["graph"] = dp_graph_report(cfg, rank_device(spec["device"]),
                                           Path(f"{spec['out']}.graph{rank}"), params)
            note("host-batch graph report")
            res["graph_host"] = dp_host_graph_report(
                cfg, rank_device(spec["device"]), Path(f"{spec['out']}.host{rank}"))
        chained, inner = [], streaming._chain_permutations

        def recording_chain(*a, **kw):
            chained.append(inner(*a, **kw))
            return chained[-1]

        streaming._chain_permutations = recording_chain
        note("cli separate")
        reset_launch_counts()
        res["separate_rc"] = cli.main(spec["separate"])
        res["separate_launches"] = launch_counts()
        res["chained"] = [c.tolist() for c in chained]
    except BaseException as exc:        # a failed check raises SystemExit
        print(f"dp rank {rank}: failed: {exc!r}", file=sys.stderr, flush=True)
        traceback.print_exc()
        os._exit(1)
    Path(f"{spec['out']}.rank{rank}.json").write_text(json.dumps(res))
    note("done")
    shutdown_distributed()
    faulthandler.cancel_dump_traceback_later()
    return res["train_rc"] or res["separate_rc"]


def torchrun(world: int, *argv, timeout: float = DP_TIMEOUT_S) -> tuple:
    """`python -m torch.distributed.run --standalone --nproc_per_node world
    argv...` from the repo root: (wall ms, stdout); a non-zero exit (a
    failed NCCL init, a failed rank) or a call still running after
    `timeout` s fails the run."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), *argv]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=timeout,
                             env={**os.environ, "PYTHONPATH": str(ROOT)})
    except subprocess.TimeoutExpired as exc:
        print(*((o.decode(errors="replace") if isinstance(o, bytes) else o or "")[-6000:]
                for o in (exc.stdout, exc.stderr)), sep="\n", file=sys.stderr)
        check(False, f"torchrun {' '.join(argv[:6])} still running after {timeout} s")
    wall = (time.perf_counter() - t0) * 1e3
    if res.returncode != 0:
        print(res.stdout[-3000:], res.stderr[-6000:], sep="\n", file=sys.stderr)
    check(res.returncode == 0, f"torchrun {' '.join(argv[:6])} exited {res.returncode}")
    return wall, res.stdout


def dp_state_gaps(init: dict, one: dict, group: dict, opts: dict) -> dict:
    """The group's state after one step against one process's, both from
    `init` (flat_tensors).  For each optimizer of `opts` ({"g" | "d":
    (parameter names, lr)}): `mu`, `nu`, the largest gap of the first
    moment and of the root of the second (each a gradient, |g| scaled)
    over the optimizer's largest value; Adam's first move of its weights,
    lr g/(|g| + eps): `bound`, the largest group move over lr less the
    weight's rounding (eps32 |w|; Adam's bound: <= 1); `flat_share`, the
    weights one process moved by less than 0.99 lr (a gradient within a
    few eps of 0), over the optimizer and in its worst tensor; `flips`,
    the weights one process moved by >= 0.99 lr that the group moved more
    than 1e-2 lr away, by tensor, with `flip_grad`, the largest such
    weight's one-process gradient over the optimizer's largest (|mu|); and
    `sharp_gap`, the largest gap over lr of the moved weights whose
    gradient is at least DP_REL_TOL["moments"] of the largest (the check
    holds it to 1e-2).  `buffers`: every other tensor's largest gap over
    its own largest value (D's spectral-norm u and sigma), the worst three
    by name."""
    out, done = {}, set()
    eps = torch.finfo(torch.float32).eps
    for o, (names, lr) in opts.items():
        mu1 = [one[f"{o}_opt/mu/{n}"].abs() for n in names]
        top = max(float(m.max()) for m in mu1)
        floor = DP_REL_TOL["moments"] * top
        row = {"lr": lr, "bound": 0.0, "flips": 0, "flip_grad": 0.0, "sharp_gap": 0.0,
               "flip_tensors": {}, "flat_worst": {}}
        flat = total = 0
        for n, m in zip(names, mu1):
            k = f"{o}/{n}"
            moved1, moved = one[k] - init[k], group[k] - init[k]
            gap = (moved - moved1).abs() / lr
            sharp = moved1.abs() >= 0.99 * lr
            flip = sharp & (gap > 1e-2)
            held = sharp & (m >= floor)
            ulp = eps * torch.maximum(init[k].abs(), group[k].abs())
            row["bound"] = max(row["bound"], float((moved.abs() - ulp).max()) / lr)
            if held.any():
                row["sharp_gap"] = max(row["sharp_gap"], float(gap[held].max()))
            if flip.any():
                row["flips"] += int(flip.sum())
                row["flip_grad"] = max(row["flip_grad"], float(m[flip].max()) / top)
                row["flip_tensors"][n] = int(flip.sum())
            flat += int((~sharp).sum())
            total += sharp.numel()
            share = float((~sharp).float().mean())
            if share > max(row["flat_worst"].values(), default=0.0):
                row["flat_worst"] = {n: share}
            done.add(k)
        row["flat_share"] = flat / total
        for kind, f in (("mu", torch.abs), ("nu", torch.sqrt)):
            keys = [f"{o}_opt/{kind}/{n}" for n in names]
            big = max(float(f(one[k]).max()) for k in keys)
            row[kind] = max(float((f(group[k]) - f(one[k])).abs().max()) for k in keys) / big
            done.update(keys)
        out[o] = row
    rest = {k: float((group[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
            for k, v in one.items() if k not in done}
    out["buffers"] = max(rest.values(), default=0.0)
    out["buffers_worst"] = {k: rest[k] for k in sorted(rest, key=rest.get)[-3:]}
    return out


def dp_state_ok(gaps: dict) -> bool:
    """dp_state_gaps within the W >= 2 limits (DP_REL_TOL)."""
    return gaps["buffers"] <= DP_REL_TOL["buffers"] and all(
        gaps[o]["bound"] <= 1 + 1e-4 and gaps[o]["sharp_gap"] <= 1e-2
        and gaps[o]["mu"] <= DP_REL_TOL["moments"] and gaps[o]["nu"] <= DP_REL_TOL["moments"]
        for o in ("g", "d"))


def dp_rank0_separation(world: int, dev, tmp: Path, wd: Path, wav: Path, stride: int) -> dict:
    """At W >= 2: one-shot and scan-mode `cli separate` of `wav` through
    `-m gan_sass_tf_tpu_torch.cli` under torchrun, as a user starts them.
    Rank 0 separates alone; the other ranks return at once and leave the
    group, so none may wait in a collective: each call ends within
    DP_SEPARATE_TIMEOUT_S with rc 0, and rank 0's sources agree with this
    process's run of the same command (>= 40 dB a segment after the best
    permutation; the ranks keep torch's TF32 default for cuDNN)."""
    out = {}
    for mode, extra in (("one_shot", []), ("scan", ["--streaming", "--streaming-mode", "scan"])):
        args = ["separate", "--config", "stream_v5e8", "--workdir", str(wd),
                "--device", dev.type, "--input", str(wav), *extra]
        t0 = time.perf_counter()
        captured(cli.main, [*args, "--output-dir", str(tmp / f"dp_{mode}_1")])
        one_ms = (time.perf_counter() - t0) * 1e3
        wall, _ = torchrun(world, "-m", "gan_sass_tf_tpu_torch.cli", *args,
                           "--output-dir", str(tmp / f"dp_{mode}_w"),
                           timeout=DP_SEPARATE_TIMEOUT_S)
        got, ref = (np.stack([read_wav(str(p))[1] for p in sorted(
            (tmp / d).glob(f"{wav.stem}_src*.wav"))]) for d in (f"dp_{mode}_w", f"dp_{mode}_1"))
        check(got.shape == ref.shape, f"dp {mode}: rank 0 wrote {got.shape}, not {ref.shape}")
        worst, same, n = segment_agreement(got, ref, stride)
        check(worst >= 40.0, f"dp {mode} under torchrun vs one process: {worst} dB < 40")
        out[mode] = {"torchrun_wall_ms": wall, "one_process_ms": one_ms,
                     "min_si_sdr_db": worst, "segments_same_permutation": same,
                     "segments": n, "max_abs_diff": float(np.abs(got - ref).max())}
    return out


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
        init = flat_tensors(exp.state)
        opts = {o: (opt.names, float(opt.lr(opt.count))) for o, opt in
                (("g", exp.state.g_opt), ("d", exp.state.d_opt))}
        one, one_params = dp_step_report(exp)
        exp.close()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    spec = tmp / "dp_spec.json"
    spec.write_text(json.dumps({
        "device": dev.type, "out": str(out), "step_workdir": str(ref_wd),
        "timeout_s": DP_TIMEOUT_S,
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
    # O(1)); at W = 1 every state tensor by its max |.|, at W >= 2, where
    # the ranks sum in another order than one process, dp_state_gaps.
    rel = {"metrics": max(abs(step["metrics"][k] - v) / max(abs(v), 1.0)
                          for k, v in one["metrics"].items()),
           "eval": max(abs(step["eval"][k] - v) / max(abs(v), 1.0)
                       for k, v in one["eval"].items())}
    if world == 1:
        rel["params"] = max(float((dp_params[k] - v).abs().max())
                            / max(float(v.abs().max()), 1e-30) for k, v in one_params.items())
        tol, gaps = {k: 1e-5 for k in rel}, None
    else:
        tol = DP_REL_TOL
        gaps = dp_state_gaps(init, one_params, dp_params, opts)
    check(all(v <= tol[k] for k, v in rel.items()),
          f"dp step at world {world} vs one process: {rel}, limits {tol}")
    reduces = sum(n for k, n in step["collectives"]["group"].items()
                  if k.startswith(("nccl:all_reduce", "gloo:all_reduce")))
    want = cfg.train.d_steps + 2               # D's grads a D step, G's grads, metrics
    check(reduces == want, f"dp step: {reduces} all-reduces, not {want}: "
                           f"{step['collectives']['group']}")
    graphs = None
    if world > 1 and dev.type == "cuda":
        check(sum(step["nccl_kernels"]["group"].values()) > 0,
              f"no NCCL kernel in the profiled dp step: {step['nccl_kernels']}")
    if dp_graphs(world, dev.type):
        # Each rank held its replays, its eval graph and its traced replay's
        # NCCL kernels to the eager group step itself (dp_graph_report).
        meshes = list(step["graph"])
        check(all(list(r["graph"]) == meshes for r in ranks) and len(meshes) == 2,
              f"dp graph: meshes {[list(r['graph']) for r in ranks]}")
        graphs = {m: {
            "replays_vs_eager_same_bits": all(
                r["graph"][m][k]["same_bits"] for r in ranks
                for k in ("first_step_vs_group_step", "first_replay_vs_eager",
                          "replays_vs_eager")),
            "graphed_wall_ms_by_rank": [r["graph"][m]["graphed_wall_ms"] for r in ranks],
            "replay_by_rank": [{k: r["graph"][m]["replay"][k] for k in (
                "sum_ms", "busy_ms", "span_ms", "nccl_kernels", "nccl_ms")}
                for r in ranks],
            "launches_per_replay": step["graph"][m]["launches_per_replay"],
            **({"eval_by_rank": [r["graph"][m]["eval"] for r in ranks]}
               if "eval" in step["graph"][m] else {})} for m in meshes}
        graphs["host_batches"] = {
            "replays_vs_eager_same_bits": all(
                r["graph_host"][k]["same_bits"] for r in ranks
                for k in ("first_replay_vs_eager", "replays_vs_eager")),
            "rows_by_rank": [r["graph_host"]["rows"] for r in ranks],
            "graphed_wall_ms_by_rank": [r["graph_host"]["graphed_wall_ms"] for r in ranks]}
        check(graphs["host_batches"]["replays_vs_eager_same_bits"],
              f"dp host batches: {[r['graph_host'] for r in ranks]}")

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
    rank0_only = (dp_rank0_separation(world, dev, tmp, wd, wav, stride)
                  if world > 1 else None)

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
    by_rank = {k: [{"dp_train": r["train_launches"][k], "dp_eval": r["eval_launches"][k],
                    "dp_stream": r["separate_launches"][k]} for r in ranks]
               for k in ("stft_features", "masked_istft", "istft", "istft_bwd")}
    keys = ("metrics", "eval", "wall_ms", "device_ms", "step_launches", "nccl_kernels",
            "collectives", "all_reduce_g")
    emit("dp", world=world, backend=step["backend"], config="stream_v5e8",
         batch=cfg.train.batch_size, local_batch=cfg.train.batch_size // world,
         wall_ms={**walls, "phase": (time.perf_counter() - t_phase) * 1e3},
         losses=losses, workdir_files=files, metrics_rows_train=logged,
         launches={**counts, "dp_train_by_rank": [r["train_launches"] for r in ranks]},
         step={"one_process": {k: one[k] for k in keys},
               "world": {k: step[k] for k in keys},
               "max_rel_diff": rel, "tol": tol, "tol_read_on_the_card": True,
               "state_gaps": gaps},
         graph=graphs, rank0_separation=rank0_only,
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
         "ring or tree kernels and a split batch (at world 1 NCCL completes each "
         "in-place SUM all-reduce without a kernel); so too the graphed group "
         "replays against eager group steps on the (dcn 1 x data W) and (dcn 2 x "
         "data W/2) meshes and in host-batch mode, the eval graph's captured all-reduce against the eager "
         "group eval, the NCCL kernels of a traced replay, the W >= 2 "
         "limits on the state (dp_state_gaps: Adam's moves, the moments, the "
         "buffers) and one-shot and scan `cli separate` under torchrun with "
         "rank 0 alone")
    # The state's limits are checked after the line, so that a run that
    # fails them still prints every reading.
    check(gaps is None or dp_state_ok(gaps),
          f"dp step at world {world} vs one process: state {gaps}, limits {tol}")
    return counts, by_rank


def dp_alone() -> int:
    """`python3 chip_smoke.py --dp`: the device and build lines, then the dp
    phase alone at torch.cuda.device_count() ranks on a 60 s mixture of its
    own (on a host with four cards, its W >= 2 checks), and the last
    line."""
    kind = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        write_wav(str(Path(tmp) / "stream60s.wav"), SR_STREAM,
                  mixtures(np.random.default_rng(SEED), 1, T_STREAM, SR_STREAM)[0])
        phase_dp(torch.device("cuda", 0), Path(tmp))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


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


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance of two float32 tensors in units in the last place."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def batch_args(cfg, offset=0, step=None, from_bank=True, keys=None) -> dict:
    """rng_ops.batch_*'s arguments for `cfg`'s train step: its batch, gain
    and noise, and with a step its dropout and noise keys at the config's
    d_steps where `keys` (default: where the step draws dropout or
    instance noise, `train/step.py`)."""
    if keys is None:
        keys = cfg.model.dropout > 0.0 or cfg.train.d_instance_noise > 0.0
    return {"b": cfg.train.batch_size, "gain_db": cfg.data.gain_jitter_db,
            "snr_db": noise_snr(cfg.data), "offset": offset, "step": step,
            "from_bank": from_bank,
            "d_steps": cfg.train.d_steps if step is not None and keys else 0}


def batch_check(what: str, ker, ref, noise: bool) -> dict:
    """The batch kernel's outputs against its plain version's: picks,
    shifts, gains and train keys bit-equal; scaled within 1 ulp (the
    samples off counted); the mixture within 1 ulp, or under noise within
    1e-6·max|mixture|."""
    for f in ("picks", "shifts", "gains", "train_keys"):
        a, b = getattr(ker, f), getattr(ref, f)
        check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
              f"rng batch {what}: kernel {f} != plain")
    out = {"scaled_max_ulp": ulps(ker.scaled, ref.scaled),
           "scaled_samples_off": int((ker.scaled != ref.scaled).sum()),
           "scaled_samples": ref.scaled.numel(),
           "mixture_max_abs_err": max_err(ker.mixture, ref.mixture),
           "mixture_samples_off": int((ker.mixture != ref.mixture).sum())}
    check(out["scaled_max_ulp"] <= 1, f"rng batch {what}: scaled {out}")
    if noise:
        out["mixture_tol"] = 1e-6 * float(ref.mixture.abs().max())
        check(out["mixture_max_abs_err"] <= out["mixture_tol"],
              f"rng batch {what}: mixture {out}")
    else:
        out["mixture_max_ulp"] = ulps(ker.mixture, ref.mixture)
        check(out["mixture_max_ulp"] <= 1, f"rng batch {what}: mixture {out}")
    return out


def outputs(batch) -> list:
    """A Batch's tensors, its Nones left out."""
    return [x for x in batch if x is not None]


def sampler_shapes(dev) -> dict:
    """The sampler's four kinds at each R x n of SAMPLE_SHAPES against the
    plain version, rows keyed from one seed: bits, uniforms and randints (a
    narrow and the widest int32 range) bit for bit, normals within
    NORMAL_ULP."""
    key = prng_key(SEED_RNG_SAMPLER, dev)
    draws = (("bits", 0, 1), ("uniform", -1.5, 2.5), ("randint", 0, 9),
             ("randint", -2 ** 31, 2 ** 31 - 1), ("normal", 0.0, 1.0))
    out = {}
    for r, n in SAMPLE_SHAPES:
        keys = rng_ops.example_keys_reference(key, 0, r)[0][0]
        got = {}
        for kind, lo, hi in draws:
            what = f"{kind} [{lo}, {hi})" if kind in ("uniform", "randint") else kind
            ker = rng_ops.sample_kernel(keys, n, kind, lo, hi)
            ref = rng_ops.sample_reference(keys, n, kind, lo, hi)
            check(ker.shape == ref.shape == (r, n) and ker.dtype == ref.dtype,
                  f"rng sampler {r} x {n} {what}: {ker.shape} {ker.dtype} vs "
                  f"{ref.shape} {ref.dtype}")
            if kind == "normal":
                got[what] = {"max_ulp": ulps(ker, ref), "max_abs_err": max_err(ker, ref)}
                check(got[what]["max_ulp"] <= NORMAL_ULP,
                      f"rng sampler {r} x {n} normal: {got[what]} over {NORMAL_ULP} ulp")
            else:
                got[what] = {"bit_equal": bool(torch.equal(ker, ref))}
                check(got[what]["bit_equal"], f"rng sampler {r} x {n} {what}: kernel != plain")
        out[f"{r} x {n}"] = got
    return out


def phase_rng(dev):
    """The batch kernel (ops/threefry.py `batch_kernel`) against its plain
    version at the stream_v5e8 --hard b32 step (the bank, noise, train keys
    at its d_steps) and the bench's wsj0_logmel b128 (the bank, no noise),
    each also at offset 3·b and on host-batch sources with no step, at
    three grids (the default, a block an example, 3 tiles a row): picks,
    shifts, gains and train keys bit-equal, the rest as batch_check; the
    sampler's normals under the step's noise keys within NORMAL_ULP (the
    batch's noise is the same device code); a captured graph of the step's
    batch keyed from the device step against eager calls over RNG_REPLAYS
    replays; the batch's device ms (by CUDA graph, and each kernel's by
    torch.profiler), the plain version's, the bound and a yardstick (take_rows and the mixing on the
    kernel's draws, graphed); the sampler's four kinds at SAMPLE_SHAPES and
    its times."""
    cases, timing = {}, {}
    hard = quality_protocol.protocol_config("stream_v5e8", True)
    gen = torch.Generator(device=dev).manual_seed(SEED_RNG_BATCH)
    plain_ms = lambda fn: time_fns(calls=2, plain=fn)["plain"]   # noqa: E731
    for name, cfg in (("stream_v5e8 --hard b32", hard),
                      (f"wsj0_logmel b{B_BENCH} (bench)", bench_config(B_BENCH, 1))):
        b, s, t = cfg.train.batch_size, cfg.data.num_sources, cfg.segment_samples
        noise, tiles = cfg.data.num_noise > 0, rng_ops.batch_tiles(t)
        key = prng_key(cfg.train.seed + 1, dev)
        step = torch.tensor(41, dtype=torch.int64, device=dev)
        bank = torch.randn(s, cfg.data.bank_utterances, t, device=dev, generator=gen)
        sources = torch.randn(b, s, t, device=dev, generator=gen)
        errs = {}
        for what, src, kw in (("bank", bank, batch_args(cfg, 0, step, keys=True)),
                              ("bank, offset 3b", bank,
                               batch_args(cfg, 3 * b, step, keys=True)),
                              ("sources, offset 3b, no step", sources,
                               batch_args(cfg, 3 * b, None, False))):
            ref = rng_ops.batch_reference(key, src, **kw)
            grids = {blocks: rng_ops.batch_kernel(key, src, **kw, blocks=blocks)
                     for blocks in dict.fromkeys((tiles, 1, min(3, tiles)))}
            errs[what] = batch_check(f"{name} {what}", grids[tiles], ref, noise)
            same = all(all(torch.equal(x, y) for x, y in zip(outputs(grids[tiles]),
                                                             outputs(k)))
                       for k in grids.values())
            check(same, f"rng batch {name} {what}: the grids' bits differ")
            errs[what].update(grids=sorted(grids), grids_bit_equal=same,
                              train_keys=None if ref.train_keys is None
                              else len(ref.train_keys))
        k_noise = rng_ops.example_keys_reference(key, 0, b, step)[1][1]
        if noise:
            normals = (rng_ops.sample_kernel(k_noise, t, "normal"),
                       rng_ops.sample_reference(k_noise, t, "normal"))
            errs["noise normals (the sampler)"] = {"max_ulp": ulps(*normals),
                                                   "max_abs_err": max_err(*normals)}
            check(ulps(*normals) <= NORMAL_ULP, f"rng {name} normals: "
                  f"{errs['noise normals (the sampler)']} over {NORMAL_ULP} ulp")
        # Captured: keyed from the device step, as the captured train step.
        gstep = torch.zeros((), dtype=torch.int64, device=dev)
        kw = batch_args(cfg, 0, gstep, keys=True)
        draw = lambda: outputs(rng_ops.batch_kernel(key, bank, **kw))   # noqa: E731
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            draw()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = draw()
        replays = []
        for r in range(RNG_REPLAYS):
            gstep.fill_(1000 * r + 7)
            graph.replay()
            same = all(torch.equal(a, e) for a, e in zip(static, draw()))
            check(same, f"rng {name}: replay {r} at step {1000 * r + 7} != eager batch")
            replays.append(same)
        del graph, static
        cases[name] = {"batch": b, "sources": s, "samples": t, "tiles": tiles,
                       "bank": cfg.data.bank_utterances, "noise": noise,
                       "kernel_vs_plain": errs, "replays_equal_eager": replays}

        # Times at the step's shape, from the device step.
        kw = batch_args(cfg, 0, step)
        call = lambda: rng_ops.batch_kernel(key, bank, **kw)   # noqa: E731
        ker = call()
        normals = rng_ops.sample_kernel(k_noise, t, "normal") if noise else None
        by_kernel = {("threefry_batch_noise" if "noise" in k else "threefry_batch"): ms
                     for k, (ms, _) in device_kernels(call).items()
                     if "threefry_batch" in k}
        bound = cost.batch(b, s, t, tiles, True, True, noise, kw["d_steps"])
        timing[name] = {
            "ms": graph_ms(call), "kernel_device_ms": by_kernel,
            "plain_ms": plain_ms(lambda: rng_ops.batch_reference(key, bank, **kw)),
            "bound_ms": bound.bound(), "bytes": bound.bytes,
            "yardstick_ms": graph_ms(lambda: mix(take_rows(bank, ker.picks, ker.shifts),
                                                 ker.gains, normals, kw["snr_db"])),
            "yardstick": "take_rows + data.mixer.mix on the kernel's draws (and the "
                         "sampler's normals), graphed: the plain ops of the batch "
                         "after its draws",
            "launches_a_call": 1 + int(noise)}
        if noise:
            nb_ = cost.batch_noise(b, t, tiles)
            ref_mix = ker.mixture.clone()
            timing[name].update(
                noise_bound_ms=nb_.bound(),
                noise_plain_ms=plain_ms(lambda: ref_mix + rng_ops.sample_reference(
                    k_noise, t, "normal") * torch.sqrt(
                        (ref_mix ** 2).mean(-1, keepdim=True) / 10.0 ** (kw["snr_db"] / 10))))

    bench_name = f"wsj0_logmel b{B_BENCH} (bench)"
    hard_name = "stream_v5e8 --hard b32"
    bt, ht = timing[bench_name], timing[hard_name]
    rows = {
        "threefry_batch": {
            "ms": bt["ms"], "plain_ms": bt["plain_ms"], "bound_ms": bt["bound_ms"][0],
            "bound_by": bt["bound_ms"][1], "library_ms": None,
            "library": "no single PyTorch call computes the batch; yardstick_ms is "
                       "take_rows + the mixing on its draws",
            "yardstick_ms": bt["yardstick_ms"],
            "max_abs_err": max(e["mixture_max_abs_err"] for c in cases.values()
                               for w, e in c["kernel_vs_plain"].items()
                               if "mixture_max_abs_err" in e),
            "shape": f"{bench_name}: the bank's 128 x 2 rows of 23 936, one launch",
            "stream_v5e8_hard": {k: ht[k] for k in ("ms", "kernel_device_ms", "plain_ms",
                                                    "bound_ms", "yardstick_ms")}},
        "threefry_batch_noise": {
            "ms": ht["kernel_device_ms"].get("threefry_batch_noise"),
            "ms_by": "torch.profiler, the launch in an eager call",
            "plain_ms": ht["noise_plain_ms"], "bound_ms": ht["noise_bound_ms"][0],
            "bound_by": ht["noise_bound_ms"][1], "library_ms": None,
            "max_abs_err": max(e["mixture_max_abs_err"]
                               for e in cases[hard_name]["kernel_vs_plain"].values()
                               if "mixture_max_abs_err" in e),
            "shape": f"{hard_name}: 32 x 32 000 mixture samples, normals added"}}

    # The sampler (no path draws through it since the batch kernel; a
    # key a row): the normals at the --hard step's noise shape, and the
    # bench step's 128 x 2 draws beside PyTorch's Philox draws
    # (yardsticks, used nowhere in the port).
    b, t = hard.train.batch_size, hard.segment_samples
    key = prng_key(hard.train.seed + 1, dev)
    k_noise = rng_ops.example_keys_reference(
        key, 0, b, torch.tensor(41, dtype=torch.int64, device=dev))[1][1]
    noise_args = (k_noise, t, "normal")
    sample_bound = cost.sample(b, t, "normal").bound()
    kb = rng_ops.example_keys_reference(key, 0, 128)[0][0]
    rows["threefry_sample"] = {
        "ms": graph_ms(lambda: rng_ops.sample_kernel(*noise_args)),
        "plain_ms": plain_ms(lambda: rng_ops.sample_reference(*noise_args)),
        "bound_ms": sample_bound[0], "bound_by": sample_bound[1],
        "max_abs_err": max_err(rng_ops.sample_kernel(*noise_args),
                               rng_ops.sample_reference(*noise_args)),
        "shape": f"{b} x {t} normals (the --hard step's noise shape)",
        "library_ms": graph_ms(lambda: torch.randn(b, t, device=dev)),
        "library": f"torch.randn({b}, {t}): as many normals with Philox bits",
        "bench_draws_ms": {
            "randint 128 x 2": graph_ms(lambda: rng_ops.sample_kernel(kb, 2, "randint", 0, 9)),
            "uniform 128 x 2": graph_ms(lambda: rng_ops.sample_kernel(kb, 2, "uniform", -1, 1)),
            "torch.randint(0, 9, (128, 2))": graph_ms(
                lambda: torch.randint(0, 9, (128, 2), device=dev)),
            "torch.rand(128, 2)": graph_ms(lambda: torch.rand(128, 2, device=dev))}}
    shapes = sampler_shapes(dev)
    emit("rng", cases=cases, timing=timing, sampler_shapes=shapes, rows=rows,
         launches_a_step={"bank, no noise": {"threefry_batch": 1},
                          "bank, noise": {"threefry_batch": 1, "threefry_batch_noise": 1}},
         tol="picks, shifts, gains, train keys bit-equal; scaled within 1 ulp; the "
             "mixture within 1 ulp, under noise within 1e-6·max|mixture|; normals within "
             f"{NORMAL_ULP} ulp; every grid and replay bit-equal",
         int32_ops_per_s=cost.INT32_OPS_PER_S, cipher_int_ops=cost.CIPHER_INT_OPS,
         library="PyTorch has no threefry sampler: torch.randn, torch.randint and "
                 "torch.rand (Philox) are yardsticks")
    rows.update(phase_rng_dropout(dev))
    return rows


def every_option_config():
    """stream_v5e8 with STREAM_OPTIONS (the options phase's step)."""
    return cli._apply_overrides(config.get_config("stream_v5e8"), list(STREAM_OPTIONS))


def step_sites(cfg, dev) -> tuple:
    """The dropout sites and noise inputs of one eager train step of `cfg`:
    each dispatch call's (shape, dtype, dims, p) and (shape, dtype, std),
    in order, each once; and the step's dropout launches, the forward's a
    Counter of sites (g_remat's recomputed forward included) and the
    backward's (the mask kernel) a Counter of (shape, dtype)."""
    sites, noises, backward = [], [], []
    inner_drop, inner_noise = dispatch.dropout, dispatch.instance_noise
    inner_mask = rng_ops.dropout_mask_kernel

    def drop(x, key, fold, p, dims):
        sites.append((tuple(x.shape), x.dtype, tuple(dims), p))
        return inner_drop(x, key, fold, p, dims)

    def noise(x, key, std):
        noises.append((tuple(x.shape), x.dtype, std))
        return inner_noise(x, key, std)

    def mask(dy, words, scale, blocks=None):
        backward.append((tuple(dy.shape), dy.dtype))
        return inner_mask(dy, words, scale, blocks)

    dispatch.dropout, dispatch.instance_noise = drop, noise
    rng_ops.dropout_mask_kernel = mask
    try:
        exp = Experiment(cfg, device=dev)
        exp._train_step(exp.state, exp._bank, exp._train_key)
        torch.cuda.synchronize()
    finally:
        dispatch.dropout, dispatch.instance_noise = inner_drop, inner_noise
        rng_ops.dropout_mask_kernel = inner_mask
    del exp
    return (list(dict.fromkeys(sites)), list(dict.fromkeys(noises)),
            collections.Counter(sites), collections.Counter(backward))


def noise_tol(ref: torch.Tensor, std: float) -> float:
    """f32 noise, kernel vs plain: NORMAL_ULP ulps of erf⁻¹ (below 4 in
    magnitude, so an ulp of at most 2^-22) times std·√2, and one rounding
    of the sum."""
    return std * math.sqrt(2.0) * NORMAL_ULP * 2.0 ** -22 \
        + float(torch.finfo(torch.float32).eps) * float(ref.abs().max())


def dropout_paths(x, key, fold, p, dims, dy, w):
    """Dropout through the kernels and through the plain versions:
    [(y, words, dx, ddy) kernel, the same plain]; dx the backward on dy,
    ddy the double backward's on w (R1's)."""
    out = []
    for kernel in (True, False):
        xg = x.detach().clone().requires_grad_()
        dyg = dy.detach().clone().requires_grad_()
        y, words = rng_ops.Dropout.apply(xg, key, fold, p, dims, kernel)
        (dx,) = torch.autograd.grad(y, xg, dyg, create_graph=True)
        (ddy,) = torch.autograd.grad(dx, dyg, w)
        out.append((y.detach(), words, dx.detach(), ddy))
    return out


def library_dropout_bwd(dy, words, scale):
    """torch's dropout backward from a saved mask (aten's
    native_dropout_backward on the mask unpacked to bool, a byte an
    element): the PyTorch call beside the mask kernel, used nowhere in the
    port."""
    kept = rng_ops.unpack_mask(words, dy.shape)
    return lambda: torch.ops.aten.native_dropout_backward(dy, kept, scale)


def phase_rng_dropout(dev) -> dict:
    """The step's dropout and noise keys, flax's dropout and the instance
    noise (`ops/threefry.py`) at the every-option stream_v5e8 step's sites,
    in the step's dtype and in f32, against their plain versions: the
    dropout's output, packed mask, backward and double backward bit for
    bit, at the largest site also at other block counts; a captured graph
    of them keyed from the device step against eager launches; their
    device ms, and the step's dropout launches' summed."""
    gen = torch.Generator(device=dev).manual_seed(SEED_RNG_DROPOUT)
    cfg = every_option_config()
    d_steps = cfg.train.d_steps
    sites, noises, fwd_launches, bwd_launches = step_sites(cfg, dev)
    check(sites and noises, f"every-option step: dropout sites {sites}, noise {noises}")
    key = prng_key(cfg.train.seed + 1, dev)
    step = torch.tensor(41, dtype=torch.int64, device=dev)
    bank = torch.randn(cfg.data.num_sources, cfg.data.bank_utterances,
                       cfg.segment_samples, device=dev, generator=gen)
    ker_keys = rng_ops.batch_kernel(key, bank, **batch_args(cfg, 0, step)).train_keys
    ref_keys = rng_ops.train_keys_reference(key, step, 0, d_steps)
    check(torch.equal(ker_keys, ref_keys), "rng step keys: the batch kernel's != plain")
    g_row, d_rows, adv_rows = rng_ops.train_key_rows(d_steps)
    fold = DropoutKey(key).fold(1)
    k_g = ker_keys[g_row]
    cases = []
    for shape, dtype, dims, p in sites:
        for dt in dict.fromkeys((dtype, torch.float32)):
            x, dy, w = (torch.randn(shape, device=dev, generator=gen).to(dt)
                        for _ in range(3))
            ker, ref = dropout_paths(x, k_g, fold, p, dims, dy, w)
            same = [torch.equal(a, b) for a, b in zip(ker, ref)]
            check(all(same), f"rng dropout {shape} {dt}: kernel != plain "
                             f"(y, words, dx, ddy bit-equal: {same})")
            cases.append({"shape": list(shape), "dtype": str(dt), "dims": list(dims),
                          "p": p, "kept": float(rng_ops.unpack_mask(
                              ker[1], shape).float().mean()),
                          "forward_max_abs_err": max_err(ker[0], ref[0]),
                          "backward_max_abs_err": max_err(ker[2], ref[2]),
                          "double_backward_max_abs_err": max_err(ker[3], ref[3]),
                          "y_words_dx_ddy_bit_equal": same})
    noise_cases = []
    for shape, dtype, std in noises:
        for dt in dict.fromkeys((dtype, torch.float32)):
            x = torch.randn(shape, device=dev, generator=gen).to(dt)
            k = ker_keys[d_rows[0][1]]
            ker, ref = rng_ops.noise_kernel(x, k, std), rng_ops.noise_reference(x, k, std)
            err = max_err(ker, ref)
            if dt == torch.bfloat16:
                check(torch.equal(ker, ref), f"rng noise {shape} bf16: kernel != plain")
            else:
                check(err <= noise_tol(ref, std), f"rng noise {shape} f32: {err}")
            noise_cases.append({"shape": list(shape), "dtype": str(dt), "std": std,
                                "max_abs_err": err,
                                "bit_equal": bool(torch.equal(ker, ref))})

    # The largest site at other grids: the same y, words and dx.
    shape, dtype, dims, p = max(sites, key=lambda c: math.prod(c[0]))
    scale = rng_ops.dropout_constants(dtype, p)[1]
    xd = torch.randn(shape, device=dev, generator=gen).to(dtype)
    dyd = torch.randn(shape, device=dev, generator=gen).to(dtype)
    n_words = rng_ops.mask_words(xd.numel())
    grids = {"default": None, "seven": 7,
             "a_word_a_thread": -(-n_words // rng_ops.THREADS)}
    by_grid = {}
    for name, blocks in grids.items():
        y, words = rng_ops.dropout_kernel(xd, k_g, fold, p, dims, blocks)
        by_grid[name] = (y, words, rng_ops.dropout_mask_kernel(dyd, words, scale, blocks))
    grids_equal = {name: [torch.equal(a, b) for a, b in zip(got, by_grid["default"])]
                   for name, got in by_grid.items()}
    check(all(all(v) for v in grids_equal.values()),
          f"rng dropout {shape}: y, words, dx differ by grid: {grids_equal}")
    default_blocks = rng_ops.dropout_blocks(n_words, xd.device)

    # The largest D input's noise at other grids: the same bits.
    n_shape, n_dtype, std = max(noises, key=lambda c: math.prod(c[0]))
    noise_grids = {}
    for dt in dict.fromkeys((n_dtype, torch.float32)):
        xg = torch.randn(n_shape, device=dev, generator=gen).to(dt)
        kg = ker_keys[d_rows[0][1]]
        vecs = -(-xg.numel() * xg.element_size() // 16)
        blocks = {"default": None, "seven": 7,
                  "two_vectors_a_thread": -(-vecs // (2 * rng_ops.THREADS))}
        got = {name: rng_ops.noise_kernel(xg, kg, std, b) for name, b in blocks.items()}
        ref = rng_ops.noise_reference(xg, kg, std)
        same = {name: bool(torch.equal(y, got["default"])) for name, y in got.items()}
        check(all(same.values()), f"rng noise {n_shape} {dt}: differs by grid: {same}")
        err = max_err(got["default"], ref)
        if dt == torch.bfloat16:
            check(torch.equal(got["default"], ref), f"rng noise {n_shape} bf16: kernel != plain")
        else:
            check(err <= noise_tol(ref, std), f"rng noise {n_shape} f32: {err}")
        noise_grids[str(dt)] = {
            "blocks": {k: v or rng_ops.dropout_blocks(vecs, dev) for k, v in blocks.items()},
            "equal_default": same, "max_abs_err": err,
            "bit_equal": bool(torch.equal(got["default"], ref))}
        del xg, got, ref

    # Captured: keys from the device step, dropout forward and backward at
    # the largest site, the noise at the largest D input.
    x = xd.clone().requires_grad_()
    dy = dyd
    xn = torch.randn(n_shape, device=dev, generator=gen).to(n_dtype)
    gstep = torch.zeros((), dtype=torch.int64, device=dev)

    def draw():
        keys = rng_ops.batch_kernel(key, bank, **batch_args(cfg, 0, gstep)).train_keys
        y, words = rng_ops.Dropout.apply(x, keys[g_row], fold, p, dims, True)
        (dx,) = torch.autograd.grad(y, x, dy)
        return [keys, y.detach(), words, dx, rng_ops.noise_kernel(xn, keys[adv_rows[1]],
                                                                   std)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        draw()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = draw()
    replays = []
    for r in range(RNG_REPLAYS):
        gstep.fill_(1000 * r + 7)
        graph.replay()
        eager = draw()
        same = all(torch.equal(a, e) for a, e in zip(static, eager))
        plain = dropout_paths(x, eager[0][g_row], fold, p, dims, dy, dy)[1]
        same = same and all(torch.equal(a, b) for a, b in zip(eager[1:4], plain[:3]))
        check(same, f"rng dropout/noise: replay {r} at step {1000 * r + 7} != eager")
        replays.append(same)

    # Times: the largest site and D input, as the step has them; every
    # dropout launch of the step, each site timed alone, summed.
    words = by_grid["default"][1]
    n, item = xd.numel(), xd.element_size()
    drop_bound = cost.dropout(n, item).bound()
    mask_bound = cost.dropout_mask(n, item).bound()
    nn_, n_item = xn.numel(), xn.element_size()
    noise_bound = cost.noise(nn_, n_item).bound()
    noise_f32_bound = cost.noise(nn_, 4).bound()
    xn32 = xn.float()
    k_n = ker_keys[adv_rows[1]]
    plain_ms = lambda fn: time_fns(calls=2, plain=fn)["plain"]   # noqa: E731
    step_ms, by_site = step_dropout_ms(sites, fwd_launches, bwd_launches, k_g, fold, gen,
                                       dev)
    rows = {
        "threefry_dropout": {
            "ms": graph_ms(lambda: rng_ops.dropout_kernel(xd, k_g, fold, p, dims)),
            "plain_ms": plain_ms(lambda: rng_ops.dropout_reference(xd, k_g, fold, p, dims)),
            "bound_ms": drop_bound[0], "bound_by": drop_bound[1],
            "library_ms": graph_ms(lambda: torch.nn.functional.dropout(xd, p, True)),
            "library": "torch.nn.functional.dropout: the same work with Philox bits",
            "max_abs_err": max(c["forward_max_abs_err"] for c in cases),
            "blocks": default_blocks,
            "shape": f"{list(shape)} {dtype} (the largest site): y and its packed mask"},
        "threefry_dropout_bwd": {
            "ms": graph_ms(lambda: rng_ops.dropout_mask_kernel(dyd, words, scale)),
            "plain_ms": plain_ms(lambda: rng_ops.dropout_mask_reference(dyd, words, scale)),
            "bound_ms": mask_bound[0], "bound_by": mask_bound[1],
            "library_ms": graph_ms(library_dropout_bwd(dyd, words, scale)),
            "library": "aten native_dropout_backward(dy, bool mask, scale): the same "
                       "function from a byte-a-element mask",
            "f_dropout_on_dy_ms": graph_ms(lambda: torch.nn.functional.dropout(dyd, p, True)),
            "max_abs_err": max(c["backward_max_abs_err"] for c in cases),
            "shape": f"{list(shape)} {dtype}: the gradient from the forward's packed "
                     f"mask (dropout_mask_kernel, no draw)"},
        "threefry_noise": {
            "ms": graph_ms(lambda: rng_ops.noise_kernel(xn, k_n, std)),
            "plain_ms": plain_ms(lambda: rng_ops.noise_reference(xn, k_n, std)),
            "bound_ms": noise_bound[0], "bound_by": noise_bound[1],
            "library_ms": graph_ms(lambda: torch.normal(xn, std)),
            "library": "torch.normal(x, std): x + std·N(0, 1) with Philox bits",
            "max_abs_err": max(c["max_abs_err"] for c in noise_cases),
            "blocks": noise_grids[str(n_dtype)]["blocks"]["default"],
            "float32": {"ms": graph_ms(lambda: rng_ops.noise_kernel(xn32, k_n, std)),
                        "bound_ms": noise_f32_bound[0], "bound_by": noise_f32_bound[1],
                        "library_ms": graph_ms(lambda: torch.normal(xn32, std))},
            "shape": f"{list(n_shape)} {n_dtype} (the largest D input)"},
    }
    emit("rng", case="dropout and noise at the every-option stream_v5e8 step",
         sets=list(STREAM_OPTIONS), dropout_sites=cases, noise_inputs=noise_cases,
         train_keys_bit_equal=True, replays_equal_eager=replays,
         largest_site_grids={"blocks": {k: v or default_blocks for k, v in grids.items()},
                             "y_words_dx_equal_default": grids_equal},
         largest_noise_grids=noise_grids,
         step_dropout_ms=step_ms, step_dropout_by_site=by_site,
         pr16_largest_site_ms={"forward": 0.184, "backward": 0.185,
                               "source": "PERF.md §6: PR 16's kernel, its chip run 6"},
         rows=rows,
         tol=f"keys, dropout outputs, masks, gradients, double backward, bf16 noise "
             f"bit-equal; f32 noise within NORMAL_ULP ({NORMAL_ULP}) ulp of erf⁻¹ "
             f"times std·√2 plus one rounding")
    return rows


def step_dropout_ms(sites, fwd_launches, bwd_launches, key, fold, gen, dev) -> tuple:
    """The device ms of one step's dropout launches: each site's forward
    and each backward shape's mask kernel timed alone (graph_ms) on seeded
    inputs, times its launches a step, summed; and the rows."""
    rows = []
    for shape, dtype, dims, p in sites:
        x = torch.randn(shape, device=dev, generator=gen).to(dtype)
        rows.append({"kernel": "threefry_dropout", "shape": list(shape), "dtype": str(dtype),
                     "p": p, "launches": fwd_launches[(shape, dtype, dims, p)],
                     "ms": graph_ms(lambda: rng_ops.dropout_kernel(x, key, fold, p, dims))})
    for (shape, dtype), launches in bwd_launches.items():
        _, _, dims, p = next(s for s in sites if s[:2] == (shape, dtype))
        dy = torch.randn(shape, device=dev, generator=gen).to(dtype)
        _, words = rng_ops.dropout_kernel(dy, key, fold, p, dims)
        scale = rng_ops.dropout_constants(dtype, p)[1]
        rows.append({"kernel": "dropout_mask", "shape": list(shape), "dtype": str(dtype),
                     "launches": launches,
                     "ms": graph_ms(lambda: rng_ops.dropout_mask_kernel(dy, words, scale))})
    total = {k: sum(r["ms"] * r["launches"] for r in rows if r["kernel"] == name)
             for k, name in (("forward", "threefry_dropout"), ("backward", "dropout_mask"))}
    return {**total, "sum": total["forward"] + total["backward"],
            "launches": {"forward": sum(fwd_launches.values()),
                         "backward": sum(bwd_launches.values())}}, rows


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
STREAM_OPTIONS = time_dropout.EVERY_OPTION
OPTIONS_STEPS, OPTIONS_STEP_SAMPLES = 4, 8
SEED_OPTIONS = 9                     # the options phase's own generator
SR_MUSIC, T_MUSIC_SEP = 44100, 30 * 44100      # the separated music wav: 30 s


def set_args(overrides) -> list:
    return [a for o in overrides for a in ("--set", o)]


def counted(fn):
    """(fn(), the launches of every kernel it made), each count set to 0
    just before and read just after (the device synchronized)."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def both_paths(exp, keys=("g_loss", "g_recon", "d_loss")):
    """One step from one state on the kernel and on the plain DSP path: the
    metrics, the states after, and the relative gaps, checked."""
    out, states = {}, {}
    for path in (None, "reference"):
        states[path or "kernel"] = state = copy.deepcopy(exp.state)
        with dispatch.force_backend(path):
            _, m = exp._train_step(state, exp._bank, exp._train_key)
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
    step(state, exp._bank, exp._train_key)
    return got[0]


def paired_walls(exps: dict) -> dict:
    """Median wall ms (synchronized) of one train step of each Experiment,
    OPTIONS_STEP_SAMPLES each, in turns (a, b, b, a, ...)."""
    names = list(exps)
    walls = {n: [] for n in names}
    for n in names:
        exps[n]._train_step(exps[n].state, exps[n]._bank, exps[n]._train_key)
    for i in range(2 * OPTIONS_STEP_SAMPLES):
        n = (names + names[::-1])[i % (2 * len(names))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exps[n]._train_step(exps[n].state, exps[n]._bank, exps[n]._train_key)
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
        e._train_step(e.state, e._bank, e._train_key)
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
    cap = graphed.captures()
    ev, counts["options_music_eval"] = counted(lambda: captured(
        cli.main, ["eval", *common, "--batches", "1"]))
    check("si_sdr_improvement" in ev
          and k12(counts["options_music_eval"]) == served(1),
          f"music options eval: {ev} {counts['options_music_eval']}, captures "
          f"{graphed.captures() - cap}")
    wav = tmp / "music30s.wav"
    write_wav(str(wav), SR_MUSIC, mixtures(rng, 1, T_MUSIC_SEP, SR_MUSIC)[0])
    cap = graphed.captures()
    _, counts["options_music_separation"] = counted(lambda: captured(cli.main, [
        "separate", *common, "--input", str(wav), "--output-dir", str(tmp / "music_out")]))
    check(k12(counts["options_music_separation"]) == served(1),
          f"music options separation launches {counts['options_music_separation']}, "
          f"captures {graphed.captures() - cap}")
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
    cfg = every_option_config()
    exp = Experiment(cfg, device=dev)
    d, g = exp.state.d, exp.state.g
    check(d.patch and d.norm == "batch" and g.phase_ct and g.dec_l0 == "subpixel"
          and g.head.mode == "pack", "stream options: the modules lack an option")
    bn0 = [t.detach().clone() for n in d.norms for t in (n.mean, n.var)]
    last, counts["options_stream_train"] = counted(lambda: exp.train(num_steps=2))
    c = counts["options_stream_train"]
    check(c["istft"] == 2 and c["istft_bwd"] == 2 and c["stft_features"] == 4
          and c["threefry_batch"] == 2 and c["threefry_sample"] == 0
          and c["threefry_dropout"] > 0
          and c["threefry_dropout_bwd"] > 0 and c["threefry_noise"] > 0,
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
    """The quality protocol through its main() at full width (the main
    path's preset first), then the music train step's wall time on both DSP
    paths and its peak memory."""
    reset, counts = reset_launch_counts, launch_counts

    runs = {}
    for name, argv, need in (
        ("wsj0_logmel --hard", ["wsj0_logmel", str(QUALITY_WSJ0_STEPS),
                                "--hard", "--seeds", "0,7", "--device", str(dev)],
         ("stft_features", "masked_istft", "stft", "threefry_batch",
          "threefry_batch_noise")),
        ("stream_v5e8 --hard", ["stream_v5e8", str(QUALITY_STREAM_STEPS),
                                "--hard", "--seeds", "0,7", "--device", str(dev)],
         ("stft_features", "masked_istft", "istft", "istft_bwd", "stft",
          "threefry_batch", "threefry_batch_noise")),
        ("music_complex_44k", ["music_complex_44k", str(QUALITY_MUSIC_STEPS),
                               "--device", str(dev)],
         ("stft_features", "masked_istft", "stft", "threefry_batch")),
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
    exp._train_step(exp.state, exp._bank, exp._train_key)
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
    """A tools-phase or install-phase process: `module.main(argv)`, what
    `python -m module argv...` runs, or, where `module` is a file (a
    console script), that file run as `python FILE argv...` runs it; then
    the kernels it launched, its exit code, and where the port and its
    library came from, written to `out` as JSON."""
    import gan_sass_tf_tpu_torch

    reset_launch_counts()
    if os.path.isfile(module):
        sys.argv = [module, *argv]
        try:
            runpy.run_path(module, run_name="__main__")
            rc = 0
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else int(e.code is not None)
    else:
        rc = importlib.import_module(module).main(list(argv))
    Path(out).write_text(json.dumps({"rc": rc, "launches": launch_counts(),
        "captures": graphed.captures(),
        "package": gan_sass_tf_tpu_torch.__file__,
        "library": str(build.library_path()) if build._lib else None}))
    return rc


def installed_env(tmp: Path) -> dict:
    """The environment of a process that runs the port installed under
    tmp/site (install_port), its kernels built under tmp/cache."""
    return {**os.environ, "PYTHONPATH": str(tmp / "site"),
            "XDG_CACHE_HOME": str(tmp / "cache")}


def worker_process(cmd: list, what: str, installed: Path = None) -> tuple:
    """(wall s, stdout) of this script run as `cmd` (its arguments) in a
    process of its own; a non-zero exit fails the run.  With `installed`
    (install_port's directory) it runs from there with `python -P` and
    installed_env, so that nothing of the checkout is on its path."""
    flags, cwd, env = (), ROOT, {**os.environ, "PYTHONPATH": str(ROOT)}
    if installed is not None:
        flags, cwd, env = ("-P",), installed, installed_env(installed)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *flags, str(SCRIPT), *cmd], cwd=cwd,
                         capture_output=True, text=True, timeout=TOOLS_TIMEOUT_S,
                         env=env)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-3000:], res.stderr[-6000:], sep="\n", file=sys.stderr)
    check(res.returncode == 0, f"{what} exited {res.returncode}")
    return wall, res.stdout


def tool_process(tmp: Path, name: str, module: str, *argv, installed: Path = None
                 ) -> tuple:
    """(wall s, stdout, tool_worker's report) of `module.main(argv)` (or the
    file `module`) in a process of its own, counted by tool_worker; a
    non-zero exit fails the run.  `installed`: as worker_process."""
    out = tmp / f"{name}.json"
    wall, stdout = worker_process(["--tool-worker", str(out), module, *argv],
                                  f"tools: {module} {' '.join(argv[:4])}", installed)
    return wall, stdout, json.loads(out.read_text())


def pip(*argv) -> None:
    """`python -m pip ARGV` with no package index; a non-zero exit fails
    the run."""
    res = subprocess.run([sys.executable, "-m", "pip", *argv, "--no-index", "-q"],
                         capture_output=True, text=True, timeout=INSTALL_TIMEOUT_S)
    if res.returncode != 0:
        print(res.stdout[-3000:], res.stderr[-6000:], sep="\n", file=sys.stderr)
    check(res.returncode == 0, f"install: pip {argv[0]} exited {res.returncode}")


def requires_jax(metadata: str, extra=None) -> list:
    """The Requires-Dist lines of a wheel's METADATA that name the JAX
    package's frameworks: the base list's (extra None) or one extra's."""
    reqs = re.findall(r"^Requires-Dist: (.*)$", metadata, re.M)
    return [r for r in reqs
            if re.match(r"(jax|flax|optax|orbax)\b", r.strip(), re.I)
            and (re.search(f"extra == .{extra}.", r) if extra
                 else "extra ==" not in r)]


def install_port(tmp: Path) -> dict:
    """Build a wheel of this checkout and install it under tmp/site, the
    port's package made read-only.  The wheel is built from a copy of the
    checkout (setuptools writes build/ and *.egg-info/ beside the sources),
    ops/_build/ and any library in it included: the wheel must hold every
    CUDA source and header, no library, and the `gan-sass-torch` console
    script."""
    src, dist, site = tmp / "src", tmp / "dist", tmp / "site"
    shutil.copytree(ROOT, src, ignore=shutil.ignore_patterns(
        ".git", "build", "*.egg-info"))
    t0 = time.perf_counter()
    pip("wheel", "--no-deps", "--no-build-isolation", "-w", str(dist), str(src))
    wheel, = dist.glob("*.whl")
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
        scripts = z.read(next(n for n in names if n.endswith(
            ".dist-info/entry_points.txt"))).decode()
        metadata = z.read(next(n for n in names if n.endswith(
            ".dist-info/METADATA"))).decode()
    csrc = sorted(n.rsplit("/", 1)[1] for n in names
                  if n.startswith("gan_sass_tf_tpu_torch/ops/csrc/"))
    want = sorted(p.name for p in build._sources() + build._headers())
    check(csrc == want, f"install: the wheel's ops/csrc holds {csrc}, not {want}")
    libs = [n for n in names if n.endswith(".so") or "/_build/" in n]
    check(not libs, f"install: the wheel ships built files {libs}")
    check(re.search(r"^gan-sass-torch = gan_sass_tf_tpu_torch\.cli:main$", scripts,
                    re.M) is not None, f"install: console scripts {scripts!r}")
    check(not requires_jax(metadata, "torch"), f"install: the torch extra "
          f"names the JAX stack: {requires_jax(metadata, 'torch')}")
    pip("install", "--no-deps", "--target", str(site), str(wheel))
    subprocess.run(["chmod", "-R", "a-w", str(site / "gan_sass_tf_tpu_torch")],
                   check=True)
    return {"wheel": wheel.name, "files": len(names), "csrc": csrc,
            "requires": re.findall(r"^Requires-Dist: (.*)$", metadata, re.M),
            "base_requires_jax": requires_jax(metadata),
            "source_held_library": any((src / "gan_sass_tf_tpu_torch" / "ops" / "_build")
                                       .glob("*.so")),
            "seconds": time.perf_counter() - t0}


def install_worker(out: str, site: str, cache: str) -> int:
    """The install phase's checks, in a process that runs the installed
    port (worker_process with `installed`): the package imported from
    `site`, its library built by nvcc under `cache`, no module of JAX or
    of the JAX package loaded; then K1, K2, K3 with its backward and K4
    through ops.dispatch at one small shape each against their plain
    versions, at the tolerances of the k1-k4 phases.  Its launches are
    comparisons and count on no path."""
    import gan_sass_tf_tpu_torch

    pkg = Path(gan_sass_tf_tpu_torch.__file__).resolve()
    check(Path(site).resolve() in pkg.parents, f"install: the port came from {pkg}")
    check(Path(cache).resolve() in build.build_dir().resolve().parents,
          f"install: the build directory is {build.build_dir()}")
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & {"jax", "jaxlib", "flax", "optax", "gan_sass_tf_tpu"})
    check(not loaded, f"install: the worker loaded {loaded}")
    t0 = time.perf_counter()
    build.load_library()
    report = {"package": str(pkg), "library": str(build.library_path()),
              "build_s": time.perf_counter() - t0, "nvcc_s": build.build_seconds}
    reset_launch_counts()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED_INSTALL)
    dsp = config.get_config("wsj0_logmel").dsp
    n_fft, hop = dsp.n_fft, dsp.hop_length
    x = torch.from_numpy(mixtures(rng, 2, SR)).to(dev)

    def both(fn):
        ker = fn()
        with dispatch.force_backend("reference"):
            ref = fn()
        torch.cuda.synchronize()
        return ker, ref

    errs = {}
    feats, ref = both(lambda: dispatch.stft_features(x, dsp, emit=("spec", "logmel")))
    scale = float(ref["spec"].abs().max())
    for key, tol in (("spec", 3e-4 * scale), ("logmel", 1e-3)):
        errs[f"k1_{key}"] = max_err(feats[key], ref[key])
        check(errs[f"k1_{key}"] <= tol, f"install: k1 {key} {errs[f'k1_{key}']} > {tol}")
    spec = ref["spec"]
    masks = torch.from_numpy(rng.uniform(0, 1, (2, 2) + tuple(spec.shape[-2:]))
                             .astype(np.float32)).to(dev)
    errs["k2_interior"], errs["k2_full"] = k2_check(
        *both(lambda: dispatch.masked_istft(spec, masks, n_fft, hop)), hop, "install")
    re_, im_ = (spec.real.contiguous().requires_grad_(),
                spec.imag.contiguous().requires_grad_())
    y, ref = both(lambda: dispatch.istft(torch.complex(re_, im_), n_fft, hop))
    errs["k3"] = k3_check(y, ref, (re_, im_), torch.randn_like(ref), hop, "install")
    errs["k4"] = k4_check(*both(lambda: dispatch.stft(x, n_fft, hop)), "install")
    report.update(max_abs_err=errs, compare_launches={
        **launch_counts()},
        tol="k1 spec 3e-4*max|X|, logmel 1e-3; k2, k3, k4 as their phases")
    print(json.dumps(report), flush=True)
    Path(out).write_text(json.dumps(report))
    return 0


def phase_install(tmp: Path) -> dict:
    """The port as a user installs it: a wheel of the checkout installed
    under tmp/site, read-only, every process below run from tmp with
    nothing of the checkout on its path and XDG_CACHE_HOME=tmp/cache.
    install_worker builds and checks the kernels there; then the wheel's
    console script trains stream_v5e8 for INSTALL_STEPS steps into a
    workdir and separates a 3 s wav with it (its wavs: one a source, 3 s,
    finite), and the installed recompute_bounds runs stream_v5e8's bound.
    Returns the launches of those three runs, the install path's."""
    wheel = install_port(tmp)
    site, rng = tmp / "site", np.random.default_rng(SEED_INSTALL)
    try:
        out = tmp / "install_worker.json"
        wall, _ = worker_process(["--install-worker", str(out), str(site),
                                  str(tmp / "cache")], "install: the worker", tmp)
        worker = json.loads(out.read_text())
        script = site / "bin" / "gan-sass-torch"
        res = subprocess.run([str(script), "configs"], cwd=tmp, env=installed_env(tmp),
                             capture_output=True, text=True, timeout=INSTALL_TIMEOUT_S)
        check(res.returncode == 0 and "stream_v5e8" in res.stdout.split(),
              f"install: {script} configs exited {res.returncode}: {res.stderr[-2000:]}")
        wd, outdir, wav = tmp / "wd", tmp / "out", tmp / "mix.wav"
        write_wav(str(wav), SR_STREAM, mixtures(rng, 1, 3 * SR_STREAM, SR_STREAM)[0])
        runs = {}
        for name, target, argv in (
                ("train", str(script), ("train", "--config", "stream_v5e8", "--workdir",
                                        str(wd), "--steps", str(INSTALL_STEPS))),
                ("separate", str(script), ("separate", "--config", "stream_v5e8",
                                           "--workdir", str(wd), "--input", str(wav),
                                           "--output-dir", str(outdir))),
                ("bounds", "gan_sass_tf_tpu_torch.scripts.recompute_bounds",
                 ("stream_v5e8",))):
            w, stdout, rep = tool_process(tmp, f"install_{name}", target, *argv,
                                          installed=tmp)
            check(Path(rep["package"]).resolve().is_relative_to(site.resolve())
                  and Path(rep["library"] or "/").resolve().is_relative_to(
                      (tmp / "cache").resolve()),
                  f"install {name}: the port came from {rep['package']}, its "
                  f"library from {rep['library']}")
            runs[name] = {"wall_s": w, "launches": rep["launches"],
                          "captures": rep["captures"],
                          "tail": stdout.strip().splitlines()[-1:]}
        got = runs["train"]["launches"]
        check((got["stft_features"], got["istft"], got["istft_bwd"])
              == (2 * INSTALL_STEPS, INSTALL_STEPS, INSTALL_STEPS),
              f"install train launches {got}")
        got, made = runs["separate"]["launches"], runs["separate"]["captures"]
        check(k12(got) == served(1),
              f"install separate launches {got}, captures {made}")
        check(runs["bounds"]["launches"]["stft"] > 0,
              f"install bounds launches {runs['bounds']['launches']}")
        wavs = sorted(outdir.glob("*.wav"))
        lengths = [read_wav(str(w))[1].shape for w in wavs]
        sources = config.get_config("stream_v5e8").data.num_sources
        check(len(wavs) == sources and all(n == (3 * SR_STREAM,) for n in lengths)
              and all(np.isfinite(read_wav(str(w))[1]).all() for w in wavs),
              f"install separate: {[w.name for w in wavs]} of {lengths}")
    finally:
        subprocess.run(["chmod", "-R", "u+w", str(site)], check=False)
    emit("install", wheel=wheel, worker={**worker, "wall_s": wall}, runs=runs,
         wavs=[w.name for w in wavs],
         note="worker launches are kernel-vs-plain comparisons; the install path "
              "counts the console script's train and separate and recompute_bounds")
    return {k: sum(r["launches"][k] for r in runs.values())
            for k in ("stft_features", "masked_istft", "istft", "istft_bwd", "stft")}


def installed_run(module: str, *argv) -> int:
    """`python -m module argv...` on the port installed as phase_install
    installs it (install_port, in a temporary directory, XDG_CACHE_HOME
    there): the way to run a long job from the installed port."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        print(json.dumps({"install": install_port(tmp)}), flush=True)
        try:
            return subprocess.run([sys.executable, "-P", "-m", module, *argv],
                                  cwd=tmp, env=installed_env(tmp)).returncode
        finally:
            subprocess.run(["chmod", "-R", "u+w", str(tmp / "site")], check=False)


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
    wall, out, rep = tool_process(
        tmp, "cli_train", "gan_sass_tf_tpu_torch.cli", "train", "--config",
        "stream_v5e8", "--workdir", str(wd), "--steps", str(TOOLS_STEPS),
        "--profile-steps", "{}:{}".format(*TOOLS_PROFILE), "--tensorboard",
        "--debug-nans", "--debug-leaks", "--device", str(dev), "--set",
        "train.log_every=1")
    paths["tools_cli_train"] = rep["launches"]
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
    wall, out, rep = tool_process(
        tmp, "profile_step", "gan_sass_tf_tpu_torch.scripts.profile_step",
        "stream_v5e8", "32", "--device", str(dev))
    paths["tools_profile_step"] = rep["launches"]
    graphed, line = (json.loads(ln) for ln in out.strip().splitlines()[-2:])
    buckets = line["buckets_us_per_step"]
    named = sum(v for k, v in buckets.items() if k != "other")
    total = line["device_ms_per_step"] * 1e3
    check(named >= 0.95 * total, f"tools profile_step: the step's ranges hold "
          f"{named} of {total} device us")
    check(all(finite(graphed[k][m]) and graphed[k][m] > 0
              for k in ("wall_ms", "device_ms", "busy_ms") for m in ("graphed", "eager"))
          and graphed["launches_per_replay"]["stft_features"] > 0,
          f"tools profile_step: graphed timing {graphed}")
    report["profile_step"] = {"wall_s": wall, "line": line, "graphed": graphed,
                              "ranges_share": named / total,
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
            exp._train_step(exp.state, exp._bank, exp._train_key)
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


def graph_ms(fn, calls=CALLS_PER_SAMPLE, stream=None) -> float:
    """Median device ms a call of `fn`: CUDA events around a replayed CUDA
    graph of `calls` back-to-back calls, so every launch is timed and no
    host time falls between them (as scripts/time_synthesis.py).  The
    capture runs on `stream` where given (a backward runs on its forward's
    stream, so one captured alone needs the stream its forward ran on)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
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
            lambda: exp._train_step(exp.state, exp._bank, exp._train_key),
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
    t_in = x.shape[-1]
    ms, by = cost.stft_features(x.numel() // t_in, t_in, n_fft, hop, emits, n_mels).bound()
    return {"shape": list(x.shape), "n_fft": n_fft, "emit": list(emits),
            "kernel": t["kernel"], "plain": t["plain"], "library": t["library"],
            "device": {"kernel": launch_ms(kernel), "plain": device_ms(plain),
                       "library": device_ms(fns["library"])},
            "bound": ms, "bound_by": by}


def time_kernel(kernel, plain, bound_ms_by, graph=True, library=None,
                library_istft_only=None):
    """A kernel call timed beside its plain version and, where one is given,
    the PyTorch calls that compute the same function (`library`; for K2
    also torch.istft alone on the masked spectra, `library_istft_only`),
    through the wrapper and on the device (a library call's by
    torch.profiler: torch.istft reads its envelope check back to the host,
    so no CUDA graph can hold it), with its bound."""
    fns = {"plain": plain, "kernel": kernel, **({"library": library} if library else {})}
    t = time_fns(**fns)
    out = {"kernel": t["kernel"], "plain": t["plain"],
           "device": {"kernel": launch_ms(kernel, graph), "plain": device_ms(plain)},
           "bound": bound_ms_by[0], "bound_by": bound_ms_by[1]}
    if library:
        out["library"] = t["library"]
        out["device"]["library"] = device_ms(library)
    if library_istft_only:
        out["device"]["library_istft_only"] = device_ms(library_istft_only)
    return out


def library_istft(est, n_fft, hop):
    """torch.istft of a (..., F, K) spectrum, center=True (it drops n_fft/2
    samples at each end and has no edge clamp; center=False raises, the
    periodic Hann envelope being 0 at sample 0): the one PyTorch call that
    computes the same overlap-added, envelope-normalised inverse as K3 (its
    layout is (K, F)), timed beside it and used nowhere in the port."""
    w = torch.from_numpy(get_window("hann", n_fft)).to(est.device)
    flat = est.reshape(-1, *est.shape[-2:]).transpose(-1, -2)
    return lambda: torch.istft(flat, n_fft, hop, window=w, center=True)


def library_istft_bwd(est, n_fft, hop, stream=None):
    """The backward of library_istft's torch.istft on a leaf copy of `est`
    (one torch.autograd.grad of one call, a seeded cotangent): the PyTorch
    call beside K3's VJP, used nowhere in the port.  The forward runs on
    `stream` where given, so that graph_ms can capture the backward alone
    there (the forward reads its envelope check back to the host)."""
    w = torch.from_numpy(get_window("hann", n_fft)).to(est.device)
    flat = est.detach().reshape(-1, *est.shape[-2:]).transpose(-1, -2).contiguous()
    flat.requires_grad_()
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        y = torch.istft(flat, n_fft, hop, window=w, center=True)
    if stream is not None:
        torch.cuda.current_stream().wait_stream(stream)
    dy = torch.randn(y.shape, generator=torch.Generator(y.device).manual_seed(SEED),
                     device=y.device)
    return lambda: torch.autograd.grad(y, flat, dy, retain_graph=True)


def library_masked_istft(spec, masks, n_fft, hop, mask_type="magnitude"):
    """The mask product and torch.istft (library_istft): K2's function in
    PyTorch calls, and torch.istft alone on the product made once."""
    w = torch.from_numpy(get_window("hann", n_fft)).to(spec.device)

    def product():
        m = torch.view_as_complex(masks) if mask_type == "complex" else masks
        return spec.unsqueeze(-3) * m

    def both():
        est = product()
        return torch.istft(est.reshape(-1, *est.shape[-2:]).transpose(-1, -2), n_fft,
                           hop, window=w, center=True)

    return {"library": both, "library_istft_only": library_istft(product(), n_fft, hop)}


def k1_timing(x, n_fft, hop, emits, mel=None):
    n_mels = mel.shape[1] if mel is not None else 0
    return time_stft(
        lambda: k1.stft_features_kernel(x, n_fft, hop, emit=emits, mel_matrix=mel),
        lambda: k1.stft_features_reference(x, n_fft, hop, emit=emits, mel_matrix=mel),
        x, n_fft, hop, emits, n_mels)


def phase_timing(rng, dev, x, spec, cfg, g, batch, k3_tensors, exp, k4_inputs,
                 k1_music, k2_music, bound_walls, k1_bench):
    mel = torch.from_numpy(mel_filterbank(N_MELS, N_FFT // 2 + 1, SR)).to(dev)
    k1_sep = k1_timing(x, N_FFT, HOP, ("spec", "logmel"), mel)
    k1_bench_t = {what: k1_timing(xb, N_FFT, HOP, emits, m)
                  for what, (xb, emits, m) in k1_bench.items()}
    k1_steps = {what: k1_timing(xm, MUSIC_N_FFT, MUSIC_HOP, emits)
                for what, (xm, emits) in k1_music.items()}
    masks = torch.from_numpy(rng.uniform(0, 1, (B_MAIN, 2) + tuple(spec.shape[-2:]))
                             .astype(np.float32)).to(dev)
    k2_sep = time_kernel(
        lambda: k2.masked_istft_kernel(spec, masks, N_FFT, HOP),
        lambda: k2.masked_istft_reference(spec, masks, N_FFT, HOP),
        cost.masked_istft(B_MAIN, 2, spec.shape[-2], N_FFT, HOP).bound(),
        **library_masked_istft(spec, masks, N_FFT, HOP))
    sm, mm = k2_music     # complex masks: 6 flops a (source, bin)
    k2_mus = time_kernel(
        lambda: k2.masked_istft_kernel(sm, mm, MUSIC_N_FFT, MUSIC_HOP, mask_type="complex"),
        lambda: k2.masked_istft_reference(sm, mm, MUSIC_N_FFT, MUSIC_HOP,
                                          mask_type="complex"),
        cost.masked_istft(B_MUSIC, 2, sm.shape[-2], MUSIC_N_FFT, MUSIC_HOP,
                          "complex").bound(),
        **library_masked_istft(sm, mm, MUSIC_N_FFT, MUSIC_HOP, "complex"))

    def run_sep(path):
        def go():
            with dispatch.force_backend(path):
                separate(g, cfg, batch, dev)
        return go

    sep_plain, sep_kernel = time_pair(run_sep("reference"), run_sep(None))
    audio_s = batch.shape[0] * batch.shape[1] / SR
    spec_k3, y, ref, dy = k3_tensors
    f = spec_k3.shape[-2]
    sk = spec_k3.detach()
    with torch.no_grad():   # the train step's route: ops.dispatch.istft
        k3_t = time_kernel(lambda: dispatch.istft(sk, N_FFT, HOP),
                           lambda: k3.istft_reference(sk.real, sk.imag, N_FFT, HOP),
                           cost.istft(sk.shape[0], f, N_FFT, HOP).bound(),
                           library=library_istft(sk, N_FFT, HOP))
    # The backward reads the cotangent once and writes the interleaved
    # gradient once, with an FFT a frame: a spec-only STFT's bytes and flops.
    bwd_bound = cost.stft(ref.shape[0], ref.shape[-1], N_FFT, HOP).bound()
    bwd_t = time_kernel(
        lambda: torch.autograd.grad(y, spec_k3, dy, retain_graph=True),
        lambda: torch.autograd.grad(ref, spec_k3, dy, retain_graph=True), bwd_bound,
        graph=False, library=library_istft_bwd(sk, N_FFT, HOP))
    lib_stream = torch.cuda.Stream()
    bwd_t["library_graph_ms"] = graph_ms(library_istft_bwd(sk, N_FFT, HOP, lib_stream),
                                         stream=lib_stream)
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
         stft_features_ms=k1_sep, stft_features_bench_step_ms=k1_bench_t,
         stft_features_music_step_ms=k1_steps,
         stft_features_stream_step_ms=k1_stream_step,
         profiler_launches_per_call=prof_check,
         masked_istft_ms=k2_sep, masked_istft_music_ms=k2_mus,
         separate_ms={"kernel": sep_kernel, "plain": sep_plain},
         separate_mix_sec_per_sec={"kernel": audio_s / sep_kernel * 1e3,
                                   "plain": audio_s / sep_plain * 1e3},
         istft_shape=list(sk.shape),
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
                              "stream_step_shape": row(k1_stream_step),
                              "bench_step_shape": {what: row(t) for what, t
                                                   in k1_bench_t.items()}},
            "masked_istft": {**row(k2_sep), "music_shape": row(k2_mus)},
            "istft": row(k3_t),
            "istft_bwd": {**row(bwd_t), "adjoint_launch": row(adjoint),
                          "library_graph_ms": bwd_t["library_graph_ms"]},
            "stft": row(k4_times["stream"])}


def row(t) -> dict:
    """A `kernels` line entry from a time_stft or time_kernel dict."""
    return {"ms": t["kernel"], "device_ms": t["device"]["kernel"]["ms"],
            "plain_ms": t["plain"], "plain_device_ms": t["device"]["plain"],
            "bound_ms": t["bound"], "bound_by": t["bound_by"],
            "library_ms": t.get("library"),
            "library_device_ms": t["device"].get("library"),
            **({"library_istft_only_device_ms": t["device"]["library_istft_only"]}
               if "library_istft_only" in t["device"] else {}),
            **({"shape": t["shape"]} if "shape" in t else {})}


def main() -> int:
    kind = phase_device()
    phase_build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    x, spec, k1_err, k1_music, k1_bench = phase_k1(rng, dev)
    k2_err, k2_music = phase_k2(rng, dev, x, spec)
    with tempfile.TemporaryDirectory() as tmp:
        cfg, g, batch, counts = phase_main_path(rng, dev, Path(tmp))
    k3_errs, k3_tensors = phase_k3(rng, dev)
    k4_err, *k4_inputs = phase_k4(rng, dev)
    rng_rows = phase_rng(dev)
    exp, train_counts = phase_train(dev)
    with tempfile.TemporaryDirectory() as tmp:
        graph_counts, graph_host_counts, graph_host_bank_counts = phase_graph(
            dev, Path(tmp))
    phase_bench(dev)
    phase_roofline(dev)
    with tempfile.TemporaryDirectory() as tmp:
        pit3_counts, pit3_rows = phase_pit3(rng, dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        opt = phase_options(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        wd, workdir_counts = phase_workdir(dev, Path(tmp))
        stream_launches, stream_shapes = phase_stream(rng, dev, Path(tmp), wd)
        dp_counts, dp_by_rank = phase_dp(dev, Path(tmp))
    serve_counts = phase_serve_graph(dev)
    bound_launches, bound_walls = phase_bounds(dev)
    quality_runs = phase_quality(dev)
    times = phase_timing(rng, dev, x, spec, cfg, g, batch, k3_tensors, exp,
                         k4_inputs, k1_music, k2_music, bound_walls, k1_bench)
    with tempfile.TemporaryDirectory() as tmp:
        tools = phase_tools(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        install = phase_install(Path(tmp))
    quality_launches = {k: sum(r["launches"][k] for r in quality_runs.values())
                        for k in ("stft", "threefry_batch", "threefry_batch_noise",
                                  "threefry_sample")}

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
         **by_path("stft_features", main_path=counts, graph=graph_counts,
                   graph_host=graph_host_counts,
                   graph_host_bank_rate=graph_host_bank_counts,
                   stream_batch=stream_launches["batch"],
                   stream_scan=stream_launches["scan"], serve_graph=serve_counts,
                   pit3_train=pit3_counts["train"], pit3_eval=pit3_counts["eval"],
                   pit3_separation=pit3_counts["separation"],
                   pit3_quality=pit3_counts["quality"], **dp_counts, **opt,
                   **tools, install=install),
         "max_abs_err": k1_err, **times["stft_features"],
         "dp_launches_by_rank": dp_by_rank["stft_features"],
         "stream_shape": stream_rows("stft_features"),
         "pit3_shape": pit3_rows["stft_features"]},
        {"name": "masked_istft", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/masked_istft.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_istft.py:175",
         **by_path("masked_istft", main_path=counts,
                   stream_batch=stream_launches["batch"],
                   stream_scan=stream_launches["scan"], serve_graph=serve_counts,
                   pit3_eval=pit3_counts["eval"],
                   pit3_separation=pit3_counts["separation"],
                   pit3_quality=pit3_counts["quality"], **dp_counts,
                   **{k: opt[k] for k in ("options_music_eval",
                                          "options_music_separation",
                                          "options_music_quality")}, **tools,
                   install=install),
         "max_abs_err": k2_err, **times["masked_istft"],
         "dp_launches_by_rank": dp_by_rank["masked_istft"],
         "stream_shape": stream_rows("masked_istft"),
         "pit3_shape": pit3_rows["masked_istft"]},
        {"name": "istft", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/masked_istft.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_istft.py:71",
         **by_path("istft", train=train_counts, graph=graph_counts,
                   graph_host=graph_host_counts,
                   graph_host_bank_rate=graph_host_bank_counts, workdir=workdir_counts,
                   dp_train=dp_counts["dp_train"],
                   options_stream_train=opt["options_stream_train"], **tools,
                   install=install),
         "max_abs_err": k3_errs["forward_full"], **times["istft"],
         "dp_launches_by_rank": dp_by_rank["istft"]},
        {"name": "istft_bwd", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/stft_features.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_istft.py:151",
         **by_path("istft_bwd", train=train_counts, graph=graph_counts,
                   graph_host=graph_host_counts,
                   graph_host_bank_rate=graph_host_bank_counts, workdir=workdir_counts,
                   dp_train=dp_counts["dp_train"],
                   options_stream_train=opt["options_stream_train"], **tools,
                   install=install),
         "max_abs_err": max(k3_errs["grad_re"], k3_errs["grad_im"]),
         **times["istft_bwd"], "dp_launches_by_rank": dp_by_rank["istft_bwd"]},
        {"name": "stft", "route": "cuda",
         "source": "gan_sass_tf_tpu_torch/ops/csrc/stft_features.cu",
         "replaces": "gan_sass_tf_tpu/ops/pallas_stft.py:228",
         **by_path("stft", bounds=bound_launches, quality=quality_launches,
                   pit3_quality=pit3_counts["quality"],
                   options_music_quality=opt["options_music_quality"],
                   install=install),
         "max_abs_err": k4_err, **times["stft"]},
        *({"name": name, "route": "cuda",
           "source": "gan_sass_tf_tpu_torch/ops/csrc/threefry.cu",
           "replaces": replaces,
           **by_path(name, train=train_counts, graph=graph_counts,
                     graph_host=graph_host_counts,
                     graph_host_bank_rate=graph_host_bank_counts, workdir=workdir_counts,
                     dp_train=dp_counts["dp_train"],
                     options_stream_train=opt["options_stream_train"],
                     serve_graph=serve_counts, quality=quality_launches),
           **rng_rows[name]}
          for name, replaces in (
              ("threefry_batch", "none: jax.random keys and draws and the mix at "
                                 "gan_sass_tf_tpu/train/step.py:212-237, "
                                 "gan_sass_tf_tpu/data/device_bank.py:41-57, "
                                 "gan_sass_tf_tpu/data/mixer.py:31-51"),
              ("threefry_batch_noise", "none: the mixture's noise at "
                                       "gan_sass_tf_tpu/data/mixer.py:44-48"),
              ("threefry_sample", "none: jax.random draws at "
                                  "gan_sass_tf_tpu/data/mixer.py:31-51 (on no path "
                                  "since the batch kernel; held to its plain version "
                                  "at SAMPLE_SHAPES)"))),
        *({"name": name, "route": "cuda",
           "source": "gan_sass_tf_tpu_torch/ops/csrc/threefry.cu",
           "replaces": replaces,
           **by_path(name, graph=graph_counts, graph_host=graph_host_counts,
                     graph_host_bank_rate=graph_host_bank_counts,
                     options_stream_train=opt["options_stream_train"]),
           **rng_rows[name]}
          for name, replaces in (
              ("threefry_dropout", "none: flax nn.Dropout at "
                                   "gan_sass_tf_tpu/models/generator.py:440"),
              ("threefry_dropout_bwd", "none: the VJP of flax nn.Dropout at "
                                       "gan_sass_tf_tpu/models/generator.py:440"),
              ("threefry_noise", "none: instance noise at "
                                 "gan_sass_tf_tpu/train/step.py:169"))),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--dp"]:
        sys.exit(dp_alone())
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--tool-worker"]:
        sys.exit(tool_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--install-worker"]:
        sys.exit(install_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--installed"]:
        sys.exit(installed_run(*sys.argv[2:]))
    sys.exit(main())
