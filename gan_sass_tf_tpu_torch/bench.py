"""The port's benchmark: training throughput on one fixed workload, printed
as ONE JSON line on stdout.

    python -m gan_sass_tf_tpu_torch.bench [--device cuda]
    {"metric": "train_throughput_mixture_sec_per_sec_per_chip", "value": N,
     "unit": "mixture-sec/sec/chip", "vs_baseline": N}

Port of the root `bench.py`, with its workload, keys and environment
overrides: `wsj0_logmel` on synthetic 3 s segments, bf16 compute, the
device bank, batch BENCH_BATCH (default 128) a GPU times the GPUs of the
process group (torchrun's, else one).  BENCH_WARMUP_STEPS (default 5)
steps, `torch.cuda.synchronize()`, BENCH_STEPS (default 100) steps, and
`synchronize()` again; the value is mixture seconds trained a wall second
a GPU, unrounded.  The steps go through `Experiment.run_steps` in
dispatches of train.steps_per_dispatch: on CUDA the step captured as a
CUDA graph and replayed (`train/graphed.py`); the warm-up runs at least
to the capture, so the clock times replays only.  vs_baseline divides
the value by `baseline_measured.json`'s
cpu_tf_reference_mixture_sec_per_sec (beside the package), or is 1.0
where that file is not found.

On CUDA it fails before the warm-up when another process keeps the GPU
busy (nvidia-smi's utilization.gpu, sampled BUSY_SAMPLES times, averages
BUSY_PERCENT or more), or when nvidia-smi cannot tell: a resident job
would slow the timed steps.  It
exits with an error when `--device cuda` finds no GPU.  Everything else
goes to stderr: the card, the batch, the steps, and the eager step's
figure at the same number of steps beside the graphed one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.scripts import split_args

METRIC = "train_throughput_mixture_sec_per_sec_per_chip"
UNIT = "mixture-sec/sec/chip"
BASELINE = Path(__file__).resolve().parent.parent / "baseline_measured.json"
BUSY_SAMPLES, BUSY_INTERVAL_S, BUSY_PERCENT = 5, 0.2, 10.0


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def bench_config(per_gpu_batch: int, world: int):
    """The workload: wsj0_logmel, synthetic 3 s segments, bf16, the device
    bank, per_gpu_batch × world examples a step over every rank."""
    cfg = config.get_config("wsj0_logmel")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 segment_seconds=3.0, device_bank=True),
        model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1),
        train=dataclasses.replace(cfg.train, batch_size=per_gpu_batch * world))


def busy_reason(device: torch.device) -> Optional[str]:
    """Why the GPU of `device` counts as busy, or None: nvidia-smi's
    utilization.gpu of that card (matched by UUID), averaged over
    BUSY_SAMPLES readings BUSY_INTERVAL_S apart, at BUSY_PERCENT or more."""
    uuid = str(getattr(torch.cuda.get_device_properties(device), "uuid", ""))
    readings = []
    for i in range(BUSY_SAMPLES):
        if i:
            time.sleep(BUSY_INTERVAL_S)
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=uuid,utilization.gpu",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30, check=True).stdout
        except (OSError, subprocess.SubprocessError) as exc:
            return f"nvidia-smi could not read the GPU's utilization: {exc}"
        rows = [r.split(",") for r in out.strip().splitlines()]
        mine = [float(u) for g, u in rows if uuid and uuid in g] or \
            [float(u) for _, u in rows]
        readings.append(max(mine))
    mean = sum(readings) / len(readings)
    if mean >= BUSY_PERCENT:
        return (f"another process keeps the GPU busy: utilization.gpu "
                f"{readings} % (mean {mean} >= {BUSY_PERCENT})")
    return None


def _steps(exp, n: int) -> None:
    """n train steps in dispatches of train.steps_per_dispatch."""
    from gan_sass_tf_tpu_torch.train.experiment import dispatch_lengths

    for length in dispatch_lengths(n, exp.cfg.train.steps_per_dispatch):
        exp.run_steps(length)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device: torch.device) -> Optional[dict]:
    """Time the workload on `device` (this rank's); returns the JSON row on
    rank 0, None on the others."""
    from gan_sass_tf_tpu_torch.train import Experiment
    from gan_sass_tf_tpu_torch.train.graphed import WARMUP_STEPS

    warmup = int(os.environ.get("BENCH_WARMUP_STEPS", 5))
    steps = int(os.environ.get("BENCH_STEPS", 100))
    per_gpu = int(os.environ.get("BENCH_BATCH", 128))
    world = dist.get_world_size() if dist.is_initialized() else 1
    main = not dist.is_initialized() or dist.get_rank() == 0
    if device.type == "cuda":
        reason = busy_reason(device)
        if reason:
            raise SystemExit(f"error: {reason}")
    cfg = bench_config(per_gpu, world)
    exp = Experiment(cfg, workdir=None, device=device)
    if exp.graphed:
        warmup = max(warmup, WARMUP_STEPS + 1)    # through the capture
    _steps(exp, warmup)
    _sync(device)
    t0 = time.perf_counter()
    _steps(exp, steps)
    _sync(device)
    elapsed = time.perf_counter() - t0
    mix_sec = steps * cfg.train.batch_size * cfg.segment_samples / cfg.dsp.sample_rate
    value = mix_sec / elapsed / world
    if main:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        say(f"bench: {name}, {world} rank(s), batch {cfg.train.batch_size}, "
            f"{warmup} warm-up + {steps} timed steps, "
            f"{'graphed' if exp.graphed else 'eager'}: {elapsed / steps * 1e3} ms "
            f"a step, {value} {UNIT}")
    if exp.graphed:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            exp._step(exp._bank)
        _sync(device)
        eager = time.perf_counter() - t0
        if main:
            say(f"bench: eager step: {eager / steps * 1e3} ms a step, "
                f"{mix_sec / eager / world} {UNIT}")
    vs_baseline = 1.0
    if BASELINE.exists():
        ref = json.loads(BASELINE.read_text()).get(
            "cpu_tf_reference_mixture_sec_per_sec")
        if ref:
            vs_baseline = value / ref
    return {"metric": METRIC, "value": value, "unit": UNIT,
            "vs_baseline": vs_baseline} if main else None


def main(argv=None) -> int:
    from gan_sass_tf_tpu_torch.parallel.bootstrap import run_in_group
    from gan_sass_tf_tpu_torch.scripts.quality_protocol import device_or_exit

    _, opts = split_args(sys.argv[1:] if argv is None else argv, ("--device",))
    device = (opts["--device"] or ["cuda"])[-1]
    device_or_exit(device)
    row = run_in_group(device, run)
    if row is not None:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
