"""Profile the train step and attribute device time by part of the step.

    python -m gan_sass_tf_tpu_torch.scripts.profile_step [preset] [batch]
        [--set sec.key=val ...] [--device cuda]

Port of `scripts/profile_step.py`: train `WARMUP` steps of the preset on
synthetic data at `batch` (default wsj0_logmel at 128), then trace
`STEPS` steps with torch.profiler (utils/profiler.py) early in the
process, where its records are whole, and bucket each kernel's device time
by the train step's range that launched it (`utils/profiler.py`
STEP_RANGES: dsp, g_fwd, pit, d_step, g_bwd, optimizer; "other" outside
them).  A kernel is matched to its launch through its correlation id, so
the backward's kernels, launched on autograd's own thread, land in the
range whose window holds their launch.  Where JAX joined XLA fusions to
HLO op_name metadata, the port's step names its own parts.

Prints ms a step by bucket and the top kernels, then one JSON line with
the JAX script's keys:
  {"preset", "batch", "device_ms_per_step", "buckets_us_per_step",
   "top_ops_us_per_step"}
On the CPU (--device cpu) the host's outermost operators stand in for
kernels.  With `--set data.device_bank=false` the steps run in host-batch
mode: each takes one of POOL host batches drawn and page-locked ahead
(`train.experiment.HostBatches`), copied to the device within the step's
time, eager or graphed, as `Experiment.train` copies the prefetch
thread's batches.

On CUDA the step is then captured (`train/graphed.py`) and timed both
ways, and one more JSON line comes before the last, the values unrounded:
  {"nvidia_smi",
   "wall_ms": {"graphed", "eager"},    medians of SAMPLES synchronized
                                       steps each way, in turns
   "device_ms": {"graphed", "eager"},  kernel, copy and fill time summed,
   "busy_ms": {"graphed", "eager"},    and their union, a step (a trace
                                       of STEPS steps each way)
   "nccl_ms": {"graphed", "eager"},    the NCCL kernels' part of device_ms
   "world",                            the ranks
   "launches_per_replay",              the capture's kernel launches
   "host_batch_ms"}                    host-batch mode: the median ms of
                                       SAMPLES host_batch() calls (drawing
                                       one batch and page-locking it);
                                       null with the device bank
Under torchrun it joins the process group, data parallel as `cli train`
(`python -m torch.distributed.run --standalone --nproc_per_node N -m
gan_sass_tf_tpu_torch.scripts.profile_step stream_v5e8 32`): `batch` is
the global batch, each rank steps its rows and all-reduces over NCCL,
every rank runs the same steps, and rank 0 prints its own figures.
The file runs on an older checkout of the package too (`PYTHONPATH=that
tree python path/to/profile_step.py ...`), so two versions are timed in
one call.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import torch

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.cli import _apply_overrides
from gan_sass_tf_tpu_torch.parallel import run_in_group
from gan_sass_tf_tpu_torch.scripts import split_args
from gan_sass_tf_tpu_torch.scripts.quality_protocol import device_or_exit
from gan_sass_tf_tpu_torch.utils import profiler

STEPS, WARMUP, SAMPLES = 10, 3, 8
POOL = 4                     # host batches drawn ahead in host-batch mode


def profile_steps(exp, steps: int, batches=None):
    """(device µs by bucket, device µs by kernel name) summed over `steps`
    traced train steps of `exp`."""
    with tempfile.TemporaryDirectory() as tmp:
        first = int(exp.state.step)
        with profiler.profile_trace(tmp):
            for i in range(steps):
                with profiler.step_range(first + i):
                    exp._train_step(exp.state, exp._step_data(batches), exp._train_key)
        events = profiler.load_trace(profiler.trace_files(tmp)[-1])
    within = profiler.annotations(events, profiler.STEP_PREFIX)
    buckets = profiler.attribute(events, profiler.STEP_RANGES, within)
    top: Counter = Counter()
    for e in profiler.device_events(events):
        if any(r["ts"] <= e["launch_ts"] <= r["ts"] + r["dur"] for r in within):
            top[e["name"]] += e["dur"]
    return buckets, top


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unavailable: {exc}"


def traced(fn, calls: int = STEPS):
    """(kernel ms summed, busy ms, NCCL kernel ms) a call of `fn` over
    `calls` traced calls (one untimed call first)."""
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiler.profile_trace(tmp):
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = profiler.device_events(profiler.load_trace(profiler.trace_files(tmp)[-1]))
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy, end = busy + b - max(a, end), b
    nccl = sum(e["dur"] for e in events if "nccl" in e["name"].lower())
    return (sum(e["dur"] for e in events) / calls / 1e3, busy / calls / 1e3,
            nccl / calls / 1e3)


def time_graphed(exp, batches=None) -> dict:
    """Wall, device and busy ms of `exp`'s captured step against its eager
    step (the capture made here), in host-batch mode each with the copy of
    its batch."""
    from gan_sass_tf_tpu_torch.train.graphed import WARMUP_STEPS

    exp.run_steps(WARMUP_STEPS + 1, batches)   # the eager warm-up, the capture
    steps = {"graphed": lambda: exp.run_steps(1, batches),
             "eager": lambda: exp._step(exp._step_data(batches))}
    walls = {k: [] for k in steps}
    for i in range(2 * SAMPLES):
        mode = ("graphed", "eager", "eager", "graphed")[i % 4]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps[mode]()
        torch.cuda.synchronize()
        walls[mode].append((time.perf_counter() - t0) * 1e3)
    device, busy, nccl = {}, {}, {}
    for mode, fn in steps.items():
        device[mode], busy[mode], nccl[mode] = traced(fn)
    host = None
    if batches is not None:
        host = []
        for _ in range(SAMPLES):
            t0 = time.perf_counter()
            exp.host_batch()
            host.append((time.perf_counter() - t0) * 1e3)
    return {"nvidia_smi": nvidia_smi(),
            "wall_ms": {k: statistics.median(v) for k, v in walls.items()},
            "device_ms": device, "busy_ms": busy, "nccl_ms": nccl,
            "world": exp.dp.world, "launches_per_replay": exp._graphed.per_replay,
            "host_batch_ms": host and statistics.median(host)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pos, opts = split_args(argv)
    overrides, device = opts["--set"], (opts["--device"] or ["cuda"])[-1]
    preset = pos[0] if pos else "wsj0_logmel"
    batch = int(pos[1]) if len(pos) > 1 else 128
    device_or_exit(device)
    return run_in_group(device, lambda dev: profile(preset, batch, overrides, dev))


def profile(preset: str, batch: int, overrides, dev: torch.device) -> int:
    """main's work on this rank's device; rank 0 prints."""
    from gan_sass_tf_tpu_torch.train.experiment import Experiment, HostBatches

    cfg = _apply_overrides(config.get_config(preset), overrides)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, dataset="synthetic"),
        train=dataclasses.replace(cfg.train, batch_size=batch),
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1))
    exp = Experiment(cfg, workdir=None, device=dev)
    batches = None if exp._use_bank else HostBatches(exp, POOL)
    for _ in range(WARMUP):
        exp._train_step(exp.state, exp._step_data(batches), exp._train_key)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    agg, top = profile_steps(exp, STEPS, batches)
    total = sum(agg.values())
    timing = time_graphed(exp, batches) if exp.graphed else None
    if not exp.dp.is_main:
        return 0
    print(f"{preset} batch={batch}: {total / STEPS / 1e3:.2f} ms/step "
          f"device time over {STEPS} steps ({dev.type})")
    for k, v in sorted(agg.items(), key=lambda kv: -kv[1]):
        print(f"  {v / STEPS:9.1f} us  {k}")
    print("top kernels:")
    for op, v in top.most_common(20):
        print(f"  {v / STEPS:8.1f} us  {op[:100]}")
    if timing is not None:
        print(json.dumps(timing), flush=True)
    print(json.dumps({
        "preset": preset, "batch": batch,
        "device_ms_per_step": total / STEPS / 1e3,
        "buckets_us_per_step": {k: v / STEPS for k, v in
                                sorted(agg.items(), key=lambda kv: -kv[1])},
        "top_ops_us_per_step": {op[:100]: v / STEPS for op, v in top.most_common(15)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
