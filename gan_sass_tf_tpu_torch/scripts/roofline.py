"""Roofline of the train step per preset: the achieved TFLOP/s and GB/s
against the card's peaks, which wall each preset sits against, and the
speed-of-light step.

    python -m gan_sass_tf_tpu_torch.scripts.roofline [preset ...] [--steps N]
        [--batch B] [--set sec.key=val ...] [--calibrate] [--profile]
        [--device cuda]

Port of `scripts/roofline.py`.  For each preset (default: all five), on
synthetic data at its batch or B: one eager step counted by the bytes
ledger (`scripts/bytes_ledger.py`: the dispatcher's FLOPs and bytes, the
LSTM's rule, the hand-written kernels' costs from their shapes; where JAX
read XLA's `cost_analysis()` and HLO entry ledger); then `--steps` (30)
graphed steps timed with CUDA events after the warm-up and the capture
(`Experiment.run_steps`, the path training runs), and `EAGER_STEPS` eager
steps beside them.  Prints one JSON line a preset with the JAX script's
keys, renamed where the name says TPU:

  ms_per_step, eager_ms_per_step   graphed and eager device-synchronized ms
  hlo_gflops_per_step, hlo_gb_per_step
                                   the ledger's counts (the JAX names kept);
                                   hlo_logical_gb_per_step and
                                   cost_analysis_gb_per_step equal
                                   hlo_gb_per_step: no lane padding, and
                                   eager ops are not fused
  kernel_gflops_per_step, kernel_gb_per_step
                                   the hand-written kernels' share of them
  achieved_tflops, achieved_gbs    counts over the graphed step
  tc_util_vs_peak                  TFLOP/s over `peak_tflops`: the H100
                                   SXM's dense bf16 tensor-core peak, or its
                                   TF32 peak for an f32 preset (cuDNN's
                                   convolutions may take TF32 under torch's
                                   defaults); `peak` names it
  hbm_util_vs_peak                 GB/s over 3.35 TB/s
  bound                            "compute" or "hbm", the larger share
  speed_of_light_ms, sol_headroom_x
                                   max(flops / peak, bytes / 3.35 TB/s) and
                                   the graphed step over it
  gpu                              nvidia-smi's name and power limit

A share above 1.0 is an error, not a result: the script exits 1 after the
line.  With `--device cpu` the line carries the counts and the CPU's wall
ms a step, and null for every share and rate.  `--calibrate` first prints
the counterpart of `calibrate_hbm`: a 2 GB float32 read-and-write
elementwise pass timed with CUDA events, against 3.35 TB/s.  `--profile`
adds `unseen`: torch.profiler over `PROFILE_STEPS` eager steps, the device
time a step of the kernels that move data no dispatched op is charged for
(cuDNN's NCHW/NHWC layout transposes, split-K reductions), by family and
kernel (`scripts/bytes_ledger.py` says why the ledger cannot see them).
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.ops import cost
from gan_sass_tf_tpu_torch.scripts import split_args
from gan_sass_tf_tpu_torch.scripts.bytes_ledger import (
    experiment_config,
    step_ledger,
)
from gan_sass_tf_tpu_torch.scripts.profile_step import nvidia_smi
from gan_sass_tf_tpu_torch.scripts.quality_protocol import device_or_exit
from gan_sass_tf_tpu_torch.utils import profiler

STEPS, EAGER_STEPS, PROFILE_STEPS = 30, 10, 5
PEAK_HBM_GBS = cost.HBM_BYTES_PER_S / 1e9
PEAKS = {"bfloat16": (cost.BF16_TC_FLOPS_PER_S / 1e12, "bf16 tensor cores, dense"),
         "float32": (cost.TF32_TC_FLOPS_PER_S / 1e12, "TF32 tensor cores, dense")}
# Kernels that move data no dispatched op is charged for, by family:
# substrings of the lower-cased kernel name.
UNSEEN = (("layout transposes", ("nchwtonhwc", "nhwctonchw")),
          ("split-K reductions", ("splitk",)))
SHARE_KEYS = ("tc_util_vs_peak", "hbm_util_vs_peak")


def _events_ms(fn, n: int) -> float:
    """Device-synchronized ms a call of fn, over n calls between two CUDA
    events."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def time_steps(exp, steps: int) -> dict:
    """ms a step: graphed (`run_steps(steps)`, after the warm-up and the
    capture) and eager, on the card; the eager step's wall ms on the CPU."""
    eager = lambda: exp._step(exp._step_data())          # noqa: E731
    if exp.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(steps):
            eager()
        return {"ms": (time.perf_counter() - t0) * 1e3 / steps, "eager_ms": None}
    if exp.graphed:
        from gan_sass_tf_tpu_torch.train.graphed import WARMUP_STEPS

        exp.run_steps(WARMUP_STEPS + 1)                # warm-up, capture, a replay
        graphed = _events_ms(lambda: exp.run_steps(steps), 1) / steps
    eager()
    eager_ms = _events_ms(eager, EAGER_STEPS)
    return {"ms": graphed if exp.graphed else eager_ms, "eager_ms": eager_ms}


def unseen(exp, steps: int = PROFILE_STEPS) -> dict:
    """Device ms a step of all kernels and of the UNSEEN families' (by
    family and kernel), from torch.profiler over `steps` eager steps."""
    exp._step(exp._step_data())
    with tempfile.TemporaryDirectory() as tmp:
        with profiler.profile_trace(tmp):
            for _ in range(steps):
                exp._step(exp._step_data())
        events = profiler.device_events(profiler.load_trace(profiler.trace_files(tmp)[-1]))
    total = sum(e["dur"] for e in events) / steps / 1e3
    fams, kernels = {}, {}
    for e in events:
        low = e["name"].lower()
        fam = next((f for f, keys in UNSEEN if any(k in low for k in keys)), None)
        if fam is not None:
            ms = e["dur"] / steps / 1e3
            fams[fam] = fams.get(fam, 0.0) + ms
            kernels[e["name"][:120]] = kernels.get(e["name"][:120], 0.0) + ms
    seen = sum(fams.values())
    return {"steps": steps, "device_ms_per_step": total, "unseen_ms_per_step": seen,
            "unseen_share": seen / total if total else None, "by_family": fams,
            "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])}


def roofline(flops: float, nbytes: float, ms: float, dtype: str, on_card: bool) -> dict:
    """The rates, shares, bound and speed of light of `flops` and `nbytes`
    done in `ms` (nulls off the card)."""
    peak, peak_name = PEAKS[dtype]
    sol = max(flops / (peak * 1e12), nbytes / cost.HBM_BYTES_PER_S) * 1e3
    out = {"achieved_tflops": None, "achieved_gbs": None, "tc_util_vs_peak": None,
           "hbm_util_vs_peak": None, "peak_tflops": peak, "peak": peak_name,
           "bound": None, "speed_of_light_ms": sol, "sol_headroom_x": None}
    if on_card:
        tflops, gbs = flops / ms / 1e9, nbytes / ms / 1e6
        tc, hbm = tflops / peak, gbs / PEAK_HBM_GBS
        out.update(achieved_tflops=tflops, achieved_gbs=gbs, tc_util_vs_peak=tc,
                   hbm_util_vs_peak=hbm, bound="compute" if tc > hbm else "hbm",
                   sol_headroom_x=ms / sol if sol > 0 else None)
    return out


def measure(preset: str, steps: int, batch: Optional[int], overrides: Sequence[str],
            dev: torch.device, profile: bool = False) -> dict:
    """One preset's line (see the module docstring)."""
    from gan_sass_tf_tpu_torch.train import Experiment

    exp = Experiment(experiment_config(preset, batch, overrides), workdir=None,
                     device=dev)
    return report(exp, step_ledger(exp), steps, profile)


def report(exp, ledger, steps: int, profile: bool = False) -> dict:
    """The line of `exp`'s counted step (`ledger`), its steps timed."""
    cfg, dev = exp.cfg, exp.device
    seen = unseen(exp) if profile else None
    t = time_steps(exp, steps)
    on_card = dev.type == "cuda"
    flops, nbytes = ledger.total_flops(), ledger.total_bytes()
    gb = nbytes / 1e9
    seg_s = cfg.segment_samples / cfg.dsp.sample_rate
    line = {
        "preset": cfg.name, "batch": cfg.train.batch_size, "device": dev.type,
        "ms_per_step": t["ms"], "eager_ms_per_step": t["eager_ms"],
        "mix_s_per_s": cfg.train.batch_size * seg_s / t["ms"] * 1e3,
        "hlo_gflops_per_step": flops / 1e9, "hlo_gb_per_step": gb,
        "hlo_logical_gb_per_step": gb, "cost_analysis_gb_per_step": gb,
        "kernel_gflops_per_step": ledger.kernel_flops() / 1e9,
        "kernel_gb_per_step": ledger.kernel_bytes() / 1e9,
        **roofline(flops, nbytes, t["ms"], cfg.model.compute_dtype, on_card),
        "dsp_backend": "kernel" if on_card else "reference",
        "gpu": nvidia_smi() if on_card else None,
        "kernel_launches": ledger.launches(),
    }
    if seen is not None:
        line["unseen"] = seen
    return line


def calibrate_hbm(dev: torch.device, gb: float = 2.0, iters: int = 20) -> dict:
    """The practical HBM ceiling: an in-place float32 elementwise pass over
    `gb` GB (read and written) timed with CUDA events, against the paper
    peak."""
    x = torch.zeros(int(gb * 1e9 / 4), device=dev)
    for _ in range(3):
        x.mul_(1.000001)
    ms = _events_ms(lambda: x.mul_(1.000001), iters)
    moved = 2 * x.numel() * 4
    gbs = moved / ms / 1e6
    return {"calibration": "hbm_stream", "gb_per_iter": moved / 1e9, "ms_per_iter": ms,
            "measured_gbs": gbs, "pct_of_paper_peak": 100 * gbs / PEAK_HBM_GBS,
            "gpu": nvidia_smi()}


def over_peak(line: dict) -> list:
    """The shares of a line above 1.0."""
    return [k for k in SHARE_KEYS if line[k] is not None and line[k] > 1.0]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    presets, opts = split_args(argv, ("--set", "--device", "--batch", "--steps"))
    flags = {a for a in presets if a in ("--calibrate", "--profile")}
    presets = [p for p in presets if p not in flags]
    dev = device_or_exit((opts["--device"] or ["cuda"])[-1])
    batch = int(opts["--batch"][-1]) if opts["--batch"] else None
    steps = int(opts["--steps"][-1]) if opts["--steps"] else STEPS
    if "--calibrate" in flags:
        if dev.type != "cuda":
            raise SystemExit("error: --calibrate measures the card's HBM: --device cuda")
        print(json.dumps(calibrate_hbm(dev)), flush=True)
    bad = []
    for preset in presets or config.list_configs():
        line = measure(preset, steps, batch, opts["--set"], dev, "--profile" in flags)
        print(json.dumps(line), flush=True)
        bad += [f"{preset} {k} {line[k]}" for k in over_peak(line)]
    if bad:
        print(f"error: shares above 1.0 (a count or a time is wrong): {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
