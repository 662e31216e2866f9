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
kernels.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
from collections import Counter

import torch

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.cli import _apply_overrides
from gan_sass_tf_tpu_torch.scripts import split_args
from gan_sass_tf_tpu_torch.scripts.quality_protocol import device_or_exit
from gan_sass_tf_tpu_torch.utils import profiler

STEPS, WARMUP = 10, 3


def profile_steps(exp, steps: int):
    """(device µs by bucket, device µs by kernel name) summed over `steps`
    traced train steps of `exp`."""
    with tempfile.TemporaryDirectory() as tmp:
        with profiler.profile_trace(tmp):
            for _ in range(steps):
                with profiler.step_range(exp.state.step):
                    exp._train_step(exp.state, exp._bank, exp._train_seed)
        events = profiler.load_trace(profiler.trace_files(tmp)[-1])
    within = profiler.annotations(events, profiler.STEP_PREFIX)
    buckets = profiler.attribute(events, profiler.STEP_RANGES, within)
    top: Counter = Counter()
    for e in profiler.device_events(events):
        if any(r["ts"] <= e["launch_ts"] <= r["ts"] + r["dur"] for r in within):
            top[e["name"]] += e["dur"]
    return buckets, top


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pos, opts = split_args(argv)
    overrides, device = opts["--set"], (opts["--device"] or ["cuda"])[-1]
    preset = pos[0] if pos else "wsj0_logmel"
    batch = int(pos[1]) if len(pos) > 1 else 128
    dev = device_or_exit(device)

    from gan_sass_tf_tpu_torch.train import Experiment

    cfg = _apply_overrides(config.get_config(preset), overrides)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, dataset="synthetic"),
        train=dataclasses.replace(cfg.train, batch_size=batch),
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1))
    exp = Experiment(cfg, workdir=None, device=dev)
    if not exp._use_bank:
        raise SystemExit("error: profile_step takes a device-bank preset")
    for _ in range(WARMUP):
        exp._train_step(exp.state, exp._bank, exp._train_seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    agg, top = profile_steps(exp, STEPS)
    total = sum(agg.values())
    print(f"{preset} batch={batch}: {total / STEPS / 1e3:.2f} ms/step "
          f"device time over {STEPS} steps ({dev.type})")
    for k, v in sorted(agg.items(), key=lambda kv: -kv[1]):
        print(f"  {v / STEPS:9.1f} us  {k}")
    print("top kernels:")
    for op, v in top.most_common(20):
        print(f"  {v / STEPS:8.1f} us  {op[:100]}")
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
