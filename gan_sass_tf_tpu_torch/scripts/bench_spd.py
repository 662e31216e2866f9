"""steps_per_dispatch: training throughput at K = 1, 4 and 16 steps a
dispatch, and the eager step beside them.

    python -m gan_sass_tf_tpu_torch.scripts.bench_spd [preset] [batch] [steps]
        [--set sec.key=val ...] [--device cuda]

Port of `scripts/bench_spd.py`.  On the TPU a dispatch scans K steps inside
one jitted call; here (on CUDA, device-bank mode) it replays the step
captured as a CUDA graph K times (`train/graphed.py`), so K only changes
how many replays go between two returns to the train loop.  One
Experiment of the preset on synthetic data (at `batch`, default the
preset's) is warmed up through its capture, then each K runs max(1,
steps // K) dispatches (`steps` default 192) between two
torch.cuda.synchronize() calls, and last the eager step runs as many
steps.  With `--set data.device_bank=false` (host-batch mode) each step,
graphed or eager, copies one of profile_step's POOL host batches, drawn
and page-locked ahead, to the device within its time; a dispatch of K is K
such steps.  One JSON line a row, the values unrounded:

  {"preset", "batch", "spd", "steps", "mode": "graphed" | "eager",
   "mix_s_per_s_per_chip", "ms_per_step"}

On the CPU every row is the eager step ("mode": "eager").
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.cli import _apply_overrides
from gan_sass_tf_tpu_torch.scripts import split_args
from gan_sass_tf_tpu_torch.scripts.profile_step import POOL
from gan_sass_tf_tpu_torch.scripts.quality_protocol import device_or_exit

SPDS = (1, 4, 16)


def main(argv=None) -> int:
    from gan_sass_tf_tpu_torch.train.experiment import Experiment, HostBatches
    from gan_sass_tf_tpu_torch.train.graphed import WARMUP_STEPS

    pos, opts = split_args(sys.argv[1:] if argv is None else argv)
    dev = device_or_exit((opts["--device"] or ["cuda"])[-1])
    preset = pos[0] if pos else "2src_toy_cpu"
    batch = int(pos[1]) if len(pos) > 1 else None
    total = int(pos[2]) if len(pos) > 2 else 192

    cfg = _apply_overrides(config.get_config(preset), opts["--set"])
    train_kw = {"log_every": 10**9, "eval_every": 10**9, "ckpt_every": 10**9}
    if batch:
        train_kw["batch_size"] = batch
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, dataset="synthetic"),
        train=dataclasses.replace(cfg.train, **train_kw),
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1))
    exp = Experiment(cfg, workdir=None, device=dev)
    batches = None if exp._use_bank else HostBatches(exp, POOL)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def row(spd, steps, mode, seconds):
        mix = steps * cfg.train.batch_size * cfg.segment_samples / cfg.dsp.sample_rate
        print(json.dumps({"preset": preset, "batch": cfg.train.batch_size,
                          "spd": spd, "steps": steps, "mode": mode,
                          "mix_s_per_s_per_chip": mix / seconds,
                          "ms_per_step": seconds / steps * 1e3}), flush=True)

    exp.run_steps(WARMUP_STEPS + 1, batches)  # eager warm-up, then the capture
    mode = "graphed" if exp.graphed else "eager"
    for spd in SPDS:
        n_disp = max(1, total // spd)
        sync()
        t0 = time.perf_counter()
        for _ in range(n_disp):
            exp.run_steps(spd, batches)
        sync()
        row(spd, n_disp * spd, mode, time.perf_counter() - t0)
    sync()
    t0 = time.perf_counter()
    for _ in range(total):
        exp._step(exp._step_data(batches))
    sync()
    row(1, total, "eager", time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
