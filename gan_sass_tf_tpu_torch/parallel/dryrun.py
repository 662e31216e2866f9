"""One data-parallel train step of a tiny config over N ranks: the port's
`dryrun_multichip` (`__graft_entry__.py`).

    python -m gan_sass_tf_tpu_torch.parallel.dryrun --world 4
    python -m gan_sass_tf_tpu_torch.parallel.dryrun --world 2 --device cpu

spawns N ranks (NCCL with one GPU a rank, the default; gloo on the CPU
with --device cpu), joins them through a file store in a temporary
directory, runs one step of `stream_v5e8` cut to n_fft 128, 0.05 s
segments and G/D (8, 16) at global batch N, and prints `dryrun_multichip(N): ok — metrics {...}` from rank 0.
Any rank's failure exits non-zero; a CUDA run without N visible GPUs
fails before spawning.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import math
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gan_sass_tf_tpu_torch import config


def tiny_config(batch_size: int):
    """stream_v5e8 cut as the JAX dryrun cuts it, the mesh over every rank."""
    cfg = config.get_config("stream_v5e8")
    return cfg.replace(
        dsp=dataclasses.replace(cfg.dsp, n_fft=128, hop_length=32, win_length=128),
        train=dataclasses.replace(cfg.train, batch_size=batch_size),
        data=dataclasses.replace(cfg.data, segment_seconds=0.05),
        model=dataclasses.replace(cfg.model, g_channels=(8, 16), d_channels=(8, 16)),
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1))


def _rank(rank: int, world: int, device: str, store: str) -> None:
    from gan_sass_tf_tpu_torch.parallel.bootstrap import shutdown_distributed
    from gan_sass_tf_tpu_torch.train import Experiment

    dev = torch.device(device)
    kwargs = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300), **kwargs)
    try:
        exp = Experiment(tiny_config(world), device=dev)
        metrics = exp.train(num_steps=1)
        if exp.state.step != 1:
            raise RuntimeError(f"rank {rank}: step {int(exp.state.step)} after "
                               "one step")
        bad = [k for k, v in metrics.items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"rank {rank}: non-finite {bad}: {metrics}")
        if rank == 0:
            shown = {k: round(v, 4) for k, v in metrics.items()
                     if k != "mixture_sec_per_sec"}
            print(f"dryrun_multichip({world}): ok — metrics {shown}", flush=True)
    finally:
        shutdown_distributed()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gan_sass_tf_tpu_torch.parallel.dryrun")
    p.add_argument("--world", type=int, default=2, help="number of ranks")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = p.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"error: --device cuda --world {args.world} needs {args.world} "
              f"CUDA devices, {torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(args.world, args.device, os.path.join(tmp, "store")),
                           nprocs=args.world, join=True, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
