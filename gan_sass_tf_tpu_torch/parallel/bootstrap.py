"""Bring up the process group that torchrun describes.

Counterpart of `gan_sass_tf_tpu/parallel/bootstrap.py`.  torchrun starts
one process a rank and hands each its place in the environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); without that
environment there is nothing to join and the process runs on one device:

    initialize_distributed(device="cuda")     # False outside torchrun
    dp = data_parallel(cfg.mesh, cfg.train.batch_size)   # over that group

The backend follows the device: NCCL for CUDA, one rank a GPU
(`cuda:LOCAL_RANK`), gloo on the CPU.  A failed init raises; nothing falls
back to another backend or device.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(device="cuda") -> bool:
    """Join the process group of torchrun's environment: True once joined
    (also at world size 1, so that the card runs the collectives), False
    and no effect without that environment.  NCCL for a CUDA `device`
    (binding cuda:LOCAL_RANK first), gloo for the CPU."""
    env = os.environ
    if "RANK" not in env and "WORLD_SIZE" not in env:
        return False
    missing = [k for k in TORCHRUN_ENV if k not in env]
    if missing:
        raise RuntimeError(f"incomplete torchrun environment: {missing} unset")
    if dist.is_initialized():
        return True
    device = torch.device(device)
    kwargs = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda asked for, but no CUDA device is visible")
        local = torch.device("cuda", int(env["LOCAL_RANK"]))
        torch.cuda.set_device(local)
        kwargs["device_id"] = local        # NCCL connects now, and fails here
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://", rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]), **kwargs)
    return True


def rank_device(device) -> torch.device:
    """`device` for this rank: a CUDA device without an index becomes
    cuda:LOCAL_RANK inside a process group, anything else stays."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None and dist.is_initialized()
            and "LOCAL_RANK" in os.environ):
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def shutdown_distributed() -> None:
    """Destroy the default process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def run_in_group(device, run):
    """run(this rank's device) inside torchrun's process group when there
    is one, joined here and left after (a group the caller joined stays
    the caller's); else run(device)."""
    joined = not dist.is_initialized() and initialize_distributed(device=device)
    try:
        return run(rank_device(device))
    finally:
        if joined:
            shutdown_distributed()
