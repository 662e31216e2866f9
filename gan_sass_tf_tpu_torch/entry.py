"""Entry points of the port: the counterpart of `__graft_entry__.py`.

    from gan_sass_tf_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()                  # on the GPU; entry(device="cpu") on the CPU
    wavs = fn(*args)                    # (4, 2, T) separated sources
    dryrun_multichip(4)                 # one data-parallel step over 4 GPUs

entry() builds the `stream_v5e8` generator at full width, its weights
drawn from an explicit torch.Generator seeded 0 (`models.build_generator`),
and returns fn(g, mixture) -> (B, S, T) wavs, the separation graph (K1 ->
G -> K2, `train.build_separate_fn`), with its example arguments: that G
and a zero (4, T) mixture of one segment, as the JAX entry's are.  Like
the JAX fn(params, mixture), fn takes the weights (here the module) first.
"""

from __future__ import annotations

import sys

import torch

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.models import build_generator
from gan_sass_tf_tpu_torch.train.step import build_separate_fn

PRESET = "stream_v5e8"
SEED = 0


def entry(device="cuda"):
    """(fn, (g, mixture)) for the full-width stream_v5e8 separation graph on
    `device` (default cuda, which fails without a GPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry(): device cuda asked for, but no CUDA device "
                           "is visible (pass device='cpu' to run on the CPU)")
    cfg = config.get_config(PRESET)
    g = build_generator(cfg, device, seed=SEED)
    mixture = torch.zeros((4, cfg.segment_samples), dtype=torch.float32,
                          device=device)

    def fn(g: torch.nn.Module, mixture: torch.Tensor) -> torch.Tensor:
        return build_separate_fn(cfg, g)(mixture)

    return fn, (g, mixture)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """One data-parallel train step of a tiny stream_v5e8 over n_devices
    ranks (`parallel/dryrun.py`); raises SystemExit on failure."""
    from gan_sass_tf_tpu_torch.parallel import dryrun

    rc = dryrun.main(["--world", str(n_devices), "--device", device])
    if rc:
        raise SystemExit(rc)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry() forward ok:", tuple(out.shape), out.dtype)
    sys.exit(0)
