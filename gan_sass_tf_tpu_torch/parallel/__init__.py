"""Data parallelism over a torch.distributed process group: the port's
counterpart of the JAX package's ('dcn', 'data') device mesh.  NCCL with
one rank a GPU on the card, gloo on the CPU; launched by torchrun."""

from gan_sass_tf_tpu_torch.parallel.bootstrap import (
    initialize_distributed,
    rank_device,
    run_in_group,
    shutdown_distributed,
)
from gan_sass_tf_tpu_torch.parallel.mesh import DataParallel, data_parallel, mesh_shape

__all__ = ["initialize_distributed", "rank_device", "run_in_group", "shutdown_distributed",
           "DataParallel", "data_parallel", "mesh_shape"]
