"""The data-parallel mesh as a torch.distributed process group.

Counterpart of `gan_sass_tf_tpu/parallel/mesh.py`.  The JAX package lays
its devices out as a ('dcn', 'data') mesh, shards the batch over both axes
and runs the train step under `shard_map` with explicit `pmean`s.  Here a
rank is one process on one device; the ranks are the mesh flattened row-
major over (dcn, data), so rank r holds global examples
[r·B_local, (r+1)·B_local), the rows the JAX `_shard_offset` gives its
shard.  Parameters and optimizer state are replicated: each rank holds them
whole and the collectives below keep them equal.

Two rules differ from `make_mesh`:
  * the mesh must span every rank (dcn × data == world size).  JAX leaves
    devices beyond a smaller mesh idle; a rank cannot sit out a collective,
    so the port refuses that mesh;
  * without a process group there is one device, whatever `cfg.mesh` asks
    for (a note says so), as the port ran before data parallelism.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_issued = 0        # collectives this process has issued through a DataParallel


def collectives_issued() -> int:
    """How many collectives this process has issued through a DataParallel
    (a CUDA graph capture that moves it holds one of the group's)."""
    return _issued


def _issue() -> None:
    global _issued
    _issued += 1


def mesh_shape(mesh_cfg, world: int) -> Tuple[int, int]:
    """(dcn, data) of `mesh_cfg` over `world` ranks; data_axis_size -1 (or
    0) takes every rank.  ValueError unless dcn × data == world."""
    dcn = mesh_cfg.dcn_axis_size
    data = mesh_cfg.data_axis_size
    if data in (-1, 0, None):
        data = world // dcn
    need = dcn * data
    if need != world:
        extra = ("" if need > world else
                 "; the mesh must span every rank (a rank cannot sit out a "
                 "collective)")
        raise ValueError(f"mesh needs {need} devices (dcn={dcn} × data={data}), "
                         f"have {world}{extra}")
    return dcn, data


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This rank's place in the mesh: the world size, the rank, the local
    batch (global batch / world) and the process group (None: one device,
    no collectives; every helper is then a no-op)."""

    world: int = 1
    rank: int = 0
    local_batch: int = 0
    group: Optional[dist.ProcessGroup] = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes files and prints."""
        return self.rank == 0

    def batch_rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch."""
        if global_batch % self.world:
            raise ValueError(f"batch {global_batch} is not divisible by the "
                             f"world size {self.world}")
        n = global_batch // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]) -> None:
        """Replace each tensor by its mean over the ranks, in place: one
        flattened bucket a dtype, summed over the ranks, then divided by
        the world size (the same arithmetic on NCCL and gloo)."""
        if self.group is None:
            return
        for flat, members in _buckets(tensors):
            _issue()
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            flat.div_(self.world)
            _unflatten(flat, members)

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Copy rank `src`'s values of the tensors into every rank's, in
        place (one bucket a dtype)."""
        if self.group is None:
            return
        for flat, members in _buckets(tensors):
            _issue()
            dist.broadcast(flat, src=src, group=self.group)
            _unflatten(flat, members)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x` concatenated along dim 0, in rank order."""
        if self.group is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        _issue()
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)

    def barrier(self) -> None:
        if self.group is not None:
            _issue()
            dist.barrier(group=self.group)


def _buckets(tensors: Sequence[torch.Tensor]):
    """[(flat copy, members)] of the tensors grouped by dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return [(torch.cat([t.detach().reshape(-1) for t in ts]), ts)
            for ts in by_dtype.values()]


@torch.no_grad()
def _unflatten(flat: torch.Tensor, members: Sequence[torch.Tensor]) -> None:
    at = 0
    for t in members:
        n = t.numel()
        t.copy_(flat[at:at + n].view_as(t))
        at += n


@functools.lru_cache(maxsize=None)
def _note_one_device(dcn: int, data: int) -> None:
    """Printed once a process for each mesh that runs on one device."""
    print(f"note: cfg.mesh is dcn={dcn} × data={data} = {dcn * data} devices; "
          "no process group (launch with torchrun for data parallelism), so "
          "this runs on 1 device", file=sys.stderr, flush=True)


def data_parallel(mesh_cfg, global_batch: int,
                  what: str = "global batch_size") -> DataParallel:
    """The DataParallel of the process group that `initialize_distributed`
    joined (one device when none was) for `mesh_cfg`, splitting
    `global_batch` over the ranks.  ValueError when the mesh is not the
    world or `global_batch` does not divide by it."""
    if not (dist.is_available() and dist.is_initialized()):
        dcn, data = mesh_cfg.dcn_axis_size, max(mesh_cfg.data_axis_size or 1, 1)
        if dcn * data != 1:          # data_axis_size -1 alone: every device, 1 here
            _note_one_device(dcn, data)
        return DataParallel(1, 0, global_batch, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh_shape(mesh_cfg, world)
    if global_batch % world:
        raise ValueError(f"{what} {global_batch} must be divisible by the mesh "
                         f"size {world} (dcn×data)")
    return DataParallel(world, rank, global_batch // world, dist.group.WORLD)
