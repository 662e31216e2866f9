"""The train step captured once as a CUDA graph and replayed.

The counterpart of the JAX package's jitted, scanned dispatch
(`gan_sass_tf_tpu/train/experiment.py`, `train.steps_per_dispatch`): there
every step is one compiled executable and a dispatch scans K of them; here
the eager step's launches (about 1 000 to 5 000 a step, each with its host
time) are recorded once into a `torch.cuda.CUDAGraph`, and every later step
is one replay of it, with no host work in between.

    graphed = GraphedStep(train_step, state, bank, key)
    metrics = graphed.run(k)            # k train steps

  * The first `WARMUP_STEPS` steps run eagerly on a side stream: they
    build what the step memoises on its first calls (the kernels' tables
    and launch plans, the mel matrix, cuDNN's and cuBLAS's handles and
    workspaces, autograd's streams).  They are real steps.
  * Then one step is captured.  A capture runs none of the kernels it
    records, so it moves neither the state nor its counters: the step
    after it is the first replay.
  * Each replay reads the bank, the key and the state's tensors where they
    were at capture and updates the state in place; its metrics land in
    the same six tensors every time (`run` returns them).
  * A replay runs the kernels the eager step runs, in the same order, so
    K replays and K eager steps from one state give the same bits.

The step may read no number on the host: its step number and update
counts are 0-d device tensors and its train key a (2,) one
(`train/state.py`, `data/threefry.py`),
and whatever it builds from the host on a first call is memoised by the
warm-up.  What a capture cannot hold raises with its cause; there is no
quiet return to eager steps.  A state, bank or key replaced (rather than
copied into) needs a new GraphedStep: `Experiment` makes one when they are
not the ones it captured.  Under a process group of two or more ranks the
capture holds the step's NCCL all-reduces too; no run on more than one
GPU has checked that path yet, and a failed capture there says so.

Launch counts: a kernel wrapper called during a capture counts the launch
it records (`ops.dispatch.launch_counts`), and replays pass no wrapper.
`launch_correction()` is what to add to those counts for the kernels that
ran: the launches each capture recorded, times its replays, less the
recorded calls themselves.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from gan_sass_tf_tpu_torch.ops import dispatch

WARMUP_STEPS = 3

_recorded: Dict[str, int] = {}     # wrapper calls made while capturing
_replayed: Dict[str, int] = {}     # kernel launches made by replays


def launch_correction() -> Dict[str, int]:
    """Per kernel (`ops.dispatch.launch_counts`' names): the launches that
    replays made less the calls counted while capturing, since the last
    `reset_launch_correction()`."""
    return {k: _replayed.get(k, 0) - _recorded.get(k, 0)
            for k in dispatch.launch_counts()}


def reset_launch_correction() -> None:
    _recorded.clear()
    _replayed.clear()


class GraphedStep:
    """`train_step(state, data, key)` on CUDA tensors, eager for the first
    `warmup` steps, then captured once and replayed one step at a time."""

    def __init__(self, train_step: Callable, state, data: torch.Tensor,
                 key: torch.Tensor, warmup: int = WARMUP_STEPS, world: int = 1):
        if not data.is_cuda:
            raise ValueError(f"a CUDA graph needs CUDA tensors, got the data "
                             f"on {data.device}")
        self.train_step, self.state, self.data, self.key = (
            train_step, state, data, key)
        self.warmup, self.warm, self.world = warmup, 0, world
        self.graph = None
        self.metrics: Dict[str, torch.Tensor] = {}
        self.replays = 0
        self.per_replay: Dict[str, int] = {}    # kernel launches in one step
        self._side = torch.cuda.Stream(data.device)

    def holds(self, state, data: torch.Tensor, key: torch.Tensor) -> bool:
        """Whether this graph was captured on these very objects."""
        return self.state is state and self.data is data and self.key is key

    def run(self, n: int) -> Dict[str, torch.Tensor]:
        """Run `n` train steps; returns the last one's metrics (the graph's
        output tensors once it is captured: the next replay overwrites
        them)."""
        metrics = self.metrics
        while n and self.warm < self.warmup:
            metrics = self._eager()
            self.warm += 1
            n -= 1
        if n:
            if self.graph is None:
                self._capture()
            for _ in range(n):
                self.graph.replay()
            self.replays += n
            for k, v in self.per_replay.items():
                _replayed[k] = _replayed.get(k, 0) + v * n
            metrics = self.metrics
        return metrics

    def _eager(self) -> Dict[str, torch.Tensor]:
        main = torch.cuda.current_stream(self.data.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            _, metrics = self.train_step(self.state, self.data, self.key)
        main.wait_stream(self._side)
        return metrics

    def _capture(self) -> None:
        torch.cuda.synchronize(self.data.device)
        before = dispatch.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                _, metrics = self.train_step(self.state, self.data, self.key)
        except Exception as exc:
            where = (f" (under a process group of {self.world} ranks, which "
                     f"captures the NCCL all-reduces: a path not yet run on "
                     f"more than one GPU)" if self.world > 1 else "")
            raise RuntimeError(f"capturing the train step as a CUDA graph "
                               f"failed{where}: {exc}") from exc
        after = dispatch.launch_counts()
        self.per_replay = {k: after[k] - before[k] for k in after}
        for k, v in self.per_replay.items():
            _recorded[k] = _recorded.get(k, 0) + v
        self.graph, self.metrics = graph, metrics
