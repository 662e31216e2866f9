"""The train step captured once as a CUDA graph and replayed.

The counterpart of the JAX package's jitted, scanned dispatch
(`gan_sass_tf_tpu/train/experiment.py`, `train.steps_per_dispatch`): there
every step is one compiled executable and a dispatch scans K of them; here
the eager step's launches (about 1 000 to 5 000 a step, each with its host
time) are recorded once into a `torch.cuda.CUDAGraph`, and every later step
is one replay of it, with no host work in between.

    graphed = GraphedStep(train_step, state, data, key)
    metrics = graphed.run(k)            # k train steps

  * The first `WARMUP_STEPS` steps run eagerly on a side stream: they
    build what the step memoises on its first calls (the kernels' tables
    and launch plans, the mel matrix, cuDNN's and cuBLAS's handles and
    workspaces, autograd's streams).  They are real steps.
  * Then one step is captured.  A capture runs none of the kernels it
    records, so it moves neither the state nor its counters: the step
    after it is the first replay.
  * Each replay reads the data, the key and the state's tensors where they
    were at capture and updates the state in place; its metrics land in
    the same six tensors every time (`run` returns them).  The data is the
    device bank, or in host-batch mode one static device batch that each
    host batch is copied into before its step (`Experiment.run_steps`).
  * A replay runs the kernels the eager step runs, in the same order, so
    K replays and K eager steps from one state give the same bits.

The step may read no number on the host: its step number and update
counts are 0-d device tensors and its train key a (2,) one
(`train/state.py`, `data/threefry.py`),
and whatever it builds from the host on a first call is memoised by the
warm-up.  What a capture cannot hold raises with its cause; there is no
quiet return to eager steps.  A state, data or key replaced (rather than
copied into) needs a new GraphedStep: `Experiment` makes one when they are
not the ones it captured.  Under a process group the capture holds the
step's NCCL all-reduces too, and the eval's its mean over the ranks (on
four H100s, replays give the eager group step's bits on every rank:
`chip_smoke.py --dp`).  NCCL, destroying a communicator, waits until
every graph that captured one of its collectives is gone, so
`parallel.shutdown_distributed` first drops those graphs
(`release_group_graphs`, its `before_shutdown` hook); graphs that hold no
collective, such as serving's, stay.

Serving and eval replay graphs too (`GraphedCall`, `GraphedFn`): the
counterpart of the JAX package's jitted `separate_fn_for`, its batched
streamer's chunk group, its scan streamer and `Experiment._eval_step`.
`GraphedFn(fn)` runs `fn` as `jax.jit` runs it: on CUDA inputs one
`GraphedCall` per (shapes, dtypes, device) of its inputs and the DSP
backend forced (`ops.dispatch.force_backend`), at most MEMO_SIZE of them,
the least recently used dropped first; on CPU inputs `fn` itself, eagerly.
As GraphedStep, a GraphedCall runs its first WARMUP_CALLS calls eagerly and
captures on the next, so a shape called once costs one eager call.
`GeneratorMemo` memoises such callables per (cfg, G) without keeping G
alive.  The eager functions stay what `build_separate_fn`,
`build_streaming_scan_fn` and `build_eval_step` return.

Host memory is pinned through `pin`, never while this process captures: a
capture (global mode) makes CUDA refuse unsafe calls from every thread, such
as the host allocations and event queries of page-locking, and the
host-batch producer pins in a thread of its own.  A thread that may free a
page-locked batch (its last reference) holds `capture_lock` to do so.

Launch counts: a kernel wrapper called during a capture counts the launch
it records (`ops.dispatch.launch_counts`), and replays pass no wrapper.
`launch_correction()` is what to add to those counts for the kernels that
ran: the launches each capture recorded, times its replays, less the
recorded calls themselves.  The warm-up calls before a capture are eager
launches and count as such.
"""

from __future__ import annotations

import collections
import functools
import threading
import weakref
from typing import Callable, Dict, Optional

import torch

from gan_sass_tf_tpu_torch.ops import dispatch
from gan_sass_tf_tpu_torch.parallel import bootstrap, mesh

WARMUP_STEPS = 3
WARMUP_CALLS = 2        # eager calls of a GraphedCall before its capture
MEMO_SIZE = 8           # entries a memo keeps, as the JAX package's lru_caches

_recorded: Dict[str, int] = {}     # wrapper calls made while capturing
_replayed: Dict[str, int] = {}     # kernel launches made by replays
_captures = 0                      # graphs captured by this process
_under_group: "weakref.WeakSet[_Captured]" = weakref.WeakSet()   # hold a collective
capture_lock = threading.Lock()    # held by a capture, and by `pin`


def captures() -> int:
    """The CUDA graphs this process has captured (GraphedStep and
    GraphedCall)."""
    return _captures


def launch_correction() -> Dict[str, int]:
    """Per kernel (`ops.dispatch.launch_counts`' names): the launches that
    replays made less the calls counted while capturing, since the last
    `reset_launch_correction()`."""
    return {k: _replayed.get(k, 0) - _recorded.get(k, 0)
            for k in dispatch.launch_counts()}


def reset_launch_correction() -> None:
    _recorded.clear()
    _replayed.clear()


def release_group_graphs() -> int:
    """Drop every CUDA graph that captured one of a process group's
    collectives, and return how many.  NCCL, destroying a communicator,
    waits until every such graph is gone, so `parallel.shutdown_distributed`
    calls this first (a `before_shutdown` hook).  A released capture raises
    if it is run again; graphs that hold no collective stay."""
    held = [c for c in _under_group if c.graph is not None]
    if held and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for c in held:
        c.graph, c.out, c.released = None, None, True
    _under_group.clear()
    return len(held)


bootstrap.before_shutdown(release_group_graphs)


def pin(x: torch.Tensor) -> torch.Tensor:
    """A copy of the CPU tensor `x` in page-locked memory, made while no
    graph is being captured: safe from any thread."""
    with capture_lock:
        return x.pin_memory()


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream a device for the eager steps before a capture: each
    new stream costs cuBLAS a workspace that lives as long as the process."""
    return torch.cuda.Stream(device)


class _Captured:
    """What GraphedStep and GraphedCall share: `fn` run eagerly for the
    first `warmup` calls (on the device's side stream with `side`, else on
    the current stream), then captured once (the launch counts it records,
    RuntimeError with its cause if it fails) and replayed (the launches the
    replays make)."""

    def __init__(self, fn: Callable, device: torch.device, warmup: int, what: str,
                 side: bool):
        self.fn, self.what, self.device = fn, what, device
        self.warmup, self.warm = warmup, 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None                          # the graph's output tensors
        self.replays = 0
        self.per_replay: Dict[str, int] = {}     # kernel launches in one replay
        self.released = False                    # by release_group_graphs
        self._side = _side_stream(device) if side else None

    def _eager(self, *args):
        self.warm += 1
        if self._side is None:
            return self.fn(*args)
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            out = self.fn(*args)
        main.wait_stream(self._side)
        return out

    def _capture(self, *args) -> None:
        global _captures
        self._check_held()
        torch.cuda.synchronize(self.device)
        before, issued = dispatch.launch_counts(), mesh.collectives_issued()
        graph = torch.cuda.CUDAGraph()
        try:
            with capture_lock, torch.cuda.graph(graph):
                out = self.fn(*args)
        except Exception as exc:
            raise RuntimeError(f"capturing {self.what} as a CUDA graph failed: "
                               f"{exc}") from exc
        after = dispatch.launch_counts()
        self.per_replay = {k: after[k] - before[k] for k in after}
        for k, v in self.per_replay.items():
            _recorded[k] = _recorded.get(k, 0) + v
        self.graph, self.out = graph, out
        _captures += 1
        if mesh.collectives_issued() != issued:
            _under_group.add(self)

    def _check_held(self) -> None:
        if self.released:
            raise RuntimeError(f"{self.what}: its CUDA graph was released with the "
                               "process group it was captured in")

    def _replay(self, n: int = 1) -> None:
        self._check_held()
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        for k, v in self.per_replay.items():
            _replayed[k] = _replayed.get(k, 0) + v * n


class GraphedStep(_Captured):
    """`train_step(state, data, key)` on CUDA tensors, eager for the first
    `warmup` steps, then captured once and replayed one step at a time.
    `data` is the device bank or the static host batch: what is copied into
    it before `run` (on the current stream) is what the next step reads."""

    def __init__(self, train_step: Callable, state, data: torch.Tensor,
                 key: torch.Tensor, warmup: int = WARMUP_STEPS, world: int = 1):
        if not data.is_cuda:
            raise ValueError(f"a CUDA graph needs CUDA tensors, got the data "
                             f"on {data.device}")
        where = (f" under a process group of {world} ranks, which captures the "
                 f"NCCL all-reduces" if world > 1 else "")
        super().__init__(lambda: train_step(state, data, key), data.device, warmup,
                         f"the train step{where}", side=True)
        self.state, self.data, self.key = state, data, key
        self.metrics: Dict[str, torch.Tensor] = {}

    def holds(self, state, data: torch.Tensor, key: torch.Tensor) -> bool:
        """Whether this graph was captured on these very objects."""
        return self.state is state and self.data is data and self.key is key

    def run(self, n: int) -> Dict[str, torch.Tensor]:
        """Run `n` train steps; returns the last one's metrics (the graph's
        output tensors once it is captured: the next replay overwrites
        them)."""
        metrics = self.metrics
        while n and self.warm < self.warmup:
            metrics = self._eager()[1]
            n -= 1
        if n:
            if self.graph is None:
                self._capture()
                self.metrics = self.out[1]
            self._replay(n)
            metrics = self.metrics
        return metrics


def _clone(out):
    """A fresh copy of a graph's output: a tensor or a dict of tensors."""
    if isinstance(out, dict):
        return {k: v.clone() for k, v in out.items()}
    return out.clone()


class GraphedCall(_Captured):
    """`fn(*args)` on CUDA tensors of static shapes: eager for the first
    `warmup` calls, then captured once and replayed.

    The warm-up calls are real calls on the current stream, each returning
    its own result, so a shape called once costs what the eager function
    costs; they build what `fn` memoises on its first calls (the
    kernels' tables and synthesis plans, the mel matrix, cuDNN's and
    cuBLAS's handles and workspaces).  The next call copies its inputs into
    buffers this object owns, captures one call on them and replays it;
    every later call copies and replays.  `__call__` returns fresh tensors
    (one device copy of a replay's outputs), which the next replay cannot
    overwrite; `run` returns a replay's own output tensors, valid until the
    next replay.

    The graph reads `fn`'s weights where they were at capture: a
    `load_state_dict` copies into that storage and the next replay uses
    the new weights (an EMA copy loaded into the eval G too); a parameter
    replaced by another tensor is not seen.  `fn` may read no number on
    the host that changes between calls.  A capture that fails raises
    RuntimeError with its cause; there is no quiet return to eager calls.
    """

    def __init__(self, fn: Callable, *args: torch.Tensor, warmup: int = WARMUP_CALLS):
        where = sorted({str(a.device) if isinstance(a, torch.Tensor) else type(a).__name__
                        for a in args if not (isinstance(a, torch.Tensor) and a.is_cuda)})
        if not args or where:
            raise ValueError(f"a CUDA graph needs CUDA tensors, got "
                             f"{', '.join(where) or 'no tensor'}")
        inner = getattr(fn, "func", fn)           # a functools.partial's function
        super().__init__(fn, args[0].device, warmup,
                         getattr(inner, "__qualname__", type(inner).__name__), side=False)
        with torch.inference_mode(False):     # loadable outside inference mode
            self.static = [torch.empty_like(a) for a in args]

    def load(self, *args: torch.Tensor) -> None:
        """Copy `args` into the input buffers."""
        if len(args) != len(self.static):
            raise ValueError(f"{self.what}: {len(args)} arguments, captured "
                             f"with {len(self.static)}")
        with torch.no_grad():
            for buf, a in zip(self.static, args):
                if a.shape != buf.shape or a.dtype != buf.dtype:
                    raise ValueError(f"{self.what}: an argument {tuple(a.shape)} "
                                     f"{a.dtype}, captured at {tuple(buf.shape)} "
                                     f"{buf.dtype}")
                buf.copy_(a)

    def run(self, *args: torch.Tensor):
        """One call on `args`: a warm-up call's own result, else one replay
        (the capture first, on the call after the warm-up) and the graph's
        output tensors."""
        if self.warm < self.warmup:
            return self._eager(*args)
        self.load(*args)
        if self.graph is None:
            self._capture(*self.static)
        self._replay()
        return self.out

    def __call__(self, *args: torch.Tensor):
        out = self.run(*args)
        return _clone(out) if out is self.out else out


def signature(*args: torch.Tensor) -> tuple:
    """What a capture of a call on `args` is specific to: the DSP backend
    forced (`ops.dispatch.force_backend`) and each argument's shape, dtype
    and device."""
    return (dispatch.backend(),) + tuple(
        (tuple(a.shape), a.dtype, a.device) for a in args)


class LRU(collections.OrderedDict):
    """At most `maxsize` entries, the least recently used dropped first."""

    def __init__(self, maxsize: int = MEMO_SIZE):
        super().__init__()
        self.maxsize = maxsize

    def get_or_make(self, key, make: Callable):
        value = self.pop(key) if key in self else make()
        self[key] = value
        while len(self) > self.maxsize:
            self.popitem(last=False)
        return value


class GraphedFn:
    """`fn(*args)` as `jax.jit` runs a function: on CUDA tensors one
    GraphedCall per (shapes, dtypes, device) of `args` and the DSP backend
    forced, at most `maxsize` of them (the least recently used is dropped
    with its graph); on CPU tensors `fn` itself, eagerly."""

    def __init__(self, fn: Callable, maxsize: int = MEMO_SIZE):
        self.fn = fn
        self.graphs = LRU(maxsize)

    def graph_for(self, *args: torch.Tensor) -> GraphedCall:
        """The GraphedCall of `args`' signature, made if there is none."""
        return self.graphs.get_or_make(signature(*args),
                                       lambda: GraphedCall(self.fn, *args))

    def __call__(self, *args: torch.Tensor):
        if not args[0].is_cuda:
            return self.fn(*args)
        return self.graph_for(*args)(*args)


class GeneratorMemo:
    """`make(cfg, g, *rest)` memoised per (cfg, G, *rest), at most
    `maxsize` entries with the least recently used dropped first, as the
    JAX package's `functools.lru_cache(maxsize=8)` memoises its jitted
    functions, but holding G weakly: `make` is given a `weakref.proxy` of
    G, and when G is gone so are its entries, with their graphs and memory
    pools."""

    def __init__(self, make: Callable, maxsize: int = MEMO_SIZE):
        functools.update_wrapper(self, make)
        self.make = make
        self.entries = LRU(maxsize)

    def __call__(self, cfg, g, *rest):
        if g is None:                       # no G (a stubbed separation)
            return self.entries.get_or_make((cfg, None, *rest),
                                            lambda: self.make(cfg, None, *rest))
        key = (cfg, weakref.ref(g, self._forget), *rest)
        return self.entries.get_or_make(
            key, lambda: self.make(cfg, weakref.proxy(g), *rest))

    def _forget(self, ref: weakref.ref) -> None:
        for key in [k for k in self.entries if k[1] is ref]:
            del self.entries[key]

    def cache_clear(self) -> None:
        self.entries.clear()
