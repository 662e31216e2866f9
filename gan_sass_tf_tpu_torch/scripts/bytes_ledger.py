"""FLOPs and HBM bytes of one train step, by the step's ranges: the port's
counterpart of `scripts/bytes_ledger.py` (the HLO entry ledger) and of the
`cost_analysis()` that `scripts/roofline.py` reads.

    python -m gan_sass_tf_tpu_torch.scripts.bytes_ledger [preset ...]
        [--batch B] [--set sec.key=val ...] [--device cuda]

For each preset (default: all five) one eager train step is counted after
one uncounted step (which fills the step's per-device caches), on synthetic
data at the preset's batch or B.  Prints the GB and GFLOP a step by range,
the top ops by bytes in each range and the hand-written kernels' charges,
then one JSON line a preset.  It runs on the card unless `--device cpu` is
given; one configuration gives the same count on both.

How a step is counted.  PyTorch runs the step eagerly, one launch an op, so
the count is of the ops as the dispatcher sees them, under a
`TorchDispatchMode` (backward ops included: autograd runs them below it):

  * FLOPs: convolutions, their backward and matmuls, by the rules of
    `torch.utils.flop_counter`'s registry; elementwise work is not counted
    (XLA's `cost_analysis` counts it: ~2 % of a narrow step).
  * Bytes: each op is charged its tensor operands plus its outputs, each
    tensor once (an expanded operand its stored elements); views (`view`,
    `detach`, `t`, `expand`, `permute`, ...) and allocations are free; an
    in-place op charges the tensor it writes once, beside its other
    operands; a copy or a cast charges a read and a write.  Eager PyTorch
    does not fuse and the captured graph replays the same launches, so the
    sum is the unfused traffic the step launches.  It has no lane padding:
    where the JAX ledger reports physical (tiled) bytes, this one's bytes
    are logical and physical at once.
  * `torch.lstm` is charged once a call from its gate GEMMs' shapes (under
    a `TorchFunctionMode` that sees the call before it decomposes: on the
    card it reaches the dispatcher as `_cudnn_rnn`, on the CPU as oneDNN's
    `mkldnn_rnn_layer` or, with oneDNN off, its gate matmuls), forward and
    backward as the CPU's decomposition computes them: each weight's
    gradient, the input's where the input needs one, the carry's from the
    second step on.  Its bytes are its operands and outputs (backward: the
    incoming gradients, the operands and outputs again, the gradients out).
  * The hand-written kernels (K1-K4, K3's adjoint, the threefry launches)
    run through ctypes, not the dispatcher.  Their `ops.dispatch` entry
    points are wrapped while counting: each launch is charged its bytes
    and operations from its shapes (`ops/cost.py`) and counted, and the
    aten ops of the plain version on the CPU (or of the wrapper on the
    card) are not counted.  K3's backward is charged to the `dsp` range,
    where `ops/istft.py` runs it.
  * Attribution: each op goes to the innermost range of
    `utils/profiler.STEP_RANGES` open where it runs (read from the
    `record_function` enter and exit ops the dispatcher sees; autograd's
    backward runs while `torch.autograd.grad` waits inside its range), or
    to "other".

What it cannot see: work that one aten op launches inside itself beyond
its operands and output.  On the card cuDNN transposes NCHW tensors to
NHWC and back around a convolution, inside the one `convolution` op the
ledger charges once; cuBLAS's and cuDNN's split-K reductions and
workspaces likewise.  `scripts/roofline.py --profile` measures the device
time of those kernels a step.  The JAX ledger's caveat, a while loop's body
charged once, does not arise: eager PyTorch launches every trip.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.cli import _apply_overrides
from gan_sass_tf_tpu_torch.ops import cost, dispatch
from gan_sass_tf_tpu_torch.ops import threefry as rng_ops
from gan_sass_tf_tpu_torch.scripts import split_args
from gan_sass_tf_tpu_torch.scripts.quality_protocol import device_or_exit
from gan_sass_tf_tpu_torch.utils.profiler import STEP_RANGES

OTHER = "other"
# Ops that move no data: allocations, and views the schema does not mark
# as aliasing.
FREE_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "_unsafe_view", "unsafe_split",
            "unsafe_split_with_sizes", "unsafe_chunk", "lift_fresh",
            "_record_function_enter_new", "_record_function_enter",
            "_record_function_exit"}
# Ops that read only their operand's shape: charged their output alone.
SHAPE_ONLY_OPS = {"ones_like", "zeros_like", "full_like", "rand_like", "randn_like",
                  "randint_like", "new_zeros", "new_ones", "new_full"}
RANGE_ENTER = ("_record_function_enter_new", "_record_function_enter")
RANGE_EXIT = "_record_function_exit"
# The narrow configurations of tests/test_torch_train.py (`_cfg("wav")` and
# `_narrow_preset("wsj0_logmel", (8, 16))`) as --set overrides: f32, G and D
# levels (8, 16), batch 2, 0.25 s, no dropout, gain jitter, noise sources
# or instance noise.  chip_smoke.py counts them on the CPU and the card.
_NARROW = ["model.g_channels=8,16", "model.d_channels=8,16",
           "model.compute_dtype=float32", "model.dropout=0.0",
           "train.batch_size=2", "train.d_instance_noise=0.0",
           "data.segment_seconds=0.25", "data.gain_jitter_db=0.0",
           "data.num_noise=0", "data.bank_utterances=4"]
NARROW = {"stream_v5e8": _NARROW + ["loss.recon_domain=wav"],
          "wsj0_logmel": _NARROW}


def nbytes(t) -> int:
    """Bytes of a tensor's stored elements (an expanded dim's once)."""
    if not isinstance(t, torch.Tensor) or t.numel() == 0:
        return 0
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _key(t: torch.Tensor):
    return (t.device, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)


def _unique(tensors, skip=()) -> List[torch.Tensor]:
    seen, out = set(skip), []
    for t in tensors:
        k = _key(t)
        if k not in seen:
            seen.add(k)
            out.append(t)
    return out


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes an aten op is charged: its tensor operands plus its outputs,
    each once; a written operand (in place, `out=`) once as what it writes;
    views and allocations nothing; `ones_like` and its kin their output."""
    name = func._overloadpacket.__name__
    if func.is_view or name in FREE_OPS:
        return 0
    if name in SHAPE_ONLY_OPS:
        return sum(nbytes(t) for t in _unique(_tensors(out)))
    written, read = [], []
    for i, arg in enumerate(func._schema.arguments):
        if arg.kwarg_only or i >= len(args):
            val = kwargs.get(arg.name)
        else:
            val = args[i]
        alias = arg.alias_info
        (written if alias is not None and alias.is_write else read).extend(_tensors(val))
    written = _unique(written + _tensors(out))
    read = _unique(read, skip={_key(t) for t in written})
    return sum(nbytes(t) for t in written + read)


def op_flops(func, args, kwargs, out) -> int:
    """torch.utils.flop_counter's count of a convolution, its backward or a
    matmul; 0 for any other op."""
    rule = flop_registry.get(func._overloadpacket)
    return int(rule(*args, **kwargs, out_val=out)) if rule is not None else 0


@dataclasses.dataclass
class Ledger:
    """One counted stretch of work: bytes and flops by range and by
    (range, op), and the hand-written kernels' launches and charges."""

    bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    flops: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    op_bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    op_flops: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    op_calls: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    _ranges: list = dataclasses.field(default_factory=list)
    _quiet: int = 0

    # -- the state while counting -------------------------------------
    def range(self) -> str:
        """The innermost open range of STEP_RANGES, else "other"."""
        for _, name in reversed(self._ranges):
            if name in STEP_RANGES:
                return name
        return OTHER

    @contextlib.contextmanager
    def quiet(self):
        """Count no aten op inside (a kernel's plain version or wrapper)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def add(self, rng: str, op: str, nbytes_: float, flops: float) -> None:
        self.bytes[rng] += nbytes_
        self.flops[rng] += flops
        self.op_bytes[(rng, op)] += nbytes_
        self.op_flops[(rng, op)] += flops
        self.op_calls[(rng, op)] += 1

    def op(self, func, args, kwargs, out) -> None:
        """Track a range enter or exit; else charge the op (unless quiet)."""
        name = func._overloadpacket.__name__
        if func.namespace == "profiler":
            if name in RANGE_ENTER:
                self._ranges.append((id(out), args[0]))
            elif name == RANGE_EXIT:      # the latest range of that handle
                at = [i for i, (h, _) in enumerate(self._ranges) if h == id(args[0])]
                if at:
                    del self._ranges[at[-1]]
            return
        if self._quiet:
            return
        self.add(self.range(), f"aten.{name}", op_bytes(func, args, kwargs, out),
                 op_flops(func, args, kwargs, out))

    def kernel(self, name: str, c: cost.Cost, rng: Optional[str] = None) -> None:
        """Charge one launch of the hand-written kernel `name`."""
        row = self.kernels.setdefault(name, {"launches": 0, "bytes": 0.0,
                                             "flops": 0.0, "int_ops": 0.0})
        row["launches"] += 1
        row["bytes"] += c.bytes
        row["flops"] += c.flops
        row["int_ops"] += c.int_ops
        self.add(rng or self.range(), f"kernel {name}", c.bytes, c.flops)

    # -- the totals ----------------------------------------------------
    def total_bytes(self) -> float:
        return float(sum(self.bytes.values()))

    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    def kernel_bytes(self) -> float:
        return float(sum(r["bytes"] for r in self.kernels.values()))

    def kernel_flops(self) -> float:
        return float(sum(r["flops"] for r in self.kernels.values()))

    def launches(self) -> Dict[str, int]:
        return {k: int(r["launches"]) for k, r in self.kernels.items()}

    def top_ops(self, rng: str, n: int = 8) -> list:
        """(op, bytes, flops, calls) of the range's top `n` ops by bytes."""
        rows = [(op, b, self.op_flops[(r, op)], self.op_calls[(r, op)])
                for (r, op), b in self.op_bytes.items()
                if r == rng and (b or self.op_flops[(r, op)])]
        return sorted(rows, key=lambda row: -row[1])[:n]

    def summary(self) -> dict:
        """The JSON fields: totals, by range, the top ops a range, kernels."""
        order = sorted(self.bytes, key=lambda r: -self.bytes[r])
        return {
            "ledger_gb_per_step": self.total_bytes() / 1e9,
            "ledger_gflops_per_step": self.total_flops() / 1e9,
            "kernel_gb_per_step": self.kernel_bytes() / 1e9,
            "kernel_gflops_per_step": self.kernel_flops() / 1e9,
            "buckets_gb": {r: self.bytes[r] / 1e9 for r in order},
            "buckets_gflops": {r: self.flops[r] / 1e9 for r in order},
            "top_ops_gb": {r: {op: b / 1e9 for op, b, _, _ in self.top_ops(r)}
                           for r in order},
            "kernels": {k: {"launches": int(v["launches"]), "gb": v["bytes"] / 1e9,
                            "gflops": v["flops"] / 1e9, "int_gops": v["int_ops"] / 1e9}
                        for k, v in sorted(self.kernels.items())},
        }


class _CountingMode(TorchDispatchMode):
    def __init__(self, ledger: Ledger):
        super().__init__()
        self.ledger = ledger

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ledger.op(func, args, kwargs, out)
        return out


@dataclasses.dataclass
class _Call:
    """A charged call: `fn` on the inputs, its charge forward and its
    backward's, each a function of (inputs, outputs[, gradients])."""

    ledger: Ledger
    fn: Callable
    forward: Callable
    backward: Optional[Callable] = None
    linear: bool = True        # in its differentiable inputs (double backward)


class _Charged(torch.autograd.Function):
    """`call.fn` on the inputs, none of its aten ops counted, charged by
    `call.forward`; its backward the inner graph's, charged by
    `call.backward` and counted no more."""

    @staticmethod
    def forward(ctx, call, *xs):
        needs = ctx.needs_input_grad[1:]
        with call.ledger.quiet(), torch.enable_grad():
            leaves = [x.detach().requires_grad_() if need else x
                      for x, need in zip(xs, needs)]
            outs = call.fn(*leaves)
        single = isinstance(outs, torch.Tensor)
        outs = (outs,) if single else tuple(outs)
        call.forward(xs, outs)
        ctx.call, ctx.leaves, ctx.outs, ctx.needs = call, leaves, outs, needs
        res = tuple(o.detach() if isinstance(o, torch.Tensor) else o for o in outs)
        return res[0] if single else res

    @staticmethod
    def backward(ctx, *gys):
        call, outs = ctx.call, ctx.outs
        wrt = [x for x, need in zip(ctx.leaves, ctx.needs) if need]
        used = [i for i, o in enumerate(outs)
                if isinstance(o, torch.Tensor) and o.requires_grad]

        def grads(*g):
            return torch.autograd.grad([outs[i] for i in used], wrt, list(g),
                                       allow_unused=True,
                                       create_graph=torch.is_grad_enabled())

        def charge(gs, got):
            if call.backward is not None:
                call.backward(wrt, outs, gs, got)

        gin = [gys[i] for i in used]
        if torch.is_grad_enabled():
            # create_graph: the backward is itself a charged call, so that a
            # double backward (R1 through dropout) is charged, not counted.
            if not call.linear:
                raise NotImplementedError("a double backward through a charged "
                                          "call that is not linear in its input")
            got = _Charged.apply(_Call(call.ledger, grads, charge, call.backward), *gin)
            got = (got,) if isinstance(got, torch.Tensor) else got
        else:
            with call.ledger.quiet():
                got = grads(*gin)
            if call.backward is not None:
                call.backward(wrt, outs, gin, got)
        it = iter(got)
        return (None, *(next(it) if need else None for need in ctx.needs))


def _charged(ledger: Ledger, fn, xs, forward, backward=None, linear=True):
    """fn(*xs) charged: through `_Charged` where autograd would record it,
    else run quietly and charged forward."""
    if torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                       for x in xs):
        return _Charged.apply(_Call(ledger, fn, forward, backward, linear), *xs)
    with ledger.quiet():
        out = fn(*xs)
    forward(xs, (out,) if isinstance(out, torch.Tensor) else tuple(out))
    return out


# -- the hand-written kernels' charges ---------------------------------------

def _rows(t: torch.Tensor, inner: int) -> int:
    return math.prod(t.shape[:t.dim() - inner])


def _wrappers(ledger: Ledger) -> Dict[str, Callable]:
    """The `ops.dispatch` names to replace while counting: each runs the
    original quietly and charges one launch of its kernel's cost."""
    orig = {name: getattr(dispatch, name) for name in (
        "stft_features_kernel", "stft_features_reference", "stft_kernel",
        "stft_reference", "masked_istft_kernel", "masked_istft_reference",
        "istft_ri_kernel", "_plain_istft", "step_batch", "draw", "dropout",
        "instance_noise")}

    def quiet_call(name, fn, c):
        def run(*args, **kwargs):
            with ledger.quiet():
                out = fn(*args, **kwargs)
            ledger.kernel(name, c(*args, **kwargs))
            return out
        return run

    def k1_cost(x, n_fft, hop, window="hann", emit=("spec",), mel_matrix=None, eps=1e-8):
        n_mels = mel_matrix.shape[1] if "logmel" in emit else 0
        return cost.stft_features(_rows(x, 1), x.shape[-1], n_fft, hop, emit, n_mels)

    def k4_cost(x, n_fft, hop, window="hann"):
        return cost.stft(_rows(x, 1), x.shape[-1], n_fft, hop)

    def k2_cost(spec, masks, n_fft, hop, window="hann", mask_type="magnitude", *_, **__):
        return cost.masked_istft(_rows(spec, 2), masks.shape[spec.dim() - 2],
                                 spec.shape[-2], n_fft, hop, mask_type)

    def k3(fn, inner):
        # K3 forward on a (..., F, K, 2) or complex (..., F, K) spectrum; its
        # adjoint backward, in the dsp range where ops/istft.py runs it.
        def run(spec, n_fft, hop, *args, **kwargs):
            rows, f = _rows(spec, inner), spec.shape[-inner]
            return _charged(
                ledger, lambda s: fn(s, n_fft, hop, *args, **kwargs), (spec,),
                lambda xs, outs: ledger.kernel("istft", cost.istft(rows, f, n_fft, hop)),
                lambda wrt, outs, g, got: ledger.kernel(
                    "istft_bwd", cost.istft_adjoint(rows, f, n_fft, hop), "dsp"))
        return run

    def dropout(x, key, fold, p, dims):
        # Forward the cipher kernel; backward (and R1's double backward) the
        # mask kernel, which reads the forward's packed mask.
        n, item = x.numel(), x.element_size()
        return _charged(
            ledger, lambda xx: orig["dropout"](xx, key, fold, p, dims), (x,),
            lambda xs, outs: ledger.kernel("threefry_dropout", cost.dropout(n, item)),
            lambda wrt, outs, g, got: ledger.kernel("threefry_dropout_bwd",
                                                    cost.dropout_mask(n, item)))

    def step_batch(key, data, gain_db, snr_db=None, offset=0, step=None, bank_batch=0,
                   shard=0, d_steps=0):
        # The batch launch, and under noise the noise launch.
        with ledger.quiet():
            out = orig["step_batch"](key, data, gain_db, snr_db, offset, step,
                                     bank_batch, shard, d_steps)
        b, s, t = out.scaled.shape
        noise, tiles = snr_db is not None, rng_ops.batch_tiles(t)
        ledger.kernel("threefry_batch", cost.batch(b, s, t, tiles, bank_batch > 0,
                                                   step is not None, noise, d_steps))
        if noise:
            ledger.kernel("threefry_batch_noise", cost.batch_noise(b, t, tiles))
        return out

    return {
        **{name: quiet_call("stft_features", orig[name], k1_cost)
           for name in ("stft_features_kernel", "stft_features_reference")},
        **{name: quiet_call("stft", orig[name], k4_cost)
           for name in ("stft_kernel", "stft_reference")},
        **{name: quiet_call("masked_istft", orig[name], k2_cost)
           for name in ("masked_istft_kernel", "masked_istft_reference")},
        "istft_ri_kernel": k3(orig["istft_ri_kernel"], 3),
        "_plain_istft": k3(orig["_plain_istft"], 2),
        "step_batch": step_batch,
        "draw": quiet_call(
            "threefry_sample", orig["draw"],
            lambda keys, n, kind, lo=0.0, hi=1.0: cost.sample(keys.shape[0], n, kind)),
        "dropout": dropout,
        # The noise's gradient passes as it is: no launch, no op.
        "instance_noise": quiet_call(
            "threefry_noise", orig["instance_noise"],
            lambda x, key, std: cost.noise(x.numel(), x.element_size())),
    }


# -- torch.lstm --------------------------------------------------------------

def lstm_flops(x, hx, params, has_biases, num_layers, bidirectional,
               batch_first):
    """(forward, backward) flops of a torch.lstm call: its gate GEMMs, the
    input's over the whole sequence and the carry's a step, as the CPU's
    decomposition runs them; backward each weight's gradient (where it
    needs one), the input's (where it needs one) and the carry's (from the
    second step on, and at the first where the initial state needs one)."""
    n_dir, per = (2 if bidirectional else 1), (4 if has_biases else 2)
    if len(params) != num_layers * n_dir * per:
        raise NotImplementedError(f"lstm with {len(params)} parameter tensors "
                                  f"(a projection?)")
    t, b = (x.shape[1], x.shape[0]) if batch_first else (x.shape[0], x.shape[1])
    h = hx[0].shape[-1]
    g = 4 * h
    fwd = bwd = 0
    in_grad = x.requires_grad
    state_grad = any(s.requires_grad for s in hx)
    for layer in range(num_layers):
        width = x.shape[-1] if layer == 0 else n_dir * h
        out_grad = False
        for d in range(n_dir):
            w = params[(layer * n_dir + d) * per:(layer * n_dir + d + 1) * per]
            fwd += 2 * b * t * width * g + 2 * b * t * h * g
            carry_grad = in_grad or state_grad or any(p.requires_grad for p in w)
            if w[0].requires_grad:
                bwd += 2 * b * t * width * g
            if in_grad:
                bwd += 2 * b * t * g * width
            if w[1].requires_grad:
                bwd += t * 2 * b * h * g
            if carry_grad:
                bwd += ((t - 1) + (1 if hx[0].requires_grad else 0)) * 2 * b * g * h
            out_grad = out_grad or carry_grad
        in_grad = out_grad
    return fwd, bwd


class _LstmMode(TorchFunctionMode):
    """Charges each `torch.lstm` call by `lstm_flops` and counts none of the
    ops it decomposes into."""

    def __init__(self, ledger: Ledger):
        super().__init__()
        self.ledger = ledger

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch._C._VariableFunctions.lstm:
            return func(*args, **kwargs)
        if isinstance(args[1], torch.Tensor):
            raise NotImplementedError("the ledger charges padded lstm calls only")
        x, hx, params, has_biases, num_layers, dropout, train, bidir, batch_first = args
        fwd, bwd = lstm_flops(x, hx, params, has_biases, num_layers, bidir, batch_first)
        ledger, hx, params = self.ledger, list(hx), list(params)
        n_hx = len(hx)

        def fn(xx, *rest):
            return torch.lstm(xx, tuple(rest[:n_hx]), list(rest[n_hx:]), has_biases,
                              num_layers, dropout, train, bidir, batch_first)

        def io_bytes(tensors):
            return sum(nbytes(t) for t in _unique(_tensors(tensors)))

        def forward(xs, outs):
            ledger.add(ledger.range(), "lstm", io_bytes(xs) + io_bytes(outs), fwd)

        def backward(wrt, outs, gys, grads):
            ledger.add(ledger.range(), "lstm backward",
                       io_bytes([x, hx, params]) + io_bytes(outs) + io_bytes(gys)
                       + io_bytes([gr for gr in grads if gr is not None]), bwd)

        return _charged(ledger, fn, (x, *hx, *params), forward, backward, linear=False)


@contextlib.contextmanager
def counting(ledger: Ledger, lstm_rule: bool = True):
    """Count the enclosed work into `ledger`: the dispatcher's ops, torch.lstm
    by its rule (or, with lstm_rule=False, by the ops it decomposes into),
    and each hand-written kernel by its cost."""
    swaps = _wrappers(ledger)
    saved = {name: getattr(dispatch, name) for name in swaps}
    for name, fn in swaps.items():
        setattr(dispatch, name, fn)
    try:
        with (_LstmMode(ledger) if lstm_rule else contextlib.nullcontext()), \
                _CountingMode(ledger):
            yield ledger
    finally:
        for name, fn in saved.items():
            setattr(dispatch, name, fn)


def count(fn: Callable, *args, lstm_rule: bool = True):
    """(Ledger, fn's result) of one call fn(*args) counted."""
    ledger = Ledger()
    with counting(ledger, lstm_rule):
        out = fn(*args)
    return ledger, out


# -- the step of a preset ----------------------------------------------------

def experiment_config(preset: str, batch: Optional[int] = None,
                      overrides: Sequence[str] = ()):
    """The preset on synthetic data (music with its slot profiles), on one
    mesh axis of every device, at `batch`, with the --set overrides (the JAX
    roofline's configuration, `scripts/roofline.py:41-60`)."""
    cfg = config.get_config(preset)
    data_kw = {"dataset": "synthetic"}
    if preset == "music_complex_44k":
        data_kw["slot_profiles"] = ("vocal", "accomp")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, **data_kw),
                      mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1))
    if batch is not None:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=batch))
    return _apply_overrides(cfg, list(overrides))


def step_ledger(exp, warm: bool = True) -> Ledger:
    """One eager train step of `exp` counted, after one uncounted step where
    `warm` (the step's per-device tables are built at its first call)."""
    if warm:
        exp._train_step(exp.state, exp._step_data(), exp._train_key)
    data = exp._step_data()
    ledger, _ = count(exp._train_step, exp.state, data, exp._train_key)
    if exp.device.type == "cuda":
        torch.cuda.synchronize(exp.device)
    return ledger


def print_table(preset: str, batch: int, ledger: Ledger, out=sys.stdout) -> None:
    total = ledger.total_bytes()
    print(f"{preset} batch={batch}: {total / 1e6:.3f} MB/step, "
          f"{ledger.total_flops() / 1e6:.3f} MFLOP/step (kernels "
          f"{ledger.kernel_bytes() / 1e6:.3f} MB, {ledger.kernel_flops() / 1e6:.3f} MFLOP)",
          file=out)
    for rng in sorted(ledger.bytes, key=lambda r: -ledger.bytes[r]):
        b = ledger.bytes[rng]
        print(f"  {b / 1e6:12.3f} MB {100 * b / max(total, 1):5.1f}%  "
              f"{ledger.flops[rng] / 1e6:12.3f} MFLOP  {rng}", file=out)
        for op, ob, of, n in ledger.top_ops(rng):
            print(f"      {ob / 1e6:12.3f} MB  {of / 1e6:12.3f} MFLOP  x{n:<5d} {op}",
                  file=out)
    for name, row in sorted(ledger.kernels.items()):
        print(f"  kernel {name}: {int(row['launches'])} launches, "
              f"{row['bytes'] / 1e6:.3f} MB, {row['flops'] / 1e6:.3f} MFLOP, "
              f"{row['int_ops'] / 1e6:.3f} M int ops", file=out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    presets, opts = split_args(argv, ("--set", "--device", "--batch"))
    dev = device_or_exit((opts["--device"] or ["cuda"])[-1])
    batch = int(opts["--batch"][-1]) if opts["--batch"] else None

    from gan_sass_tf_tpu_torch.train import Experiment

    for preset in presets or config.list_configs():
        cfg = experiment_config(preset, batch, opts["--set"])
        exp = Experiment(cfg, workdir=None, device=dev)
        ledger = step_ledger(exp)
        print_table(preset, cfg.train.batch_size, ledger)
        print(json.dumps({"preset": preset, "batch": cfg.train.batch_size,
                          "device": dev.type, **ledger.summary()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
