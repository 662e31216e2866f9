"""The Experiment: the train loop over the device bank or host batches, the
held-out eval, the throughput metric, and the workdir (checkpoints with
auto-resume, the config fingerprint guard, the best checkpoint by held-out
SI-SDRi, and the metrics file), on one device or data parallel over a
process group.

Port of `gan_sass_tf_tpu/train/experiment.py`.  Data parallel over the
process group that `parallel.initialize_distributed` joined, every rank
builds the same seeded state (and rank 0's is broadcast after a reseed),
the same bank, and draws the same global host batches, of which it keeps
its rows (`parallel/mesh.py`); the step all-reduces.  Rank 0 alone writes
the workdir, each write followed by a barrier; every rank reads it.

A workdir holds

    config.json            the config (`Config.to_json()`), checked on reopen
    checkpoints/<step>.pt  the newest 3 train states (`torch.save`)
    best/<step>.pt         the state with the best eval SI-SDRi (keep_best)
    best.json              {"step", "eval_si_sdr_improvement"} of best/
    metrics.jsonl          logged train metrics and eval rows ("eval_" keys)
    tb/                    the same scalars as TensorBoard events (tensorboard=True)
    profile/               Chrome traces of the steps train(profile_steps=) names

The checkpoint format is the port's own; orbax checkpoints of the JAX
package are refused (their G weights load through `--params`,
models/convert.py).
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from gan_sass_tf_tpu_torch.data import build_bank, make_dataset
from gan_sass_tf_tpu_torch.models import build_generator
from gan_sass_tf_tpu_torch.parallel.mesh import data_parallel
from gan_sass_tf_tpu_torch.train.state import TrainState, create_train_state
from gan_sass_tf_tpu_torch.train.step import build_eval_step, build_train_step
from gan_sass_tf_tpu_torch.utils.metrics_writer import MetricsWriter
from gan_sass_tf_tpu_torch.utils.profiler import profile_trace, step_range

KEEP_CHECKPOINTS = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def checkpoint_steps(directory: str) -> List[int]:
    """Steps of the complete checkpoints `<step>.pt` in `directory`, in
    increasing order (a `.tmp` file left by an interrupted save is not
    one)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(f[:-3]) for f in os.listdir(directory)
                  if f.endswith(".pt") and f[:-3].isdigit())


def _named_tensors(tree, prefix=""):
    """(path, tensor) of a nested state dict, in a fixed order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_tensors(v, f"{prefix}{k}/")
        elif torch.is_tensor(v):
            yield prefix + k, v


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a nested state dict, in a fixed order."""
    return [t for _, t in _named_tensors(tree)]


def check_finite(step: int, named) -> None:
    """FloatingPointError naming the first (path, tensor) of `named` that
    holds a NaN or an infinity (one device sync for all of them)."""
    named = list(named)
    ok = torch.stack([torch.isfinite(t).all() for _, t in named]).tolist()
    for (path, t), good in zip(named, ok):
        if not good:
            raise FloatingPointError(
                f"debug_nans: non-finite value in {path} after step {step}"
                + (f" ({float(t)})" if t.numel() == 1 else ""))


def check_no_graph(step: int, named) -> None:
    """RuntimeError naming the first (path, tensor) of `named` that carries
    an autograd graph (a grad_fn) out of the step."""
    for path, t in named:
        if t.grad_fn is not None:
            raise RuntimeError(
                f"debug_leaks: {path} carries an autograd graph "
                f"({t.grad_fn.name()}) out of step {step}")


class Experiment:
    """Train and evaluate one preset on one device, or data parallel.

        exp = Experiment(get_config("stream_v5e8"), workdir="runs/a", device="cuda")
        exp.train(num_steps=100, log_fn=print)     # resumes from runs/a if it can
        exp.evaluate(num_batches=4)
        exp.close()

    Inside a process group (`parallel.initialize_distributed`) it trains
    data parallel over every rank of it.

    The debug tripwires (every rank checks its own state):
      debug_nans   each step runs under autograd's anomaly mode (restored
                   after the step), and its metrics and the whole train
                   state after it are checked; the first NaN or infinity
                   raises FloatingPointError naming where it was found
                   (the counterpart of jax_debug_nans);
      debug_leaks  after each step no tensor of the train state and no
                   metric may carry an autograd graph out of it, which
                   would keep that graph alive; one that does raises
                   RuntimeError naming it (the counterpart of
                   jax_check_tracer_leaks).
    tensorboard=True mirrors the metrics to <workdir>/tb (rank 0).
    """

    def __init__(self, cfg, workdir: Optional[str] = None, device="cuda",
                 resume: bool = True, debug_nans: bool = False,
                 debug_leaks: bool = False, tensorboard: bool = False):
        self.cfg = cfg
        self.workdir = workdir
        self.debug_nans, self.debug_leaks = debug_nans, debug_leaks
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda asked for, but no CUDA device is visible")
        self.dp = data_parallel(cfg.mesh, cfg.train.batch_size)
        # Device-bank mode samples every batch on the device; host-batch
        # mode copies one dataset batch a step from a prefetch thread.
        self._use_bank = cfg.data.device_bank
        self._spd = cfg.train.steps_per_dispatch if self._use_bank else 1
        self._rows = self.dp.batch_rows(cfg.train.batch_size)
        self._train_step = build_train_step(
            cfg, from_bank=self._use_bank, local_batch=self.dp.local_batch,
            dp=self.dp)
        self.reseed(cfg.train.seed)
        if workdir:
            self._init_checkpointing(resume)
            best_path = os.path.join(workdir, "best.json")
            if os.path.exists(best_path):
                with open(best_path) as f:
                    self._best_metric = json.load(f)["eval_si_sdr_improvement"]
        writes = bool(workdir) and self.dp.is_main
        self.metrics = MetricsWriter(
            os.path.join(workdir, "metrics.jsonl") if writes else None,
            os.path.join(workdir, "tb") if writes and tensorboard else None)

    def reseed(self, seed: int) -> None:
        """Re-initialize everything seed-dependent: G, D, both optimizers,
        the train seed, the device bank or host dataset, the eval data and
        the best eval metric seen."""
        cfg = self.cfg
        self.state: TrainState = create_train_state(cfg, self.device, seed)
        self._train_seed = seed + 1
        self.dataset = None if self._use_bank else make_dataset(cfg, seed=seed)
        self.eval_dataset = make_dataset(cfg, seed=seed + 9999,
                                         split=cfg.data.eval_split)
        self._bank = None
        if self._use_bank:
            self._bank = torch.from_numpy(build_bank(cfg, seed=seed)).to(self.device)
        self._eval_g = None
        self._best_metric = float("-inf")
        # Rank 0's parameters, optimizer moments, spectral-norm buffers and
        # EMA into every rank's; the step, the update counts and the train
        # seed are plain ints that every rank already shares.
        self.dp.broadcast_(_tensors(self.state.state_dict()))

    def _main_writes(self, write: Callable[[], None]) -> None:
        """Run `write` on rank 0 alone, then wait for it on every rank."""
        if self.dp.is_main:
            write()
        self.dp.barrier()

    # ------------------------------------------------------------------
    # The workdir: checkpoints, auto-resume, the config fingerprint guard.
    # ------------------------------------------------------------------

    def _init_checkpointing(self, resume: bool) -> None:
        ckpt_dir = os.path.join(self.workdir, "checkpoints")
        if os.path.isdir(ckpt_dir) and not checkpoint_steps(ckpt_dir) and any(
                d.isdigit() and os.path.isdir(os.path.join(ckpt_dir, d))
                for d in os.listdir(ckpt_dir)):
            raise ValueError(
                f"workdir {self.workdir!r} holds orbax checkpoints of the JAX "
                "package, which the port does not read; export the "
                "generator's params to a flat .npz and pass --params "
                "(gan_sass_tf_tpu_torch/models/convert.py)")
        os.makedirs(ckpt_dir, exist_ok=True)
        cfg_path = os.path.join(self.workdir, "config.json")
        exists = os.path.exists(cfg_path)
        self.dp.barrier()           # every rank has looked before rank 0 writes
        if exists:
            with open(cfg_path) as f:
                saved = f.read()
            # Compared through from_json, so that fields added since the
            # workdir was made (absent from the saved JSON, carrying their
            # defaults) still match; a field the schema no longer has makes
            # from_json raise, and that is a different config.
            try:
                compatible = (type(self.cfg).from_json(saved).to_json()
                              == self.cfg.to_json())
            except (TypeError, KeyError):
                compatible = False
            if not compatible:
                raise ValueError(
                    f"workdir {self.workdir!r} was created with a different "
                    "config (fingerprint mismatch); refusing to mix runs")
        else:
            def write_config():
                with open(cfg_path, "w") as f:
                    f.write(self.cfg.to_json())
            self._main_writes(write_config)
        if resume and checkpoint_steps(ckpt_dir):
            self.restore()

    def _write(self, directory: str, step: int, keep: int) -> None:
        """torch.save the train state and the train seed to
        directory/<step>.pt through a temporary name, then keep it and the
        newest `keep` - 1 others there."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{step}.pt")
        torch.save({"state": self.state.state_dict(),
                    "train_seed": self._train_seed}, path + ".tmp")
        os.replace(path + ".tmp", path)
        others = [s for s in checkpoint_steps(directory) if s != step]
        for old in others[:len(others) - (keep - 1)]:
            os.remove(os.path.join(directory, f"{old}.pt"))

    def _read(self, directory: str, step: int) -> None:
        """Load directory/<step>.pt (every rank reads the same file)."""
        payload = torch.load(os.path.join(directory, f"{step}.pt"),
                             map_location=self.device, weights_only=True)
        self.state.load_state_dict(payload["state"])
        self._train_seed = int(payload["train_seed"])

    def save(self) -> None:
        """Write checkpoints/<step>.pt (no-op without a workdir)."""
        if self.workdir:
            self._main_writes(lambda: self._write(
                os.path.join(self.workdir, "checkpoints"), self.state.step,
                KEEP_CHECKPOINTS))

    def restore(self, step: Optional[int] = None) -> None:
        """Load checkpoints/<step>.pt, by default the newest."""
        ckpt_dir = os.path.join(self.workdir, "checkpoints")
        self._read(ckpt_dir, step if step is not None else checkpoint_steps(ckpt_dir)[-1])

    def _save_best(self, step: int, metric: float) -> None:
        def write():
            self._write(os.path.join(self.workdir, "best"), step, 1)
            with open(os.path.join(self.workdir, "best.json"), "w") as f:
                json.dump({"step": step, "eval_si_sdr_improvement": metric}, f)
        self._main_writes(write)

    def _log(self, step: int, row: Dict[str, float]) -> None:
        """A metrics.jsonl row (rank 0 writes it)."""
        self._main_writes(lambda: self.metrics.write(step, row))

    def restore_best(self) -> int:
        """Load the checkpoint with the best held-out eval SI-SDRi
        (train.keep_best).  Returns the step it was written at."""
        steps = checkpoint_steps(os.path.join(self.workdir, "best")) \
            if self.workdir else []
        if not steps:
            raise FileNotFoundError(
                f"no best checkpoint under {self.workdir!r} "
                "(train.keep_best off, or no eval ran yet)")
        self._read(os.path.join(self.workdir, "best"), steps[-1])
        return steps[-1]

    # ------------------------------------------------------------------
    # Train and eval loops
    # ------------------------------------------------------------------

    def _to_device(self, batch) -> torch.Tensor:
        x = torch.from_numpy(batch)
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        return x

    def _step(self, data: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One train step on `data`, under the debug tripwires asked for."""
        step = self.state.step
        if not self.debug_nans:
            self.state, metrics = self._train_step(self.state, data, self._train_seed)
        else:
            try:
                with torch.autograd.set_detect_anomaly(True, check_nan=True):
                    self.state, metrics = self._train_step(
                        self.state, data, self._train_seed)
            except RuntimeError as exc:
                if "nan values" not in str(exc):
                    raise
                raise FloatingPointError(
                    f"debug_nans: in the backward of step {step}: {exc}") from exc
            check_finite(step, [(f"metrics/{k}", v) for k, v in metrics.items()])
            check_finite(step, _named_tensors(self.state.state_dict()))
        if self.debug_leaks:
            check_no_graph(step, [(f"metrics/{k}", v) for k, v in metrics.items()])
            check_no_graph(step, _named_tensors(self.state.state_dict(keep_vars=True)))
        return metrics

    def train(self, num_steps: Optional[int] = None,
              log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
              profile_steps: Optional[Tuple[int, int]] = None
              ) -> Dict[str, float]:
        """Run `num_steps` steps (default train.total_steps) from the
        current step and return the last logged metrics, with
        `mixture_sec_per_sec`: mixture seconds per wall second from the end
        of the first step group on.

        Steps run one at a time.  train.steps_per_dispatch only groups them
        (in bank mode) for the cadence: metrics are read (which
        synchronizes the device), logged and evaluated at group ends, every
        train.log_every steps, and the throughput clock starts after the
        first group.  (On the TPU it also scanned the group into one
        dispatch.)  The log, checkpoint and eval boundaries are multiples
        of their periods counted from step 0, so a resumed run meets them
        where the continuous run did.  With a workdir the state is saved
        every train.ckpt_every steps and at the end.

        profile_steps=(A, B) with a workdir traces steps A to B - 1 into
        <workdir>/profile (rank 0; utils/profiler.py), each step in a
        "ProfilerStep#<step>" range."""
        cfg = self.cfg
        total = num_steps if num_steps is not None else cfg.train.total_steps
        n_full, rem = divmod(total, self._spd)
        lengths = [self._spd] * n_full + ([rem] if rem else [])
        samples_per_step = cfg.train.batch_size * cfg.segment_samples

        def crossed(completed: int, every: int, length: int) -> bool:
            return (completed // every) > ((completed - length) // every)

        # Host-batch mode: a producer thread decodes the next batches while
        # the device runs the current step.
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        thread = None
        if not self._use_bank:
            dataset, rows = self.dataset, self._rows

            def producer():
                while not stop.is_set():
                    try:
                        item = dataset.batch()[rows]
                    except Exception as exc:      # handed to the train loop
                        item = exc
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if isinstance(item, Exception):
                        return

            thread = threading.Thread(target=producer, name="host-batch-prefetch",
                                      daemon=True)
            thread.start()

        def next_data():
            if self._use_bank:
                return self._bank
            item = q.get()
            if isinstance(item, Exception):
                raise item
            return self._to_device(item)

        profile = (profile_steps if profile_steps and self.workdir and self.dp.is_main
                   else None)
        tracing, profiling = contextlib.ExitStack(), False
        last: Dict[str, float] = {}
        t_start, steps_timed = time.perf_counter(), 0
        step_now = saved = self.state.step
        try:
            for i, length in enumerate(lengths):
                if i == 1:                 # the clock leaves out the first group
                    _sync(self.device)
                    t_start, steps_timed = time.perf_counter(), 0
                for _ in range(length):
                    s = self.state.step
                    traced = profile is not None and profile[0] <= s < profile[1]
                    if traced and not profiling:
                        tracing.enter_context(profile_trace(
                            os.path.join(self.workdir, "profile")))
                        profiling = True
                    with step_range(s) if traced else contextlib.nullcontext():
                        metrics = self._step(next_data())
                    if profiling and s + 1 >= profile[1]:
                        tracing.close()
                        profiling = False
                steps_timed += length
                completed = step_now + length
                if crossed(completed, cfg.train.log_every, length) \
                        or i == len(lengths) - 1:
                    last = {k: float(v) for k, v in metrics.items()}
                    elapsed = time.perf_counter() - t_start
                    mix_sec = steps_timed * samples_per_step / cfg.dsp.sample_rate
                    last["mixture_sec_per_sec"] = mix_sec / elapsed
                    self._log(completed, last)
                    if log_fn:
                        log_fn(completed, last)
                if self.workdir and crossed(completed, cfg.train.ckpt_every, length):
                    self.save()
                    saved = completed
                if crossed(completed, cfg.train.eval_every, length):
                    # eval_batches, not evaluate()'s default: this metric
                    # ranks checkpoints for keep_best.
                    ev = self.evaluate(num_batches=cfg.train.eval_batches)
                    self._log(completed, {"eval_" + k: v for k, v in ev.items()})
                    si = ev.get("si_sdr_improvement")
                    if (self.workdir and cfg.train.keep_best
                            and si is not None and si > self._best_metric):
                        self._best_metric = si
                        self._save_best(completed, si)
                step_now = completed
        finally:
            tracing.close()
            stop.set()
            if thread is not None:
                thread.join(timeout=5)
        if self.workdir and saved != self.state.step:
            self.save()
        return last

    @property
    def eval_g_params(self) -> Dict[str, torch.Tensor]:
        """G parameters for eval and inference: the EMA shadow when
        train.g_ema > 0, else the live ones."""
        ema = self.state.g_ema
        return ema if ema is not None else dict(self.state.g.named_parameters())

    def eval_generator(self) -> torch.nn.Module:
        """G carrying `eval_g_params`, for eval and inference: the live G,
        or a second G loaded with the EMA shadow as it stands now."""
        if self.state.g_ema is None:
            return self.state.g
        if self._eval_g is None:
            self._eval_g = build_generator(self.cfg, self.device)
        self._eval_g.load_state_dict(self.state.g_ema)
        return self._eval_g

    def evaluate(self, num_batches: int = 4, dataset=None) -> Dict[str, float]:
        """PIT SI-SDR of the separated held-out mixtures (batch means over
        `num_batches` batches of `dataset`, default the eval split; data
        parallel, each rank scores its rows of every batch)."""
        dataset = dataset if dataset is not None else self.eval_dataset
        eval_step = build_eval_step(self.cfg, self.eval_generator(), self.dp)
        acc: Dict[str, float] = {}
        for i in range(num_batches):
            batch = dataset.batch()
            sources = torch.from_numpy(
                batch[self.dp.batch_rows(batch.shape[0])]).to(self.device)
            for k, v in eval_step(sources, 10_000 + i).items():
                acc[k] = acc.get(k, 0.0) + float(v) / num_batches
        return acc

    def close(self) -> None:
        """Close the metrics file."""
        self.metrics.close()
