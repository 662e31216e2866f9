"""The Experiment on one device: the train loop over the device bank, the
held-out eval, and the throughput metric.

Port of `gan_sass_tf_tpu/train/experiment.py` (`train`, `evaluate`,
`eval_g_params`, `reseed`) for one device and no workdir.  The utterance
bank is uploaded to the device once and every step samples its batch there,
so no batch crosses from the host while training.  Not ported yet, each
raising NotImplementedError where asked for: checkpoints and the workdir
(ROADMAP.md, 'Modules to port', item 6), host-batch mode (item 6), data
parallelism over several devices (item 8).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from gan_sass_tf_tpu_torch.data import build_bank, make_dataset
from gan_sass_tf_tpu_torch.models import build_generator
from gan_sass_tf_tpu_torch.train.state import TrainState, create_train_state
from gan_sass_tf_tpu_torch.train.step import build_eval_step, build_train_step

_ITEM6 = "(ROADMAP.md, 'Modules to port', item 6)"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Experiment:
    """Train and evaluate one preset on one device.

        exp = Experiment(get_config("stream_v5e8"), device="cuda")
        exp.train(num_steps=100, log_fn=print)
        exp.evaluate(num_batches=4)
    """

    def __init__(self, cfg, workdir: Optional[str] = None, device="cuda"):
        if workdir is not None:
            raise NotImplementedError(
                f"workdir (checkpoints, auto-resume, metrics file) is not "
                f"ported yet {_ITEM6}; train without --workdir")
        if not cfg.data.device_bank:
            raise NotImplementedError(
                f"host-batch mode (data.device_bank=False) is not ported yet "
                f"{_ITEM6}")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda asked for, but no CUDA device is visible")
        self._train_step = build_train_step(
            cfg, from_bank=True, local_batch=cfg.train.batch_size)
        self.reseed(cfg.train.seed)

    def reseed(self, seed: int) -> None:
        """Re-initialize everything seed-dependent: G, D, both optimizers,
        the train seed, the device bank and the eval data."""
        cfg = self.cfg
        self.state: TrainState = create_train_state(cfg, self.device, seed)
        self._train_seed = seed + 1
        self.eval_dataset = make_dataset(cfg, seed=seed + 9999,
                                         split=cfg.data.eval_split)
        self._bank = torch.from_numpy(build_bank(cfg, seed=seed)).to(self.device)
        self._eval_g = None

    def train(self, num_steps: Optional[int] = None,
              log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None
              ) -> Dict[str, float]:
        """Run `num_steps` steps (default train.total_steps) and return the
        last logged metrics, with `mixture_sec_per_sec`: mixture seconds per
        wall second from the end of the first step group on.

        Steps run one at a time.  train.steps_per_dispatch only groups them
        for the cadence: metrics are read (which synchronizes the device),
        logged and evaluated at group ends, every train.log_every steps,
        and the throughput clock starts after the first group.  (On the
        TPU it also scanned the group into one dispatch.)"""
        cfg = self.cfg
        total = num_steps if num_steps is not None else cfg.train.total_steps
        spd = cfg.train.steps_per_dispatch
        n_full, rem = divmod(total, spd)
        lengths = [spd] * n_full + ([rem] if rem else [])
        samples_per_step = cfg.train.batch_size * cfg.segment_samples

        def crossed(completed: int, every: int, length: int) -> bool:
            return (completed // every) > ((completed - length) // every)

        last: Dict[str, float] = {}
        t_start, steps_timed = time.perf_counter(), 0
        step_now = self.state.step
        for i, length in enumerate(lengths):
            if i == 1:                 # the clock leaves out the first group
                _sync(self.device)
                t_start, steps_timed = time.perf_counter(), 0
            for _ in range(length):
                self.state, metrics = self._train_step(
                    self.state, self._bank, self._train_seed)
            steps_timed += length
            completed = step_now + length
            if crossed(completed, cfg.train.log_every, length) \
                    or i == len(lengths) - 1:
                last = {k: float(v) for k, v in metrics.items()}
                elapsed = time.perf_counter() - t_start
                mix_sec = steps_timed * samples_per_step / cfg.dsp.sample_rate
                last["mixture_sec_per_sec"] = mix_sec / elapsed
                if log_fn:
                    log_fn(completed, last)
            if crossed(completed, cfg.train.eval_every, length):
                self.evaluate(num_batches=cfg.train.eval_batches)
            step_now = completed
        return last

    @property
    def eval_g_params(self) -> Dict[str, torch.Tensor]:
        """G parameters for eval and inference: the EMA shadow when
        train.g_ema > 0, else the live ones."""
        ema = self.state.g_ema
        return ema if ema is not None else dict(self.state.g.named_parameters())

    def _eval_generator(self) -> torch.nn.Module:
        if self.state.g_ema is None:
            return self.state.g
        if self._eval_g is None:
            self._eval_g = build_generator(self.cfg, self.device)
        self._eval_g.load_state_dict(self.state.g_ema)
        return self._eval_g

    def evaluate(self, num_batches: int = 4, dataset=None) -> Dict[str, float]:
        """PIT SI-SDR of the separated held-out mixtures (batch means over
        `num_batches` batches of `dataset`, default the eval split)."""
        dataset = dataset if dataset is not None else self.eval_dataset
        eval_step = build_eval_step(self.cfg, self._eval_generator())
        acc: Dict[str, float] = {}
        for i in range(num_batches):
            sources = torch.from_numpy(dataset.batch()).to(self.device)
            for k, v in eval_step(sources, 10_000 + i).items():
                acc[k] = acc.get(k, 0.0) + float(v) / num_batches
        return acc
