"""Train state and the two optimizers.

Port of `gan_sass_tf_tpu/train/state.py`.  Each optimizer is optax's
`chain(clip_by_global_norm(grad_clip), adam(lr_schedule, b1, b2))`, written
out because torch's pieces differ: `clip_grad_norm_` scales by
c / (‖g‖ + 1e-6) where optax leaves g alone below c and scales by c / ‖g‖
above it, and `torch.optim.Adam` is not the place to read a per-optimizer
schedule count from.  The lr schedules are optax's `cosine_decay_schedule`
and `linear_schedule`, evaluated at the optimizer's own update count.

The step and the update counts are 0-d int64 tensors on the state's device,
advanced in place by the step, and the schedules and Adam's bias
corrections are computed from them on that device in float32, as optax
computes them.  So no number of the step is read on the host, and a CUDA
graph that captured one step replays the next (`train/graphed.py`); the
CPU runs the same computation.

`state_dict()` of the optimizers and of `TrainState` holds tensors, dicts,
ints and None only (the counters as ints), so a checkpoint loads with
`torch.load(..., weights_only=True)`; loading copies into the live tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from gan_sass_tf_tpu_torch.models import (
    build_discriminator,
    build_generator,
    load_discriminator,
    load_generator,
)

Schedule = Callable[[Union[int, torch.Tensor]], Union[float, torch.Tensor]]


def counter(device, value: int = 0) -> torch.Tensor:
    """A 0-d int64 counter on `device`."""
    return torch.full((), value, dtype=torch.int64, device=device)


def lr_schedule(cfg, base_lr: float, kind: str) -> Schedule:
    """Update count (an int or a 0-d tensor) -> learning rate, a 0-d f32
    tensor on the count's device (TrainConfig.{g,d}_lr_schedule): the
    decayed schedules run over train.lr_decay_steps down to
    base_lr * train.lr_end_factor and hold there."""
    n, alpha = cfg.train.lr_decay_steps, cfg.train.lr_end_factor
    if kind not in ("constant", "cosine", "linear"):
        raise ValueError(f"unknown lr schedule {kind!r}")

    def schedule(count):
        c = torch.as_tensor(count).float()
        if kind == "constant":
            return torch.full_like(c, base_lr)
        if kind == "cosine":       # optax.cosine_decay_schedule(base, n, alpha)
            c = c.clamp(max=n)
            cosine = 0.5 * (1 + torch.cos(math.pi * c / n))
            return base_lr * ((1 - alpha) * cosine + alpha)
        # optax.linear_schedule(base, base·alpha, n)
        end = base_lr * alpha
        frac = 1 - c.clamp(0, n) / n
        return (base_lr - end) * frac + end
    return schedule


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g if ‖g‖ < max_norm else g·max_norm/‖g‖,
    ‖g‖ the norm over all tensors; decided on the device, no sync."""
    g_norm = torch.stack(torch._foreach_norm(grads)).norm()
    scale = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                        max_norm / g_norm)
    return torch._foreach_mul(grads, scale)


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
               what: str) -> None:
    """Copy a saved {name: tensor} dict into live tensors of the same names,
    in place, so that whatever holds the live tensors keeps them."""
    if set(dst) != set(src):
        raise KeyError(f"{what}: saved names {sorted(set(src) ^ set(dst))} "
                       "do not match this model's")
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[k])


class ClippedAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr, b1, b2, eps)) over
    a fixed list of parameters.  `step(grads)` updates them in place and
    never synchronizes with the device.  `lr` maps the update count (a 0-d
    int64 tensor on the parameters' device) to a float or a 0-d tensor.
    `names` key the moments in `state_dict()` (default: the parameters'
    positions)."""

    def __init__(self, params: List[torch.Tensor], lr: Schedule,
                 max_norm: float, b1: float, b2: float, eps: float = 1e-8,
                 names: Optional[Sequence[str]] = None):
        self.params = list(params)
        self.names = list(names) if names is not None else [
            str(i) for i in range(len(self.params))]
        if len(self.names) != len(self.params):
            raise ValueError(f"{len(self.names)} names for {len(self.params)} "
                             "parameters")
        self.lr, self.max_norm, self.b1, self.b2, self.eps = lr, max_norm, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = counter(self.params[0].device)

    def state_dict(self) -> dict:
        """{"count", "mu", "nu"}: the update count (which drives the lr
        schedule) and both moments by parameter name."""
        return {"count": int(self.count),
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, sd: dict) -> None:
        _copy_into(dict(zip(self.names, self.mu)), sd["mu"], "optimizer mu")
        _copy_into(dict(zip(self.names, self.nu)), sd["nu"], "optimizer nu")
        self.count.fill_(int(sd["count"]))

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        grads = clip_by_global_norm([g.float() for g in grads], self.max_norm)
        lr = self.lr(self.count)
        self.count.add_(1)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        # Bias corrections in float32 from the new count, as optax.
        count = self.count.float()
        bc1 = 1 - torch.pow(b1, count)
        bc2 = 1 - torch.pow(b2, count)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        # optax scales the update by -lr, then adds it.
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)


def make_optimizers(cfg, g: torch.nn.Module, d: torch.nn.Module):
    """(G optimizer, D optimizer) over the modules' parameters."""
    t = cfg.train

    def tx(module, lr, kind):
        names, params = zip(*module.named_parameters())
        return ClippedAdam(list(params), lr_schedule(cfg, lr, kind),
                           t.grad_clip, t.beta1, t.beta2, names=names)

    return tx(g, t.g_lr, t.g_lr_schedule), tx(d, t.d_lr, t.d_lr_schedule)


@dataclasses.dataclass
class TrainState:
    """Everything that evolves during training.  `step` is a 0-d int64
    tensor on the state's device, advanced in place by the step; G and D
    are modules (D's spectral-norm state lives in its buffers); `g_ema` is
    the EMA shadow of G's parameters by name when train.g_ema > 0."""

    step: torch.Tensor
    g: torch.nn.Module
    d: torch.nn.Module
    g_opt: ClippedAdam
    d_opt: ClippedAdam
    g_ema: Optional[Dict[str, torch.Tensor]] = None

    def state_dict(self, keep_vars: bool = False) -> dict:
        """The step (an int), G's and D's state_dicts (D's spectral-norm u
        and sigma buffers included), both optimizers and the EMA shadow (or
        None).
        The tensors are the live ones, as Module.state_dict gives them
        (with `keep_vars`, the modules' tensors themselves, not detached)."""
        return {"step": int(self.step),
                "g": self.g.state_dict(keep_vars=keep_vars),
                "d": self.d.state_dict(keep_vars=keep_vars),
                "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict(), "g_ema": self.g_ema}

    def load_state_dict(self, sd: dict) -> None:
        """Load `state_dict()`'s payload in place: the modules, optimizers,
        EMA and counters keep their tensors, now holding the saved values
        (so a CUDA graph captured on this state stays valid)."""
        if (sd["g_ema"] is None) != (self.g_ema is None):
            raise ValueError("the saved state and this one disagree on the "
                             "G EMA (train.g_ema)")
        self.g.load_state_dict(sd["g"])
        self.d.load_state_dict(sd["d"])
        self.g_opt.load_state_dict(sd["g_opt"])
        self.d_opt.load_state_dict(sd["d_opt"])
        if self.g_ema is not None:
            _copy_into(self.g_ema, sd["g_ema"], "G EMA")
        self.step.fill_(int(sd["step"]))


def _state_for(cfg, g, d) -> TrainState:
    g_opt, d_opt = make_optimizers(cfg, g, d)
    ema = None
    if cfg.train.g_ema > 0.0:     # starts at the init point, as the reference
        ema = {k: p.detach().clone() for k, p in g.named_parameters()}
    return TrainState(step=counter(next(g.parameters()).device), g=g, d=d,
                      g_opt=g_opt, d_opt=d_opt, g_ema=ema)


def create_train_state(cfg, device, seed: int = 0) -> TrainState:
    """G and D as the JAX package's `create_train_state` initializes them
    from jax.random.PRNGKey(seed) (G from its first split, D from its
    second; `models.build_generator`), and fresh optimizers."""
    g = build_generator(cfg, device, seed=seed)
    d = build_discriminator(cfg, device, seed=seed)
    return _state_for(cfg, g, d)


def load_train_state(cfg, g_params, d_variables, device) -> TrainState:
    """A step-0 train state carrying the JAX package's G params and D
    variables (params and spectral-norm `batch_stats`, as numpy trees)."""
    return _state_for(cfg, load_generator(cfg, g_params, device),
                      load_discriminator(cfg, d_variables, device))
