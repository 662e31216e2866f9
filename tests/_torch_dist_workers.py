"""Rank code for tests/test_torch_parallel.py: each rank of a gloo group,
spawned by torch.multiprocessing, runs the port data parallel on the CPU
and writes what it got to `.npz`/`.json` files in the test's directory.

This module imports torch and the port only, so spawned ranks never import
JAX.  The configs live here so that the test and its ranks build the same
ones."""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch.infer import streaming
from gan_sass_tf_tpu_torch.parallel import data_parallel
from gan_sass_tf_tpu_torch.scripts import quality_protocol, recompute_bounds
from gan_sass_tf_tpu_torch.train import Experiment, build_train_step, load_train_state

STEPS = 2
TIMEOUT = datetime.timedelta(seconds=120)    # a hung collective fails the test


def dp_cfg(device_bank: bool = True, **train):
    """A small stream_v5e8 (G and D two conv levels of width 8, 0.25 s, f32)
    with everything random on: gain jitter, a noise source, instance noise,
    R1 and the G EMA; global batch 4."""
    cfg = config.get_config("stream_v5e8")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, g_channels=(8, 8), d_channels=(8, 8),
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, **{
            "batch_size": 4, "d_instance_noise": 0.1, "r1_gamma": 1.0,
            "g_ema": 0.9, "log_every": 1, **train}),
        data=dataclasses.replace(cfg.data, segment_seconds=0.25, num_noise=1,
                                 bank_utterances=8, device_bank=device_bank),
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1),
        stream=dataclasses.replace(cfg.stream, chunk_seconds=0.25, batch_chunks=4))


# Case (b) clips every gradient: its 2-rank run matches 1 rank only if the
# ranks average their gradients before the clip.
HOST_CLIP = 1e-2


def flat_state(exp) -> dict:
    """G's and D's state dicts (D's spectral-norm buffers too) and the EMA."""
    out = {f"g/{k}": v for k, v in exp.state.g.state_dict().items()}
    out.update({f"d/{k}": v for k, v in exp.state.d.state_dict().items()})
    out.update({f"ema/{k}": v for k, v in (exp.state.g_ema or {}).items()})
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def run_steps(exp) -> dict:
    """train(STEPS), logging every step: each step's metrics and the state
    after."""
    out = {}

    def log(step, m):
        out.update({f"m{step}/{k}": np.float64(v) for k, v in m.items()
                    if k != "mixture_sec_per_sec"})

    exp.train(num_steps=STEPS, log_fn=log)
    out.update({f"p/{k}": v for k, v in flat_state(exp).items()})
    return out


def stream_mixture(cfg) -> np.ndarray:
    """A few seconds of two tones and noise (every rank makes the same)."""
    r = np.random.default_rng(11)
    n = np.arange(int(2.2 * cfg.dsp.sample_rate)) / cfg.dsp.sample_rate
    x = 0.3 * np.sin(2 * np.pi * 220 * n) + 0.2 * np.sign(np.sin(2 * np.pi * 3 * n)) \
        * np.sin(2 * np.pi * 880 * n) + 0.02 * r.standard_normal(n.size)
    return x.astype(np.float32)


def recorded_streaming(g, cfg, mixture):
    """separate_streaming's output and the chained permutations it chose."""
    chained, inner = [], streaming._chain_permutations

    def record(*args, **kwargs):
        chained.append(inner(*args, **kwargs))
        return chained[-1]

    streaming._chain_permutations = record
    try:
        y = streaming.separate_streaming(g, cfg, mixture, "cpu")
    finally:
        streaming._chain_permutations = inner
    return y, chained[0]


def _errors(world: int) -> dict:
    """The ValueError each refused setup raises at this world size."""
    cfg = dp_cfg()
    cases = {
        "mesh_larger": lambda: Experiment(cfg.replace(mesh=dataclasses.replace(
            cfg.mesh, data_axis_size=2 * world)), device="cpu"),
        "mesh_smaller": lambda: Experiment(cfg.replace(mesh=dataclasses.replace(
            cfg.mesh, data_axis_size=world // 2)), device="cpu"),
        "batch": lambda: Experiment(cfg.replace(train=dataclasses.replace(
            cfg.train, batch_size=world + 1)), device="cpu"),
        "batch_chunks": lambda: streaming.separate_streaming(
            None, cfg.replace(stream=dataclasses.replace(
                cfg.stream, batch_chunks=world + 1)),
            stream_mixture(cfg), "cpu", separate_fn=lambda x: x[:, None]),
    }
    out = {}
    for name, make in cases.items():
        try:
            make()
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


def _jax_case(tmp: str, rank: int, name: str = "c") -> dict:
    """Case (c): from the JAX init the test converted, STEPS steps on the
    test's sources through build_train_step with the group; the metrics and
    the flax-layout state after step 1."""
    with open(os.path.join(tmp, f"{name}_input.pkl"), "rb") as f:
        inp = pickle.load(f)
    cfg = config.Config.from_json(inp["cfg"])
    state = load_train_state(cfg, inp["g_params"], inp["d_variables"], "cpu")
    dp = data_parallel(cfg.mesh, cfg.train.batch_size)
    step = build_train_step(cfg, dp=dp)
    rows = dp.batch_rows(cfg.train.batch_size)
    out = {"metrics": [], "rank": rank}
    for i, src in enumerate(inp["sources"]):
        state, m = step(state, torch.from_numpy(src[rows]), 7)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["tstate1"] = (
                tmodels.generator_params_to_flax(state.g.state_dict()),
                tmodels.discriminator_variables_to_flax(state.d.state_dict()),
                None)
    return out


def suite(rank: int, world: int, tmp: str) -> None:
    """Every case at `world` ranks; files <case>_rank<r>.npz / .json."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        def save(name, arrays):
            np.savez(os.path.join(tmp, f"{name}_rank{rank}.npz"), **arrays)

        # (d), (e) from the seeded init, before any step.
        cfg = dp_cfg()
        exp = Experiment(cfg, device="cpu")
        ev = exp.evaluate(num_batches=2)
        save("eval", {k: np.float64(v) for k, v in ev.items()})
        y, perm = recorded_streaming(exp.eval_generator(), cfg, stream_mixture(cfg))
        save("stream", {"y": y, "perm": perm})
        # (a) bank mode, (b) host batches with a tight clip.
        save("bank", run_steps(exp))
        save("host", run_steps(Experiment(dp_cfg(False, grad_clip=HOST_CLIP),
                                          device="cpu")))
        # (c) against the JAX shard_map step.
        with open(os.path.join(tmp, f"jax_rank{rank}.pkl"), "wb") as f:
            pickle.dump(_jax_case(tmp, rank), f)
        # (f) the workdir: 2 steps, then a new Experiment resumes for a 3rd;
        # beside 3 steps in one go.
        wd_cfg = dp_cfg(ckpt_every=1, eval_every=2, eval_batches=1)
        for wd, runs in (("wd_resumed", (2, 1)), ("wd_straight", (3,))):
            for n in runs:
                e = Experiment(wd_cfg, workdir=os.path.join(tmp, wd), device="cpu")
                e.train(num_steps=n)
                e.close()
            save(wd, flat_state(e))
        # (g) refused setups.
        with open(os.path.join(tmp, f"errors_rank{rank}.json"), "w") as f:
            json.dump(_errors(world), f)
    finally:
        dist.destroy_process_group()


def dropout_cfg():
    """dp_cfg() (spectral-norm D) with dropout 0.2 in G and D."""
    cfg = dp_cfg()
    return cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.2))


# The quality scripts at the sizes of tests/test_torch_oracle.py's toy runs.
QUALITY_ARGV = ["2src_toy_cpu", "2", "--hard", "--device", "cpu",
                "--set", "train.batch_size=2", "--set", "data.segment_seconds=0.25",
                "--set", "model.g_channels=8,16", "--set", "model.d_channels=8,16"]
BOUNDS_ARGV = ["3src_pit", "--device", "cpu", "--set", "data.segment_seconds=0.25",
               "--set", "train.batch_size=2"]


def printed(main, argv) -> str:
    """What `main(argv)` prints on stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if main(argv) != 0:
            raise RuntimeError(f"{main.__module__} {argv} failed")
    return out.getvalue()


def options_suite(rank: int, world: int, tmp: str) -> None:
    """The model options' cases at `world` ranks: the BN D against the JAX
    shard_map step (bn_rank<r>.pkl), dropout against one rank
    (dropout_rank<r>.npz), and what the quality scripts print on each rank
    (quality_rank<r>.json)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        with open(os.path.join(tmp, f"bn_rank{rank}.pkl"), "wb") as f:
            pickle.dump(_jax_case(tmp, rank, "bn"), f)
        np.savez(os.path.join(tmp, f"dropout_rank{rank}.npz"),
                 **run_steps(Experiment(dropout_cfg(), device="cpu")))
        with open(os.path.join(tmp, f"quality_rank{rank}.json"), "w") as f:
            json.dump({"quality": printed(quality_protocol.main, QUALITY_ARGV),
                       "bounds": printed(recompute_bounds.main, BOUNDS_ARGV)}, f)
    finally:
        dist.destroy_process_group()
