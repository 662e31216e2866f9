"""The device counters behind the captured train step, the multi-step
dispatch and the port's bench, on the CPU.

A CUDA graph runs only on the card (`chip_smoke.py`'s graph phase holds
replays to the eager step there, bit for bit).  What it needs is tested
here: the threefry draws keyed by 0-d tensors equal the int-keyed ones, the
optimizer with device counters is optax's over 30 updates, the counters
round-trip a checkpoint as ints, `train(N)` runs exactly N steps in
dispatches of train.steps_per_dispatch, and the bench's and bench_spd's
output contracts."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu.train.state import _lr_schedule as j_lr_schedule
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.data import mix_sources, prng_key, sample_bank
from gan_sass_tf_tpu_torch.data.threefry import fold_in
from gan_sass_tf_tpu_torch.models.dropout import DropoutKey
from gan_sass_tf_tpu_torch.ops import dispatch
from gan_sass_tf_tpu_torch.scripts import bench_spd
from gan_sass_tf_tpu_torch.scripts.profile_step import POOL
from gan_sass_tf_tpu_torch.train import ClippedAdam, Experiment
from gan_sass_tf_tpu_torch.train.experiment import dispatch_lengths
from gan_sass_tf_tpu_torch.train.graphed import GraphedStep
from gan_sass_tf_tpu_torch.train.state import lr_schedule
from gan_sass_tf_tpu_torch.train.step import instance_noise

ROOT = Path(__file__).resolve().parents[1]
SEEDS = [(123457, 41), (2 ** 32 + 5, 0), (-1, 2 ** 31 + 3)]


def _keys(seed, step):
    """The threefry key fold_in(PRNGKey(seed), step) from ints and from 0-d
    int64 tensors."""
    return {"int": fold_in(prng_key(seed), step),
            "tensor": fold_in(prng_key(torch.tensor(seed, dtype=torch.int64)),
                              torch.tensor(step, dtype=torch.int64))}


@pytest.mark.parametrize("seed,step", SEEDS)
@pytest.mark.parametrize("draw", ["picks_shifts", "gains_noise", "instance_noise",
                                  "dropout"])
def test_tensor_keys_draw_int_key_bits(draw, seed, step):
    """Every draw of the step (the bank's picks and shifts, the mixer's
    gains and noise, instance noise and dropout's keep-masks) under a
    threefry key built from 0-d int64 tensors equals the draw under the key
    built from Python ints, bit for bit, also for a seed past 2^32 and a
    negative one."""
    cfg = config.get_config("stream_v5e8").data
    cfg = dataclasses.replace(cfg, num_noise=1, gain_jitter_db=5.0)
    bank = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, 64)).astype(np.float32))
    out = {}
    for kind, key in _keys(seed, step).items():
        if draw == "picks_shifts":
            out[kind] = sample_bank(bank, key, 5, example_offset=3)
        elif draw == "gains_noise":
            out[kind] = torch.cat([x.flatten() for x in mix_sources(
                bank[:, :4].transpose(0, 1).contiguous(), key, cfg, example_offset=2)])
        elif draw == "instance_noise":
            out[kind] = instance_noise(torch.zeros(6, 4, 3, 2), 0.5, key)
        else:
            out[kind] = DropoutKey(key).apply(torch.ones(4, 3, 5), 0.3, 1)
    assert torch.equal(out["int"], out["tensor"])


def test_train_keys_follow_the_in_place_step():
    """The step's dropout and noise keys read the step tensor when they
    are computed, as a replayed step computes them: the same ops after the
    step moved in place draw the next step's noise."""
    key, step = prng_key(5), torch.tensor(3)
    x = torch.zeros(4, 8)

    def draw(at=step):
        keys = dispatch.step_batch(key, torch.zeros(1, 2, 8), 0.0, step=at,
                                   d_steps=1).train_keys
        return instance_noise(x, 1.0, keys[2])

    before = draw()
    step.add_(1)
    assert torch.equal(draw(), draw(torch.tensor(4)))
    assert not torch.equal(before, draw())


def _schedule_cfg(kind):
    cfg = config.get_config("stream_v5e8")
    return cfg.replace(train=dataclasses.replace(
        cfg.train, g_lr_schedule=kind, lr_decay_steps=20, lr_end_factor=0.2))


def _int_count_adam(params, grads_seq, lr, max_norm, b1, b2, eps=1e-8):
    """The optimizer as it read a Python-int update count: the lr schedule
    in float64 on the host, the bias corrections rounded to float32 and
    read back, `params += -lr · update`."""
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    for count, grads in enumerate(grads_seq, 1):
        norm = torch.stack(torch._foreach_norm(grads)).norm()
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        grads = torch._foreach_mul(grads, scale)
        rate = lr(count - 1)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(params, upd, alpha=-rate)
    return params


def _host_schedule(kind, base, n, alpha):
    """The schedule in float64 on the host (optax's formulas)."""
    if kind == "constant":
        return lambda c: base
    if kind == "cosine":
        return lambda c: base * ((1 - alpha) * 0.5 * (1 + math.cos(
            math.pi * min(c, n) / n)) + alpha)
    return lambda c: (base - base * alpha) * (1 - min(max(c, 0), n) / n) + base * alpha


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear"])
def test_device_count_adam_matches_optax_over_30_updates(kind, rng):
    """ClippedAdam with its update count a 0-d tensor, the schedule and
    the bias corrections computed from it in float32: optax's chain(clip,
    adam(schedule)) over 30 updates that cross the schedule's 20-step
    horizon, gradients above and below the clip.  Within 1e-7 + 1e-6
    relative (XLA's and torch's float32 cos and pow differ in the last
    bit), and within the same of the optimizer that read an int count and
    evaluated the schedule in float64 (the learning rate rounds to float32
    at another place)."""
    cfg = _schedule_cfg(kind)
    t = cfg.train
    shapes = [(3, 4), (5,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(100.0 if i % 3 == 0 else 0.1) * rng.standard_normal(s).astype(np.float32)
              for s in shapes] for i in range(30)]
    tx = optax.chain(optax.clip_by_global_norm(t.grad_clip),
                     optax.adam(j_lr_schedule(j_config.Config.from_json(cfg.to_json()),
                                              t.g_lr, kind), b1=t.beta1, b2=t.beta2))
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = ClippedAdam(tp, lr_schedule(cfg, t.g_lr, kind), t.grad_clip, t.beta1, t.beta2)
    assert opt.count.dtype == torch.int64 and opt.count.dim() == 0
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(x) for x in g])
    assert int(opt.count) == 30
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=1e-6)
    old = _int_count_adam([torch.from_numpy(p.copy()) for p in params],
                          [[torch.from_numpy(x) for x in g] for g in grads],
                          _host_schedule(kind, t.g_lr, t.lr_decay_steps,
                                         t.lr_end_factor),
                          t.grad_clip, t.beta1, t.beta2)
    for a, b in zip(tp, old):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=1e-6)


def _tiny(**train):
    cfg = config.get_config("stream_v5e8")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, g_channels=(8, 16), d_channels=(8, 16),
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, **{"batch_size": 2, **train}),
        data=dataclasses.replace(cfg.data, segment_seconds=0.25, bank_utterances=4),
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1))


def test_counters_round_trip_checkpoints_as_ints(tmp_path):
    """state_dict() writes the step, the update counts and the train seed
    as ints; a checkpoint dict written when they were Python ints (ints for
    all three) loads into the live counters and the train key
    (PRNGKey(train_seed)), which stay the same tensors."""
    exp = Experiment(_tiny(), device="cpu")
    exp.train(num_steps=3)
    exp._write(str(tmp_path), 3, 1)
    saved = torch.load(tmp_path / "3.pt", weights_only=True)
    sd = saved["state"]
    assert type(sd["step"]) is int and sd["step"] == 3
    assert type(sd["g_opt"]["count"]) is int and sd["d_opt"]["count"] == 3
    assert type(saved["train_seed"]) is int
    live = (exp.state.step, exp.state.g_opt.count, exp.state.d_opt.count,
            exp._train_key)
    old = {"state": {**sd, "step": 7, "g_opt": {**sd["g_opt"], "count": 7},
                     "d_opt": {**sd["d_opt"], "count": 6}}, "train_seed": 42}
    torch.save(old, tmp_path / "7.pt")
    exp._read(str(tmp_path), 7)
    now = (exp.state.step, exp.state.g_opt.count, exp.state.d_opt.count,
           exp._train_key)
    assert all(a is b for a, b in zip(live, now))
    assert [int(t) for t in now[:3]] == [7, 7, 6]
    assert now[3].tolist() == [0, 42]
    assert all(t.dtype == torch.int64 and t.dim() == 0 for t in now[:3])
    assert now[3].dtype == torch.int64 and now[3].shape == (2,)


@pytest.mark.parametrize("n,logged", [(1, [1]), (6, [4, 6]), (9, [4, 8, 9])])
def test_train_runs_exactly_n_steps_in_dispatches(n, logged):
    """At 4 steps a dispatch, train(N) runs exactly N steps, the last
    dispatch short when 4 does not divide N, and reads the metrics at each
    dispatch end (log_every 1); the CPU runs the eager step."""
    assert dispatch_lengths(n, 4) == [4] * (n // 4) + ([n % 4] if n % 4 else [])
    exp = Experiment(_tiny(steps_per_dispatch=4, log_every=1), device="cpu")
    assert not exp.graphed
    got = []
    m = exp.train(num_steps=n, log_fn=lambda s, row: got.append(s))
    assert int(exp.state.step) == n and got == logged
    assert int(exp.state.g_opt.count) == int(exp.state.d_opt.count) == n
    assert all(np.isfinite(v) for v in m.values())


def test_tables_first_made_in_inference_mode_serve_training():
    """The per-device tables the step caches (the plain iSTFT's window and
    envelope, PIT's permutations, PhaseConvTranspose's tap index) are
    normal tensors even when an eval under inference mode makes them
    first: the train step after it saves them for its backward."""
    dsp_stft = importlib.import_module("gan_sass_tf_tpu_torch.dsp.stft")
    pit = importlib.import_module("gan_sass_tf_tpu_torch.losses.pit")
    phase_ct = importlib.import_module("gan_sass_tf_tpu_torch.models.phase_ct")

    for cached in (dsp_stft._window, dsp_stft._inv_env, pit._perm_indices,
                   phase_ct._device_tap_index):
        cached.cache_clear()
    cfg = _tiny()
    exp = Experiment(cfg.replace(model=dataclasses.replace(cfg.model, g_phase_ct=True)),
                     device="cpu")
    exp.evaluate(num_batches=1)
    m = exp.train(num_steps=1)
    assert all(np.isfinite(v) for v in m.values())


def test_eager_step_only_off_the_card():
    """Experiment.graphed is False on the CPU, and a GraphedStep refuses
    data that is not on a CUDA device."""
    exp = Experiment(_tiny(), device="cpu")
    assert not exp.graphed
    with pytest.raises(ValueError, match="CUDA"):
        GraphedStep(exp._train_step, exp.state, exp._bank, exp._train_key)


def test_bench_json_contract():
    """`python -m gan_sass_tf_tpu_torch.bench --device cpu`, shrunk by the
    environment overrides, prints ONE JSON line with the four keys of the
    root bench.py, value > 0."""
    env = {**os.environ, "BENCH_WARMUP_STEPS": "1", "BENCH_STEPS": "1",
           "BENCH_BATCH": "2"}
    proc = subprocess.run([sys.executable, "-m", "gan_sass_tf_tpu_torch.bench",
                           "--device", "cpu"], cwd=ROOT, env=env, timeout=300,
                          capture_output=True, text=True)
    assert proc.returncode == 0, f"stderr:\n{proc.stderr[-3000:]}"
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected ONE JSON line, got: {lines}"
    row = json.loads(lines[0])
    assert set(row) == {"metric", "value", "unit", "vs_baseline"}
    assert row["metric"] == "train_throughput_mixture_sec_per_sec_per_chip"
    assert row["value"] > 0 and row["vs_baseline"] > 0
    if not torch.cuda.is_available():     # the default device is cuda
        proc = subprocess.run([sys.executable, "-m", "gan_sass_tf_tpu_torch.bench"],
                              cwd=ROOT, env=env, timeout=300, capture_output=True,
                              text=True)
        assert proc.returncode != 0 and not proc.stdout.strip()
        assert "no CUDA device" in proc.stderr


def test_bench_spd_rows(capsys):
    """bench_spd prints a row for each K in (1, 4, 16) and one for the
    eager step, each with its keys and a positive throughput."""
    _bench_spd_rows(capsys)


def test_bench_spd_rows_host_batches(capsys, monkeypatch):
    """The same rows in host-batch mode (`--set data.device_bank=false`):
    the steps take the POOL host batches drawn ahead."""
    drawn, host_batch = [], Experiment.host_batch
    monkeypatch.setattr(Experiment, "host_batch",
                        lambda self: drawn.append(1) or host_batch(self))
    _bench_spd_rows(capsys, "--set", "data.device_bank=false")
    assert len(drawn) == POOL


def _bench_spd_rows(capsys, *sets):
    assert bench_spd.main(["2src_toy_cpu", "2", "8", "--device", "cpu", *sets]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["spd"], r["mode"]) for r in rows] == [
        (1, "eager"), (4, "eager"), (16, "eager"), (1, "eager")]
    assert [r["steps"] for r in rows] == [8, 8, 16, 8]
    for r in rows:
        assert set(r) == {"preset", "batch", "spd", "steps", "mode",
                          "mix_s_per_s_per_chip", "ms_per_step"}
        assert r["batch"] == 2 and r["mix_s_per_s_per_chip"] > 0
