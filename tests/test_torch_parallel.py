"""Data parallelism of the port on the CPU: two gloo ranks against one rank,
against the JAX package's shard_map step on a 2-device mesh, and the
refusals.

The ranks run tests/_torch_dist_workers.py (torch only), spawned once for
the whole module through a file store (no TCP port); they hand their
results back as files.  The one-rank references run here, in the test
process, with no process group."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from collections.abc import Mapping
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_workers as workers
from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu.config import MeshConfig
from gan_sass_tf_tpu.data.synthetic import SyntheticDataset
from gan_sass_tf_tpu.parallel import batch_sharding, make_mesh
from gan_sass_tf_tpu.train import Experiment as JExperiment
from gan_sass_tf_tpu_torch.parallel import (
    DataParallel,
    data_parallel,
    initialize_distributed,
    mesh_shape,
)
from gan_sass_tf_tpu_torch.train import Experiment
from gan_sass_tf_tpu_torch.data import prng_key
from gan_sass_tf_tpu_torch.ops import dispatch
from gan_sass_tf_tpu_torch.ops.threefry import train_key_rows
from gan_sass_tf_tpu_torch.train.step import build_train_step, instance_noise
from test_torch_train import _cfg as train_cfg
from test_torch_train import _check_run

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
METRICS = ("d_loss", "g_loss", "g_adv", "g_recon", "d_real_logit", "d_fake_logit")


def _spawn(fn, world, *args, timeout=240.0):
    """Run fn(rank, world, *args) in `world` spawned processes; fail on a
    rank's error or after `timeout` seconds."""
    _join(_start(fn, world, *args), timeout)


def _start(fn, world, *args):
    """fn(rank, world, *args) started in `world` spawned processes."""
    return mp.start_processes(fn, args=(world, *args), nprocs=world, join=False,
                              start_method="spawn")


def _join(ctx, timeout=240.0):
    """Wait for the processes of `_start`; fail on a rank's error or after
    `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"ranks still running after {timeout} s")


def _plain(tree):
    """Nested mappings as dicts of numpy arrays (no flax type crosses to
    the ranks, which do not import JAX)."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _jax_run(tmp: Path) -> dict:
    """Case (c): the JAX Experiment on a 2-device ('dcn', 'data') mesh,
    STEPS steps of host batches from its seeded init; the init, the
    sources and the port's config go to the ranks."""
    base = train_cfg("wav")
    cfg = base.replace(data=dataclasses.replace(base.data, device_bank=False),
                       mesh=dataclasses.replace(base.mesh, data_axis_size=-1))
    jcfg = j_config.Config.from_json(cfg.to_json())
    mesh = make_mesh(MeshConfig(data_axis_size=WORLD), devices=jax.devices()[:WORLD])
    exp = JExperiment(jcfg, workdir=None, mesh=mesh)
    state0 = jax.tree.map(np.asarray, exp.state)
    ds = SyntheticDataset(jcfg, seed=3)
    sources = [ds.batch() for _ in range(workers.STEPS)]
    with open(tmp / "c_input.pkl", "wb") as f:
        pickle.dump({"cfg": cfg.to_json(), "sources": sources,
                     "g_params": _plain(state0.g_params),
                     "d_variables": {"params": _plain(state0.d_params),
                                     "batch_stats": _plain(state0.d_batch_stats)}}, f)
    run = {"jax": [], "cfg": cfg, "jstate0": state0}
    for i, src in enumerate(sources):
        exp.state, m = exp._train_step(exp.state, jax.device_put(src, batch_sharding(mesh)),
                                       jax.random.PRNGKey(7))
        run["jax"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            run["jstate1"] = jax.tree.map(np.asarray, exp.state)
    return run


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The files of one two-rank run of every case, and the JAX run."""
    tmp = tmp_path_factory.mktemp("dp")
    jax_run = _jax_run(tmp)
    _spawn(workers.suite, WORLD, str(tmp))
    return tmp, jax_run


@pytest.fixture(scope="module")
def one_rank():
    """The one-rank references, in this process (no process group)."""
    cfg = workers.dp_cfg()
    exp = Experiment(cfg, device="cpu")
    out = {"eval": exp.evaluate(num_batches=2)}
    out["stream"] = workers.recorded_streaming(exp.eval_generator(), cfg,
                                               workers.stream_mixture(cfg))
    out["bank"] = workers.run_steps(exp)
    out["host"] = workers.run_steps(Experiment(
        workers.dp_cfg(False, grad_clip=workers.HOST_CLIP), device="cpu"))
    return out


def _load(tmp, name, rank):
    return dict(np.load(tmp / f"{name}_rank{rank}.npz"))


@pytest.mark.parametrize("mode", ["bank", "host"])
def test_two_ranks_metrics_match_one_rank(ranks, one_rank, mode):
    """Each step's six metrics, 2 ranks x B/2 against 1 rank x B: gains,
    a noise source, R1 and the EMA on; host batches with every gradient
    clipped.  (Instance noise is drawn per shard, as the reference's, and
    held to its shard_map step in tests/test_torch_options_dist.py.)"""
    got, ref = _load(ranks[0], mode, 0), one_rank[mode]
    for step in range(1, workers.STEPS + 1):
        for k in METRICS:
            np.testing.assert_allclose(got[f"m{step}/{k}"], ref[f"m{step}/{k}"],
                                       rtol=2e-4, atol=1e-5, err_msg=f"{mode} {k} {step}")


@pytest.mark.parametrize("mode", ["bank", "host"])
def test_two_ranks_params_match_one_rank(ranks, one_rank, mode):
    got, ref = _load(ranks[0], mode, 0), one_rank[mode]
    params = [k for k in ref if k.startswith("p/")]
    assert any(k.startswith("p/ema/") for k in params)
    assert any(k.startswith("p/d/u") for k in params)       # spectral-norm state
    for k in params:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=2e-5,
                                   err_msg=f"{mode} {k}")


@pytest.mark.parametrize("mode", ["bank", "host"])
def test_ranks_hold_bitwise_equal_state(ranks, mode):
    """Every state tensor bitwise equal on both ranks, D's spectral-norm u
    and sigma too, which the step does not all-reduce."""
    a, b = _load(ranks[0], mode, 0), _load(ranks[0], mode, 1)
    assert a.keys() == b.keys()
    assert any(k.startswith("p/d/u") for k in a) and any(k.startswith("p/d/sigma") for k in a)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_step_all_reduces_gradients_and_metrics(monkeypatch):
    """The step's collectives: one SUM (then ÷ world) of D's gradients a D
    step, one of G's gradients, one of the six metrics, and none of D's
    spectral-norm buffers."""
    import torch.distributed as dist

    exp = Experiment(workers.dp_cfg(d_steps=2), device="cpu")
    sizes = []

    def all_reduce(flat, op, group):
        assert op == dist.ReduceOp.SUM and flat.dtype == torch.float32
        sizes.append(flat.numel())

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    dp = DataParallel(1, 0, exp.cfg.train.batch_size, group=object())
    step = build_train_step(exp.cfg, from_bank=True, local_batch=dp.local_batch, dp=dp)
    step(exp.state, exp._bank, exp._train_key)
    numel = lambda ts: sum(t.numel() for t in ts)   # noqa: E731
    assert sizes == [numel(exp.state.d_opt.params)] * 2 + [numel(exp.state.g_opt.params), 6]
    assert numel(exp.state.d.buffers()) not in sizes


def test_host_case_clips_every_gradient():
    """The host case's premise: every G and D gradient exceeds its clip, so
    averaging per-rank clipped gradients would not give the one-rank step;
    its 2-rank match shows the ranks average before the clip."""
    exp = Experiment(workers.dp_cfg(False, grad_clip=workers.HOST_CLIP), device="cpu")
    norms = []
    for opt in (exp.state.g_opt, exp.state.d_opt):
        def step(grads, inner=opt.step):
            norms.append(float(torch.stack(torch._foreach_norm(list(grads))).norm()))
            inner(grads)
        opt.step = step
    exp.train(num_steps=1)
    assert len(norms) == 1 + exp.cfg.train.d_steps
    assert min(norms) > 10 * workers.HOST_CLIP, norms


def test_two_ranks_match_jax_shard_map(ranks):
    """Case (c): the port at 2 ranks against the JAX Experiment on a
    2-device mesh, from the same converted init on the same sources, at
    tests/test_torch_train.py's tolerances."""
    tmp, run = ranks
    with open(tmp / "jax_rank0.pkl", "rb") as f:
        r0 = pickle.load(f)
    with open(tmp / "jax_rank1.pkl", "rb") as f:
        r1 = pickle.load(f)
    assert r0["metrics"] == r1["metrics"]
    _check_run({**run, "torch": r0["metrics"], "tstate1": r0["tstate1"]})


def test_eval_two_ranks_match_one_rank(ranks, one_rank):
    got = _load(ranks[0], "eval", 0)
    assert set(got) == set(one_rank["eval"]) == {"si_sdr", "si_sdr_mix",
                                                 "si_sdr_improvement"}
    for k, v in one_rank["eval"].items():
        assert np.isfinite(v)
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
        assert got[k] == _load(ranks[0], "eval", 1)[k]


def test_batch_streaming_two_ranks_match_one_rank(ranks, one_rank):
    """Each rank separates 2 of a group's 4 chunks and gathers the rest;
    the output and the chained permutations are the one-rank ones."""
    y_ref, perm_ref = one_rank["stream"]
    for rank in range(WORLD):
        got = _load(ranks[0], "stream", rank)
        assert got["y"].shape == y_ref.shape
        assert np.max(np.abs(got["y"] - y_ref)) <= 1e-6 * np.max(np.abs(y_ref))
        assert np.array_equal(got["perm"], perm_ref)


def test_workdir_written_once_by_rank_zero(ranks):
    wd = ranks[0] / "wd_resumed"
    files = sorted(str(p.relative_to(wd)) for p in wd.rglob("*") if p.is_file())
    assert files == ["best.json", "best/2.pt", "checkpoints/1.pt", "checkpoints/2.pt",
                     "checkpoints/3.pt", "config.json", "metrics.jsonl"]
    rows = [json.loads(line) for line in (wd / "metrics.jsonl").read_text().splitlines()]
    train_steps = [r["step"] for r in rows if "g_loss" in r]
    eval_steps = [r["step"] for r in rows if "eval_si_sdr" in r]
    assert train_steps == [1, 2, 3] and eval_steps == [2]


def test_workdir_resume_is_exact_over_two_ranks(ranks):
    """2 steps, then a new Experiment that resumes for a 3rd, against 3
    steps in one go: bitwise equal on both ranks."""
    for rank in range(WORLD):
        a, b = _load(ranks[0], "wd_resumed", rank), _load(ranks[0], "wd_straight", rank)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), (rank, k)


@pytest.mark.parametrize("case,match", [
    ("mesh_larger", "mesh needs 4 devices"),
    ("mesh_smaller", "must span every rank"),
    ("batch", "global batch_size 3 must be divisible by the mesh size 2"),
    ("batch_chunks", "stream.batch_chunks 3 must be divisible by the mesh size 2"),
])
def test_refused_at_two_ranks(ranks, case, match):
    for rank in range(WORLD):
        errors = json.loads((ranks[0] / f"errors_rank{rank}.json").read_text())
        assert errors[case] is not None and match in errors[case], errors[case]


@pytest.mark.parametrize("dcn,data,world,want", [
    (1, -1, 4, (1, 4)), (2, -1, 4, (2, 2)), (1, 2, 2, (1, 2)), (2, 2, 4, (2, 2)),
    (1, 8, 2, None), (1, 1, 2, None), (3, -1, 4, None)])
def test_mesh_shape(dcn, data, world, want):
    mesh = MeshConfig(data_axis_size=data, dcn_axis_size=dcn)
    if want is None:
        with pytest.raises(ValueError, match="mesh needs"):
            mesh_shape(mesh, world)
    else:
        assert mesh_shape(mesh, world) == want


def test_no_group_runs_on_one_device(capsys):
    """Without a process group: one device whatever cfg.mesh says (a note
    names the mesh), and every collective is a no-op."""
    from gan_sass_tf_tpu_torch import config

    dp = data_parallel(config.get_config("stream_v5e8").mesh, 32)
    assert (dp.world, dp.rank, dp.local_batch, dp.group) == (1, 0, 32, None)
    assert "dcn=1 × data=8 = 8 devices" in capsys.readouterr().err
    x = torch.arange(4.0)
    dp.all_reduce_mean([x])
    dp.broadcast_([x])
    assert torch.equal(dp.all_gather(x), x) and torch.equal(x, torch.arange(4.0))
    assert dp.batch_rows(32) == slice(0, 32)
    assert DataParallel(4, 3, 2).batch_rows(8) == slice(6, 8)


def test_instance_noise_folds_in_the_shard():
    """Rank r draws its D noise under the step's key with r folded in, as
    shard r of the reference's step (rng_dl folded with the shard, then
    with the D step, split in 3): jax.random's noise under that key, and
    another noise on each rank."""
    key, step, std = prng_key(9), torch.tensor(4), 0.3
    x = torch.zeros(8, 5, 3, 2)
    _, d_rows, _ = train_key_rows(1)
    rng_dl = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(9), 4), 5)[3]
    got = []
    for rank in range(WORLD):
        keys = dispatch.step_batch(key, torch.zeros(1, 2, 8), 0.0, step=step, shard=rank,
                                   d_steps=1).train_keys
        ours = instance_noise(x, std, keys[d_rows[0][1]])
        k = jax.random.split(jax.random.fold_in(jax.random.fold_in(rng_dl, rank), 0), 3)[1]
        np.testing.assert_allclose(ours.numpy(), np.asarray(std * jax.random.normal(k, x.shape)),
                                   rtol=0, atol=1e-6)
        got.append(ours)
    assert not torch.equal(got[0], got[1])


def test_initialize_distributed_without_torchrun_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed(device="cpu") is False
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        initialize_distributed(device="cpu")


def _dryrun(*args):
    return subprocess.run(
        [sys.executable, "-m", "gan_sass_tf_tpu_torch.parallel.dryrun", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=180,
        env={**os.environ, "PYTHONPATH": str(ROOT)})


def test_dryrun_two_gloo_ranks():
    out = _dryrun("--world", "2", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): ok — metrics {"), line
    assert "g_loss" in line


def test_dryrun_refuses_cuda_without_a_card():
    out = _dryrun("--world", "2", "--device", "cuda")
    assert out.returncode != 0 and "ok" not in out.stdout
    assert "CUDA" in out.stderr


def test_dryrun_defaults_to_cuda():
    """Without --device the dryrun asks for the card, and fails without one."""
    out = _dryrun("--world", "2")
    assert out.returncode != 0 and "ok" not in out.stdout
    assert "CUDA" in out.stderr
