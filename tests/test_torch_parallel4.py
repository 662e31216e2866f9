"""Data parallelism of the port at four gloo ranks on the CPU: the
`stream_v5e8` step with dropout and D instance noise against the JAX
package's shard_map step on a 4-device mesh, on the (dcn 1 x data 4) and
the multi-slice (dcn 2 x data 2) layouts; the ranks flattened row-major,
as the JAX `_shard_offset` flattens its shards, so the two layouts run
the same step; the eval and the batched streamer at four ranks against
one rank.

The ranks run `tests/_torch_dist_workers.py::parallel4_suite` (torch
only, one torch thread a rank), spawned once for the module; the JAX
runs and the one-rank references run in the test process.  Tolerances:
metrics 1e-4 relative and Adam's first move within 1e-2·lr
(`_check_moves`), as the two-rank tests against JAX; eval 1e-5; the
streamed output 1e-6·max|y| with the same chained permutations.  Also
the release of the graphs that hold a collective before the group is
destroyed, and `chip_smoke.py`'s W >= 2 rule on the state after a step
(`dp_state_gaps`) on made-up states."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import contextlib
import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu.config import MeshConfig
from gan_sass_tf_tpu.data.synthetic import SyntheticDataset
from gan_sass_tf_tpu.parallel import batch_sharding, make_mesh
from gan_sass_tf_tpu.train import Experiment as JExperiment
from gan_sass_tf_tpu_torch.train import Experiment
from test_torch_parallel import METRICS, _join, _load, _plain, _start
from test_torch_train import _cfg as train_cfg
from test_torch_train import _check_moves, _flat

WORLD = 4


def _mesh_cfg(dcn: int, data: int):
    """train_cfg("wav") with dropout 0.2 in G and D, instance noise 0.1,
    host batches and global batch 8 (2 a rank), on the (dcn, data) mesh."""
    base = train_cfg("wav", d_instance_noise=0.1, batch_size=8)
    return base.replace(
        model=dataclasses.replace(base.model, dropout=0.2),
        data=dataclasses.replace(base.data, device_bank=False),
        mesh=dataclasses.replace(base.mesh, dcn_axis_size=dcn, data_axis_size=data))


def _jax_init(tmp, name: str, dcn: int, data: int) -> dict:
    """The JAX Experiment on a (dcn, data) mesh of four CPU devices, from
    its seeded init; the init, STEPS batches of sources and the config go
    to the ranks (<name>_input.pkl)."""
    cfg = _mesh_cfg(dcn, data)
    jcfg = j_config.Config.from_json(cfg.to_json())
    mesh = make_mesh(MeshConfig(dcn_axis_size=dcn, data_axis_size=data),
                     devices=jax.devices()[:WORLD])
    assert dict(mesh.shape) == {"dcn": dcn, "data": data}
    exp = JExperiment(jcfg, workdir=None, mesh=mesh)
    state0 = jax.tree.map(np.asarray, exp.state)
    ds = SyntheticDataset(jcfg, seed=3)
    sources = [ds.batch() for _ in range(workers.STEPS)]
    with open(tmp / f"{name}_input.pkl", "wb") as f:
        pickle.dump({"cfg": cfg.to_json(), "sources": sources,
                     "g_params": _plain(state0.g_params),
                     "d_variables": {"params": _plain(state0.d_params),
                                     "batch_stats": _plain(state0.d_batch_stats)}}, f)
    return {"exp": exp, "mesh": mesh, "sources": sources, "cfg": cfg, "jstate0": state0}


def _jax_run(exp, mesh, sources, cfg, jstate0) -> dict:
    """STEPS steps of `_jax_init`'s Experiment on its sources: the metrics
    of each and the state after the first."""
    run = {"jax": [], "cfg": cfg, "jstate0": jstate0}
    for i, src in enumerate(sources):
        exp.state, m = exp._train_step(exp.state, jax.device_put(src, batch_sharding(mesh)),
                                       jax.random.PRNGKey(7))
        run["jax"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            run["jstate1"] = jax.tree.map(np.asarray, exp.state)
    return run


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The files of one four-rank run of every case, and the JAX runs (the
    JAX steps run while the ranks do)."""
    assert len(jax.devices()) >= WORLD
    tmp = tmp_path_factory.mktemp("dp4")
    inits = {name: _jax_init(tmp, name, *shape) for name, shape in workers.MESHES4.items()}
    ctx = _start(workers.parallel4_suite, WORLD, str(tmp))
    runs = {name: _jax_run(**init) for name, init in inits.items()}
    _join(ctx)
    return tmp, runs


@pytest.fixture(scope="module")
def one_rank():
    """evaluate(2) and the batched streamer at one rank, in this process."""
    exp = Experiment(workers.stream4_cfg(), device="cpu")
    return {"eval": exp.evaluate(num_batches=2),
            "stream": workers.recorded_streaming(exp.eval_generator(), exp.cfg,
                                                 workers.stream_mixture(exp.cfg))}


def _rank_runs(tmp, name):
    return [pickle.loads((tmp / f"{name}_rank{r}.pkl").read_bytes()) for r in range(WORLD)]


@pytest.mark.parametrize("name", sorted(workers.MESHES4))
def test_four_ranks_match_jax_shard_map(ranks, name):
    """Each rank draws its dropout masks and noise under the keys with its
    shard folded in (shards 0-3: JAX's index over (dcn, data)) and takes
    its rows of the global batch: metrics within 1e-4 relative over two
    steps, the parameters after step 1 within Adam's bounds; all ranks
    alike."""
    tmp, run = ranks[0], ranks[1][name]
    got = _rank_runs(tmp, name)
    assert [r["rank"] for r in got] == list(range(WORLD))
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"]
    for step, (j, t) in enumerate(zip(run["jax"], got[0]["metrics"]), 1):
        for k in METRICS:
            assert np.isfinite(t[k]), (step, k)
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=f"{k} {step}")
    cfg, js, j0 = run["cfg"], run["jstate1"], run["jstate0"]
    tg, td, _ = got[0]["tstate1"]
    _check_moves(_flat(tg), dict(_flat(js.g_params)), dict(_flat(j0.g_params)),
                 cfg.train.g_lr, "G")
    _check_moves(_flat(td["params"]), dict(_flat(js.d_params)),
                 dict(_flat(j0.d_params)), cfg.train.d_lr, "D")


def test_multi_slice_mesh_runs_the_flat_meshs_step(ranks):
    """(dcn 2 x data 2) and (dcn 1 x data 4) give rank r the same rows and
    the same shard index, so their steps are the same bits on every rank."""
    tmp = ranks[0]
    flat, sliced = (_rank_runs(tmp, n) for n in ("dcn1xdata4", "dcn2xdata2"))
    for a, b in zip(flat, sliced):
        assert a["metrics"] == b["metrics"]
        for part in range(2):
            for (k, v), (k2, v2) in zip(_flat(a["tstate1"][part]), _flat(b["tstate1"][part])):
                assert k == k2 and np.array_equal(v, v2), k


def test_eval_four_ranks_match_one_rank(ranks, one_rank):
    got = [_load(ranks[0], "eval4", r) for r in range(WORLD)]
    assert set(got[0]) == set(one_rank["eval"])
    for k, v in one_rank["eval"].items():
        assert np.isfinite(v)
        np.testing.assert_allclose(got[0][k], v, rtol=1e-5, atol=1e-5, err_msg=k)
        assert all(g[k] == got[0][k] for g in got), k


def test_batch_streaming_four_ranks_match_one_rank(ranks, one_rank):
    """Each rank separates 2 of a group's 8 chunks and gathers the rest;
    every rank's output and chained permutations are the one-rank ones."""
    y_ref, perm_ref = one_rank["stream"]
    for rank in range(WORLD):
        got = _load(ranks[0], "stream4", rank)
        assert got["y"].shape == y_ref.shape
        assert np.max(np.abs(got["y"] - y_ref)) <= 1e-6 * np.max(np.abs(y_ref))
        assert np.array_equal(got["perm"], perm_ref)


def test_shutdown_releases_the_graphs_captured_in_the_group(monkeypatch):
    """NCCL, destroying a communicator, waits until every CUDA graph that
    captured one of its collectives is gone: shutdown_distributed drops the
    graphs that captured one (its before_shutdown hook) before it destroys
    the group, and a released capture refuses to run or to capture again."""
    import torch.distributed as dist

    from gan_sass_tf_tpu_torch.parallel import shutdown_distributed
    from gan_sass_tf_tpu_torch.train import graphed

    order = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a: order.append(("destroy", held.graph)))
    held = graphed._Captured(lambda: None, torch.device("cpu"), 0, "a step", side=False)
    other = graphed._Captured(lambda: None, torch.device("cpu"), 0, "a call", side=False)
    held.graph = other.graph = object()
    graphed._under_group.add(held)
    shutdown_distributed()
    assert order == [("destroy", None)] and held.released and held.out is None
    assert other.graph is not None and not other.released
    with pytest.raises(RuntimeError, match="released with the process group"):
        held._replay()
    with pytest.raises(RuntimeError, match="released with the process group"):
        held._capture()


@pytest.mark.parametrize("collective", [True, False], ids=["all_reduce", "none"])
def test_only_a_capture_that_issues_a_collective_is_released(monkeypatch, collective):
    """A capture joins release_group_graphs' registry only when it issued a
    collective through a DataParallel (a serving graph keeps working after
    the group is gone)."""
    from gan_sass_tf_tpu_torch.parallel import DataParallel, mesh
    from gan_sass_tf_tpu_torch.train import graphed

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda *a, **k: None)
    dp = DataParallel(world=WORLD, rank=0, local_batch=1, group=object())
    x = torch.ones(3)
    issued = mesh.collectives_issued()
    held = graphed._Captured(lambda: dp.all_reduce_mean([x]) if collective else x * 2,
                             torch.device("cpu"), 0, "a call", side=False)
    held._capture()
    assert mesh.collectives_issued() - issued == int(collective)
    assert (held in graphed._under_group) == collective
    assert graphed.release_group_graphs() == int(collective)
    assert held.released == collective and (held.graph is None) == collective


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _adam_state(init, grads, lr):
    """flat_tensors' names after Adam's first step (b1 0.5, b2 0.999) from
    `init` with `grads`, for optimizers g and d alike."""
    state = {}
    for o in ("g", "d"):
        for n, g in grads.items():
            state[f"{o}/{n}"] = init[f"{o}/{n}"] - lr * g / (g.abs() + 1e-8)
            state[f"{o}_opt/mu/{n}"] = 0.5 * g
            state[f"{o}_opt/nu/{n}"] = 1e-3 * g * g
    state["d/u0"] = init["d/u0"].clone()
    return state


@pytest.mark.parametrize("fault, ok", [
    (None, True),
    ("a near-0 gradient's sign flipped", True),
    ("a large gradient's sign flipped", False),
    ("the gradients scaled by 1.05", False),
    ("a buffer moved", False),
])
def test_dp_state_rule_tells_rounding_from_a_wrong_all_reduce(fault, ok):
    """chip_smoke's W >= 2 rule on the group's state after one step against
    one process's: rounding passes, and so does the sign of a gradient
    within rounding of 0 (its weight moves +-lr apart); a flipped large
    gradient, gradients off by 5 % (Adam's first move alone cannot see a
    scale) and a moved buffer fail."""
    c = _chip_smoke()
    rng = np.random.default_rng(0)
    lr = 1e-4
    grads = {"w": torch.from_numpy(rng.standard_normal(256).astype(np.float32)),
             "b": torch.from_numpy(1e-5 * rng.standard_normal(16).astype(np.float32))}
    init = {f"{o}/{n}": torch.from_numpy(0.1 * rng.standard_normal(g.shape).astype(np.float32))
            for o in ("g", "d") for n, g in grads.items()}
    init["d/u0"] = torch.ones(8)
    one = _adam_state(init, grads, lr)
    bumped = {n: g * (1 + 1e-6) for n, g in grads.items()}
    if fault == "a near-0 gradient's sign flipped":
        bumped["b"][3] *= -1
    if fault == "a large gradient's sign flipped":
        bumped["w"][int(grads["w"].abs().argmax())] *= -1
    if fault == "the gradients scaled by 1.05":
        bumped = {n: g * 1.05 for n, g in grads.items()}
    group = _adam_state(init, bumped, lr)
    if fault == "a buffer moved":
        group["d/u0"][0] += 1e-3
    names = list(grads)
    gaps = c.dp_state_gaps(init, one, group, {"g": (names, lr), "d": (names, lr)})
    assert c.dp_state_ok(gaps) == ok, gaps
    assert gaps["g"]["bound"] <= 1.0 + 1e-4
    if fault == "a near-0 gradient's sign flipped":
        assert gaps["g"]["flip_tensors"] == {"b": 1}
