"""The port's model options data parallel on the CPU, at two gloo ranks: the
BN discriminator against the JAX package's shard_map step (each shard
normalizes with its own batch, then the running statistics are averaged,
so two ranks do not equal one rank there), dropout and instance noise
against that step too (each shard draws its masks and noise under its own
shard-folded keys), and the quality scripts (one line, from rank 0, equal
to one rank's).

The ranks run `tests/_torch_dist_workers.py::options_suite` (torch only),
spawned once for the module; the references run in the test process."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses
import json
import pickle

import jax
import numpy as np
import pytest

import _torch_dist_workers as workers
from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu.config import MeshConfig
from gan_sass_tf_tpu.data.synthetic import SyntheticDataset
from gan_sass_tf_tpu.parallel import batch_sharding, make_mesh
from gan_sass_tf_tpu.train import Experiment as JExperiment
from gan_sass_tf_tpu_torch.scripts import quality_protocol, recompute_bounds
from gan_sass_tf_tpu_torch.train import Experiment
from test_torch_parallel import METRICS, WORLD, _plain, _spawn
from test_torch_train import _cfg as train_cfg
from test_torch_train import _check_moves, _flat


def _bn_cfg():
    """train_cfg("wav") with the BN D on the frame-folded input, instance
    noise 0.1, host batches, the mesh over every rank."""
    base = train_cfg("wav", d_instance_noise=0.1)
    return base.replace(
        model=dataclasses.replace(base.model, d_norm="batch", d_input_fold=2),
        data=dataclasses.replace(base.data, device_bank=False),
        mesh=dataclasses.replace(base.mesh, data_axis_size=-1))


def _dropout_cfg():
    """train_cfg("wav") with dropout 0.2 in G and the spectral-norm D,
    instance noise 0.1, host batches, the mesh over every rank."""
    base = train_cfg("wav", d_instance_noise=0.1)
    return base.replace(
        model=dataclasses.replace(base.model, dropout=0.2),
        data=dataclasses.replace(base.data, device_bank=False),
        mesh=dataclasses.replace(base.mesh, data_axis_size=-1))


def _jax_run(tmp, name, cfg) -> dict:
    """The JAX Experiment on a 2-device mesh, STEPS steps from its seeded
    init; the init, the sources and the config go to the ranks
    (<name>_input.pkl)."""
    jcfg = j_config.Config.from_json(cfg.to_json())
    mesh = make_mesh(MeshConfig(data_axis_size=WORLD), devices=jax.devices()[:WORLD])
    exp = JExperiment(jcfg, workdir=None, mesh=mesh)
    state0 = jax.tree.map(np.asarray, exp.state)
    ds = SyntheticDataset(jcfg, seed=3)
    sources = [ds.batch() for _ in range(workers.STEPS)]
    with open(tmp / f"{name}_input.pkl", "wb") as f:
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
    tmp = tmp_path_factory.mktemp("options_dp")
    runs = {"bn": _jax_run(tmp, "bn", _bn_cfg()),
            "dropout": _jax_run(tmp, "dropout", _dropout_cfg())}
    _spawn(workers.options_suite, WORLD, str(tmp))
    return tmp, runs


def test_bn_discriminator_two_ranks_match_jax_shard_map(ranks):
    """Metrics within 1e-4 relative over two steps; after step 1 the
    parameters (the biases of the convs feeding a BN, whose gradient is
    zero, only within Adam's bound) and the averaged running statistics
    within 1e-6; both ranks alike."""
    tmp, run = ranks[0], ranks[1]["bn"]
    r0, r1 = (pickle.loads((tmp / f"bn_rank{r}.pkl").read_bytes()) for r in range(WORLD))
    assert r0["metrics"] == r1["metrics"]
    for step, (j, t) in enumerate(zip(run["jax"], r0["metrics"]), 1):
        for k in METRICS:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=f"{k} {step}")
    cfg, js, j0 = run["cfg"], run["jstate1"], run["jstate0"]
    tg, td, _ = r0["tstate1"]
    _check_moves(_flat(tg), dict(_flat(js.g_params)), dict(_flat(j0.g_params)),
                 cfg.train.g_lr, "G")
    pre_bn = {f"Conv_{i}/bias" for i in range(1, len(cfg.model.d_channels))}
    _check_moves([kv for kv in _flat(td["params"]) if kv[0] not in pre_bn],
                 dict(_flat(js.d_params)), dict(_flat(j0.d_params)), cfg.train.d_lr, "D")
    stats = dict(_flat(js.d_batch_stats))
    got = dict(_flat(td["batch_stats"]))
    assert got.keys() == stats.keys() and stats
    for k, v in got.items():
        np.testing.assert_allclose(v, stats[k], atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(v, dict(_flat(r1["tstate1"][1]["batch_stats"]))[k])


def test_dropout_two_ranks_match_jax_shard_map(ranks):
    """Dropout 0.2 in G and the spectral-norm D with instance noise 0.1: each
    rank draws under its shard-folded keys, as each shard of the JAX step;
    metrics within 1e-4 relative over two steps and the parameters after
    step 1 at the BN test's tolerances; both ranks alike."""
    tmp, run = ranks[0], ranks[1]["dropout"]
    r0, r1 = (pickle.loads((tmp / f"dropout_rank{r}.pkl").read_bytes())
              for r in range(WORLD))
    assert r0["metrics"] == r1["metrics"]
    for step, (j, t) in enumerate(zip(run["jax"], r0["metrics"]), 1):
        for k in METRICS:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=f"{k} {step}")
    cfg, js, j0 = run["cfg"], run["jstate1"], run["jstate0"]
    tg, td, _ = r0["tstate1"]
    _check_moves(_flat(tg), dict(_flat(js.g_params)), dict(_flat(j0.g_params)),
                 cfg.train.g_lr, "G")
    _check_moves(_flat(td["params"]), dict(_flat(js.d_params)),
                 dict(_flat(j0.d_params)), cfg.train.d_lr, "D")


def test_dropout_changes_the_step():
    """The premise of the rank test: with dropout the step's losses differ
    from the same step without it."""
    with_drop = Experiment(workers.dropout_cfg(), device="cpu").train(num_steps=1)
    without = Experiment(workers.dp_cfg(), device="cpu").train(num_steps=1)
    assert abs(with_drop["g_loss"] - without["g_loss"]) > 1e-3


def test_quality_scripts_print_one_line_equal_to_one_rank(ranks, capsys):
    """Under a two-rank group the quality protocol and the bounds print one
    JSON line, from rank 0.  The bound is bitwise one rank's (its batches
    are dealt out and their values summed); the protocol's scores come
    from data-parallel training, equal to one rank's up to float rounding
    (within 0.02 dB after rounding to 0.01 dB), and its throughput is the
    ranks' own."""
    lines = [json.loads((ranks[0] / f"quality_rank{r}.json").read_text())
             for r in range(WORLD)]
    assert lines[1] == {"quality": "", "bounds": ""}
    got_q = json.loads(lines[0]["quality"])
    got_b = json.loads(lines[0]["bounds"])
    assert quality_protocol.main(workers.QUALITY_ARGV) == 0
    ref_q = json.loads(capsys.readouterr().out)
    assert recompute_bounds.main(workers.BOUNDS_ARGV) == 0
    ref_b = json.loads(capsys.readouterr().out)
    assert got_b == ref_b
    assert got_q.keys() == ref_q.keys()
    assert got_q["oracle_bound"] == ref_q["oracle_bound"]
    for k, v in ref_q.items():
        if k in ("throughput", "d_loss_traj_per_seed"):
            continue
        if isinstance(v, float):
            assert abs(got_q[k] - v) <= 0.02 + 1e-9, (k, got_q[k], v)
        elif isinstance(v, list):
            np.testing.assert_allclose(got_q[k], v, atol=0.02 + 1e-9, err_msg=k)
        else:
            assert got_q[k] == v, k
