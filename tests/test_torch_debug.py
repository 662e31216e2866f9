"""The port's debug tripwires against the JAX package's: `debug_nans`
(jax_debug_nans) and `debug_leaks` (jax_check_tracer_leaks).

The JAX side runs its train step under jax.jit without the Experiment's
shard_map: with a NaN anywhere in the sharded step, jax_debug_nans
recurses through shard_map's output reshaping until RecursionError in
this JAX version.  It also checks only a call that compiles, so each JAX
case jits afresh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu.data.synthetic import SyntheticDataset
from gan_sass_tf_tpu.train.state import create_train_state as j_create_train_state
from gan_sass_tf_tpu.train.step import build_train_step as j_build_train_step
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.train import Experiment


def _cfg():
    cfg = config.get_config("2src_toy_cpu")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, g_channels=(8, 16), d_channels=(8, 16)),
        train=dataclasses.replace(cfg.train, batch_size=2, log_every=1),
        data=dataclasses.replace(cfg.data, segment_seconds=0.25, bank_utterances=4))


def _nan_g_weight_jax(g_params):
    """G's params with one element of the first conv kernel set to NaN
    (through numpy: under jax_debug_nans a jnp op making a NaN raises)."""
    leaves, tree = jax.tree.flatten(g_params)
    i = next(i for i, leaf in enumerate(leaves) if leaf.ndim == 4)
    bad = np.array(leaves[i])
    bad.flat[0] = np.nan
    leaves[i] = jax.device_put(bad)
    return jax.tree.unflatten(tree, leaves)


def _nan_g_weight_torch(g):
    """The same for the port's G: its first conv kernel's first element."""
    weight = next(p for p in g.parameters() if p.dim() == 4)
    with torch.no_grad():
        weight.view(-1)[0] = float("nan")


def test_debug_nans_raises_where_jax_does():
    """One G weight NaN: the JAX step under jax_debug_nans and the port's
    Experiment(debug_nans=True) both raise FloatingPointError; a clean
    step then passes in both, and anomaly mode is off again after the
    port's steps."""
    jcfg = j_config.Config.from_json(_cfg().to_json())
    g, d = jmodels.build_generator(jcfg), jmodels.build_discriminator(jcfg)
    state = j_create_train_state(jcfg, g, d, jax.random.PRNGKey(0))
    src = jnp.asarray(SyntheticDataset(jcfg, seed=3).batch())
    step = j_build_train_step(jcfg, g, d)
    jax.config.update("jax_debug_nans", True)
    try:
        jstep = jax.jit(step)
        with pytest.raises(FloatingPointError):
            jstep(state.replace(g_params=_nan_g_weight_jax(state.g_params)), src,
                  jax.random.PRNGKey(7))
        _, jm = jstep(state, src, jax.random.PRNGKey(7))
        assert all(np.isfinite(float(v)) for v in jm.values())
    finally:
        jax.config.update("jax_debug_nans", False)

    assert not torch.is_anomaly_enabled()
    exp = Experiment(_cfg(), device="cpu", debug_nans=True)
    _nan_g_weight_torch(exp.state.g)
    with pytest.raises(FloatingPointError, match="debug_nans"):
        exp.train(num_steps=1)
    assert not torch.is_anomaly_enabled()
    clean = Experiment(_cfg(), device="cpu", debug_nans=True)
    m = clean.train(num_steps=2)
    assert all(np.isfinite(v) for v in m.values())
    assert not torch.is_anomaly_enabled()


def test_debug_nans_names_a_non_finite_state_tensor():
    """A NaN that no backward sees (an Adam moment) is found in the state
    after the step and named."""
    exp = Experiment(_cfg(), device="cpu", debug_nans=True)
    exp.state.d_opt.nu[0].view(-1)[0] = float("inf")
    with pytest.raises(FloatingPointError, match="d_opt/nu/"):
        exp.train(num_steps=1)


def test_debug_leaks_clean_step_passes():
    exp = Experiment(_cfg(), device="cpu", debug_leaks=True)
    m = exp.train(num_steps=2)
    assert np.isfinite(m["g_loss"])


@pytest.mark.parametrize("where", ["metric", "state"])
def test_debug_leaks_raises_on_a_leaked_graph(where):
    """A step patched to keep a metric, or a D buffer, with its autograd
    graph raises RuntimeError naming it; without debug_leaks it trains."""
    for debug in (False, True):
        exp = Experiment(_cfg(), device="cpu", debug_leaks=debug)
        inner = exp._train_step

        def leaky(state, data, seed):
            state, metrics = inner(state, data, seed)
            w = next(state.g.parameters())
            if where == "metric":
                metrics = {**metrics, "g_loss": metrics["g_loss"] + 0.0 * w.sum()}
            else:
                name, buf = next(state.d.named_buffers())
                setattr(_owner(state.d, name), name.rsplit(".", 1)[-1],
                        buf + 0.0 * w.sum())
            return state, metrics

        exp._train_step = leaky
        if not debug:
            exp.train(num_steps=1)
            continue
        with pytest.raises(RuntimeError, match="debug_leaks: " + (
                "metrics/g_loss" if where == "metric" else "d/")):
            exp.train(num_steps=1)


def _owner(module, name):
    """The submodule that holds the buffer `name` (a dotted path)."""
    for part in name.split(".")[:-1]:
        module = getattr(module, part)
    return module
