"""The port's random numbers against `jax.random` and flax: threefry keys,
bits and samplers (`data/threefry.py`, the plain version of the threefry
kernel), the train step's key derivation, bank sampling and mixing under a
key with nothing injected, the initial weights of `create_train_state`, a
12-step trajectory of the hard data path from one seed, and the quality
protocol's bound.

Bits, uniforms and randints are held equal bit for bit.  Normals and
truncated normals are held within NORMAL_ULP units in the last place:
both packages compute √2·erf⁻¹(u) from the same float32 uniform with XLA's
polynomial, but the port's log1p (torch's) and XLA's own differ in the
last bit (3 ulp measured at most over 10^5 draws)."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu.data.device_bank import build_bank as j_build_bank
from gan_sass_tf_tpu.data.device_bank import sample_bank as j_sample_bank
from gan_sass_tf_tpu.data.mixer import mix_sources as j_mix_sources
from gan_sass_tf_tpu.data.synthetic import SyntheticDataset as JSynthetic
from gan_sass_tf_tpu.train.state import create_train_state as j_create_train_state
from gan_sass_tf_tpu.train.step import build_train_step as j_build_train_step
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch import data as tdata
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch.data import threefry as tf
from gan_sass_tf_tpu_torch.ops import dispatch
from gan_sass_tf_tpu_torch.ops import threefry as rng_ops
from gan_sass_tf_tpu_torch.scripts import quality_protocol
from gan_sass_tf_tpu_torch.train import build_train_step, create_train_state

SEEDS = (0, 7, 2 ** 31 - 1)
SHAPES = ((37,), (3, 50))
NORMAL_ULP = 4
# Initial weights: kernels are truncated normals (NORMAL_ULP) times a
# float32 std; the BiLSTM's recurrent kernels come from two LAPACK QRs of
# the same normal (measured 2.1e-6 at most).
INIT_ATOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x)


def _ulps(a, b) -> int:
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    return int(np.abs(a - b).max())


def _jax(cfg):
    return j_config.Config.from_json(cfg.to_json())


# -- keys, bits and samplers ------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    for d in (0, 1, 12345, 2 ** 32 - 1):
        np.testing.assert_array_equal(tf.fold_in(tk, d).numpy(),
                                      _np(jax.random.fold_in(jk, d)))
    for n in (2, 5):
        np.testing.assert_array_equal(tf.split(tk, n).numpy(),
                                      _np(jax.random.split(jk, n)))
    # A batch of keys folds and splits row by row, as vmap does.
    ids = torch.arange(3, 9)
    rows = jax.vmap(jax.random.fold_in, (None, 0))(jk, jnp.arange(3, 9))
    np.testing.assert_array_equal(tf.fold_in(tk, ids).numpy(), _np(rows))
    np.testing.assert_array_equal(tf.split(tf.fold_in(tk, ids)).numpy(),
                                  _np(jax.vmap(jax.random.split)(rows)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_and_randint_equal_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
    np.testing.assert_array_equal(tf.random_bits(tk, shape).numpy(),
                                  _np(jax.random.bits(jk, shape)).astype(np.int64))
    for lo, hi in ((0.0, 1.0), (-3.0, 3.0), (-0.5, 2.0)):
        ours = tf.uniform(tk, shape, lo, hi).numpy()
        ref = _np(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))
    for lo, hi in ((0, 5), (0, 32_000), (-7, 100_000)):
        np.testing.assert_array_equal(tf.randint(tk, shape, lo, hi).numpy(),
                                      _np(jax.random.randint(jk, shape, lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_truncated_normal_within_ulps_of_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
    ours, ref = tf.normal(tk, (20_000,)), jax.random.normal(jk, (20_000,))
    assert _ulps(ours, ref) <= NORMAL_ULP
    ours = tf.truncated_normal(tk, -2.0, 2.0, (4, 500))
    ref = jax.random.truncated_normal(jk, -2.0, 2.0, (4, 500))
    assert _ulps(ours, ref) <= NORMAL_ULP
    assert float(ours.abs().max()) < 2.0


def test_erf_inv_edges_and_xla_constants():
    x = torch.tensor([-1.0, 1.0, 0.0, tf.NORMAL_LOW], dtype=torch.float32)
    ours = tf.erf_inv(x).numpy()
    ref = _np(jax.scipy.special.erfinv(jnp.asarray(x.numpy())))
    assert np.isneginf(ours[0]) and np.isposinf(ours[1]) and ours[2] == 0.0
    assert _ulps(ours[3:], ref[3:]) <= NORMAL_ULP
    assert np.float32(tf.SQRT2) == np.float32(np.sqrt(2.0))


@pytest.mark.parametrize("seed,step", [(1, 0), (8, 41), (2 ** 31 - 1, 2 ** 31 + 5)])
def test_step_tensor_keys_equal_int_keys_and_jax_derivation(seed, step):
    """The train step's per-example keys from a 0-d step tensor equal the
    int path, and the JAX step's derivation: fold_in(rng, step), split in
    5, rng_data then rng_mix folded with each global example and split."""
    key = tf.prng_key(seed)
    ints = rng_ops.example_keys_reference(key, 3, 4, step=step)
    tens = rng_ops.example_keys_reference(key, 3, 4,
                                          step=torch.tensor(step, dtype=torch.int64))
    assert torch.equal(ints, tens)
    assert torch.equal(tf.prng_key(torch.tensor(seed, dtype=torch.int64)), key)
    r = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(step & 0xFFFFFFFF))
    rng_mix, rng_data = jax.random.split(r, 5)[:2]
    ids = 3 + jnp.arange(4)
    for base, ours in ((rng_data, ints[0]), (rng_mix, ints[1])):
        rows = jax.vmap(jax.random.fold_in, (None, 0))(base, ids)
        np.testing.assert_array_equal(ours.transpose(0, 1).numpy(),
                                      _np(jax.vmap(jax.random.split)(rows)))


@pytest.mark.parametrize("kind", ["bits", "uniform", "randint", "normal"])
def test_sample_reference_draws_a_row_per_key(kind):
    """`ops.dispatch.draw` on CPU keys: row r is the jax.random draw under
    keys[r] (randint's bounds, a uniform's range)."""
    keys = tf.split(tf.prng_key(11), 3)
    lo, hi = {"randint": (2, 900), "uniform": (-3.0, 3.0)}.get(kind, (0.0, 1.0))
    ours = dispatch.draw(keys, 50, kind, lo, hi)
    for r in range(3):
        jk = jnp.asarray(keys[r].numpy().astype(np.uint32))
        ref = {"bits": lambda: jax.random.bits(jk, (50,)),
               "uniform": lambda: jax.random.uniform(jk, (50,), minval=lo, maxval=hi),
               "randint": lambda: jax.random.randint(jk, (50,), lo, hi),
               "normal": lambda: jax.random.normal(jk, (50,))}[kind]()
        if kind == "normal":
            assert _ulps(ours[r], ref) <= NORMAL_ULP
        else:
            np.testing.assert_array_equal(ours[r].numpy(),
                                          _np(ref).astype(ours.numpy().dtype))


# -- bank sampling and mixing under one key ---------------------------------

def _hard_cfg(name="stream_v5e8", **data):
    cfg = config.get_config(name)
    data = {"segment_seconds": 0.25, "bank_utterances": 5, "gain_jitter_db": 3.0,
            "num_noise": 1, "snr_db": 10.0, "f0_mode": "shared", **data}
    return cfg.replace(data=dataclasses.replace(cfg.data, **data))


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_bank_equals_jax_under_one_key(seed):
    bank = np.random.default_rng(seed % 97).standard_normal((2, 5, 300)).astype(np.float32)
    ref = j_sample_bank(jnp.asarray(bank), jax.random.PRNGKey(seed), 6, 4)
    ours = tdata.sample_bank(torch.from_numpy(bank), tf.prng_key(seed), 6,
                             example_offset=4)
    np.testing.assert_array_equal(ours.numpy(), _np(ref))


@pytest.mark.parametrize("seed", SEEDS)
def test_mix_sources_equals_jax_under_one_key(seed):
    """Gains within ±3 dB and noise at 10 dB SNR, drawn by each package
    from the same key: the scaled sources bit for bit (the same gains), the
    mixture within its normals' ulps."""
    cfg = _hard_cfg()
    src = np.random.default_rng(seed % 89).standard_normal((5, 2, 2000)).astype(np.float32)
    mix, scaled = j_mix_sources(jnp.asarray(src), jax.random.PRNGKey(seed),
                                _jax(cfg).data, 3)
    tmix, tscaled = tdata.mix_sources(torch.from_numpy(src), tf.prng_key(seed),
                                      cfg.data, example_offset=3)
    np.testing.assert_array_equal(tscaled.numpy(), _np(scaled))
    np.testing.assert_allclose(tmix.numpy(), _np(mix), rtol=0,
                               atol=1e-6 * float(np.abs(_np(mix)).max()))


# -- initial weights --------------------------------------------------------

_INIT_CASES = {
    "stream_v5e8": {"g_channels": (8, 16), "d_channels": (8, 16)},
    "wsj0_logmel": {"g_channels": (8, 16), "d_channels": (8, 16)},
    "3src_pit": {"g_hidden": 16, "g_layers": 2, "d_channels": (8, 16),
                 "g_film_channels": 8},
}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(_INIT_CASES))
def test_create_train_state_draws_flax_init(name, seed):
    """The port's G and D from `seed` equal the JAX `create_train_state`'s
    from PRNGKey(seed), leaf for leaf: lecun-normal kernels, orthogonal
    LSTM recurrent kernels, zero biases, spectral-norm u and the kernels
    it normalizes at init."""
    cfg = config.get_config(name)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **_INIT_CASES[name]),
                      train=dataclasses.replace(cfg.train, batch_size=2),
                      data=dataclasses.replace(cfg.data, segment_seconds=0.25))
    jcfg = _jax(cfg)
    js = j_create_train_state(jcfg, jmodels.build_generator(jcfg),
                              jmodels.build_discriminator(jcfg),
                              jax.random.PRNGKey(seed))
    ts = create_train_state(cfg, "cpu", seed)
    pairs = (
        (tmodels.generator_params_to_flax(ts.g.state_dict()), dict(_flat(js.g_params))),
        (dict(_flat(tmodels.discriminator_variables_to_flax(ts.d.state_dict()))),
         dict(_flat({"params": js.d_params, "batch_stats": js.d_batch_stats}))))
    for ours, ref in pairs:
        assert set(ours) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(ours[k], v, rtol=0, atol=INIT_ATOL, err_msg=k)


# -- the hard data path over 12 steps from one seed -------------------------

TRAJECTORY_STEPS, SEED = 12, 3


@pytest.fixture(scope="module")
def hard_run():
    """12 f32 steps of the stream_v5e8 geometry at narrow widths in device
    bank mode, with gains, noise and shared-f0 sources, each package from
    its own init and train key of one seed (PRNGKey(seed), PRNGKey(seed +
    1)) and its own bank of that seed: no converted weights, no injected
    draws."""
    cfg = _hard_cfg(device_bank=True, bank_utterances=6)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, g_channels=(8, 16), d_channels=(8, 16),
                                  compute_dtype="float32", dropout=0.0),
        train=dataclasses.replace(cfg.train, batch_size=2, d_instance_noise=0.0))
    jcfg, b = _jax(cfg), cfg.train.batch_size
    g, d = jmodels.build_generator(jcfg), jmodels.build_discriminator(jcfg)
    jstate = j_create_train_state(jcfg, g, d, jax.random.PRNGKey(SEED))
    jstep = jax.jit(j_build_train_step(jcfg, g, d, from_bank=True, local_batch=b))
    jbank = jnp.asarray(j_build_bank(jcfg, seed=SEED))
    tstate = create_train_state(cfg, "cpu", SEED)
    tstep = build_train_step(cfg, from_bank=True, local_batch=b)
    tbank = torch.from_numpy(tdata.build_bank(cfg, seed=SEED))
    jkey, tkey = jax.random.PRNGKey(SEED + 1), tf.prng_key(SEED + 1)
    out = {"cfg": cfg, "jax": [], "torch": []}
    for _ in range(TRAJECTORY_STEPS):
        jstate, jm = jstep(jstate, jbank, jkey)
        tstate, tm = tstep(tstate, tbank, tkey)
        out["jax"].append({k: float(v) for k, v in jm.items()})
        out["torch"].append({k: float(v) for k, v in tm.items()})
    out["jstate"] = jax.tree.map(np.asarray, jstate)
    out["tstate"] = (tmodels.generator_params_to_flax(tstate.g.state_dict()),
                     tmodels.discriminator_variables_to_flax(tstate.d.state_dict()))
    return out


def test_hard_data_path_trajectory_from_one_seed_matches_jax(hard_run):
    """The losses within 1e-4 relative at every step and every G and D
    parameter within 1e-2·lr after step 12: the bounds of
    tests/test_torch_train.py's 12-step trajectory, here with nothing
    handed across."""
    run = hard_run
    for step, (j, t) in enumerate(zip(run["jax"], run["torch"]), 1):
        for k in ("g_loss", "d_loss", "g_recon"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                       err_msg=f"{k} after step {step}")
    cfg, js = run["cfg"], run["jstate"]
    tg, td = run["tstate"]
    for ours, ref, lr, what in ((tg, js.g_params, cfg.train.g_lr, "G"),
                                (td["params"], js.d_params, cfg.train.d_lr, "D")):
        ref = dict(_flat(ref))
        for k, v in _flat(ours):
            np.testing.assert_allclose(v, ref[k], atol=1e-2 * lr, rtol=0,
                                       err_msg=f"{what} {k} after step 12")


# -- the quality protocol's bound -------------------------------------------

def _jax_quality_protocol():
    spec = importlib.util.spec_from_file_location(
        "jax_quality_protocol", ROOT / "scripts" / "quality_protocol.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 7])
def test_bound_equals_jax_oracle_bound_on_eval(seed):
    """The port's `oracle_bound_on_eval` and the JAX script's, each on its
    own eval split of one seed, batch i mixed under PRNGKey(20 000 + i):
    the same number within 0.01 dB (tests/test_torch_oracle.py's bound
    tolerance)."""
    cfg = quality_protocol.protocol_config(
        "stream_v5e8", True, ["data.segment_seconds=0.25", "train.batch_size=2"])
    jcfg = _jax(cfg)
    ref = _jax_quality_protocol().oracle_bound_on_eval(
        types.SimpleNamespace(cfg=jcfg, eval_dataset=JSynthetic(
            jcfg, seed=seed, split="eval")), num_batches=2)
    ours = quality_protocol.mean_oracle_bound(
        cfg, tdata.make_dataset(cfg, seed=seed, split="eval"), torch.device("cpu"), 2)
    assert abs(ours - ref) <= 0.01, (ours, ref)
