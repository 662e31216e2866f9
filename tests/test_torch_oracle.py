"""The port's oracle-mask bounds (gan_sass_tf_tpu_torch.losses.oracle)
against the JAX package's on the same inputs, the behavioural checks of
tests/test_oracle.py on the port, and the port's quality-protocol and
recompute-bounds scripts against the JAX scripts' configs and JSON keys."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import ast
import dataclasses
import importlib.util
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu.data.mixer import mix_sources as j_mix_sources
from gan_sass_tf_tpu.data.synthetic import SyntheticDataset as JSynthetic
from gan_sass_tf_tpu.losses import oracle_bound_si_sdr as j_oracle_bound
from gan_sass_tf_tpu.losses import oracle_masks as j_oracle_masks
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch import data as tdata
from gan_sass_tf_tpu_torch.data.mixer import noise_snr
from gan_sass_tf_tpu_torch.losses import oracle_bound_si_sdr, oracle_masks
from gan_sass_tf_tpu_torch.ops import masked_istft as k2
from gan_sass_tf_tpu_torch.ops import stft as k4
from gan_sass_tf_tpu_torch.scripts import quality_protocol, recompute_bounds

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"


def _cfg(name="2src_toy_cpu", **data_kw):
    """tests/test_oracle.py's config: batch 4, 0.5 s segments."""
    cfg = config.get_config(name)
    return cfg.replace(
        train=cfg.train.__class__(**{**cfg.train.__dict__, "batch_size": 4}),
        data=cfg.data.__class__(**{**cfg.data.__dict__,
                                   "segment_seconds": 0.5, **data_kw}),
    )


def _with_dsp(cfg, **dsp_kw):
    return cfg.replace(dsp=cfg.dsp.__class__(**{**cfg.dsp.__dict__, **dsp_kw}))


def _jax(cfg):
    """The same configuration as the JAX package's Config, for its side."""
    return j_config.Config.from_json(cfg.to_json())


def _bound(cfg, seed=0):
    """The port's bound on 4 examples, mixed under PRNGKey(0)."""
    src = torch.from_numpy(tdata.make_dataset(cfg, seed=seed).batch(4))
    mix, scaled = tdata.mix_sources(src, tdata.prng_key(0), cfg.data)
    return float(oracle_bound_si_sdr(mix, scaled, cfg.dsp)["si_sdr_improvement"])


def _spectra(rng, b, s, f, k, noise=0.0):
    def cplx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    srcs = cplx(b, s, f, k).astype(np.complex64)
    mix = (srcs.sum(axis=1) + noise * cplx(b, f, k)).astype(np.complex64)
    return mix, srcs


# -- parity with the JAX package -------------------------------------------

@pytest.mark.parametrize("mask_type,act", [
    ("magnitude", "sigmoid"), ("magnitude", "softmax"), ("complex", "sigmoid"),
])
def test_oracle_masks_match_jax(rng, mask_type, act):
    mix, srcs = _spectra(rng, 2, 3, 20, 33, noise=0.5)
    ref = np.asarray(j_oracle_masks(jnp.asarray(mix), jnp.asarray(srcs),
                                    mask_type, mask_activation=act))
    ours = oracle_masks(torch.from_numpy(mix), torch.from_numpy(srcs), mask_type,
                        mask_activation=act).numpy()
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def _jax_mix_draws(key, b, s, t, gain_db):
    """The gains and noise `mix_sources` draws, by its own recipe."""
    keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(b))

    def one(k):
        k_gain, k_noise = jax.random.split(k)
        return (jax.random.uniform(k_gain, (s, 1), minval=-gain_db,
                                   maxval=gain_db)[:, 0],
                jax.random.normal(k_noise, (t,)))

    gains, noise = jax.vmap(one)(keys)
    return torch.from_numpy(np.array(gains)), torch.from_numpy(np.array(noise))


@pytest.mark.parametrize("name,mask_type,act,hard", [
    ("2src_toy_cpu", "magnitude", "sigmoid", False),
    ("2src_toy_cpu", "magnitude", "softmax", True),
    ("2src_toy_cpu", "complex", "sigmoid", True),
    ("music_complex_44k", "magnitude", "sigmoid", True),
    ("music_complex_44k", "magnitude", "softmax", False),
    ("music_complex_44k", "complex", "sigmoid", False),
])
def test_oracle_bound_matches_jax_on_injected_draws(name, mask_type, act, hard):
    """Same sources, and the JAX mixer's gains and noise injected through
    `data.mix`: the bound, its SI-SDR and the mixture's agree within
    0.01 dB."""
    cfg = quality_protocol.protocol_config(name, hard, [
        f"dsp.mask_type={mask_type}", f"dsp.mask_activation={act}",
        "data.segment_seconds=0.25", "train.batch_size=2"])
    jcfg = _jax(cfg)
    src = JSynthetic(jcfg, seed=5, split="eval").batch()
    key = jax.random.PRNGKey(quality_protocol.BOUND_SEED)
    ref = j_oracle_bound(*j_mix_sources(jnp.asarray(src), key, jcfg.data), jcfg.dsp)
    b, s, t = src.shape
    gains, noise = _jax_mix_draws(key, b, s, t, cfg.data.gain_jitter_db)
    mix, scaled = tdata.mix(torch.from_numpy(src), gains, noise, noise_snr(cfg.data))
    ours = oracle_bound_si_sdr(mix, scaled, cfg.dsp)
    assert set(ours) == set(ref)
    for key_ in ref:
        assert abs(float(ours[key_]) - float(ref[key_])) <= 0.01, key_
    assert (k4.launches, k2.launches) == (0, 0)


# -- the behavioural checks of tests/test_oracle.py, on the port ------------

def test_oracle_irm_bound_strongly_positive():
    assert _bound(_cfg()) > 10.0


def test_hard_protocol_creates_headroom():
    easy = _bound(_cfg())
    hard = _bound(_cfg(f0_mode="shared"))
    assert hard < easy - 2.0, (easy, hard)

    def irm(cfg):
        return _bound(_with_dsp(cfg, mask_activation="softmax"))

    hard_irm = irm(_cfg(f0_mode="shared"))
    harder_irm = irm(_cfg(f0_mode="shared", num_noise=1, snr_db=10.0))
    assert harder_irm < hard_irm, (hard_irm, harder_irm)
    assert harder_irm > 3.0


def test_psf_oracle_dominates_irm_on_noisy_tasks(rng):
    cfg = _cfg(f0_mode="shared", num_noise=1, snr_db=10.0)
    psf = _bound(cfg)
    irm = _bound(_with_dsp(cfg, mask_activation="softmax"))
    assert psf > irm + 2.0, (psf, irm)
    mix, srcs = _spectra(rng, 2, 2, 6, 9)
    m = oracle_masks(torch.from_numpy(mix), torch.from_numpy(srcs), "magnitude",
                     mask_activation="sigmoid")
    assert float(m.min()) >= 0.0 and float(m.max()) <= 1.0


def test_complex_oracle_beats_magnitude_on_overlap():
    cfg = _cfg(f0_mode="shared")
    assert _bound(_with_dsp(cfg, mask_type="complex")) > _bound(cfg) + 3.0


def test_oracle_complex_mask_respects_tanh_bound(rng):
    mix, srcs = _spectra(rng, 2, 2, 6, 9)
    m = oracle_masks(torch.from_numpy(mix), torch.from_numpy(srcs), "complex")
    assert m.shape == (2, 2, 6, 9, 2)
    assert float(m.abs().max()) <= 1.0 + 1e-6


def test_oracle_magnitude_masks_sum_to_one(rng):
    mix, srcs = _spectra(rng, 2, 3, 6, 9)
    m = oracle_masks(torch.from_numpy(mix), torch.from_numpy(srcs), "magnitude",
                     mask_activation="softmax")
    np.testing.assert_allclose(m.sum(dim=1).numpy(), 1.0, atol=1e-3)
    assert float(m.min()) >= 0.0
    with pytest.raises(ValueError, match="mask_type"):
        oracle_masks(torch.from_numpy(mix), torch.from_numpy(srcs), "phase")


# -- the scripts ------------------------------------------------------------

def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_json_keys(name):
    """The keys of the dict literal that the JAX script's main() prints (the
    one with a "preset" key), read from its source."""
    tree = ast.parse((SCRIPTS / f"{name}.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "preset" in keys:
                return keys
    raise AssertionError(f"no JSON dict in scripts/{name}.py main()")


def _finite(value):
    if isinstance(value, list):
        return all(_finite(v) for v in value)
    if isinstance(value, float):
        return math.isfinite(value)
    return True


@pytest.mark.parametrize("hard", [False, True])
def test_protocol_config_equals_the_jax_scripts(hard):
    ref = _jax_script("quality_protocol")
    overrides = ["train.batch_size=2", "model.g_channels=8,16"]
    for name in config.list_configs():
        ours = quality_protocol.protocol_config(name, hard, overrides)
        assert ours.__module__ == "gan_sass_tf_tpu_torch.config"
        assert dataclasses.asdict(ours) == dataclasses.asdict(
            ref.protocol_config(name, hard, overrides)), name


_TOY = ["--device", "cpu", "--set", "train.batch_size=2",
        "--set", "data.segment_seconds=0.25", "--set", "model.g_channels=8,16",
        "--set", "model.d_channels=8,16"]


def test_quality_protocol_prints_the_jax_scripts_keys(capsys):
    assert quality_protocol.main(["2src_toy_cpu", "2", "--hard", "--seeds",
                                  "0,7", *_TOY]) == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == _jax_json_keys("quality_protocol")
    assert (out["preset"], out["hard"], out["steps"], out["seeds"]) == \
        ("2src_toy_cpu", True, 2, [0, 7])
    assert all(_finite(v) for v in out.values()), out
    assert len(out["si_sdr_improvement_per_seed"]) == 2
    assert out["oracle_bound"] > 3.0 and out["throughput"] > 0
    assert "step 2: g=" in captured.err and "seed 7: held-out" in captured.err
    assert (k4.launches, k2.launches) == (0, 0)


def test_quality_protocol_refuses_unported_generator_and_missing_gpu(capsys):
    """Every generator is ported: the toy G runs the protocol (one line);
    the missing GPU is still refused."""
    assert quality_protocol.main(["2src_toy_cpu", "1", "--set", "model.generator=toy",
                                  "--set", "model.g_hidden=16", *_TOY]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["steps"] == 1 and _finite(out["si_sdr_improvement"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        quality_protocol.main(["2src_toy_cpu", "1", "--device", "cuda"])


@pytest.mark.parametrize("preset,hard", [("2src_toy_cpu", True), ("3src_pit", False)])
def test_recompute_bounds_prints_the_jax_scripts_keys(capsys, preset, hard):
    argv = [preset, "--device", "cpu", "--set", "data.segment_seconds=0.25",
            "--set", "train.batch_size=2"] + (["--hard"] if hard else [])
    assert recompute_bounds.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == _jax_json_keys("recompute_bounds")
    cfg = quality_protocol.protocol_config(
        preset, hard, ["data.segment_seconds=0.25", "train.batch_size=2"])
    assert (out["preset"], out["hard"], out["mask_type"], out["mask_activation"]) \
        == (preset, hard, cfg.dsp.mask_type, cfg.dsp.mask_activation)
    assert out["oracle_bound"] == round(
        recompute_bounds.oracle_bound(cfg, torch.device("cpu")), 2)
    assert out["oracle_bound"] > 3.0
    with pytest.raises(SystemExit, match="no CUDA device"):
        recompute_bounds.main([preset])
