"""The port's data layer against the JAX package's: the copied synthetic
generator bit for bit, bank sampling and mixing on injected draws and under
threefry keys, and the distributions of the threefry draws that dropout
and instance noise take."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu.data import make_dataset as j_make_dataset
from gan_sass_tf_tpu.data.device_bank import build_bank as j_build_bank
from gan_sass_tf_tpu.data.device_bank import sample_bank as j_sample_bank
from gan_sass_tf_tpu.data.mixer import mix_sources as j_mix_sources
from gan_sass_tf_tpu.data.synthetic import SyntheticDataset as JSynthetic
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch import data as tdata
from gan_sass_tf_tpu_torch.data import threefry as tf
from gan_sass_tf_tpu_torch.data.mixer import noise_snr
from gan_sass_tf_tpu_torch.data.threefry import fold_in


def _key(seed, step):
    """A threefry key per (seed, step): fold_in(PRNGKey(seed), step)."""
    return fold_in(tdata.prng_key(seed), step)


def _cfg(name="stream_v5e8", **data):
    cfg = config.get_config(name)
    data = {"segment_seconds": 0.25, "bank_utterances": 5, **data}
    return cfg.replace(data=dataclasses.replace(cfg.data, **data))


def _jax(cfg):
    """The same configuration as the JAX package's Config, for its side."""
    return j_config.Config.from_json(cfg.to_json())


@pytest.mark.parametrize("name,data", [
    ("stream_v5e8", {}),
    ("stream_v5e8", {"f0_mode": "shared"}),
    ("music_complex_44k", {"segment_seconds": 0.1}),   # vocal + accomp slots
    ("3src_pit", {}),                                    # three source slots
    ("3src_pit", {"f0_mode": "shared"}),
])
def test_synthetic_bank_and_eval_batches_bit_identical(name, data):
    cfg = _cfg(name, **data)
    np.testing.assert_array_equal(tdata.build_bank(cfg, seed=4),
                                  j_build_bank(_jax(cfg), seed=4))
    ours = tdata.SyntheticDataset(cfg, seed=9, split="eval")
    ref = JSynthetic(_jax(cfg), seed=9, split="eval")
    for _ in range(2):
        a, b = ours.batch(), ref.batch()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split", ["train", "eval"])
def test_make_dataset_matches_jax(split):
    cfg = _cfg("3src_pit")
    ours, ref = tdata.make_dataset(cfg, seed=2, split=split), j_make_dataset(
        _jax(cfg), seed=2, split=split)
    assert isinstance(ours, tdata.SyntheticDataset) and ours.split == split
    np.testing.assert_array_equal(ours.batch(), ref.batch())


def test_make_dataset_refuses_wav_dir_and_unknown(tmp_path):
    """wav_dir needs its corpus root (tests/test_torch_corpus.py reads
    one); an unknown dataset name is refused."""
    cfg = _cfg(dataset="wav_dir", data_dir=str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="wav_dir dataset root"):
        tdata.make_dataset(cfg)
    with pytest.raises(ValueError, match="unknown dataset"):
        tdata.make_dataset(_cfg(dataset="nope"))


def _jax_draws(rng, b, s, nb, t, offset=0):
    """The picks and shifts `sample_bank` draws, by its own recipe."""
    keys = jax.vmap(jax.random.fold_in, (None, 0))(rng, offset + jnp.arange(b))

    def one(key):
        k_pick, k_shift = jax.random.split(key)
        return (jax.random.randint(k_pick, (s,), 0, nb),
                jax.random.randint(k_shift, (s,), 0, t))

    picks, shifts = jax.vmap(one)(keys)
    return np.array(picks), np.array(shifts)


def test_take_rows_matches_sample_bank_on_injected_picks(rng):
    bank = rng.standard_normal((2, 5, 300)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(j_sample_bank(jnp.asarray(bank), key, 6, 4))
    picks, shifts = _jax_draws(key, 6, 2, 5, 300, offset=4)
    ours = tdata.take_rows(torch.from_numpy(bank), torch.from_numpy(picks).long(),
                           torch.from_numpy(shifts).long()).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_sample_bank_is_per_global_example(rng):
    bank = torch.from_numpy(rng.standard_normal((2, 7, 100)).astype(np.float32))
    whole = tdata.sample_bank(bank, _key(5, 3), 8)
    halves = [tdata.sample_bank(bank, _key(5, 3), 4, example_offset=o)
              for o in (0, 4)]
    torch.testing.assert_close(torch.cat(halves), whole, atol=0, rtol=0)
    assert not torch.equal(tdata.sample_bank(bank, _key(5, 4), 8), whole)
    # Every row is a rolled bank utterance of its own slot.
    for b in range(8):
        for s in range(2):
            row = whole[b, s].numpy()
            assert any(np.allclose(np.roll(bank[s, n].numpy(), -k), row)
                       for n in range(7) for k in range(100)
                       if bank[s, n, k] == row[0])


@pytest.mark.parametrize("num_noise", [0, 1])
def test_apply_mix_matches_mix_sources_on_injected_draws(rng, num_noise):
    cfg = _cfg(gain_jitter_db=3.0, num_noise=num_noise, snr_db=10.0)
    src = rng.standard_normal((3, 2, 400)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    mix, scaled = j_mix_sources(jnp.asarray(src), key, _jax(cfg).data, 2)
    # The same gains and noise, by mix_sources' own recipe.
    keys = jax.vmap(jax.random.fold_in, (None, 0))(key, 2 + jnp.arange(3))

    def draws(k):
        k_gain, k_noise = jax.random.split(k)
        return (jax.random.uniform(k_gain, (2, 1), minval=-3.0, maxval=3.0)[:, 0],
                jax.random.normal(k_noise, (400,)))

    gains, noise = (np.array(a) for a in jax.vmap(draws)(keys))
    ours = tdata.mix(torch.from_numpy(src), torch.from_numpy(gains),
                     torch.from_numpy(noise), noise_snr(cfg.data))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(mix), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(scaled), rtol=1e-6,
                               atol=1e-6)


def test_mix_sources_gains_and_noise(rng):
    cfg = _cfg(gain_jitter_db=3.0, num_noise=1, snr_db=10.0)
    src = torch.from_numpy(rng.standard_normal((64, 2, 2000)).astype(np.float32))
    mix, scaled = tdata.mix_sources(src, _key(1, 2), cfg.data)
    gains_db = 20 * torch.log10((scaled / src)[..., 0])
    assert float(gains_db.abs().max()) <= 3.0 + 1e-4
    assert float(gains_db.std()) > 1.0                     # spread over ±3 dB
    noise = mix - scaled.sum(1)
    snr = 10 * torch.log10((scaled.sum(1) ** 2).mean(-1) / (noise ** 2).mean(-1))
    assert abs(float(snr.mean()) - 10.0) < 0.5
    again = tdata.mix_sources(src[4:8], _key(1, 2), cfg.data, example_offset=4)
    torch.testing.assert_close(again[0], mix[4:8], atol=0, rtol=0)
    plain = tdata.mix_sources(src, _key(1, 2), _cfg(gain_jitter_db=0.0).data)
    torch.testing.assert_close(plain[1], src, atol=0, rtol=0)


def test_threefry_draws_distributions_and_independence():
    """The uniforms, the f32 and bf16 normals and the bernoulli masks that
    dropout and instance noise draw: their moments, and bits under other
    keys (another seed, step or fold) that agree by chance only."""
    shape = (4096, 16)
    u = tf.uniform(_key(0, 0), shape)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 5e-3 and abs(float(u.std()) - 12 ** -0.5) < 5e-3
    for dtype, tol in ((torch.float32, 0.02), (torch.bfloat16, 0.03)):
        n = tf.normal(_key(0, 1), shape, dtype).float()
        assert abs(float(n.mean())) < tol and abs(float(n.std()) - 1.0) < tol, dtype
    kept = tf.bernoulli(_key(0, 2), 0.9, shape).float().mean()
    assert abs(float(kept) - 0.9) <= 5 * (0.9 * 0.1 / u.numel()) ** 0.5
    bits = tf.random_bits(_key(0, 0), shape)
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    others = [tf.random_bits(_key(1, 0), shape), tf.random_bits(_key(0, 1), shape),
              tf.random_bits(fold_in(_key(0, 0), 1), shape)]
    for o in others:
        assert float((o == bits).float().mean()) < 1e-3
    corr = np.corrcoef(u[:, 0].numpy(), u[:, 1].numpy())[0, 1]
    assert abs(corr) < 0.05
