"""A train step's batch (`ops.dispatch.step_batch`, the plain version of
`csrc/threefry.cu`'s batch kernel) against the JAX package's `sample_bank`
and `mix_sources` and the JAX step's key derivation, and numpy mirrors of
how the kernel lays out its work: the (example, tile) blocks and the roll's
two segments against `take_rows`, the fixed-order sums of mixture² against
the plain mean.  The kernel itself runs on the card only (`chip_smoke.py`
rng); here its wrapper must refuse what it cannot take.

Picks, shifts, gains and train keys are held equal bit for bit; the
scaled sources and the mixture within test_torch_data.py's 1e-6 (rtol and
atol), a noisy mixture within test_torch_random.py's 1e-6·max|mixture|
(its normals are within a few ulp of jax's)."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import ctypes
import dataclasses
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu.data.device_bank import sample_bank as j_sample_bank
from gan_sass_tf_tpu.data.mixer import mix_sources as j_mix_sources
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch import data as tdata
from gan_sass_tf_tpu_torch.data import threefry as tf
from gan_sass_tf_tpu_torch.data.mixer import noise_snr
from gan_sass_tf_tpu_torch.ops import build, dispatch
from gan_sass_tf_tpu_torch.ops import threefry as rng_ops

B, T, N_BANK, SEED, STEP = 4, 1000, 8, 21, 41
TILE, THREADS, PER = rng_ops.BATCH_TILE, rng_ops.THREADS, rng_ops.BATCH_TILE // rng_ops.THREADS
WARP = 32


def _cfg(s, noise):
    name = "3src_pit" if s == 3 else "stream_v5e8"
    cfg = config.get_config(name)
    data = {"gain_jitter_db": 3.0, "num_noise": int(noise), "snr_db": 10.0}
    return cfg.replace(data=dataclasses.replace(cfg.data, **data))


def _jax_keys(stepped):
    """(rng_data, rng_mix) of the JAX step, or the key as both."""
    key = jax.random.PRNGKey(SEED)
    if not stepped:
        return key, key
    rng_mix, rng_data = jax.random.split(jax.random.fold_in(key, STEP), 5)[:2]
    return rng_data, rng_mix


def _jax_draws(rng_data, rng_mix, s, t, offset):
    """Picks, shifts and gains by sample_bank's and mix_sources' recipes."""
    def keys(base):
        return jax.vmap(jax.random.fold_in, (None, 0))(base, offset + jnp.arange(B))

    def picks_shifts(key):
        k_pick, k_shift = jax.random.split(key)
        return (jax.random.randint(k_pick, (s,), 0, N_BANK),
                jax.random.randint(k_shift, (s,), 0, t))

    def gains(key):
        return jax.random.uniform(jax.random.split(key)[0], (s, 1), minval=-3.0,
                                  maxval=3.0)[:, 0]

    picks, shifts = jax.vmap(picks_shifts)(keys(rng_data))
    return np.asarray(picks), np.asarray(shifts), np.asarray(jax.vmap(gains)(keys(rng_mix)))


def _jax_train_keys(shard, d_steps):
    """gan_sass_tf_tpu/train/step.py:213-228, :317, :178, :372."""
    r = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), STEP), 5)
    rng_g, rng_dl, rng_ga = (jax.random.fold_in(k, shard) for k in r[2:])
    want = [rng_g]
    for di in range(d_steps):
        want += list(jax.random.split(jax.random.fold_in(rng_dl, di), 3))
    return np.stack([np.asarray(k) for k in want + list(jax.random.split(rng_ga))])


CASES = [c for c in itertools.product((2, 3), (0, 12), (False, True), (False, True),
                                      (True, False))]


@pytest.mark.parametrize("s,offset,stepped,noise,from_bank", CASES)
def test_batch_equals_the_jax_step(s, offset, stepped, noise, from_bank):
    """The plain batch against sample_bank (bank) and mix_sources under
    the JAX step's rng_data and rng_mix (a step) or one key (none), for
    global examples offset + [0, B); with a step also its train keys, at
    d_steps 1 (two sources) or 2 (three), shard 1."""
    cfg = _cfg(s, noise)
    rng = np.random.default_rng(s * 100 + offset)
    src = rng.standard_normal((s, N_BANK, T) if from_bank else (B, s, T)).astype(np.float32)
    rng_data, rng_mix = _jax_keys(stepped)
    d_steps = s - 1 if stepped else 0
    out = dispatch.step_batch(tf.prng_key(SEED), torch.from_numpy(src), 3.0,
                              noise_snr(cfg.data), offset=offset,
                              step=torch.tensor(STEP) if stepped else None,
                              bank_batch=B if from_bank else 0, shard=1, d_steps=d_steps)
    jcfg = j_config.Config.from_json(cfg.to_json())
    sources = (j_sample_bank(jnp.asarray(src), rng_data, B, offset) if from_bank
               else jnp.asarray(src))
    mix, scaled = (np.asarray(a) for a in j_mix_sources(sources, rng_mix, jcfg.data, offset))
    picks, shifts, gains = _jax_draws(rng_data, rng_mix, s, T, offset)

    np.testing.assert_array_equal(out.gains.numpy(), gains)
    if from_bank:
        np.testing.assert_array_equal(out.picks.numpy(), picks)
        np.testing.assert_array_equal(out.shifts.numpy(), shifts)
    else:
        assert out.picks is None and out.shifts is None
    if stepped:
        np.testing.assert_array_equal(out.train_keys.numpy(), _jax_train_keys(1, d_steps))
    else:
        assert out.train_keys is None
    np.testing.assert_allclose(out.scaled.numpy(), scaled, rtol=1e-6, atol=1e-6)
    if noise:
        np.testing.assert_allclose(out.mixture.numpy(), mix, rtol=0,
                                   atol=1e-6 * float(np.abs(mix).max()))
        assert not np.allclose(out.mixture.numpy(), scaled.sum(1), atol=1e-3)
    else:
        np.testing.assert_allclose(out.mixture.numpy(), mix, rtol=1e-6, atol=1e-6)


def test_sample_bank_and_mix_sources_are_the_batch():
    """`sample_bank` is the batch's scaled rows at no gain, `mix_sources`
    its mixture and scaled sources under the same key."""
    cfg = _cfg(2, True)
    bank = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, N_BANK, T)).astype(np.float32))
    key = tf.prng_key(SEED)
    batch = rng_ops.batch_reference(key, bank, B, 0.0, offset=5, from_bank=True)
    picked = tdata.sample_bank(bank, key, B, example_offset=5)
    assert torch.equal(picked, batch.scaled)
    assert torch.equal(picked, tdata.take_rows(bank, batch.picks, batch.shifts))
    mixed = rng_ops.batch_reference(key, picked, B, 3.0, 10.0, offset=5)
    for a, b in zip(tdata.mix_sources(picked, key, cfg.data, example_offset=5), mixed):
        assert torch.equal(a, b)


# -- numpy mirrors of the kernel's layout ------------------------------------

def _kernel_rows(bank, picks, shifts, blocks):
    """threefry_batch_kernel's scaled rows at gain 0 over a grid of
    `blocks` x B: block (x, i) walks tiles x, x + blocks, ...; thread j of
    a tile takes samples tile·TILE + q·THREADS + j, q < PER, each read at
    t + shift or, past the row's end, t + shift - T (the roll's two
    segments).  Returns the rows and how often each sample was written."""
    s, _, t = bank.shape
    b = picks.shape[0]
    tiles = -(-t // TILE)
    out = np.zeros((b, s, t), np.float32)
    writes = np.zeros((b, s, t), np.int64)
    j = np.arange(THREADS)
    for i, x in itertools.product(range(b), range(blocks)):
        for tile in range(x, tiles, blocks):
            for q in range(PER):
                tt = tile * TILE + q * THREADS + j
                tt = tt[tt < t]
                for src in range(s):
                    sh = int(shifts[i, src])
                    u = np.where(tt < t - sh, tt + sh, tt + sh - t)
                    out[i, src, tt] = bank[src, picks[i, src], u]
                    writes[i, src, tt] += 1
    return out, writes


@pytest.mark.parametrize("t,blocks", [(1000, None), (2500, None), (2500, 1), (5000, 2),
                                      (TILE, None)])
def test_kernel_block_map_equals_take_rows(t, blocks):
    """Every sample written once, by its tile's block, from the rolled row:
    the mirror equals `take_rows`, shifts 0 and T - 1 included, at the
    default grid (a block a tile) and at fewer blocks."""
    rng = np.random.default_rng(t)
    bank = rng.standard_normal((3, 5, t)).astype(np.float32)
    picks = rng.integers(0, 5, (B, 3))
    shifts = rng.integers(0, t, (B, 3))
    shifts[0] = (0, t - 1, t // 2)
    tiles = rng_ops.batch_tiles(t)
    assert tiles == -(-t // 1024)
    got, writes = _kernel_rows(bank, picks, shifts, tiles if blocks is None else blocks)
    assert (writes == 1).all()
    want = tdata.take_rows(torch.from_numpy(bank), torch.from_numpy(picks),
                           torch.from_numpy(shifts)).numpy()
    np.testing.assert_array_equal(got, want)


def _tile_sums(m):
    """threefry_batch_kernel's sum of mixture² a tile, in float32: a
    thread's samples in order from 0, the warp's 32 by an xor butterfly
    (offsets 16 .. 1; every lane ends with the same sum), the warps in
    order; then the tiles in order, times 1/T (noise_std)."""
    t = m.shape[0]
    f = np.float32
    partial = []
    for tile in range(-(-t // TILE)):
        sq = np.zeros(THREADS, f)
        for q in range(PER):
            tt = tile * TILE + q * THREADS + np.arange(THREADS)
            ok = tt < t
            v = m[np.minimum(tt, t - 1)]
            sq = np.where(ok, sq + v * v, sq).astype(f)
        lanes = sq.reshape(THREADS // WARP, WARP)
        for off in (16, 8, 4, 2, 1):
            lanes = (lanes + lanes[:, np.arange(WARP) ^ off]).astype(f)
        assert (lanes == lanes[:, :1]).all()
        p = lanes[0, 0]
        for w in range(1, THREADS // WARP):
            p = f(p + lanes[w, 0])
        partial.append(p)
    total = partial[0]
    for p in partial[1:]:
        total = f(total + p)
    return f(total * (f(1.0) / f(t)))


@pytest.mark.parametrize("t", [1, 777, 1024, 23936, 32000])
def test_fixed_order_mean_square_equals_the_plain_mean(t):
    """The kernel's order of the mean of mixture² against the plain
    `(mixture ** 2).mean()` to 1e-6 relative, at a sample, a tile's edge
    and the bench's and stream_v5e8's rows."""
    m = np.random.default_rng(t).standard_normal(t).astype(np.float32) * 3
    plain = float((torch.from_numpy(m) ** 2).mean())
    assert _tile_sums(m) == pytest.approx(plain, rel=1e-6)


# -- the wrapper ---------------------------------------------------------------

def test_batch_args_mirror_the_kernel_struct():
    """`BatchArgs` holds csrc/threefry.cu's struct BatchArgs field for
    field, in order, with the same widths."""
    src = (build.CSRC / "threefry.cu").read_text()
    body = re.search(r"struct BatchArgs \{(.*?)\n\};", src, re.S).group(1)
    c_types = {"float*": ctypes.c_void_p, "long long*": ctypes.c_void_p,
               "long long": ctypes.c_longlong, "uint32_t": ctypes.c_uint32,
               "float": ctypes.c_float, "int": ctypes.c_int}
    fields = []
    for line in body.splitlines():
        decl = re.match(r"\s*(?:const )?(%s) ([A-Za-z_, ]+);"
                        % "|".join(re.escape(c) for c in c_types), line)
        if decl:
            fields += [(n.strip(), c_types[decl.group(1)]) for n in decl.group(2).split(",")]
    assert fields == rng_ops.BatchArgs._fields_
    assert ctypes.sizeof(rng_ops.BatchArgs) == 152


def test_batch_kernel_refuses_what_it_cannot_take():
    """No fallback: the kernel's wrapper raises on CPU tensors, and both
    versions on a wrong dtype or shape, a step that is not 0-d int64, or
    train keys without a step."""
    key, bank = tf.prng_key(1), torch.zeros(2, 3, 50)
    with pytest.raises(ValueError, match="CUDA"):
        rng_ops.batch_kernel(key, bank, 2, 3.0, from_bank=True)
    with pytest.raises(ValueError, match="CUDA"):
        rng_ops.batch_kernel(key, torch.zeros(2, 2, 50), 2, 3.0, 10.0,
                             step=torch.tensor(4), d_steps=1)
    for fn in (rng_ops.batch_kernel, rng_ops.batch_reference):
        with pytest.raises(ValueError, match="float32"):
            fn(key, bank.double(), 2, 3.0, from_bank=True)
        with pytest.raises(ValueError, match="float32"):
            fn(key, bank[0], 2, 3.0)
        with pytest.raises(ValueError, match="0-d int64"):
            fn(key, bank, 2, 3.0, step=torch.tensor([4]), from_bank=True)
        with pytest.raises(ValueError, match="train keys need the step"):
            fn(key, bank, 2, 3.0, from_bank=True, d_steps=1)
