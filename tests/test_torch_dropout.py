"""Dropout's keep-masks and D's instance noise against `jax.random` and
flax: bernoulli and the bf16 normal, the step's dropout and noise keys,
the noise, flax's `nn.Dropout` at each kind of site (the flax tensor's
index from the port's NCHW one, the module path, the bf16 division), each
dropout site of the five modules that have one, and 12 f32 train steps of
the every-option stream_v5e8 geometry.

The flax side is jitted, as the reference's train step is: XLA turns
`x / keep` into x·float32(1/keep) and folds and contracts `x + std·√2·e`
into one fma, which the port's plain versions and kernels compute (in
bf16 every op rounds to bf16 and the two forms agree).  Bernoulli masks,
bf16 normals, bf16 noise and every dropout site are held equal bit for
bit.  f32 normals and f32 noise are held within NORMAL_ULP units in the
last place of the normal: the port's log1p (torch's) and XLA's differ in
the last bit (tests/test_torch_random.py)."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu.data.device_bank import build_bank as j_build_bank
from gan_sass_tf_tpu.train.state import create_train_state as j_create_train_state
from gan_sass_tf_tpu.train.step import build_train_step as j_build_train_step
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch import data as tdata
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch.data import threefry as tf
from gan_sass_tf_tpu_torch.models.dropout import NCHW, DropoutKey
from gan_sass_tf_tpu_torch.ops import threefry as rng_ops
from gan_sass_tf_tpu_torch.train import build_train_step, create_train_state
from gan_sass_tf_tpu_torch.train.step import instance_noise

SEEDS = (0, 7, 2 ** 31 - 1)
SHAPES = ((37,), (3, 50))
NORMAL_ULP = 4
STEPS, SEED = 12, 3


def _jax(cfg):
    return j_config.Config.from_json(cfg.to_json())


def _ulps(a, b) -> int:
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    return int(np.abs(a - b).max())


def _bits16(x) -> np.ndarray:
    """bf16 values (a torch tensor or a jax array) as their 16 bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


# -- bernoulli and the normals ----------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_and_normals_equal_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
    for p in (0.1, 0.5, 0.8, 0.9):
        np.testing.assert_array_equal(tf.bernoulli(tk, p, shape).numpy(),
                                      np.asarray(jax.random.bernoulli(jk, p, shape)))
    np.testing.assert_array_equal(_bits16(tf.normal(tk, shape, torch.bfloat16)),
                                  _bits16(jax.random.normal(jk, shape, jnp.bfloat16)))
    ours = tf.normal(tk, shape, torch.float32)
    assert _ulps(ours, jax.random.normal(jk, shape, jnp.float32)) <= NORMAL_ULP


def test_bf16_normal_takes_all_of_jax_128_values():
    """jax draws a bf16 normal from 7 random bits: every one of its 128
    values, bit for bit."""
    tk, jk = tf.prng_key(11), jax.random.PRNGKey(11)
    ours = _bits16(tf.normal(tk, (4096,), torch.bfloat16))
    np.testing.assert_array_equal(ours, _bits16(jax.random.normal(jk, (4096,), jnp.bfloat16)))
    assert len(np.unique(ours)) == 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_noise_equals_jitted_jax(dtype):
    """The step's noise, x + std·normal(key, x.shape, x.dtype), against the
    reference's expression jitted: bf16 bit for bit, f32 within the
    normal's ulps times std."""
    x = np.random.default_rng(4).standard_normal((6, 9, 17, 4)).astype(np.float32) * 3
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = jax.jit(lambda v, k: v + 0.1 * jax.random.normal(k, v.shape, v.dtype))(
        jx, jax.random.PRNGKey(5))
    ours = instance_noise(tx, 0.1, tf.prng_key(5))
    assert ours.dtype == tx.dtype and ours.shape == tx.shape
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_bits16(ours), _bits16(ref))
    else:
        # |erf⁻¹| < 4 here: NORMAL_ULP of its ulps times std·√2, and the sum's
        # rounding.
        ref = np.asarray(ref)
        tol = 0.1 * tf.SQRT2 * NORMAL_ULP * np.spacing(np.float32(2.0)) \
            + np.spacing(np.abs(ref))
        assert (np.abs(ours.numpy() - ref) <= tol).all()
    assert instance_noise(tx, 0.0, tf.prng_key(5)) is tx


# -- the step's keys ----------------------------------------------------------

@pytest.mark.parametrize("shard,d_steps", [(0, 1), (1, 2), (3, 3)])
def test_train_keys_equal_the_jax_step_derivation(shard, d_steps):
    """rng_g, each D step's (dropout, noise, R1 dropout) and the adversarial
    call's (dropout, noise), as gan_sass_tf_tpu/train/step.py:213-228,
    :317, :178 and :372 derive them, the shard folded in."""
    jk, step = jax.random.PRNGKey(9), 41
    _, _, rng_g, rng_dl, rng_ga = jax.random.split(jax.random.fold_in(jk, step), 5)
    rng_g, rng_dl, rng_ga = (jax.random.fold_in(k, shard) for k in (rng_g, rng_dl, rng_ga))
    want = [rng_g]
    for di in range(d_steps):
        want += list(jax.random.split(jax.random.fold_in(rng_dl, di), 3))
    want += list(jax.random.split(rng_ga))
    ours = rng_ops.train_keys_reference(tf.prng_key(9), torch.tensor(step), shard, d_steps)
    np.testing.assert_array_equal(ours.numpy(), np.stack([np.asarray(k) for k in want]))
    g_row, d_rows, adv_rows = rng_ops.train_key_rows(d_steps)
    assert (g_row, d_rows[-1][-1], adv_rows) == (0, 3 * d_steps, (1 + 3 * d_steps,
                                                                   2 + 3 * d_steps))


# -- flax's nn.Dropout at a site ------------------------------------------------

class _Inner(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.Dropout(0.3, deterministic=False)(x)


class _Sites(nn.Module):
    """Three dropout sites: Dropout_0 and Dropout_1 of this module and
    Dropout_0 of its child _Inner_0, each on x."""

    @nn.compact
    def __call__(self, x):
        return (nn.Dropout(0.1, deterministic=False)(x),
                nn.Dropout(0.5, deterministic=False)(x), _Inner()(x))


@pytest.mark.parametrize("layout", ["nchw", "bth"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_site_equals_flax_dropout(dtype, layout):
    """Each site's output bit for bit: the masks of the flax tensor's flat
    index (the port's NCHW tensor mapped to flax's (B, T, F, C)), the
    module path, and x·(1/keep) with keep rounded to x's dtype."""
    shape = (3, 7, 11, 5) if layout == "nchw" else (3, 13, 10)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    refs = jax.jit(lambda v, k: _Sites().apply({}, v, rngs={"dropout": k}))(
        jx, jax.random.PRNGKey(21))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    dims = None
    if layout == "nchw":                       # the port holds (B, C, T, F)
        tx, dims = tx.permute(0, 3, 1, 2).contiguous(), NCHW
    key = tf.prng_key(21)
    sites = [(DropoutKey(key), 0, 0.1), (DropoutKey(key), 1, 0.5),
             (DropoutKey(key, ("_Inner_0",)), 0, 0.3)]
    for (dk, site, p), ref in zip(sites, refs):
        ours = dk.apply(tx, p, site, dims)
        if layout == "nchw":
            ours = ours.permute(0, 2, 3, 1)
        ours, ref = ours.float().numpy(), np.asarray(ref).astype(np.float32)
        np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32),
                                      err_msg=f"{dtype} {layout} {dk.path} {site}")


def test_dropout_gradient_is_the_mask_drawn_again():
    """dx = select(mask, dy·(1/keep), 0), and its own gradient the same
    again (R1's double backward)."""
    x = torch.randn(2, 4, 6, 5, requires_grad=True)
    dk = DropoutKey(tf.prng_key(3))
    y = dk.apply(x, 0.4, 2, NCHW)
    dy = torch.randn(y.shape, requires_grad=True)
    (dx,) = torch.autograd.grad(y, x, dy, create_graph=True)
    torch.testing.assert_close(dx, dk.apply(dy.detach(), 0.4, 2, NCHW), rtol=0, atol=0)
    w = torch.randn(dx.shape)
    (gw,) = torch.autograd.grad(dx, dy, w)
    torch.testing.assert_close(gw, dk.apply(w, 0.4, 2, NCHW), rtol=0, atol=0)
    kept = y.detach() != 0
    assert torch.equal(kept, dx.detach() != 0)
    torch.testing.assert_close(y.detach()[kept], (x.detach() * np.float32(1 / np.float32(0.6)))[kept],
                               rtol=0, atol=0)


# -- the packed keep mask and the VJP that reads it ---------------------------

# Port shapes whose size is not a multiple of 32 (the mask's last word has a
# tail), with the flax dims of an NCHW conv site or of a (B, T, H) site; F = 65
# is the largest every-option site's.
MASK_SHAPES = {"nchw": [(3, 5, 7, 11), (2, 3, 7, 65)], "bth": [(3, 13, 10), (5, 9, 7)]}


class _One(nn.Module):
    p: float = 0.3

    @nn.compact
    def __call__(self, x):
        return nn.Dropout(self.p, deterministic=False)(x)


def _to_flax(t, layout):
    return t.permute(0, 2, 3, 1) if layout == "nchw" else t


def _to_port(a, layout):
    return np.transpose(a, (0, 3, 1, 2)) if layout == "nchw" else a


def _packed(kept: np.ndarray) -> np.ndarray:
    """numpy's packing of a bool array in row-major order: bit m % 32 of
    word m // 32, as int32."""
    flat = np.packbits(kept.reshape(-1), bitorder="little")
    flat = np.pad(flat, (0, -len(flat) % 4))
    return flat.view("<u4").astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("shape_i", [0, 1])
@pytest.mark.parametrize("layout", ["nchw", "bth"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_words_equal_flax_dropout_mask(dtype, layout, shape_i):
    """dropout_reference's words are flax's nn.Dropout mask (jitted, three
    sites and paths) packed in the port's memory order, the tail word's
    bits past the end 0."""
    shape = MASK_SHAPES[layout][shape_i]
    n = int(np.prod(shape))
    assert n % 32
    x = np.abs(np.random.default_rng(5).standard_normal(shape)).astype(np.float32) + 0.5
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    refs = jax.jit(lambda v, k: _Sites().apply({}, v, rngs={"dropout": k}))(
        jnp.asarray(np.asarray(_to_flax(torch.from_numpy(x), layout)), dtype),
        jax.random.PRNGKey(23))
    dims = NCHW if layout == "nchw" else None
    key = tf.prng_key(23)
    sites = [(DropoutKey(key), 0, 0.1), (DropoutKey(key), 1, 0.5),
             (DropoutKey(key, ("_Inner_0",)), 0, 0.3)]
    for (dk, site, p), ref in zip(sites, refs):
        kept = _to_port(np.asarray(ref).astype(np.float32) != 0, layout)
        y, words = rng_ops.dropout_reference(tx, key, dk.fold(site), p,
                                             dims or tuple(range(len(shape))))
        assert words.dtype == torch.int32 and words.shape == (-(-n // 32),)
        np.testing.assert_array_equal(words.numpy(), _packed(kept),
                                      err_msg=f"{dtype} {layout} {dk.path} {site}")
        assert (int(words[-1]) & 0xFFFFFFFF) >> (n % 32) == 0
        assert torch.equal(rng_ops.unpack_mask(words, shape), torch.from_numpy(kept))
        assert torch.equal(y, dk.apply(tx, p, site, dims))


@pytest.mark.parametrize("layout", ["nchw", "bth"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_backward_equals_jax_vjp_and_second_derivative(dtype, layout):
    """The backward through the saved words against jax.vjp of flax's
    dropout (jitted), and its own backward (R1's double backward) against
    JAX's second derivative, bit for bit; what the forward saves is the
    words, not the key."""
    shape, p = MASK_SHAPES[layout][1], 0.3
    rng = np.random.default_rng(8)
    x, dy, w = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    jdt = getattr(jnp, dtype)
    flax_in = [jnp.asarray(np.asarray(_to_flax(torch.from_numpy(a), layout)), jdt)
               for a in (x, dy, w)]

    def f(v, k):
        return _One(p).apply({}, v, rngs={"dropout": k})

    def vjp(v, ct, k):
        return jax.vjp(lambda u: f(u, k), v)[1](ct)[0]

    def second(v, ct, ww, k):
        return jax.vjp(lambda c: vjp(v, c, k), ct)[1](ww)[0]

    jk = jax.random.PRNGKey(31)
    ref_dx = np.asarray(jax.jit(vjp)(flax_in[0], flax_in[1], jk))
    ref_ddy = np.asarray(jax.jit(second)(*flax_in, jk))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tdy = torch.from_numpy(dy).to(tdt).requires_grad_()
    dims = NCHW if layout == "nchw" else None
    y = DropoutKey(tf.prng_key(31)).apply(tx, p, 0, dims)
    (saved,) = y.grad_fn.saved_tensors
    assert saved.dtype == torch.int32 and saved.shape == (-(-tx.numel() // 32),)
    (dx,) = torch.autograd.grad(y, tx, tdy, create_graph=True)
    (ddy,) = torch.autograd.grad(dx, tdy, torch.from_numpy(w).to(tdt))
    for ours, ref in ((dx, ref_dx), (ddy, ref_ddy)):
        ours = _to_flax(ours.detach(), layout).float().numpy()
        np.testing.assert_array_equal(ours.view(np.int32),
                                      ref.astype(np.float32).view(np.int32))
    scale = rng_ops.dropout_constants(tdt, p)[1]
    assert torch.equal(dx.detach(), rng_ops.dropout_mask_reference(tdy.detach(), saved,
                                                                   scale))


def _forward_walk(shape, dims, blocks):
    """numpy mirror of threefry_dropout_kernel's walk (csrc/threefry.cu) over
    `blocks` blocks of rng_ops.THREADS threads, in uint32 arithmetic: a
    thread's first word's coordinates and the grid's stride's digits by
    division, once; a word's elements by steps of the innermost flax
    stride, counting down to where the innermost dim rolls over, and the
    wraps of rng_ops.walk_wraps; the next word by a mixed-radix add.
    Returns each element's (j, word, bit, visits)."""
    m32 = np.uint64(0xFFFFFFFF)
    size, jstride = rng_ops.flax_layout(shape, dims)
    wrap = rng_ops.walk_wraps(size, jstride)
    size, jstride, wrap = (np.array(a, np.uint64) for a in (size, jstride, wrap))
    n, bits = int(np.prod(shape)), rng_ops.WORD_BITS
    nwords, stride = -(-n // bits), blocks * rng_ops.THREADS

    def coords(m):
        m, c = np.asarray(m, np.uint64), [None] * 4
        for d in range(3, 0, -1):
            c[d], m = m % size[d], m // size[d]
        c[0] = m
        return c

    j_of, word_of, bit_of = (np.zeros(n, np.int64) for _ in range(3))
    visits = np.zeros(n, np.int64)
    w = np.arange(min(stride, nwords), dtype=np.uint64)
    c, g = coords(w * np.uint64(bits)), coords(stride * bits)
    one = np.uint64(1)
    while True:
        live = w < nwords
        if not live.any():
            return j_of, word_of, bit_of, visits
        left, e2, e1 = size[3] - c[3], c[2].copy(), c[1].copy()
        j = sum(c[d] * jstride[d] for d in range(4)) & m32
        for i in range(bits):
            m = w * np.uint64(bits) + np.uint64(i)
            ok = live & (m < n)
            idx = m[ok].astype(np.int64)
            j_of[idx], word_of[idx], bit_of[idx] = j[ok], w[ok], i
            visits[idx] += 1
            # step(): j by the innermost stride; the rare branch where it rolls over
            j, left = (j + jstride[3]) & m32, left - one
            roll = left == 0
            left = np.where(roll, size[3], left)
            j = np.where(roll, (j + wrap[3]) & m32, j)
            e2 = np.where(roll, e2 + one, e2)
            roll = roll & (e2 == size[2])
            e2 = np.where(roll, np.uint64(0), e2)
            j = np.where(roll, (j + wrap[2]) & m32, j)
            e1 = np.where(roll, e1 + one, e1)
            roll = roll & (e1 == size[1])
            e1 = np.where(roll, np.uint64(0), e1)
            j = np.where(roll, (j + wrap[1]) & m32, j)
        w = w + np.uint64(stride)
        carry = np.zeros_like(w)
        for d in (3, 2, 1):
            c[d] = c[d] + g[d] + carry
            carry = (c[d] >= size[d]).astype(np.uint64)
            c[d] = c[d] - carry * size[d]
        c[0] = c[0] + g[0] + carry


@pytest.mark.parametrize("shape,dims", [
    ((2, 3, 41, 65), NCHW), ((3, 5, 37, 65), NCHW), ((2, 1, 9, 65), NCHW),
    ((4, 3, 1, 7), NCHW), ((3, 13, 10), (0, 1, 2)), ((5, 33, 7), (0, 1, 2))])
def test_forward_walk_mirror_equals_flax_index(shape, dims):
    """Every element's j on the kernel's walk (no division an element) is
    its flax flat index (flax_layout's strides), its word m // 32 and bit
    m % 32, each element once: at one block (a thread walks many words),
    two, and a thread a word."""
    size, jstride = rng_ops.flax_layout(shape, dims)
    n = int(np.prod(shape))
    coord = np.unravel_index(np.arange(n), size)
    want = sum(c * s for c, s in zip(coord, jstride))
    m = np.arange(n)
    for blocks in (1, 2, -(-rng_ops.mask_words(n) // rng_ops.THREADS)):
        j, word, bit, visits = _forward_walk(shape, dims, blocks)
        assert (visits == 1).all(), blocks
        np.testing.assert_array_equal(j, want, err_msg=f"blocks {blocks}")
        np.testing.assert_array_equal(word, m // 32)
        np.testing.assert_array_equal(bit, m % 32)


@pytest.mark.parametrize("p", [0.5, 0.4, 0.3, 0.2, 0.1])
def test_integer_keep_test_equals_the_float_one(p):
    """(b >> 9) < keep_below(keep) against bernoulli's float32 uniform below
    keep, for all 2^23 values of b >> 9 at keep = 1 - p."""
    keep, _ = rng_ops.dropout_constants(torch.float32, p)
    k = np.arange(1 << 23, dtype=np.uint32)
    u = (k | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    np.testing.assert_array_equal(k < rng_ops.keep_below(keep), u < np.float32(keep))


def test_dropout_kernels_refuse_cpu_tensors():
    """On the CPU the dispatch takes the plain versions; the kernels' wrappers
    launch on CUDA tensors or raise."""
    x = torch.randn(2, 3, 4, 5)
    with pytest.raises(ValueError, match="CUDA"):
        rng_ops.dropout_kernel(x, tf.prng_key(1), 7, 0.5, NCHW)
    with pytest.raises(ValueError, match="CUDA"):
        rng_ops.dropout_mask_kernel(x, torch.zeros(4, dtype=torch.int32), 2.0)


# -- every module's dropout sites ---------------------------------------------

def _site_cfg(kind, dtype):
    """A narrow config whose G or D has dropout 0.5 at each of its sites:
    the MLP G (Dropout_0, _1), the conv G (bottleneck Dropout_0, one a
    decoder level), the BiLSTM G (one a layer), the conv D and the patch D
    (one a conv)."""
    preset = {"mlp": "2src_toy_cpu", "bilstm": "3src_pit"}.get(kind, "stream_v5e8")
    cfg = config.get_config(preset)
    model = {"compute_dtype": dtype, "dropout": 0.5, "g_channels": (8, 16),
             "d_channels": (8, 16)}
    model.update({"mlp": {"generator": "toy", "g_hidden": 16},
                  "bilstm": {"g_hidden": 16, "g_film_channels": 8},
                  "patch_d": {"discriminator": "patch"}}.get(kind, {}))
    dsp = {"n_fft": 64, "hop_length": 16, "win_length": 64} if kind == "bilstm" else {}
    return cfg.replace(model=dataclasses.replace(cfg.model, **model),
                       dsp=dataclasses.replace(cfg.dsp, **dsp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlp", "conv_g", "bilstm", "conv_d", "patch_d"])
def test_dropout_sites_equal_flax_apply(kind, dtype):
    """The module applied with train=True under one `dropout` rng, against
    flax's apply (jitted) of the same parameters under that rng, at the
    tolerances of tests/test_torch_models.py (f32 1e-4; bf16 1e-2 for the
    BiLSTM, 3e-2 for the convs); under another rng the mean error is
    over 5 times as large."""
    atol = 1e-4 if dtype == "float32" else (1e-2 if kind == "bilstm" else 3e-2)
    cfg = _site_cfg(kind, dtype)
    rng = np.random.default_rng(6)
    key = tf.prng_key(17)
    if kind.endswith("_d"):
        td = tmodels.build_discriminator(cfg, "cpu", seed=1)
        variables = tmodels.discriminator_variables_to_flax(td.state_dict())
        flax_d = jmodels.build_discriminator(_jax(cfg))
        x = rng.standard_normal((3, 20, 33, 2)).astype(np.float32)

        def ref_fn(v, k):
            return flax_d.apply(variables, v, train=True, mutable=["batch_stats"],
                                rngs={"dropout": k})[0]

        def ours_fn(dk):
            return td(torch.from_numpy(x), train=True, dropout=dk)
    else:
        tg = tmodels.build_generator(cfg, "cpu", seed=1)
        params = {"params": _nest(tmodels.generator_params_to_flax(tg.state_dict()))}
        flax_g = jmodels.build_generator(_jax(cfg))
        x = rng.standard_normal((2, 12, cfg.dsp.feature_dim)).astype(np.float32)

        def ref_fn(v, k):
            return flax_g.apply(params, v, train=True, rngs={"dropout": k})

        def ours_fn(dk):
            return tg(torch.from_numpy(x), train=True, dropout=dk)
    ref = np.asarray(jax.jit(ref_fn)(jnp.asarray(x), jax.random.PRNGKey(17)))
    with torch.no_grad():
        ours = ours_fn(DropoutKey(key)).numpy()
        other = ours_fn(DropoutKey(tf.prng_key(18))).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=atol)
    assert np.abs(other - ref).mean() > 5 * np.abs(ours - ref).mean()


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# -- the every-option step over 12 steps ---------------------------------------

@pytest.fixture(scope="module")
def option_steps():
    """12 f32 steps of the stream_v5e8 geometry (device bank, gains, a
    noise source, shared f0) with G and D at one conv level of width 8
    (G's bottleneck and decoder dropout sites), dropout 0.2, instance
    noise 0.1, g_remat and the patch BN D, each package from its own init,
    bank and train key of one seed.  JAX's init is jitted: the same bits
    as the eager init, in a third of its time."""
    cfg = config.get_config("stream_v5e8")
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, segment_seconds=0.25, bank_utterances=4,
                                 gain_jitter_db=3.0, num_noise=1, snr_db=10.0,
                                 f0_mode="shared"),
        model=dataclasses.replace(cfg.model, g_channels=(8,), d_channels=(8,),
                                  compute_dtype="float32", dropout=0.2, g_remat=True,
                                  discriminator="patch", d_norm="batch"),
        train=dataclasses.replace(cfg.train, batch_size=2, d_instance_noise=0.1))
    jcfg, b = _jax(cfg), cfg.train.batch_size
    g, d = jmodels.build_generator(jcfg), jmodels.build_discriminator(jcfg)
    jstate = jax.jit(lambda k: j_create_train_state(jcfg, g, d, k))(jax.random.PRNGKey(SEED))
    jstep = jax.jit(j_build_train_step(jcfg, g, d, from_bank=True, local_batch=b))
    jbank = jnp.asarray(j_build_bank(jcfg, seed=SEED))
    tstate = create_train_state(cfg, "cpu", SEED)
    tstep = build_train_step(cfg, from_bank=True, local_batch=b)
    tbank = torch.from_numpy(tdata.build_bank(cfg, seed=SEED))
    jkey, tkey = jax.random.PRNGKey(SEED + 1), tf.prng_key(SEED + 1)
    out = {"jax": [], "torch": []}
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jbank, jkey)
        tstate, tm = tstep(tstate, tbank, tkey)
        out["jax"].append({k: float(v) for k, v in jm.items()})
        out["torch"].append({k: float(v) for k, v in tm.items()})
    return out


def test_every_option_steps_match_jax(option_steps):
    """Every metric within 1e-4 relative at each of 12 steps (the
    step-parity tolerance of tests/test_torch_train.py)."""
    for step, (j, t) in enumerate(zip(option_steps["jax"], option_steps["torch"]), 1):
        assert t.keys() == j.keys()
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=f"{k} after step {step}")
