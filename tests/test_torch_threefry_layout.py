"""numpy mirrors of how `csrc/threefry.cu`'s noise and sampler lay out their
work, held to the plain versions (`data/threefry.py`) and to `jax.random`:

  * the bf16 noise: a 128-entry table of round_bf16(coef·z), z jax's bf16
    normal of the byte's top 7 bits, filled by the plain arithmetic, and
    looked up by (b & 0xFF) >> 1 for each element of a thread's 16-byte
    vector (8 elements; a scalar path for the tail) in a grid-stride loop;
  * erf⁻¹ with a branch on w < 5 in place of a select a coefficient;
  * the sampler's thread-to-(row, value) map: 4 values of one row a
    thread (one where rows are shorter than 4), several short rows a block
    or a long row across blocks on x, rows on y in a loop past the grid's
    65 535.

The kernels run only on the card (`chip_smoke.py`'s rng phase holds them
to the plain versions there); these mirrors check the arithmetic and the
index maps they were written from, bit for bit."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu_torch.data import threefry as tf
from gan_sass_tf_tpu_torch.ops import threefry as rng_ops

THREADS = rng_ops.THREADS
VEC_BF16 = 8                 # bf16 elements a 16-byte vector
SAMPLE_VEC = 4               # a sampler thread's values of a long row (kSampleVec)
MAX_GRID_Y = 65535           # kMaxGridY
NORMALS = 128                # the bf16 normal's values (kNormals)


def _bf16(a) -> np.ndarray:
    """float32 values rounded to bf16 (nearest even), as float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _erf_inv_branch(x) -> np.ndarray:
    """The kernel's erf⁻¹: w = -log1p(-x²), then each value takes one side,
    w < 5 or not, and runs its Horner steps there alone (a float64 product
    and sum rounded once to float32, as fma32), times x; ±1 -> ±inf.  Its
    log1p and sqrt are torch's, as the plain version's: on the CPU torch's
    float32 sqrt can miss the correctly rounded root (numpy's, and the
    kernel's __fsqrt_rn) by an ulp."""
    x = np.asarray(x, np.float32)
    w = -torch.log1p(torch.from_numpy(x * -x))
    root, w = torch.sqrt(w).numpy(), w.numpy()
    out = np.empty_like(x)
    small = w < np.float32(5.0)
    with np.errstate(invalid="ignore", over="ignore"):
        for side, coefs in ((small, tf.ERF_INV_SMALL), (~small, tf.ERF_INV_LARGE)):
            ws = w[side] - np.float32(2.5) if coefs is tf.ERF_INV_SMALL \
                else root[side] - np.float32(3.0)
            p = np.full(ws.shape, np.float32(coefs[0]))
            for c in coefs[1:]:
                p = (p.astype(np.float64) * ws + np.float32(c)).astype(np.float32)
            out[side] = p * x[side]
        edge = np.abs(x) == 1.0
        out[edge] = x[edge] * np.float32(np.inf)
    return out


def _bf16_normals() -> np.ndarray:
    """z of each byte's top 7 bits m: round_bf16(round_bf16(erf⁻¹(u))·
    bf16(√2)), u = (4m - 255)/256 (bf16_noise before its coef)."""
    u = (4 * np.arange(NORMALS) - 255).astype(np.float32) * np.float32(1 / 256)
    return _bf16(_bf16(_erf_inv_branch(u)) * np.float32(tf.SQRT2_BF16))


def _noise_walk(x, bits, coef, blocks):
    """threefry_noise_kernel<bf16> over `blocks` blocks: a table of
    round_bf16(coef·z), then each thread's 16-byte vectors (8 elements,
    the last one's tail element by element) in a grid-stride loop, y =
    round_bf16(x + table[(b & 0xFF) >> 1]) with the add in float32.
    Returns y and how many times each element was written."""
    table = _bf16(np.float32(coef) * _bf16_normals())
    n = x.size
    y, visits = np.zeros(n, np.float32), np.zeros(n, np.int64)
    chunks, stride = -(-n // VEC_BF16), blocks * THREADS
    for first in range(0, min(stride, chunks)):
        for q in range(first, chunks, stride):
            m = np.arange(q * VEC_BF16, min(q * VEC_BF16 + VEC_BF16, n))
            y[m] = _bf16(x[m] + table[(bits[m] & 0xFF) >> 1])
            visits[m] += 1
    return y, visits


@pytest.mark.parametrize("shape", [(6, 9, 17, 4), (3, 41, 7)])
def test_noise_table_lookup_equals_plain_and_jax_bf16(shape):
    """The 128-entry lookup by (b & 0xFF) >> 1 gives tf.normal's and
    jax.random.normal's bf16 normals bit for bit, and the noise's walk
    (at one block, seven, and a vector a thread) the plain noise and the
    reference's jitted expression bit for bit, each element once; (3, 41,
    7) ends in a tail of 5."""
    seed, std = 5, 0.1
    key, jkey = tf.prng_key(seed), jax.random.PRNGKey(seed)
    bits = tf.random_bits(key, (int(np.prod(shape)),)).numpy()
    z = _bf16_normals()[(bits & 0xFF) >> 1]
    want = tf.normal(key, shape, torch.bfloat16).float().numpy().reshape(-1)
    np.testing.assert_array_equal(z.view(np.int32), want.view(np.int32))
    jz = np.asarray(jax.random.normal(jkey, shape, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(z.view(np.int32), jz.reshape(-1).view(np.int32))

    tx = (torch.from_numpy(np.random.default_rng(4).standard_normal(shape)
                           .astype(np.float32)) * 3).bfloat16()
    ref = rng_ops.noise_reference(tx, key, std).float().numpy().reshape(-1)
    jref = jax.jit(lambda v, k: v + std * jax.random.normal(k, v.shape, v.dtype))(
        jnp.asarray(tx.float().numpy(), jnp.bfloat16), jkey)
    np.testing.assert_array_equal(ref.view(np.int32), np.asarray(
        jref.astype(jnp.float32)).reshape(-1).view(np.int32))
    x = tx.float().numpy().reshape(-1)
    coef = rng_ops.noise_coef(torch.bfloat16, std)
    for blocks in (1, 7, -(-x.size // (VEC_BF16 * THREADS))):
        y, visits = _noise_walk(x, bits, coef, blocks)
        assert (visits == 1).all(), blocks
        np.testing.assert_array_equal(y.view(np.int32), ref.view(np.int32))


def _boundary_uniforms() -> np.ndarray:
    """float32 uniforms where erf⁻¹'s branch turns (w = 5 at |u| =
    sqrt(1 - e^-5) ≈ 0.99662: 64 floats each side of it, both signs), at
    the ends (±(1 - 2^-23), nextafter(-1, 0), ±1) and 0."""
    turn = np.float32(np.sqrt(1.0 - np.exp(-5.0)))
    near = turn.view(np.int32) + np.arange(-64, 65, dtype=np.int32)
    near = near.view(np.float32)
    ends = np.array([1 - 2.0 ** -23, tf.NORMAL_LOW, 1.0, 0.0], np.float32)
    return np.concatenate([near, -near, ends, -ends])


def test_erf_inv_branch_equals_the_select():
    """erf⁻¹ taking one side (w < 5 or not) a value equals the plain
    version's select a coefficient bit for bit: over the 128 bf16
    uniforms, 10^5 seeded float32 normal uniforms, and the values where
    the branch turns and at the ends."""
    u_bf16 = (4 * np.arange(NORMALS) - 255).astype(np.float32) / np.float32(256)
    u_f32 = tf.uniform(tf.prng_key(23), (100_000,), tf.NORMAL_LOW, 1.0).numpy()
    u = np.concatenate([u_bf16, u_f32, _boundary_uniforms()])
    got = _erf_inv_branch(u)
    want = tf.erf_inv(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    w = -np.log1p(-u.astype(np.float64) ** 2)
    assert (w < 5).any() and (w >= 5).any()        # both sides taken
    assert np.isinf(got[np.abs(u) == 1]).all()


# -- the sampler's map ---------------------------------------------------------

def _sample_grid(r, n, max_y=MAX_GRID_Y):
    """threefry_sample_launch's grid: (values a thread, chunks a row, rows
    a block, row groups, blocks on x, blocks on y)."""
    v = SAMPLE_VEC if n >= SAMPLE_VEC else 1
    chunks = (n - 1) // v + 1
    rows = 1 if chunks >= THREADS else THREADS // chunks
    groups = (r - 1) // rows + 1
    gx = (chunks - 1) // THREADS + 1 if chunks >= THREADS else 1
    return v, chunks, rows, groups, gx, min(groups, max_y)


def _block_threads(chunks, rows, gx):
    """(local row, chunk) of each live thread of a row of blocks, as the
    kernel computes them: one division, local = threadIdx.x // chunks."""
    bx, t = np.meshgrid(np.arange(gx), np.arange(THREADS), indexing="ij")
    local = t // chunks
    chunk = bx * THREADS + t - local * chunks
    live = (local < rows) & (chunk < chunks)
    return local[live], chunk[live]


def _row_groups(groups, gy):
    """The row group g of each (blockIdx.y, loop iteration): g = blockIdx.y
    + k·gridDim.y while below `groups`."""
    g = np.arange(gy)[:, None] + gy * np.arange(-(-groups // gy))[None, :]
    return g[g < groups]


def _sample_counts(r, n, max_y=MAX_GRID_Y):
    """(row visits (r,), (local, chunk) visits (rows, chunks), value visits
    of a chunk (n,)): how often the map reaches each row, each thread
    place and each value of a row.  A thread's row depends on (g, local)
    only and its chunk on (blockIdx.x, threadIdx.x) only, and local is
    row mod rows, so (row, j) is visited row visits x place visits x
    value visits times."""
    v, chunks, rows, groups, gx, gy = _sample_grid(r, n, max_y)
    local, chunk = _block_threads(chunks, rows, gx)
    places = np.zeros((rows, chunks), np.int64)
    np.add.at(places, (local, chunk), 1)
    row = (_row_groups(groups, gy)[:, None] * rows + np.arange(rows)[None, :]).ravel()
    row_visits = np.bincount(row[row < r], minlength=r)
    j = (np.arange(chunks)[:, None] * v + np.arange(v)).ravel()
    value_visits = np.bincount(j[j < n], minlength=n)
    return row_visits, places[np.unique(np.arange(r) % rows)], value_visits


@pytest.mark.parametrize("r", [1, 2, 128, 70_000])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 32_000])
def test_sampler_map_visits_every_value_once(r, n):
    """Every (row, j) of an (r, n) draw is reached exactly once; a block
    holds as many whole rows as fit, or a row's threads fill all its
    blocks but the last (at 128 x 2 one block, as at a value a thread)."""
    row_visits, places, value_visits = _sample_counts(r, n)
    assert (row_visits == 1).all() and (places == 1).all() and (value_visits == 1).all()
    v, chunks, rows, groups, gx, gy = _sample_grid(r, n)
    assert v == (1 if n < SAMPLE_VEC else SAMPLE_VEC)
    if chunks < THREADS:
        assert gx == 1 and THREADS - chunks < rows * chunks <= THREADS
    else:
        assert rows == 1 and (gx - 1) * THREADS < chunks <= gx * THREADS
    if (r, n) == (128, 2):
        assert gx * gy == 1


@pytest.mark.parametrize("r,n,max_y", [(70_000, 5, 100), (300, 3, 1), (5, 1100, 2),
                                       (3, 5, MAX_GRID_Y), (128, 32_000, 7),
                                       (128, 2, MAX_GRID_Y), (70_000, 2, 50)])
def test_sampler_map_enumerated(r, n, max_y):
    """The map thread by thread, every (row, j) counted, with the y grid
    cut to `max_y` so that threads loop over row groups: each once."""
    v, chunks, rows, groups, gx, gy = _sample_grid(r, n, max_y)
    local, chunk = _block_threads(chunks, rows, gx)
    visits = np.zeros(r * n, np.int64)
    for g in _row_groups(groups, gy):
        row = g * rows + local
        ok = row < r
        j0 = chunk[ok] * v
        for i in range(v):
            live = j0 + i < n
            np.add.at(visits, row[ok][live] * n + j0[live] + i, 1)
    assert (visits == 1).all()


# -- the wrappers and the tools around the kernels ------------------------------

def test_noise_and_sampler_kernels_refuse_cpu_tensors():
    """On the CPU the dispatch takes the plain versions; the noise and
    sampler wrappers launch on CUDA tensors or raise."""
    key = tf.prng_key(1)
    with pytest.raises(ValueError, match="CUDA"):
        rng_ops.noise_kernel(torch.randn(2, 3, 4, 5).bfloat16(), key, 0.1, blocks=7)
    with pytest.raises(ValueError, match="CUDA"):
        rng_ops.sample_kernel(key[None].repeat(3, 1), 5, "normal")


def test_time_dropout_needs_cuda_and_its_edits_match_the_source():
    """scripts/time_dropout.py refuses to run without a CUDA device (this
    process sees none) in each mode; every ablation edits text the kernel
    source holds (the noise's edits once), and names kernels it times."""
    from gan_sass_tf_tpu_torch.ops import build
    from gan_sass_tf_tpu_torch.scripts import time_dropout

    assert not torch.cuda.is_available()
    for argv in ([], ["--kernels"], ["--ablate"], ["bench"]):
        with pytest.raises(SystemExit, match="CUDA"):
            time_dropout.main(argv)
    src = (build.CSRC / "threefry.cu").read_text()
    for what, (groups, edits, _) in time_dropout.ABLATIONS.items():
        assert set(groups) <= set(time_dropout.SASS_OF), what
        for old, _ in edits:
            assert src.count(old) == (2 if old == time_dropout._KEEP else 1), what


def test_kernel_sass_splits_basic_blocks_and_names_sampler_kinds():
    """kernel_sass's basic blocks start at branch targets (a label or an
    address) and end after a branch or exit; the hot block is the one with
    the most rotates; a sampler instance is named by its kind and values a
    thread."""
    from gan_sass_tf_tpu_torch.scripts import kernel_sass

    sass = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_122threefry_sample_kernelILi3ELj4EEEvPKxjjjjjffjjxPv",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
        "        /*0010*/              @P0 BRA 0x40 ;",
        "        /*0020*/                   SHF.L.W.U32.HI R2, R2, 0xd, R2 ;",
        "        /*0030*/                   IADD3 R3, R3, R2, RZ ;",
        "        /*0040*/                   SHF.L.W.U32.HI R2, R2, 0xf, R2 ;",
        "        /*0050*/                   SHF.L.W.U32.HI R3, R3, 0x1a, R3 ;",
        "        /*0060*/              @!P1 BRA `(.L_x_1) ;",
        "        /*0070*/                   EXIT ;",
        ".L_x_1:",
        "        /*0080*/                   FFMA R1, R1, R1, R1 ;",
        "        /*0090*/                   EXIT ;"])
    (name, lines), = kernel_sass.function_lines(sass).items()
    assert kernel_sass.short(name) == "threefry_sample_kernel<normal, 4>"
    assert kernel_sass.basic_blocks(lines) == [
        ["LDC", "BRA"], ["SHF.L.W.U32.HI", "IADD3"],
        ["SHF.L.W.U32.HI", "SHF.L.W.U32.HI", "BRA"], ["EXIT"], ["FFMA", "EXIT"]]
    hot = kernel_sass.tally(kernel_sass.hot_block(lines))
    assert hot["rotates"] == 2 and hot["alu"] == 2 and hot["instructions"] == 3
    assert kernel_sass.functions(sass)[name][:2] == ["LDC", "BRA"]
