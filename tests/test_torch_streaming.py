"""The port's streaming separation against the JAX package's
`infer/streaming.py` on the same generator weights, and the behaviour
tests of tests/test_infer.py run on the port.

The parity cases use `2src_toy_cpu` with G (8, 16) in f32 and pure tones,
whose chunks have a clear best source permutation; the chunk geometry and
the permutation chaining are held equal exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu.config import MeshConfig
from gan_sass_tf_tpu.infer import streaming as j_streaming
from gan_sass_tf_tpu.parallel import make_mesh
from gan_sass_tf_tpu_torch import config, infer
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch.infer import streaming

SR = 8000


def _cfg(**stream):
    cfg = config.get_config("2src_toy_cpu")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, g_channels=(8, 16)),
        stream=dataclasses.replace(cfg.stream, **stream))


def _jax(cfg):
    """The same configuration as the JAX package's Config, for its side."""
    return j_config.Config.from_json(cfg.to_json())


def _tones(seconds):
    n = np.arange(int(seconds * SR)) / SR
    return (np.sin(2 * np.pi * 300 * n) + np.sin(2 * np.pi * 1500 * n)).astype(
        np.float32)


@pytest.fixture(scope="module")
def weights():
    """Seeded flax G params of the toy config and the port's G carrying
    them (models/convert.py)."""
    cfg = _cfg()
    g = jmodels.build_generator(_jax(cfg))
    feats = jnp.zeros((1, 16, cfg.dsp.feature_dim), jnp.float32)
    params = g.init(jax.random.PRNGKey(0), feats)["params"]
    return params, tmodels.load_generator(cfg, jax.tree.map(np.asarray, params),
                                          "cpu")


@pytest.mark.parametrize("name", ["2src_toy_cpu", "wsj0_logmel", "stream_v5e8",
                                  "music_complex_44k"])
@pytest.mark.parametrize("short_window", [False, True])
def test_chunk_geometry_matches_jax(name, short_window):
    cfg = config.get_config(name)
    if short_window:        # win_length < n_fft: the hop-aligned extension
        dsp = cfg.dsp
        cfg = cfg.replace(dsp=dataclasses.replace(
            dsp, win_length=dsp.n_fft - dsp.hop_length - 3))
    for total in (100, 2000, SR, 23_456, 60 * cfg.dsp.sample_rate):
        assert streaming._chunk_geometry(cfg, total) == \
            j_streaming._chunk_geometry(_jax(cfg), total)
    if name == "stream_v5e8" and not short_window:
        # 60 s: 62 chunks of 16 000 samples, 8 groups of 8 in batch mode.
        assert streaming._chunk_geometry(cfg, 960_000) == (
            16_000, 15_488, 512, 62, 960_768, 0)


@pytest.mark.parametrize("hysteresis", [0.0, 1e-3, 1e-2])
@pytest.mark.parametrize("s", [2, 3])
def test_chain_permutations_matches_jax(rng, hysteresis, s):
    heads = rng.standard_normal((9, s, 40)).astype(np.float32)
    tails = heads[:, ::-1] + 0.5 * rng.standard_normal((9, s, 40)).astype(np.float32)
    heads[4] *= 1e-3                       # a near-silent overlap
    for scale in (None, 0.8):
        ours = streaming._chain_permutations(heads, tails, hysteresis, scale=scale)
        ref = j_streaming._chain_permutations(heads, tails, hysteresis, scale=scale)
        np.testing.assert_array_equal(ours, ref)


def test_finalize_stream_matches_jax(rng):
    """Both joins: the slice-add (t_c % stride != 0, stream_v5e8's case)
    and the overlap-add (t_c a multiple of the stride)."""
    for n, t_c, stride, overlap in ((5, 80, 60, 20), (6, 64, 32, 32), (1, 50, 40, 10)):
        est = rng.standard_normal((n, 2, t_c)).astype(np.float32)
        perm = np.stack([rng.permutation(2) for _ in range(n)]).astype(np.int32)
        ours = streaming._finalize_stream(torch.from_numpy(est), torch.from_numpy(perm),
                                          stride, overlap).numpy()
        ref = np.asarray(j_streaming._finalize_stream(jnp.asarray(est),
                                                      jnp.asarray(perm), stride, overlap))
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def _recorded_chains(monkeypatch, module):
    """Wrap module._chain_permutations to record what it returns."""
    seen, inner = [], module._chain_permutations

    def chain(*args, **kwargs):
        seen.append(inner(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(module, "_chain_permutations", chain)
    return seen


# (mode, chunk_seconds, hysteresis).  1 s chunks join by slice-add, 0.064 s
# (t_c = 2·stride) by overlap-add.  The JAX scan path matches chunk 0
# against its zero initial carry, a tie that float rounding breaks either
# way at hysteresis 0 (at 0.064 s it swaps both sources for the whole
# stream); the port keeps chunk 0's order, as the batched paths do.  A
# margin keeps the JAX order there too.
@pytest.mark.parametrize("mode,chunk_seconds,hysteresis", [
    ("batch", 1.0, 0.0), ("batch", 0.064, 0.0), ("batch", 0.064, 1e-3),
    ("scan", 1.0, 0.0), ("scan", 0.064, 1e-3)])
def test_streaming_matches_jax(weights, monkeypatch, mode, chunk_seconds,
                               hysteresis):
    params, g = weights
    cfg = _cfg(chunk_seconds=chunk_seconds, batch_chunks=4,
               perm_hysteresis=hysteresis)
    wav = _tones(2.5)
    if mode == "batch":
        ours_perm = _recorded_chains(monkeypatch, streaming)
        ref_perm = _recorded_chains(monkeypatch, j_streaming)
        ours = infer.separate_streaming(g, cfg, wav, "cpu")
        ref = np.asarray(j_streaming.separate_streaming(
            params, _jax(cfg), wav, mesh=make_mesh(MeshConfig(data_axis_size=1))))
        np.testing.assert_array_equal(ours_perm[0], ref_perm[0])
    else:
        ours = infer.separate_streaming_scan(g, cfg, wav, "cpu")
        ref = j_streaming.separate_streaming_scan(params, _jax(cfg), wav)
    assert ours.shape == ref.shape == (2, wav.shape[0])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize("fn", [infer.separate_streaming,
                                infer.separate_streaming_scan])
def test_streaming_short_input(weights, fn):
    wav = np.random.default_rng(1).standard_normal(2000).astype(np.float32)
    out = fn(weights[1], _cfg(), wav, "cpu")        # shorter than one chunk
    assert out.shape == (2, 2000) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="single"):
        fn(weights[1], _cfg(), wav[None], "cpu")


def test_streaming_perm_alignment():
    """Chunks with swapped sources are re-aligned to a consistent order."""
    rng = np.random.default_rng(0)
    stride, overlap = 60, 20
    t_c = stride + overlap
    base = rng.standard_normal((2, 3 * stride + overlap)).astype(np.float32)
    chunks = np.stack([base[:, i * stride: i * stride + t_c] for i in range(3)])
    chunks[1] = chunks[1][::-1]              # swap the sources of the middle chunk
    fixed = streaming._align_chunk_permutations(chunks, stride, overlap, 0.0)
    for i in range(1, 3):
        np.testing.assert_allclose(fixed[i, :, :overlap], fixed[i - 1, :, stride:],
                                   atol=1e-6)


def test_streaming_scan_first_chunk_full_weight(weights):
    """Chunk 0's head is not faded against the zero initial carry: its
    first `overlap` samples match the batched path's on the source sum."""
    cfg, wav = _cfg(), _tones(2.5)
    out_scan = infer.separate_streaming_scan(weights[1], cfg, wav, "cpu")
    out_batch = infer.separate_streaming(weights[1], cfg, wav, "cpu")
    overlap = cfg.stream.overlap_frames * cfg.dsp.hop_length
    np.testing.assert_allclose(out_scan.sum(axis=0)[:overlap],
                               out_batch.sum(axis=0)[:overlap], rtol=0, atol=1e-4)


def test_streaming_win_length_no_boundary_dips(weights):
    """With win_length < n_fft each chunk reads a hop-aligned extension and
    is cropped, so chunk boundaries show no dips: both modes match the
    one-shot separation of the whole signal on the source sum."""
    base = _cfg()
    cfg = base.replace(dsp=dataclasses.replace(base.dsp, win_length=200))
    g = tmodels.build_generator(cfg, "cpu")
    wav = _tones(2.5)
    t = wav.shape[0]
    ref = infer.separate(g, cfg, wav, "cpu")
    valid = t - (cfg.dsp.n_fft - cfg.dsp.win_length)     # one-shot zero tail
    for fn in (infer.separate_streaming, infer.separate_streaming_scan):
        out = fn(g, cfg, wav, "cpu")
        assert out.shape == (2, t)
        a, b = out.sum(axis=0)[256:valid], ref.sum(axis=0)[256:valid]
        d = np.abs(a - b)
        scale = max(1.0, float(np.abs(b).max()))
        assert np.quantile(d, 0.99) < 5e-2 * scale, fn.__name__
        assert d.max() < 0.25 * scale, fn.__name__
        energy = np.convolve(np.abs(a), np.ones(64) / 64, mode="valid")
        assert energy.min() > 0.25 * energy.max(), fn.__name__


def test_streaming_perm_hysteresis_near_silent_overlap():
    """A near-silent overlap carries no matching evidence: with the margin
    the chain keeps the previous assignment, pure argmin flips, and a loud
    genuine swap is still corrected."""
    stride, overlap = 60, 20
    t_c = stride + overlap
    rng = np.random.default_rng(3)
    chunks = rng.standard_normal((3, 2, t_c)).astype(np.float32)
    eps = 1e-4
    chunks[1, 0, stride:], chunks[1, 1, stride:] = eps, -eps
    chunks[2, 0, :overlap], chunks[2, 1, :overlap] = -eps, eps
    heads, tails = chunks[:, :, :overlap], chunks[:, :, stride:]
    perm = streaming._chain_permutations(heads, tails, 1e-3)
    np.testing.assert_array_equal(perm[2], perm[1])
    perm0 = streaming._chain_permutations(heads, tails, 0.0)
    assert not np.array_equal(perm0[2], perm0[1])
    loud = rng.standard_normal((2, 3 * stride + overlap)).astype(np.float32)
    ch = np.stack([loud[:, i * stride: i * stride + t_c] for i in range(3)])
    ch[1] = ch[1][::-1]
    p = streaming._chain_permutations(ch[:, :, :overlap], ch[:, :, stride:], 1e-3)
    assert p[1].tolist() == [1, 0]


def _stub_separate(sr):
    """tests/_streaming_gap_scenario.py's order-unstable band-split
    'separator' on torch chunks: (B, T) -> (B, 2, T).  Its output order
    follows each chunk's content through a float sum, so the JAX stub
    itself runs here and the flips fall where they fall in
    tests/test_infer.py."""
    from _streaming_gap_scenario import make_stub_separate

    stub = make_stub_separate(sr)
    return lambda chunks: torch.from_numpy(
        np.array(stub(None, jnp.asarray(chunks.numpy()))))


@pytest.mark.parametrize("hysteresis", [1e-3, 0.0])
def test_streaming_silent_gap_end_to_end(monkeypatch, hysteresis):
    """An order-unstable separator and a noisy pause over several chunk
    boundaries.  With the margin, both paths emit a swap-free stream (loud
    boundaries fixed by the overlap evidence, the gap held by hysteresis);
    with hysteresis 0 the scan path flips mid-gap (the negative control:
    without it the positive case proves nothing)."""
    from _streaming_gap_scenario import gap_assignment, make_scenario

    cfg = _cfg(perm_hysteresis=hysteresis)
    mixture, low, high, t, sr = make_scenario(cfg)
    stub = _stub_separate(sr)
    monkeypatch.setattr(streaming, "build_separate_fn", lambda cfg_, g_: stub)
    scan = infer.separate_streaming_scan(None, cfg, mixture, "cpu")
    if hysteresis:
        out = infer.separate_streaming(None, cfg, mixture, "cpu", separate_fn=stub)
        assert out.shape == scan.shape == (2, t)
        i0, i1 = gap_assignment(out, low, high, sr)
        assert i0 == i1, "batch path: sources swapped across the gap"
        i0, i1 = gap_assignment(scan, low, high, sr)
        assert i0 == i1, "scan path: sources swapped across the gap"
    else:
        i0, i1 = gap_assignment(scan, low, high, sr, require_clean=False)
        assert i0 != i1, "hysteresis 0 no longer flips in the gap"
