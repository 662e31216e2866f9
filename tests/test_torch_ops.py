"""The port's DSP kernels' plain versions (gan_sass_tf_tpu_torch.ops)
against the JAX package's Pallas kernels, run in TPU interpret mode as
tests/test_pallas.py runs them, plus the dispatch guards.  The CUDA kernels
themselves are compared with these plain versions on the card by
chip_smoke.py (this process has no GPU)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gan_sass_tf_tpu.dsp.features import mel_filterbank
from gan_sass_tf_tpu.ops import dispatch as j_dispatch
from gan_sass_tf_tpu.ops.pallas_istft import istft_pallas, masked_istft_pallas
from gan_sass_tf_tpu.ops.pallas_stft import stft_features_pallas, stft_pallas
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.dsp import istft as plain_istft
from gan_sass_tf_tpu_torch.dsp.windows import get_window
from gan_sass_tf_tpu_torch.ops import dispatch
from gan_sass_tf_tpu_torch.ops import istft as k3
from gan_sass_tf_tpu_torch.ops import masked_istft as k2
from gan_sass_tf_tpu_torch.ops import stft as k4
from gan_sass_tf_tpu_torch.ops import stft_features as k1

EMIT = ("spec", "mag", "logmag", "logmel")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("n_fft,hop,t,n_mels", [
    (512, 128, 5000, 80),
    (256, 64, 4000, 16),
])
def test_stft_features_reference_matches_pallas(rng, interpret, n_fft, hop,
                                                t, n_mels):
    x = _rand(rng, 2, t)
    mel = mel_filterbank(n_mels, n_fft // 2 + 1, 8000)
    ref = stft_features_pallas(jnp.asarray(x), n_fft, hop, emit=EMIT,
                               mel_matrix=jnp.asarray(mel), eps=1e-8)
    ours = k1.stft_features_reference(torch.from_numpy(x), n_fft, hop,
                                      emit=EMIT, mel_matrix=torch.from_numpy(mel))
    assert set(ours) == set(EMIT)
    scale = float(np.abs(np.asarray(ref["mag"])).max())
    for key in EMIT:
        a, b = ours[key].numpy(), np.asarray(ref[key])
        assert a.shape == b.shape, key
        atol = 3e-4 * scale if key in ("spec", "mag") else 1e-3
        np.testing.assert_allclose(a, b, atol=atol, err_msg=key)


@pytest.mark.parametrize("mask_type", ["magnitude", "complex"])
def test_masked_istft_reference_matches_pallas(rng, interpret, mask_type):
    n_fft, hop, t, b, s = 512, 128, 5000, 2, 3
    x = _rand(rng, b, t)
    spec = np.array(k1.stft_features_reference(
        torch.from_numpy(x), n_fft, hop)["spec"].numpy())
    m_shape = (b, s) + spec.shape[-2:] + ((2,) if mask_type == "complex" else ())
    masks = rng.uniform(-1, 1, m_shape).astype(np.float32)
    ref = np.asarray(masked_istft_pallas(jnp.asarray(spec), jnp.asarray(masks),
                                         n_fft, hop, mask_type=mask_type))
    ours = k2.masked_istft_reference(torch.from_numpy(spec),
                                     torch.from_numpy(masks), n_fft, hop,
                                     mask_type=mask_type).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours[..., hop:-hop], ref[..., hop:-hop],
                               atol=3e-4, rtol=1e-3)


def test_masked_istft_reference_env_none_and_length(rng):
    n_fft, hop = 256, 64
    x = torch.from_numpy(_rand(rng, 1, 2000))
    spec = k1.stft_features_reference(x, n_fft, hop)["spec"]
    masks = torch.ones((1, 1) + tuple(spec.shape[-2:]))
    full = k2.masked_istft_reference(spec, masks, n_fft, hop)
    raw = k2.masked_istft_reference(spec, masks, n_fft, hop, env="none")
    inv = k2._inv_env(n_fft, hop, "hann", spec.shape[-2], torch.device("cpu"))
    torch.testing.assert_close(full, raw * inv, atol=1e-6, rtol=1e-5)
    cut = k2.masked_istft_reference(spec, masks, n_fft, hop, length=1000)
    assert cut.shape == (1, 1, 1000)


@pytest.mark.parametrize("emit", [("spec", "logmel"), ("logmag",), ("mag",)])
def test_dispatch_cpu_takes_reference_and_counts_nothing(rng, emit):
    dcfg = config.get_config("wsj0_logmel").dsp
    x = torch.from_numpy(_rand(rng, 2, 4000))
    before = (k1.launches, k2.launches)
    out = dispatch.stft_features(x, dcfg, emit=emit)
    ref = k1.stft_features_reference(
        x, 512, 128, emit=emit,
        mel_matrix=torch.from_numpy(mel_filterbank(80, 257, 8000)))
    assert set(out) == set(emit)
    for key in emit:
        torch.testing.assert_close(out[key], ref[key])
    if "spec" in emit:
        masks = torch.full((2, 2) + tuple(out["spec"].shape[-2:]), 0.5)
        y = dispatch.masked_istft(out["spec"], masks, 512, 128)
        assert y.shape == (2, 2, 4000 - (4000 - 512) % 128)
    assert (k1.launches, k2.launches) == before == (0, 0)


def test_dispatch_win_length_pads_tail(rng):
    dcfg = config.get_config("wsj0_logmel").dsp
    dcfg = dcfg.__class__(**{**dcfg.__dict__, "win_length": 400})
    x = torch.from_numpy(_rand(rng, 1, 5000))
    out = dispatch.stft_features(x, dcfg, emit=("spec",))
    assert out["spec"].shape[-2] == 1 + (5000 - 400) // 128
    masks = torch.ones((1, 1) + tuple(out["spec"].shape[-2:]))
    y = dispatch.masked_istft(out["spec"], masks, 512, 128, win_length=400)
    assert y.shape[-1] == (out["spec"].shape[-2] - 1) * 128 + 400


def test_kernel_wrappers_reject_bad_input(rng):
    x = torch.zeros(1, 4000)
    spec = torch.zeros(1, 10, 257, dtype=torch.complex64)
    masks = torch.zeros(1, 2, 10, 257)
    cases = [
        (lambda: k1.stft_features_kernel(x, 512, 100), "hop"),
        (lambda: k1.stft_features_kernel(x.double(), 512, 128), "float32"),
        (lambda: k1.stft_features_kernel(x[:, :100], 512, 128), "shorter"),
        (lambda: k1.stft_features_kernel(x, 512, 128, emit=("nope",)), "emit"),
        (lambda: k1.stft_features_kernel(x, 512, 128, emit=("logmel",)), "mel"),
        (lambda: k1.stft_features_kernel(x, 512, 128), "CUDA"),
        (lambda: k2.masked_istft_kernel(spec, masks, 512, 100), "hop"),
        (lambda: k2.masked_istft_kernel(spec, masks, 256, 64), "bins"),
        (lambda: k2.masked_istft_kernel(spec.real.contiguous(), masks, 512, 128),
         "complex64"),
        (lambda: k2.masked_istft_kernel(spec, masks, 512, 128,
                                        mask_type="complex"), "masks must"),
        (lambda: k2.masked_istft_kernel(spec, masks[:, :, :9], 512, 128),
         "masks must"),
        (lambda: k2.masked_istft_kernel(spec, masks, 512, 128), "CUDA"),
        (lambda: k2.masked_istft_kernel(spec, masks, 512, 128, env="x"), "env"),
    ]
    for fn, match in cases:
        with pytest.raises(ValueError, match=match):
            fn()
    assert (k1.launches, k2.launches) == (0, 0)


def test_istft_kernel_rejects_bad_input():
    re = torch.zeros(1, 10, 257)
    k3_cases = [
        (lambda: k3.istft_kernel(re, re, 512, 100), "hop"),
        (lambda: k3.istft_kernel(re.double(), re, 512, 128), "float32"),
        (lambda: k3.istft_kernel(re, re[:, :9], 512, 128), "one shape"),
        (lambda: k3.istft_kernel(re, re, 256, 64), "bins"),
        (lambda: k3.istft_kernel(re.transpose(1, 2).contiguous().transpose(1, 2),
                                 re, 512, 128), "contiguous"),
        (lambda: k3._launch_forward(torch.zeros(0, 10, 257), re, 512, 128,
                                    "hann"), "batch"),
    ]
    for fn, match in k3_cases:
        with pytest.raises(ValueError, match=match):
            fn()
    assert (k3.launches, k3.bwd_launches) == (0, 0)


def test_stft_features_kernel_refuses_a_gradient(rng):
    """The K1 kernel has no backward: an input that requires grad raises
    (before the device check, so it is reachable here) instead of cutting
    the gradient without a word."""
    dcfg = config.get_config("stream_v5e8").dsp
    x = torch.from_numpy(_rand(rng, 1, 4000)).requires_grad_()
    with dispatch.force_backend("kernel"):
        with pytest.raises(ValueError, match="no backward"):
            dispatch.stft_features(x, dcfg, emit=("spec",))
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            dispatch.stft_features(x, dcfg, emit=("spec",))
    with pytest.raises(ValueError, match="CUDA"):
        k1.stft_features_kernel(x.detach(), 512, 128)
    assert k1.launches == 0


def test_force_backend(rng):
    dcfg = config.get_config("wsj0_logmel").dsp
    x = torch.from_numpy(_rand(rng, 1, 4000))
    with dispatch.force_backend("kernel"):
        with pytest.raises(ValueError, match="CUDA"):
            dispatch.stft_features(x, dcfg, emit=("spec",))
    with dispatch.force_backend("reference"):
        assert "spec" in dispatch.stft_features(x, dcfg, emit=("spec",))
    with pytest.raises(ValueError, match="backend"):
        with dispatch.force_backend("pallas"):
            pass
    assert dispatch._FORCED is None


def test_kernel_modules_import_without_toolchain():
    from gan_sass_tf_tpu_torch.ops import build

    assert "triton" not in sys.modules
    assert build._lib is None
    assert [p.name for p in build._sources()] == ["masked_istft.cu",
                                                   "stft_features.cu"]
    assert [p.name for p in build._headers()] == ["fft.cuh"]
    assert {"istft_launch", "istft_adjoint_launch", "masked_istft_launch",
            "stft_launch", "stft_features_launch"} == set(build._SIGNATURES)
    assert build.library_path().parent == build.BUILD_DIR


ISTFT_GRIDS = [            # tests/test_pallas.py GRIDS
    (256, 64, 4000),
    (512, 128, 16384),
    (512, 128, 24064),
]


def _planes(rng, b, t, n_fft, hop):
    spec = k1.stft_features_reference(torch.from_numpy(_rand(rng, b, t)),
                                      n_fft, hop)["spec"]
    return np.array(spec.real.numpy()), np.array(spec.imag.numpy())


@pytest.mark.parametrize("n_fft,hop,t", ISTFT_GRIDS)
def test_istft_matches_pallas(rng, interpret, n_fft, hop, t):
    """K3 forward: the plain version and the autograd wrapper's CPU path
    against istft_pallas; interior atol 2e-4 / rtol 1e-3 as the reference's
    own test, the full length within 1e-3·max|y|."""
    re, im = _planes(rng, 2, t, n_fft, hop)
    ref = np.asarray(istft_pallas(jax.lax.complex(jnp.asarray(re), jnp.asarray(im)),
                                  n_fft, hop))
    tre, tim = torch.from_numpy(re), torch.from_numpy(im)
    for ours in (k3.istft_reference(tre, tim, n_fft, hop).numpy(),
                 k3.istft_kernel(tre, tim, n_fft, hop).numpy()):
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours[:, hop:-hop], ref[:, hop:-hop],
                                   atol=2e-4, rtol=1e-3)
        assert np.abs(ours - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("n_fft,hop,t", [(256, 64, 2048), (512, 128, 5000)])
def test_istft_vjp_matches_pallas_custom_vjp(rng, interpret, n_fft, hop, t):
    """K3 backward: the wrapper's gradient (the K1-form adjoint on the plain
    STFT) and plain autograd, against jax.grad through istft_pallas's custom
    VJP; atol 5e-4·scale, rtol 1e-3 (tests/test_pallas.py)."""
    re, im = _planes(rng, 2, t, n_fft, hop)
    f = re.shape[-2]
    tgt = _rand(rng, 2, (f - 1) * hop + n_fft - 37)

    def jloss(a, b):
        y = istft_pallas(jax.lax.complex(a, b), n_fft, hop, length=tgt.shape[-1])
        return jnp.mean((y - tgt) ** 2)

    ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
    for fn in (k3.istft_kernel, k3.istft_reference):
        tre = torch.from_numpy(re).requires_grad_()
        tim = torch.from_numpy(im).requires_grad_()
        y = fn(tre, tim, n_fft, hop, length=tgt.shape[-1])
        ((y - torch.from_numpy(tgt)) ** 2).mean().backward()
        for ours, want in zip((tre.grad, tim.grad), ref):
            want = np.asarray(want)
            scale = np.abs(want).max() + 1e-12
            np.testing.assert_allclose(ours.numpy(), want, atol=5e-4 * scale,
                                       rtol=1e-3)


def test_k1_form_adjoint_equals_autograd_through_plain_istft(rng):
    """The identity the card runs: dre, dim = a_k · STFT_w(dy·inv_env)."""
    n_fft, hop = 512, 128
    re, im = (torch.from_numpy(a).requires_grad_()
              for a in _planes(rng, 3, 6000, n_fft, hop))
    y = plain_istft(torch.complex(re, im), n_fft, hop, norm="global")
    dy = torch.from_numpy(_rand(rng, *y.shape))
    y.backward(dy)
    dre, dim = k3.istft_adjoint(dy, n_fft, hop, "hann", re.shape[-2])
    for ours, want in ((dre, re.grad), (dim, im.grad)):
        scale = float(want.abs().max())
        torch.testing.assert_close(ours, want, atol=1e-6 * scale, rtol=1e-5)


def test_dispatch_istft_cpu_takes_plain_path(rng):
    n_fft, hop = 512, 128
    re, im = _planes(rng, 2, 5000, n_fft, hop)
    spec = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    spec = spec.reshape(1, 2, *spec.shape[-2:]).requires_grad_()
    y = dispatch.istft(spec, n_fft, hop)
    assert y.shape == (1, 2, (re.shape[-2] - 1) * hop + n_fft)
    torch.testing.assert_close(y, plain_istft(spec, n_fft, hop, norm="global"))
    y.square().sum().backward()
    assert spec.grad is not None and torch.isfinite(spec.grad).all()
    assert dispatch.istft(spec, n_fft, hop, win_length=400).shape[-1] == \
        (re.shape[-2] - 1) * hop + 400
    with dispatch.force_backend("kernel"):          # the wrapper's CPU path
        torch.testing.assert_close(dispatch.istft(spec, n_fft, hop), y,
                                   atol=1e-6, rtol=1e-5)
    assert (k3.launches, k3.bwd_launches, k1.launches) == (0, 0, 0)


STFT_GRIDS = [             # tests/test_pallas.py GRIDS, then music_complex_44k's
    ((2, 4000), 256, 64),
    ((2, 16384), 512, 128),
    ((2, 24064), 512, 128),
    ((2, 10752), 2048, 512),
    ((2, 3, 4000), 256, 64),       # (B, S, T), as for the oracle's targets
]


@pytest.mark.parametrize("shape,n_fft,hop", STFT_GRIDS)
def test_stft_reference_matches_stft_pallas(rng, interpret, shape, n_fft, hop):
    """K4's plain version against stft_pallas at the reference's STFT
    tolerance: atol 3e-4·max|X|, rtol 1e-3."""
    x = _rand(rng, *shape)
    ref = np.asarray(stft_pallas(jnp.asarray(x), n_fft, hop))
    ours = k4.stft_reference(torch.from_numpy(x), n_fft, hop)
    assert ours.dtype == torch.complex64 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=3e-4 * np.abs(ref).max(),
                               rtol=1e-3)


@pytest.mark.parametrize("n_fft,hop,win_length", [(512, 128, 400), (256, 64, 256)])
def test_dispatch_stft_matches_jax_dispatch(rng, n_fft, hop, win_length):
    """The encoded window and the tail padding of win_length < n_fft, on
    the CPU path, against the JAX package's ops.dispatch.stft."""
    x = _rand(rng, 2, 3, 5000)
    ref = np.asarray(j_dispatch.stft(jnp.asarray(x), n_fft, hop,
                                     win_length=win_length))
    ours = dispatch.stft(torch.from_numpy(x), n_fft, hop, win_length=win_length)
    assert ours.shape == ref.shape == (2, 3, 1 + (5000 - win_length) // hop,
                                       n_fft // 2 + 1)
    np.testing.assert_allclose(ours.numpy(), ref, atol=3e-4 * np.abs(ref).max(),
                               rtol=1e-3)
    with dispatch.force_backend("reference"):
        torch.testing.assert_close(
            dispatch.stft(torch.from_numpy(x), n_fft, hop, win_length=win_length),
            ours, atol=0, rtol=0)
    assert k4.launches == 0


def test_stft_kernel_rejects_bad_input(rng):
    x = torch.zeros(2, 4000)
    cases = [
        (lambda: k4.stft_kernel(x, 512, 100), "hop"),
        (lambda: k4.stft_kernel(x.double(), 512, 128), "float32"),
        (lambda: k4.stft_kernel(x[:, :100], 512, 128), "shorter"),
        (lambda: k4.stft_kernel(torch.zeros(0, 4000), 512, 128), "batch"),
        (lambda: k4.stft_kernel(x.requires_grad_(), 512, 128), "no backward"),
        (lambda: k4.stft_kernel(x.detach(), 512, 128), "CUDA"),
    ]
    for fn, match in cases:
        with pytest.raises(ValueError, match=match):
            fn()
    with dispatch.force_backend("kernel"), pytest.raises(ValueError, match="CUDA"):
        dispatch.stft(torch.from_numpy(_rand(rng, 1, 4000)), 512, 128)
    assert k4.launches == 0


def _stockham(src, tw, inverse=False):
    """csrc/fft.cuh in numpy f32: Stockham stages over the last axis of
    H points, one radix-2 stage first where log2(H) is odd, then radix 4,
    reading the stage twiddles e^{-2πim/H} (conjugated, and +i for the
    radix-4 constant -i, when inverse: the unscaled inverse)."""
    h = src.shape[-1]
    q = h // 4
    ns = 1
    if int(np.log2(h)) % 2:
        a, c = src[..., :h // 2], src[..., h // 2:]
        src = np.stack([a + c, a - c], axis=-1).reshape(src.shape)
        ns = 2
    j = np.arange(q)
    while ns < h:
        k = j % ns
        t = np.conj(tw) if inverse else tw
        v = [src[..., j + r * q] * (t[r * k * (h // (4 * ns))] if r else 1)
             for r in range(4)]
        a0, a1, a2, d = v[0] + v[2], v[0] - v[2], v[1] + v[3], v[1] - v[3]
        if inverse:
            a3 = (-d.imag + 1j * d.real).astype(np.complex64)   # +i·(v1 - v3)
        else:
            a3 = (d.imag - 1j * d.real).astype(np.complex64)    # -i·(v1 - v3)
        dst = np.empty_like(src)
        for r, out in enumerate((a0 + a2, a1 + a3, a0 - a2, a1 - a3)):
            dst[..., (j - k) * 4 + k + r * ns] = out
        src, ns = dst, ns * 4
    return src


def _fft_schedule(x, n_fft, hop, window):
    """The CUDA kernel's schedule in numpy f32: frames packed as
    z[m] = w[2m]·x[2m] + i·w[2m+1]·x[2m+1], Stockham stages (one radix-2
    stage first where log2(n_fft/2) is odd, then radix 4) reading the
    port's host-built tables, and the split into the n_fft/2 + 1 bins."""
    win, tw, tws = k1.fft_tables(n_fft, window)
    h = n_fft // 2
    f = 1 + (x.shape[-1] - n_fft) // hop
    frames = x[..., np.arange(f)[:, None] * hop + np.arange(n_fft)]
    src = (frames[..., 0::2] * win[0::2]
           + 1j * (frames[..., 1::2] * win[1::2])).astype(np.complex64)
    src = _stockham(src, tw)
    kk = np.arange(h + 1)
    a, c = src[..., kk % h], np.conj(src[..., (h - kk) % h])
    e, dd = np.float32(0.5) * (a + c), np.float32(0.5) * (a - c)
    wd = tws * dd
    return ((e.real + wd.imag) + 1j * (e.imag - wd.real)).astype(np.complex64)


def _ifft_schedule(spec, n_fft, hop, window, env=True):
    """The synthesis body of csrc/masked_istft.cu (K2, K3) in numpy f32, on
    a (B, F, K) complex spectrum with any masks applied: Im X[0] and
    Im X[H] set to 0; the inverse split scaled by 1/N,
      Z[k] = (X[k] + conj X[H-k])/N + i·e^{+2πik/N}·(X[k] - conj X[H-k])/N;
    the inverse Stockham stages, after which Z read as floats is the frame;
    then the block-tiled overlap-add with ROWS and tile of the wrapper
    (ops/masked_istft.py::synthesis_block): per block of output hop-rows,
    the frames that touch it a tile at a time, each chunk adding into the
    rows its frames touch, frames in increasing order; and the inverse
    envelope (env=True)."""
    win, tw, tws = k1.fft_tables(n_fft, window)
    h, r = n_fft // 2, n_fft // hop
    x = spec.astype(np.complex64)
    x[..., 0] = x[..., 0].real
    x[..., h] = x[..., h].real
    s = np.float32(1.0 / n_fft)
    k = np.arange(h)
    a, c = x[..., k], np.conj(x[..., h - k])
    e, d = (a + c) * s, (a - c) * s
    wd = np.conj(tws[k]) * d
    z = ((e.real - wd.imag) + 1j * (e.imag + wd.real)).astype(np.complex64)
    frames = np.ascontiguousarray(_stockham(z, tw, inverse=True)).view(np.float32)
    rows, tile = k2.synthesis_block(n_fft, hop, _assert)
    b, f = frames.shape[:2]
    nrows = f + r - 1
    out = np.zeros((b, nrows * hop), np.float32)
    i = np.arange(rows * hop)
    q, o = i // hop, i % hop
    for q0 in range(0, nrows, rows):
        fbase = q0 - r + 1
        acc = np.zeros((b, rows * hop), np.float32)
        lo, hi = max(0, -fbase), min(rows + r - 1, f - fbase)
        for c0 in range(lo, hi, tile):
            c1 = min(c0 + tile, hi)
            touched = (max(0, c0 - r + 1) <= q) & (q < c1)
            for l in range(c0, c1):
                sel = touched & (q <= l) & (l < q + r)
                n = (q[sel] + r - 1 - l) * hop + o[sel]
                acc[:, sel] += win[n] * frames[:, fbase + l, n]
        keep = q0 + q < nrows
        out[:, q0 * hop + i[keep]] = acc[:, keep]
    if env:
        out *= k2._inv_env(n_fft, hop, window, f, torch.device("cpu")).numpy()
    return out


def _assert(cond, msg):
    assert cond, msg


@pytest.mark.parametrize("n_fft,hop,t,window", [
    (256, 64, 4000, "hann"),
    (512, 128, 5000, "hann"),
    (512, 128, 5000, "hann@400"),
    (2048, 512, 10752, "hann"),
])
def test_fft_schedule_matches_rfft_and_stft_pallas(rng, interpret, n_fft, hop,
                                                   t, window):
    """The K1/K4 kernel body's FFT schedule on the CPU: within 1e-5·max|X|
    of a float64 rfft, and within the reference's tolerance (atol
    3e-4·max|X|, rtol 1e-3) of stft_pallas in interpret mode."""
    x = _rand(rng, 2, t)
    ours = _fft_schedule(x, n_fft, hop, window)
    f = 1 + (t - n_fft) // hop
    frames = x.astype(np.float64)[..., np.arange(f)[:, None] * hop + np.arange(n_fft)]
    exact = np.fft.rfft(frames * get_window(window, n_fft, np.float64), axis=-1)
    assert ours.shape == exact.shape == (2, f, n_fft // 2 + 1)
    np.testing.assert_allclose(ours, exact, rtol=0,
                               atol=1e-5 * np.abs(exact).max())
    ref = np.asarray(stft_pallas(jnp.asarray(x), n_fft, hop, window))
    np.testing.assert_allclose(ours, ref, atol=3e-4 * np.abs(ref).max(), rtol=1e-3)


def _near_silent(sr, t, seed=1):
    """A tone of amplitude 1 with -20 dB noise over the first 40 %, -120 dB
    noise alone to 80 %, digital silence after (chip_smoke.near_silent)."""
    r = np.random.default_rng(seed)
    n = np.arange(t)
    x = (np.sin(2 * np.pi * 440.3 * n / sr) + 0.1 * r.standard_normal(t)) * (n < 0.4 * t)
    x += 1e-6 * r.standard_normal(t) * (n >= 0.4 * t) * (n < 0.8 * t)
    return x.astype(np.float32)[None]


@pytest.mark.parametrize("n_fft,hop,sr", [(512, 128, 8000), (2048, 512, 44100)])
def test_fft_schedule_near_silent_frames(n_fft, hop, sr):
    """Frames of a loud tone, then frames of -120 dB noise alone, then
    digital silence, in one signal: the schedule's log|X| within 1e-3 of
    float64 on every bin, so its error follows each frame's own level.
    (A -120 dB floor under a full-scale tone in the same frame is below the
    f32 roundoff of any FFT, so no f32 version can be held to 1e-3 there.)"""
    x = _near_silent(sr, 2 * sr)
    ours = np.log(np.abs(_fft_schedule(x, n_fft, hop, "hann")) + 1e-8)
    f = 1 + (x.shape[-1] - n_fft) // hop
    frames = x.astype(np.float64)[..., np.arange(f)[:, None] * hop + np.arange(n_fft)]
    exact = np.fft.rfft(frames * get_window("hann", n_fft, np.float64), axis=-1)
    np.testing.assert_allclose(ours, np.log(np.abs(exact) + 1e-8), rtol=0, atol=1e-3)
    assert (np.abs(exact[:, -5:]) == 0).all()


SYNTH_GEOMETRIES = [(256, 64, "hann"), (512, 128, "hann"), (512, 128, "hann@400"),
                    (2048, 512, "hann")]


def _spectrum(rng, *shape):
    """complex64 noise, with non-zero imaginary parts at DC and Nyquist."""
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _irfft_ola(spec, n_fft, hop, window):
    """float64: irfft (imaginary parts at DC and Nyquist ignored), window,
    overlap-add, inverse envelope."""
    x = spec.astype(np.complex128)
    x[..., 0], x[..., -1] = x[..., 0].real, x[..., -1].real
    frames = np.fft.irfft(x, n=n_fft, axis=-1) * get_window(window, n_fft, np.float64)
    f = frames.shape[-2]
    y = np.zeros(frames.shape[:-2] + ((f - 1) * hop + n_fft,))
    for i in range(f):
        y[..., i * hop:i * hop + n_fft] += frames[..., i, :]
    return y * k2._inv_env(n_fft, hop, window, f, torch.device("cpu")).numpy()


@pytest.mark.parametrize("n_frames", [1, 3, k2.ROWS + 1, 2 * k2.ROWS + 5])
@pytest.mark.parametrize("n_fft,hop,window", SYNTH_GEOMETRIES)
def test_ifft_schedule_matches_irfft_ola(rng, n_fft, hop, window, n_frames):
    """The K2/K3 synthesis body on the CPU within 1e-5·max|y| of float64,
    at one frame, fewer frames than n_fft/hop, ROWS + 1 frames (a second,
    partial block) and several blocks."""
    spec = _spectrum(rng, 2, n_frames, n_fft // 2 + 1)
    ours = _ifft_schedule(spec, n_fft, hop, window)
    exact = _irfft_ola(spec, n_fft, hop, window)
    assert ours.shape == exact.shape == (2, (n_frames - 1) * hop + n_fft)
    np.testing.assert_allclose(ours, exact, rtol=0, atol=1e-5 * np.abs(exact).max())


def _hold_istft(ours, ref, hop, atol):
    """The reference's iSTFT tolerance: the interior (one hop off each
    edge) within atol + 1e-3·|ref|, the full length within 1e-3·max|ref|."""
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours[..., hop:-hop], ref[..., hop:-hop],
                               atol=atol, rtol=1e-3)
    assert np.abs(ours - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("n_fft,hop,window,n_frames", [
    (256, 64, "hann", k2.ROWS + 1),
    (512, 128, "hann", 40),
    (512, 128, "hann@400", 3),
    (2048, 512, "hann", 1),
])
def test_ifft_schedule_matches_istft_pallas(rng, interpret, n_fft, hop, window,
                                           n_frames):
    """K3's forward schedule against istft_pallas in interpret mode, at the
    reference's tolerance (interior atol 2e-4, rtol 1e-3)."""
    spec = _spectrum(rng, 2, n_frames, n_fft // 2 + 1)
    ref = np.asarray(istft_pallas(jnp.asarray(spec), n_fft, hop, window))
    _hold_istft(_ifft_schedule(spec, n_fft, hop, window), ref, hop, 2e-4)


@pytest.mark.parametrize("mask_type,n_fft,hop,n_frames", [
    ("magnitude", 512, 128, k2.ROWS + 1),
    ("magnitude", 256, 64, 1),
    ("complex", 512, 128, 3),
    ("complex", 2048, 512, k2.ROWS + 1),
])
def test_ifft_schedule_matches_masked_istft_pallas(rng, interpret, mask_type,
                                                  n_fft, hop, n_frames):
    """K2's schedule (masks applied to the spectrum as the kernel loads it)
    against masked_istft_pallas in interpret mode, at the reference's
    tolerance (interior atol 3e-4, rtol 1e-3); masks in [-1, 1] and a
    spectrum with non-zero Im at DC and Nyquist."""
    b, s, k = 2, 3, n_fft // 2 + 1
    spec = _spectrum(rng, b, n_frames, k)
    m_shape = (b, s, n_frames, k) + ((2,) if mask_type == "complex" else ())
    masks = rng.uniform(-1, 1, m_shape).astype(np.float32)
    ref = np.asarray(masked_istft_pallas(jnp.asarray(spec), jnp.asarray(masks),
                                         n_fft, hop, mask_type=mask_type))
    m = masks if mask_type == "magnitude" else masks[..., 0] + 1j * masks[..., 1]
    est = (m * spec[:, None]).astype(np.complex64).reshape(b * s, n_frames, k)
    ours = _ifft_schedule(est, n_fft, hop, "hann").reshape(b, s, -1)
    _hold_istft(ours, ref, hop, 3e-4)


def _adjoint_schedule(dy, n_fft, hop, window, n_frames):
    """K3's backward, the adjoint instantiation of the STFT body, in numpy
    f32: _fft_schedule of dy·inv_env, times a_k (1/N at DC and Nyquist, 2/N
    elsewhere), Im at DC and Nyquist 0, as two (B, F, K) planes."""
    inv = k2._inv_env(n_fft, hop, window, n_frames, torch.device("cpu")).numpy()
    spec = _fft_schedule(dy * inv, n_fft, hop, window)
    h = n_fft // 2
    a = np.full(h + 1, 2.0 / n_fft, np.float32)
    a[[0, h]] = 1.0 / n_fft
    dre, dim = spec.real * a, spec.imag * a
    dim[..., [0, h]] = 0.0
    return dre, dim


@pytest.mark.parametrize("n_fft,hop,window,n_frames", [
    (256, 64, "hann", 3),
    (512, 128, "hann", 40),
    (512, 128, "hann@400", k2.ROWS + 1),
    (2048, 512, "hann", 1),
])
def test_adjoint_schedule_matches_istft_pallas_vjp(rng, interpret, n_fft, hop,
                                                   window, n_frames):
    """The adjoint kernel's schedule against the VJP of the JAX package's
    _istft_ri (istft_pallas's custom VJP), atol 5e-4·max|g|, rtol 1e-3 as
    tests/test_pallas.py, and within 1e-5·max|g| of the float64 adjoint."""
    from gan_sass_tf_tpu.ops.pallas_istft import _istft_ri

    k = n_fft // 2 + 1
    re, im = _rand(rng, 2, n_frames, k), _rand(rng, 2, n_frames, k)
    dy = _rand(rng, 2, (n_frames - 1) * hop + n_fft)
    _, vjp = jax.vjp(lambda a, b: _istft_ri(a, b, n_fft, hop, window),
                     jnp.asarray(re), jnp.asarray(im))
    inv = k2._inv_env(n_fft, hop, window, n_frames, torch.device("cpu")).numpy()
    frames = (dy.astype(np.float64) * inv)[
        :, np.arange(n_frames)[:, None] * hop + np.arange(n_fft)]
    x = np.fft.rfft(frames * get_window(window, n_fft, np.float64), axis=-1)
    a = np.full(k, 2.0 / n_fft)
    a[[0, -1]] = 1.0 / n_fft
    exact = (x.real * a, x.imag * a * (np.arange(k) % (k - 1) != 0))
    for ours, want, ex in zip(_adjoint_schedule(dy, n_fft, hop, window, n_frames),
                              vjp(jnp.asarray(dy)), exact):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert ours.shape == want.shape == (2, n_frames, k)
        np.testing.assert_allclose(ours, want, atol=5e-4 * scale, rtol=1e-3)
        np.testing.assert_allclose(ours, ex, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("n_fft,hop", [(500, 125), (8192, 2048), (32, 8)])
def test_stft_kernels_reject_n_fft_before_the_library(monkeypatch, n_fft, hop):
    """Every wrapper of the FFT bodies (K1, K4, K2, and K3's autograd
    wrapper and forward launch) refuses an n_fft that is not a power of two
    in [64, 4096] before it loads (or builds) the library."""
    from gan_sass_tf_tpu_torch.ops import build

    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(build, "load_library", no_library)
    x = torch.zeros(1, 3 * n_fft)
    k = n_fft // 2 + 1
    spec = torch.zeros(1, 2, k, dtype=torch.complex64)
    masks = torch.zeros(1, 1, 2, k)
    re = torch.zeros(1, 2, k)
    for fn in (lambda: k1.stft_features_kernel(x, n_fft, hop),
               lambda: k4.stft_kernel(x, n_fft, hop),
               lambda: k2.masked_istft_kernel(spec, masks, n_fft, hop),
               lambda: k3.istft_kernel(re, re, n_fft, hop),
               lambda: k3._launch_forward(re, re, n_fft, hop, "hann")):
        with pytest.raises(ValueError, match="power of two"):
            fn()
    assert (k1.launches, k4.launches, k2.launches, k3.launches) == (0, 0, 0, 0)
