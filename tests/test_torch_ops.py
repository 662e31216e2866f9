"""The port's DSP kernels' plain versions (gan_sass_tf_tpu_torch.ops)
against the JAX package's Pallas kernels, run in TPU interpret mode as
tests/test_pallas.py runs them, plus the dispatch guards.  The CUDA kernels
themselves are compared with these plain versions on the card by
chip_smoke.py (this process has no GPU)."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

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
        (lambda: k3._launch_forward(torch.zeros(0, 10, 257, 2), 512, 128,
                                    "hann"), "batch"),
        (lambda: k3.istft_ri_kernel(re, 512, 128), r"\(\.\.\., F, K, 2\)"),
        (lambda: k3.istft_ri_kernel(torch.zeros(1, 10, 129, 2), 512, 128), "bins"),
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
                                                   "stft_features.cu",
                                                   "threefry.cu"]
    assert [p.name for p in build._headers()] == ["fft.cuh"]
    assert {"istft_launch", "istft_adjoint_launch", "masked_istft_launch",
            "stft_launch", "stft_features_launch", "synthesis_prepare",
            "threefry_batch_launch", "threefry_sample_launch",
            "threefry_dropout_launch", "dropout_mask_launch",
            "threefry_noise_launch"} == set(build._SIGNATURES)
    assert build.library_path().parent == build.build_dir()


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
    dspec = k3.istft_adjoint(dy, n_fft, hop, "hann", re.shape[-2])
    assert dspec.shape == re.shape + (2,)
    dre, dim = dspec[..., 0], dspec[..., 1]
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


def _neg_i(a):
    """-i·a, exact (a swap and a sign), as the kernel's mul_neg_i."""
    return (a.imag - 1j * a.real).astype(np.complex64)


def _dft4(a, b, c, d):
    a0, a1, a2, a3 = a + c, a - c, b + d, _neg_i(b - d)
    return [a0 + a2, a1 + a3, a0 - a2, a1 - a3]


def _dft_r(u, roots):
    """The kernel's in-register R-point DFT (R = 2, 4, 8, 16) of the list u:
    R = 8 and 16 as a DFT over n1 (n = 4·n1 + n2), the twiddles
    e^{-2πi·n2·r1/R} (roots[e] = e^{-2πie/16} from the stage table; e = 4
    is -i, exact), then 4-point DFTs over n2."""
    if len(u) == 2:
        return [u[0] + u[1], u[0] - u[1]]
    if len(u) == 4:
        return _dft4(*u)
    if len(u) == 8:
        a = [None] * 8
        for n2 in range(4):
            a[n2], a[4 + n2] = u[n2] + u[4 + n2], u[n2] - u[4 + n2]
        a[5], a[6], a[7] = a[5] * roots[2], _neg_i(a[6]), a[7] * roots[6]
        y = [None] * 8
        for r1 in range(2):
            y[r1::2] = _dft4(*a[4 * r1:4 * r1 + 4])
        return y
    a = []
    for n2 in range(4):
        a += _dft4(u[n2], u[4 + n2], u[8 + n2], u[12 + n2])   # a[4·n2 + r1]
    for i, e in ((5, 1), (6, 2), (7, 3), (9, 2), (11, 6), (13, 3), (14, 6), (15, 9)):
        a[i] = a[i] * roots[e]
    a[10] = _neg_i(a[10])
    y = [None] * 16
    for r1 in range(4):
        y[r1::4] = _dft4(a[r1], a[4 + r1], a[8 + r1], a[12 + r1])
    return y


def _fft_passes(src, n_fft):
    """The register-resident forward passes of csrc/fft.cuh in numpy f32
    over the last axis of H = n_fft/2 points: the Stockham passes of
    ops/stft_features.py::fft_passes (radix 16, then one radix 2, 4 or 8),
    each butterfly an in-register DFT (_dft_r) after the twiddles of the
    pass table (pass_twiddles).  The kernels' thread layout (16 points a
    thread, TF = n_fft/32 threads a frame) moves no arithmetic."""
    tw = k1.fft_tables(n_fft, "hann")[1]
    ptw = k1.pass_twiddles(n_fft, tw)
    h = n_fft // 2
    roots = {e: tw[e * h // 16] for e in (1, 2, 3, 6, 9)}
    off = 0
    for r, ns in k1.fft_passes(n_fft):
        q = h // r
        j = np.arange(q)
        k = j % ns
        u = [src[..., j + i * q] for i in range(r)]
        if ns > 1:
            u = [u[0]] + [u[i] * ptw[off + (i - 1) * ns + k] for i in range(1, r)]
            off += (r - 1) * ns
        dst = np.empty_like(src)
        for i, y in enumerate(_dft_r(u, roots)):
            dst[..., (j - k) * r + k + i * ns] = y
        src = dst
    assert off == ptw.size
    return src


def _cplx(re, im):
    """complex64 from two f32 arrays, with no rounding."""
    out = np.empty(np.broadcast(re, im).shape, np.complex64)
    out.real, out.imag = re, im
    return out


def _fft_schedule(x, n_fft, hop, window):
    """The K1/K4 kernel body of csrc/stft_features.cu in numpy f32: frames
    packed as z[m] = w[2m]·x[2m] + i·w[2m+1]·x[2m+1]; the passes
    (_fft_passes); then the split into the n_fft/2 + 1 bins with the split
    twiddles."""
    win, tw, tws = k1.fft_tables(n_fft, window)
    h = n_fft // 2
    f = 1 + (x.shape[-1] - n_fft) // hop
    frames = x[..., np.arange(f)[:, None] * hop + np.arange(n_fft)]
    src = _fft_passes(_cplx(frames[..., 0::2] * win[0::2],
                            frames[..., 1::2] * win[1::2]), n_fft)
    kk = np.arange(h + 1)
    a, c = src[..., kk % h], np.conj(src[..., (h - kk) % h])
    e, dd = np.float32(0.5) * (a + c), np.float32(0.5) * (a - c)
    wd = tws * dd
    return ((e.real + wd.imag) + 1j * (e.imag - wd.real)).astype(np.complex64)


def _ifft_frames(spec, n_fft, window):
    """The synthesis body's per-frame work (csrc/masked_istft.cu) in numpy
    f32, on a (..., F, K) complex spectrum with any masks applied: Im X[0]
    and Im X[H] set to 0; the inverse split scaled by 1/N,
      Z[k] = (X[k] + conj X[H-k])/N + i·e^{+2πik/N}·(X[k] - conj X[H-k])/N;
    the forward passes of conj Z, conjugated (the inverse FFT), read as
    floats; the window product.  -> (..., F, n_fft) windowed frames."""
    win, _, tws = k1.fft_tables(n_fft, window)
    h = n_fft // 2
    x = spec.astype(np.complex64)
    x[..., 0] = x[..., 0].real
    x[..., h] = x[..., h].real
    s = np.float32(1.0 / n_fft)
    k = np.arange(h)
    a, c, t = x[..., k], x[..., h - k], tws[k]
    e = _cplx(s * (a.real + c.real), s * (a.imag - c.imag))
    d = _cplx(s * (a.real - c.real), s * (a.imag + c.imag))
    wd = _cplx(t.real * d.real + t.imag * d.imag, t.real * d.imag - t.imag * d.real)
    z = _fft_passes(_cplx(e.real - wd.imag, -(e.imag + wd.real)), n_fft)
    out = np.empty(z.shape[:-1] + (n_fft,), np.float32)
    out[..., 0::2] = win[0::2] * z.real
    out[..., 1::2] = -(win[1::2] * z.imag)
    return out


def _ring_rows(tile, r):
    """Rows of the kernel's ring accumulator: a power of two >= tile + r - 1."""
    return 1 << (tile + r - 2).bit_length()


def _overlap_add_schedule(frames, hop, seg, tile):
    """The synthesis body's overlap-add in numpy f32, on (B, F, n_fft)
    windowed frames: work items of `seg` output hop-rows [q0, q1), each
    taking frames q0 - r + 1 .. q1 - 1 in increasing order, `tile` at a
    time; a row starts from 0 at its first frame, adds its frames in
    increasing order, waits in the ring between tiles and is written when
    its last frame is added (each row once).  -> (B, (F + r - 1)·hop)."""
    b, f, n = frames.shape
    r = n // hop
    nrows = f + r - 1
    out = np.full((b, nrows, hop), np.nan, np.float32)
    for q0 in range(0, nrows, seg):
        q1 = min(q0 + seg, nrows)
        ring = {}
        for f0 in range(max(0, q0 - r + 1), min(f, q1), tile):
            f1 = min(f0 + tile, f, q1)
            qa, qb = max(f0, q0), min(f1 + r - 1, q1)
            assert qb - qa <= _ring_rows(tile, r)      # distinct ring slots
            for q in range(qa, qb):
                acc = (np.zeros((b, hop), np.float32) if max(0, q - r + 1) >= f0
                       else ring.pop(q))
                for l in range(max(f0, q - r + 1), min(f1, q + 1)):
                    acc = acc + frames[:, l, (q - l) * hop:(q - l + 1) * hop]
                if min(f - 1, q) < f1:
                    assert np.isnan(out[:, q]).all()
                    out[:, q] = acc
                else:
                    ring[q] = acc
            assert len(ring) <= r - 1
        assert not ring
    assert not np.isnan(out).any()
    return out.reshape(b, -1)


# The wrapper's block shape on an H100: 132 SMs, BLOCKS_PER_SM blocks each.
H100_SMS = 132


def _synthesis_tile(n_fft, s, threads):
    """(sources a work item takes, frames a tile) as csrc/masked_istft.cu's
    synthesis_prepare picks them where shared memory holds a round: one
    round of threads/(n_fft/32) frame slots shared by min(S, slots)
    sources."""
    slots = threads // (n_fft // 32)
    sources = min(s, slots)
    return sources, max(1, slots // sources)


def _synthesis_params(n_fft, hop, b, s, f, threads=256):
    """(tile, seg) the wrapper picks for b mixtures of s sources and f
    frames on an H100 at a block of `threads` (where shared memory holds a
    round's frames)."""
    sources, tile = _synthesis_tile(n_fft, s, threads)
    r = n_fft // hop
    groups = -(-s // sources)
    seg = k2.synthesis_segment(b * groups, f + r - 1, r, tile,
                               H100_SMS * k2.BLOCKS_PER_SM)
    return tile, seg


def _ifft_schedule(spec, n_fft, hop, window, env=True, sources=1, seg=None,
                   tile=None):
    """The synthesis body of csrc/masked_istft.cu (K2, K3) in numpy f32 on a
    (B, F, K) complex spectrum with any masks applied (B signals of
    `sources` each for K2): _ifft_frames, then the segment-and-ring
    overlap-add (_overlap_add_schedule) with the wrapper's tile and segment
    unless given, and the inverse envelope (env=True)."""
    frames = _ifft_frames(spec, n_fft, window)
    b, f = frames.shape[:2]
    dtile, dseg = _synthesis_params(n_fft, hop, b // sources, sources, f)
    out = _overlap_add_schedule(frames, hop, seg or dseg, tile or dtile)
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
    # every other power of two the kernel takes: its own split into passes
    (64, 16, 1001, "hann"),
    (128, 32, 1500, "hann"),
    (1024, 256, 5376, "hann"),
    (4096, 1024, 8192, "hann"),
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


@pytest.mark.parametrize("n_fft,hop,sr", [(64, 16, 8000), (128, 32, 8000),
                                          (256, 64, 8000), (1024, 256, 16000),
                                          (4096, 1024, 44100)])
def test_fft_schedule_near_silent_frames_every_n_fft(n_fft, hop, sr):
    """The near-silent signal at the kernel's other powers of two: log|X|
    within 1e-3 of float64 at every bin whose |X| reaches 1e-3 of its own
    frame's RMS |X| (chip_smoke's LOGMAG_FLOOR), in every frame, the
    -120 dB frames and digital silence among them.  Below that floor in a
    loud frame the f32 windowed input alone moves log|X| by more: at
    n_fft 64 one DC bin at 6e-6 of its frame's peak is off by 3.7e-3 here
    and in torch.fft.rfft in f32 alike."""
    x = _near_silent(sr, 2 * sr)
    f = 1 + (x.shape[-1] - n_fft) // hop
    frames = x.astype(np.float64)[..., np.arange(f)[:, None] * hop + np.arange(n_fft)]
    exact = np.abs(np.fft.rfft(frames * get_window("hann", n_fft, np.float64), axis=-1))
    keep = exact >= 1e-3 * np.sqrt((exact ** 2).mean(-1, keepdims=True))
    assert keep.all(-1).sum() > f // 2 and (exact[:, -5:] == 0).all()
    ours = np.log(np.abs(_fft_schedule(x, n_fft, hop, "hann")) + 1e-8)
    np.testing.assert_allclose(ours[keep], np.log(exact + 1e-8)[keep], rtol=0, atol=1e-3)


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


@pytest.mark.parametrize("n_frames", [1, 3, 9, 21])
@pytest.mark.parametrize("n_fft,hop,window", SYNTH_GEOMETRIES)
def test_ifft_schedule_matches_irfft_ola(rng, n_fft, hop, window, n_frames):
    """The K2/K3 synthesis body on the CPU within 1e-5·max|y| of float64,
    at one frame, fewer frames than n_fft/hop, and frames over one and over
    several tiles and segments."""
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
    (256, 64, "hann", 9),
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
    ("magnitude", 512, 128, 9),
    ("magnitude", 256, 64, 1),
    ("complex", 512, 128, 3),
    ("complex", 2048, 512, 9),
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
    ours = _ifft_schedule(est, n_fft, hop, "hann", sources=s).reshape(b, s, -1)
    _hold_istft(ours, ref, hop, 3e-4)


@pytest.mark.parametrize("n_fft,hop,n_frames,sources", [
    (512, 128, 40, 2),     # a K2 call: one mixture's two sources
    (512, 128, 2, 1),      # F < n_fft/hop
    (2048, 512, 1, 2),     # one frame
    (256, 64, 13, 3),
    (64, 16, 29, 1),       # the most frame slots a round (128)
    (1024, 128, 11, 1),    # r = 8
])
def test_ifft_schedule_bits_do_not_depend_on_segment_or_tile(rng, n_fft, hop,
                                                              n_frames, sources):
    """The synthesis body gives the same output bit for bit for every
    segment length and tile size: segments of one row, of fewer rows than
    n_fft/hop frames, of the wrapper's picks at 1 to 512 mixtures and of
    the whole signal; tiles of one frame up to a whole round of the block's
    slots.  Each sample adds its frames in increasing order from 0."""
    spec = _spectrum(rng, 2 * sources, n_frames, n_fft // 2 + 1)
    frames = _ifft_frames(spec, n_fft, "hann")
    r = n_fft // hop
    nrows = n_frames + r - 1
    rounds = {_synthesis_tile(n_fft, sources, n)[1] for n in k2.THREAD_CHOICES}
    round_tile = min(rounds)
    picks = {_synthesis_params(n_fft, hop, b, sources, n_frames, n)[1]
             for b in (1, 8, 64, 512) for n in k2.THREAD_CHOICES}
    segs = sorted({1, max(1, r - 2), r, nrows, *picks})
    tiles = sorted({1, 2, 3, max(1, round_tile // 2), *rounds})
    base = _overlap_add_schedule(frames, hop, nrows, round_tile)
    for seg in segs:
        for tile in tiles:
            got = _overlap_add_schedule(frames, hop, seg, tile)
            np.testing.assert_array_equal(got.view(np.uint32), base.view(np.uint32),
                                          err_msg=f"segment {seg}, tile {tile}")
    exact = _irfft_ola(spec, n_fft, hop, "hann")
    ours = base * k2._inv_env(n_fft, hop, "hann", n_frames, torch.device("cpu")).numpy()
    np.testing.assert_allclose(ours, exact, rtol=0, atol=1e-5 * np.abs(exact).max())


@pytest.mark.parametrize("signals,nrows,r,tile", [
    (64, 250, 4, 16),      # K3 at the stream_v5e8 step
    (16, 187, 4, 8),       # K2 at separate(): 16 mixtures, 2 sources a tile
    (8, 258, 4, 2),        # K2 at the music bound: n_fft 2048
    (1, 125, 4, 8),        # one streaming chunk
    (512, 30, 4, 16),      # more signals than blocks
    (3, 2, 8, 5),
])
def test_synthesis_segment_fills_the_blocks_once(signals, nrows, r, tile):
    """The wrapper's segment: at most one work item a resident block where
    the signals allow it (one a signal otherwise), each segment's frames a
    whole number of tiles unless it is the whole signal, and long segments
    (halo frames at most a tenth) wherever the signals fill the blocks
    four times or less."""
    blocks = H100_SMS * k2.BLOCKS_PER_SM
    seg = k2.synthesis_segment(signals, nrows, r, tile, blocks)
    assert 1 <= seg <= nrows
    items = signals * -(-nrows // seg)
    assert items <= max(blocks, signals)
    assert seg == nrows or (seg + r - 1) % tile == 0
    if signals * 4 >= blocks and seg < nrows:
        assert (r - 1) / seg <= 0.1


@pytest.mark.parametrize("b,s,f,n_fft,hop,fit,threads", [
    (64, 1, 247, 512, 128, {256: 2, 512: 1}, 512),    # K3 at the stream_v5e8 step
    (1, 2, 122, 512, 128, {256: 2, 512: 1}, 256),     # K2, one streaming chunk
    (16, 2, 184, 512, 128, {256: 2, 512: 1}, 512),    # K2 at separate(): a tie
    (8, 2, 255, 2048, 512, {256: 1, 512: 1}, 256),    # K2 at the music bound
])
def test_synthesis_threads_loads_the_sms_evenly(b, s, f, n_fft, hop, fit, threads):
    """The wrapper's block size: of 256 and 512 threads, the one whose work
    items load the busiest of an H100's SMs with the fewest frame slots
    (`fit`: blocks an SM at each size, as the card's occupancy gives them
    for these plans; at n_fft 2048 a 512-thread round keeps 4 of its 8
    slots, shared memory halving its tile), ties to the larger."""
    loads = {}
    for n in (256, 512):
        sources, tile = _synthesis_tile(n_fft, s, n)
        slots = n // (n_fft // 32)
        if n_fft == 2048 and n == 512:
            tile //= 2
        r, nrows = n_fft // hop, f + n_fft // hop - 1
        signals = b * -(-s // sources)
        blocks = H100_SMS * min(fit[n], k2.BLOCKS_PER_SM)
        seg = k2.synthesis_segment(signals, nrows, r, tile, blocks)
        grid = min(signals * -(-nrows // seg), blocks)
        loads[n] = k2.synthesis_load(signals, nrows, r, tile, slots, seg, grid, H100_SMS)
        assert loads[n] >= -(-signals * (f + r - 1) * slots // (tile * H100_SMS))
    assert k2.synthesis_threads(loads) == threads


@pytest.mark.parametrize("n_fft,hop,t", [(256, 64, 2048), (512, 128, 5000)])
def test_dispatch_istft_interleaved_route_matches_pallas(rng, interpret, n_fft,
                                                         hop, t):
    """K3's route on the interleaved spectrum: ops.dispatch.istft under
    force_backend("kernel") (the wrapper's CPU path: the same forward and
    the adjoint's interleaved gradient) against istft_pallas and jax.grad
    through its custom VJP (atol 5e-4·max|g|, rtol 1e-3); autograd reaches
    the complex spectrum through view_as_real alone, with no split into
    planes and no merge of two."""
    re, im = _planes(rng, 2, t, n_fft, hop)
    f = re.shape[-2]
    tgt = _rand(rng, 2, (f - 1) * hop + n_fft - 37)

    def jloss(a, b):
        y = istft_pallas(jax.lax.complex(a, b), n_fft, hop, length=tgt.shape[-1])
        return jnp.mean((y - tgt) ** 2)

    ref_y = np.asarray(istft_pallas(jax.lax.complex(jnp.asarray(re), jnp.asarray(im)),
                                    n_fft, hop))
    ref_g = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
    spec = torch.complex(torch.from_numpy(re), torch.from_numpy(im)).requires_grad_()
    with dispatch.force_backend("kernel"):
        y = dispatch.istft(spec, n_fft, hop)
    names, todo = set(), [y.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None:
            names.add(type(fn).__name__)
            todo.extend(nxt for nxt, _ in fn.next_functions)
    assert {"_IstftRIBackward", "ViewAsRealBackward0"} <= names
    assert not names & {"RealBackward0", "ImagBackward0", "ComplexBackward0",
                        "StackBackward0", "CloneBackward0"}
    _hold_istft(y.detach().numpy(), ref_y, hop, 2e-4)
    ((y[..., :tgt.shape[-1]] - torch.from_numpy(tgt)) ** 2).mean().backward()
    for ours, want in zip((spec.grad.real, spec.grad.imag), ref_g):
        want = np.asarray(want)
        np.testing.assert_allclose(ours.numpy(), want,
                                   atol=5e-4 * np.abs(want).max(), rtol=1e-3)
    assert (k3.launches, k3.bwd_launches) == (0, 0)


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
    (512, 128, "hann@400", 9),
    (2048, 512, "hann", 1),
    (64, 16, "hann", 5),
    (128, 32, "hann", 4),
    (1024, 256, "hann", 3),
    (4096, 1024, "hann", 2),
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


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048, 4096])
def test_fft_passes_and_pass_twiddles(n_fft):
    """The analysis body's passes (radix 16 while 16 divides what is left,
    then one radix 2, 4 or 8) multiply to H = n_fft/2, and the pass table
    holds, for each pass after the first, the stage table's own f32
    entries e^{-2πi·r·k/(R·ns)} in the [pass][r - 1][k] order the kernel
    reads, as many as csrc/stft_features.cu's pass_twiddle_count."""
    h = n_fft // 2
    log2h = h.bit_length() - 1
    passes = k1.fft_passes(n_fft)
    assert [r for r, _ in passes] == [16] * (log2h // 4) + (
        [1 << (log2h % 4)] if log2h % 4 else [])
    assert int(np.prod([r for r, _ in passes])) == h
    assert [ns for _, ns in passes] == [int(np.prod([r for r, _ in passes[:i]]))
                                        for i in range(len(passes))]
    stage = k1.fft_tables(n_fft, "hann")[1]
    ptw = k1.pass_twiddles(n_fft, stage)
    count = (240 if log2h // 4 >= 2 else 0) + (
        ((1 << (log2h % 4)) - 1) << (4 * (log2h // 4)) if log2h % 4 else 0)
    assert ptw.dtype == np.complex64 and ptw.size == count
    off = 0
    for r, ns in passes[1:]:
        block = ptw[off:off + (r - 1) * ns].reshape(r - 1, ns)
        rk = np.outer(np.arange(1, r), np.arange(ns))
        np.testing.assert_array_equal(block, stage[rk * (h // (r * ns))])
        np.testing.assert_allclose(block, np.exp(-2j * np.pi * rk / (r * ns)),
                                   rtol=0, atol=1e-7)
        off += (r - 1) * ns


def _sequential_mel(mag, mel, lo=None, hi=None):
    """(F, M) f32 sums over k of mag[f, k]·mel[k, m], one term at a time in
    order of k; each band over [lo[m], hi[m]] only when given."""
    k_all, m_all = mel.shape
    out = np.zeros((mag.shape[0], m_all), np.float32)
    for m in range(m_all):
        ks = range(k_all) if lo is None else range(int(lo[m]), int(hi[m]) + 1)
        acc = np.zeros(mag.shape[0], np.float32)
        for k in ks:
            acc = (acc + mag[:, k] * mel[k, m]).astype(np.float32)
        out[:, m] = acc
    return out


@pytest.mark.parametrize("preset", config.list_configs())
def test_banded_logmel_equals_dense_bit_for_bit(rng, preset):
    """The log-mel epilogue's band rule: a sequential f32 sum over each
    band's first to last non-zero bin (ops.stft_features.mel_bands) equals
    the sequential sum over all K bins bit for bit, since every skipped
    term is an exact zero; a band of zeros gives log(eps)."""
    d = config.get_config(preset).dsp
    mel = mel_filterbank(d.n_mels, d.n_bins, d.sample_rate).copy()
    mel[:, d.n_mels // 2] = 0.0
    mag = np.abs(_rand(rng, 12, d.n_bins) * np.logspace(-6, 2, 12)[:, None]
                 ).astype(np.float32)
    table = k1.mel_bands(torch.from_numpy(mel)).numpy()
    m = d.n_mels
    lo, hi, off = table[:m], table[m:2 * m], table[2 * m:]
    nz = mel != 0
    assert (lo[d.n_mels // 2], hi[d.n_mels // 2]) == (d.n_bins, -1)
    for b in range(m):
        if nz[:, b].any():
            rows = np.flatnonzero(nz[:, b])
            assert (lo[b], hi[b]) == (rows[0], rows[-1])
    np.testing.assert_array_equal(np.diff(off), np.maximum(hi - lo + 1, 0))
    banded = _sequential_mel(mag, mel, lo, hi)
    dense = _sequential_mel(mag, mel)
    np.testing.assert_array_equal(banded.view(np.uint32), dense.view(np.uint32))
    eps = np.float32(d.eps)
    logmel = np.log(banded + eps)
    assert (logmel[:, d.n_mels // 2] == np.log(eps)).all()
    ref = k1.stft_features_reference(torch.zeros(1, d.n_fft), d.n_fft, d.hop_length,
                                     emit=("logmel",), mel_matrix=torch.from_numpy(mel),
                                     eps=d.eps)["logmel"]
    assert float(ref[0, 0, d.n_mels // 2]) == float(np.log(eps))


def test_mel_bands_is_kept_per_matrix_and_rebuilt_on_change():
    """mel_bands builds its table once for a matrix, keeps it while the
    matrix is unchanged (an inference tensor, which has no version counter,
    counts as unchanged), and rebuilds it after an in-place change."""
    mel = torch.from_numpy(mel_filterbank(16, 129, 8000))
    first = k1.mel_bands(mel)
    assert first.dtype == torch.int32 and first.shape == (3 * 16 + 1,)
    assert k1.mel_bands(mel) is first
    mel[:, 3] = 0.0
    again = k1.mel_bands(mel)
    assert again is not first
    assert (int(again[3]), int(again[16 + 3])) == (129, -1)
    with torch.inference_mode():
        frozen = torch.from_numpy(mel_filterbank(16, 129, 8000)).clone()
        assert k1.mel_bands(frozen) is k1.mel_bands(frozen)
    torch.testing.assert_close(k1.mel_bands(frozen), first)


def test_time_analysis_imports_and_needs_cuda(capsys):
    """scripts/time_analysis.py imports here and refuses to run without a
    CUDA device (this process sees none), as time_synthesis does; each of
    its ablations edits text that the kernel source holds once."""
    from gan_sass_tf_tpu_torch.scripts import time_analysis

    assert not torch.cuda.is_available()
    assert time_analysis.main([]) == 1
    assert time_analysis.main(["--sweep"]) == 1
    assert time_analysis.main(["--ablate"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    from gan_sass_tf_tpu_torch.ops import build

    src = (build.CSRC / "stft_features.cu").read_text()
    for what, edits in time_analysis.ABLATIONS.items():   # still the source's text
        assert all(src.count(old) == 1 for old, _ in edits), what
    names = [name for name, *_ in time_analysis.SHAPES]
    assert len(set(names)) == len(names)
    assert {"stft_features wsj0_logmel step mixtures",
            "stft_features wsj0_logmel step targets"} <= set(names)


def test_time_synthesis_imports_and_needs_cuda(capsys):
    """scripts/time_synthesis.py imports here and refuses to run without a
    CUDA device in each of its modes; each of its ablations edits text that
    the synthesis source holds once, and its shapes are the K2 rows of the
    main path."""
    from gan_sass_tf_tpu_torch.ops import build
    from gan_sass_tf_tpu_torch.scripts import time_synthesis

    assert not torch.cuda.is_available()
    for argv in ([], ["--sweep"], ["--ablate"]):
        assert time_synthesis.main(argv) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    src = (build.CSRC / "masked_istft.cu").read_text()
    for what, edits in time_synthesis.ABLATIONS.items():
        assert all(src.count(old) == 1 for old, _ in edits), what
    names = [name for name, *_ in time_synthesis.K2_SHAPES]
    assert len(set(names)) == len(names) == 5
    assert {m for *_, m in time_synthesis.K2_SHAPES} == {"magnitude", "complex"}


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
               lambda: k3.istft_ri_kernel(torch.view_as_real(spec), n_fft, hop),
               lambda: k3._launch_forward(torch.view_as_real(spec), n_fft, hop,
                                          "hann")):
        with pytest.raises(ValueError, match="power of two"):
            fn()
    assert (k1.launches, k4.launches, k2.launches, k3.launches) == (0, 0, 0, 0)
