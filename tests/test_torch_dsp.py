"""PyTorch port's DSP path (gan_sass_tf_tpu_torch.dsp) against the JAX
package's on the same seeded inputs, at the JAX package's own tolerances
(tests/test_pallas.py, tests/test_dsp.py)."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import dsp as jdsp
from gan_sass_tf_tpu.dsp import features as jfeat
from gan_sass_tf_tpu.dsp import windows as jwin
from gan_sass_tf_tpu_torch import dsp as tdsp


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("get_window", ("hann", 512)),
    ("get_window", ("hann@400", 512)),
    ("get_window", ("hamming", 256)),
    ("get_window", ("rect", 64)),
    ("encode_win_length", ("hann", 512, 400)),
    ("cola_norm", (jwin.get_window("hann", 512), 128, 37)),
    ("safe_inv_env", (jwin.cola_norm(jwin.get_window("hann", 256), 64, 20),)),
    ("mel_filterbank", (80, 257, 8000)),
    ("mel_filterbank", (16, 129, 16000)),
    ("mel_interp_matrix", (80, 257, 8000)),
    ("mel_interp_matrix", (32, 1025, 44100)),
])
def test_numpy_builders_bit_equal(name, args):
    ref_mod = jfeat if name.startswith("mel") else jwin
    ours, ref = getattr(tdsp, name)(*args), getattr(ref_mod, name)(*args)
    if isinstance(ref, tuple):
        assert ours == ref
    else:
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


@pytest.mark.parametrize("n_fft,hop,t,win_length", [
    (256, 64, 4000, None),
    (512, 128, 5000, None),
    (2048, 512, 6144, None),
    (512, 128, 5000, 400),
])
def test_stft_matches_jax(rng, n_fft, hop, t, win_length):
    x = _rand(rng, 2, t)
    ours = tdsp.stft(torch.from_numpy(x), n_fft, hop, win_length=win_length).numpy()
    ref = np.asarray(jdsp.stft(jnp.asarray(x), n_fft, hop, win_length=win_length))
    assert ours.shape == ref.shape and ours.dtype == np.complex64
    np.testing.assert_allclose(ours, ref, atol=3e-4 * np.abs(ref).max())


@pytest.mark.parametrize("norm", ["global", "tf"])
@pytest.mark.parametrize("n_fft,hop,t", [(256, 64, 4000), (512, 128, 5000)])
def test_istft_matches_jax(rng, norm, n_fft, hop, t):
    x = _rand(rng, 2, t)
    spec = np.array(jdsp.stft(jnp.asarray(x), n_fft, hop))
    ours = tdsp.istft(torch.from_numpy(spec), n_fft, hop, norm=norm).numpy()
    ref = np.asarray(jdsp.istft(jnp.asarray(spec), n_fft, hop, norm=norm))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours[:, hop:-hop], ref[:, hop:-hop],
                               atol=2e-4, rtol=1e-3)
    # Edges included: the clamped envelope keeps them bounded.
    np.testing.assert_allclose(ours, ref, atol=1e-3 * np.abs(ref).max())


def test_istft_win_length_and_length(rng):
    x = _rand(rng, 1, 5000)
    spec = np.array(jdsp.stft(jnp.asarray(x), 512, 128, win_length=400))
    ours = tdsp.istft(torch.from_numpy(spec), 512, 128, win_length=400).numpy()
    ref = np.asarray(jdsp.istft(jnp.asarray(spec), 512, 128, win_length=400))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-3 * np.abs(ref).max())
    cut = tdsp.istft(torch.from_numpy(spec), 512, 128, length=3000).numpy()
    assert cut.shape == (1, 3000)


@pytest.mark.parametrize("n_fft", [256, 2048])
def test_irfft_drops_imaginary_dc_and_nyquist(rng, n_fft):
    """The plain path's irfft is irfft as JAX and numpy define it, whatever
    the device's FFT does with Im X[0] and Im X[n_fft/2] (cuFFT reads them
    at some batch shapes): equal to JAX's, and no gradient reaches them."""
    from gan_sass_tf_tpu_torch.dsp.stft import irfft

    k = n_fft // 2 + 1
    spec = (rng.standard_normal((3, k)) + 1j * rng.standard_normal((3, k))
            ).astype(np.complex64)
    ref = np.asarray(jnp.fft.irfft(jnp.asarray(spec), n=n_fft))
    t = torch.from_numpy(spec).requires_grad_()
    y = irfft(t, n_fft)
    np.testing.assert_allclose(y.detach().numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    y.square().sum().backward()
    assert (t.grad.imag[:, [0, -1]] == 0).all()


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (512, 128), (400, 160)])
def test_frame_signal_and_overlap_add_match_jax(rng, n_fft, hop):
    x = _rand(rng, 2, 3, 4000)
    ours = tdsp.frame_signal(torch.from_numpy(x), n_fft, hop).numpy()
    ref = np.asarray(jdsp.frame_signal(jnp.asarray(x), n_fft, hop))
    np.testing.assert_array_equal(ours, ref)
    frames = _rand(rng, 2, 11, n_fft)
    ours = tdsp.overlap_add(torch.from_numpy(frames), hop).numpy()
    ref = np.asarray(jdsp.overlap_add(jnp.asarray(frames), hop))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


def test_num_frames_and_short_signal():
    assert tdsp.num_frames(5000, 512, 128) == jdsp.num_frames(5000, 512, 128)
    with pytest.raises(ValueError, match="shorter"):
        tdsp.stft(torch.zeros(1, 100), 256, 64)


@pytest.mark.parametrize("mask_type", ["magnitude", "complex"])
def test_apply_mask_matches_jax(rng, mask_type):
    spec = (_rand(rng, 2, 9, 129) + 1j * _rand(rng, 2, 9, 129)).astype(np.complex64)
    m_shape = (2, 3, 9, 129) + ((2,) if mask_type == "complex" else ())
    masks = rng.uniform(-1, 1, m_shape).astype(np.float32)
    ours = tdsp.apply_mask(torch.from_numpy(spec), torch.from_numpy(masks),
                           mask_type).numpy()
    ref = np.asarray(jdsp.apply_mask(jnp.asarray(spec), jnp.asarray(masks),
                                     mask_type))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    assert tdsp.mask_channels(mask_type) == jdsp.mask_channels(mask_type)


def test_features_match_jax(rng):
    from gan_sass_tf_tpu import config as j_config
    from gan_sass_tf_tpu_torch import config

    dcfg = config.get_config("wsj0_logmel").dsp
    j_dcfg = j_config.get_config("wsj0_logmel").dsp
    x = _rand(rng, 2, 5000)
    spec = np.array(jdsp.stft(jnp.asarray(x), 512, 128))
    for fn in ("logmag", "spec_features"):
        args = () if fn == "logmag" else (dcfg,)
        j_args = () if fn == "logmag" else (j_dcfg,)
        ours = getattr(tdsp, fn)(torch.from_numpy(spec), *args).numpy()
        ref = np.asarray(getattr(jdsp, fn)(jnp.asarray(spec), *j_args))
        np.testing.assert_allclose(ours, ref, atol=1e-4)
