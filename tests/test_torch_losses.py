"""The port's training losses against the JAX package's on the same seeded
inputs: reconstruction, adversarial, and PIT matching (f32 at rtol 1e-6;
the bf16 matching decides the same permutations)."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import losses as jl
from gan_sass_tf_tpu_torch import losses as tl


def _both(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x, jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["l1", "mse"])
@pytest.mark.parametrize("batch_dims", [0, 1, 2])
def test_elem_and_recon_loss(rng, kind, batch_dims):
    _, je, te = _both(rng, 3, 2, 5, 7)
    _, jt, tt = _both(rng, 3, 2, 5, 7)
    np.testing.assert_allclose(tl.elem_loss(te, tt, kind, batch_dims).numpy(),
                               np.asarray(jl.elem_loss(je, jt, kind, batch_dims)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tl.recon_loss(te, tt, kind)),
                               float(jl.recon_loss(je, jt, kind)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["ns", "lsgan", "hinge"])
def test_gan_losses(rng, kind):
    _, jr, tr = _both(rng, 16)
    _, jf, tf = _both(rng, 16)
    np.testing.assert_allclose(float(tl.gan_d_loss(tr, tf, kind)),
                               float(jl.gan_d_loss(jr, jf, kind)), rtol=1e-6)
    np.testing.assert_allclose(float(tl.gan_g_loss(tf, kind)),
                               float(jl.gan_g_loss(jf, kind)), rtol=1e-6)


def test_unknown_kinds_raise():
    x = torch.zeros(2)
    for fn in (lambda: tl.gan_d_loss(x, x, "w"), lambda: tl.gan_g_loss(x, "w"),
               lambda: tl.recon_loss(x, x, "l3")):
        with pytest.raises(ValueError, match="unknown"):
            fn()


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("kind", ["l1", "mse"])
def test_pairwise_and_pit_loss(rng, s, kind):
    _, je, te = _both(rng, 4, s, 6, 9)
    tgt = rng.standard_normal((4, s, 6, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tl.pairwise_losses(te, torch.from_numpy(tgt), kind).numpy(),
        np.asarray(jl.pairwise_losses(je, jnp.asarray(tgt), kind)), rtol=1e-6)
    loss, perm = tl.pit_loss(te, torch.from_numpy(tgt), kind)
    jloss, jperm = jl.pit_loss(je, jnp.asarray(tgt), kind)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-6)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


@pytest.mark.parametrize("shape", [(2, 2, 10, 13), (2, 2, 3, 13), (2, 2, 9, 2)])
def test_pool4_and_tiny_grid_passthrough(rng, shape):
    _, jx, tx = _both(rng, *shape)
    ours, ref = tl.pool4(tx), jl.pool4(jx)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)
    if shape[2] < 4 or shape[3] < 4:
        assert torch.equal(ours, tx)


@pytest.mark.parametrize("kind", ["l1", "mse"])
def test_pooled_match_perm_and_align(rng, kind):
    """Targets are shuffled estimates plus noise, so the right permutation
    is clear and the bf16 matching of both packages must find it."""
    b, s = 6, 3
    est = np.abs(rng.standard_normal((b, s, 20, 33))).astype(np.float32)
    order = np.stack([rng.permutation(s) for _ in range(b)])
    tgt = np.take_along_axis(est, order[:, :, None, None], axis=1)
    tgt = (tgt + 0.05 * rng.standard_normal(tgt.shape)).astype(np.float32)
    perm = tl.pooled_match_perm(torch.from_numpy(est), torch.from_numpy(tgt), kind)
    jperm = np.asarray(jl.pooled_match_perm(jnp.asarray(est), jnp.asarray(tgt), kind))
    np.testing.assert_array_equal(perm.numpy(), jperm)
    aligned = tl.align_to_perm(torch.from_numpy(tgt), perm).numpy()
    np.testing.assert_array_equal(
        aligned, np.asarray(jl.align_to_perm(jnp.asarray(tgt), jnp.asarray(jperm))))
    np.testing.assert_allclose(aligned, est, atol=0.3)     # undoes the shuffle
    wav = rng.standard_normal((b, s, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        tl.align_to_perm(torch.from_numpy(wav), perm).numpy(),
        np.asarray(jl.align_to_perm(jnp.asarray(wav), jnp.asarray(jperm))))
