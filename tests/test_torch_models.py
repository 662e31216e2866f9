"""The port's generator and discriminator against the flax modules on the
same converted weights and seeded inputs, in f32 and bf16."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch.data import prng_key
from gan_sass_tf_tpu_torch.models.dropout import DropoutKey


def _small(name="wsj0_logmel", **model):
    cfg = config.get_config(name)
    model = {"g_channels": (8, 16), **model}
    dsp = {"n_mels": 32} if cfg.dsp.feature == "logmel" else {}
    return cfg.replace(model=dataclasses.replace(cfg.model, **model),
                       dsp=dataclasses.replace(cfg.dsp, **dsp))


def _jax(cfg):
    """The same configuration as the JAX package's Config, for its side."""
    return j_config.Config.from_json(cfg.to_json())


def _both(cfg, n_frames, seed=0):
    """(flax masks, port masks) on the same params and features."""
    g = jmodels.build_generator(_jax(cfg))
    feats = np.random.default_rng(seed).standard_normal(
        (2, n_frames, cfg.dsp.feature_dim)).astype(np.float32)
    params = g.init(jax.random.PRNGKey(seed), jnp.asarray(feats))
    ref = np.asarray(g.apply(params, jnp.asarray(feats)))
    tg = tmodels.load_generator(cfg, jax.tree.map(np.asarray, params), "cpu")
    with torch.no_grad():
        ours = tg(torch.from_numpy(feats)).numpy()
    return ref, ours


@pytest.mark.parametrize("n_frames", [28, 31])   # even / odd SAME padding
def test_generator_f32_matches_flax(n_frames):
    ref, ours = _both(_small(compute_dtype="float32"), n_frames)
    assert ours.shape == ref.shape == (2, 2, n_frames, 257)
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.mark.parametrize("n_frames", [28, 31])
def test_generator_bf16_matches_flax(n_frames):
    cfg = _small()
    assert cfg.model.compute_dtype == "bfloat16"       # as shipped
    ref, ours = _both(cfg, n_frames)
    assert ours.dtype == np.float32                     # masks leave in f32
    np.testing.assert_allclose(ours, ref, atol=3e-2)


@pytest.mark.parametrize("name,model", [
    ("2src_toy_cpu", {}),                               # linear-grid 1x1 head
    ("2src_toy_cpu", {"g_time_stride": False, "g_decoder_slim": 0.5}),
])
def test_generator_linear_head_matches_flax(name, model):
    ref, ours = _both(_small(name, **model), 23)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_generator_complex_and_softmax_masks_match_flax():
    cfg = _small("2src_toy_cpu")
    cfg = cfg.replace(dsp=dataclasses.replace(cfg.dsp, mask_type="complex"))
    ref, ours = _both(cfg, 20)
    assert ours.shape == (2, 2, 20, 129, 2)
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    cfg = cfg.replace(dsp=dataclasses.replace(
        cfg.dsp, mask_type="magnitude", mask_activation="softmax",
        mask_noise_slot=True))
    ref, ours = _both(cfg, 20)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_flax_tree_names_and_npz_roundtrip(tmp_path):
    cfg = _small(compute_dtype="float32")
    g = tmodels.build_generator(cfg, "cpu", seed=3)
    flat = tmodels.generator_params_to_flax(g.state_dict())
    # Same names and shapes as the flax module's own init.
    params = jmodels.build_generator(_jax(cfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 32)))["params"]
    ref = {"/".join(k.key for k in path): v.shape for path, v in
           jax.tree_util.tree_leaves_with_path(params)}
    assert {k: v.shape for k, v in flat.items()} == ref
    path = str(tmp_path / "g.npz")
    tmodels.save_flax_npz(path, g.state_dict())
    g2 = tmodels.load_generator(cfg, tmodels.load_flax_npz(path), "cpu")
    for k, v in g.state_dict().items():
        torch.testing.assert_close(g2.state_dict()[k], v, atol=0, rtol=0)


def test_seeded_init_is_reproducible():
    cfg = _small()
    a = tmodels.build_generator(cfg, "cpu", seed=1).state_dict()
    b = tmodels.build_generator(cfg, "cpu", seed=1).state_dict()
    c = tmodels.build_generator(cfg, "cpu", seed=2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["convs.0.weight"], c["convs.0.weight"])


def test_full_width_wsj0_parameter_count():
    g = tmodels.build_generator(config.get_config("wsj0_logmel"), "cpu")
    assert sum(p.numel() for p in g.parameters()) == 1_061_218


@pytest.mark.parametrize("n_frames", [28, 31])
def test_generator_crop_nyquist_matches_flax(n_frames):
    """stream_v5e8's g_crop_nyquist: G runs on K-1 bins and the Nyquist
    mask repeats its neighbour's."""
    cfg = _small("stream_v5e8", compute_dtype="float32")
    assert cfg.model.g_crop_nyquist
    ref, ours = _both(cfg, n_frames)
    assert ours.shape == ref.shape == (2, 2, n_frames, 257)
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    np.testing.assert_array_equal(ours[..., -1], ours[..., -2])


def _d_cfg(dtype="float32", **model):
    cfg = config.get_config("stream_v5e8")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, d_channels=(8, 16), compute_dtype=dtype, **model))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("update_stats", [False, True])
def test_spectral_norm_discriminator_matches_flax(rng, dtype, atol, update_stats):
    """Logits, and the power-iteration state (u, sigma) each call leaves
    behind, against flax's SpectralNorm with converted params and stats."""
    cfg = _d_cfg(dtype)
    d = jmodels.build_discriminator(_jax(cfg))
    x = rng.standard_normal((3, 21, 257, 2)).astype(np.float32)
    variables = jax.tree.map(np.asarray, d.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    # A second call from the stored state, so u has moved off its init.
    _, moved = d.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree.map(np.asarray, moved["batch_stats"])}
    ref, new = d.apply(variables, jnp.asarray(x), train=update_stats,
                       mutable=["batch_stats"])
    td = tmodels.load_discriminator(cfg, variables, "cpu")
    with torch.no_grad():
        ours = td(torch.from_numpy(x), update_stats=update_stats)
    assert ours.dtype == torch.float32 and ours.shape == (3,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol)
    after = tmodels.discriminator_variables_to_flax(td.state_dict())["batch_stats"]
    want = jax.tree.map(np.asarray, new["batch_stats"])
    for sn, leaves in want.items():
        for name, v in leaves.items():
            np.testing.assert_allclose(after[sn][name], v, atol=1e-6, err_msg=name)
    if not update_stats:        # nothing stored: the state is what went in
        for sn, leaves in variables["batch_stats"].items():
            for name, v in leaves.items():
                np.testing.assert_array_equal(after[sn][name], v)


def test_spectral_norm_gradient_flows_through_sigma(rng):
    """d logits / d W matches flax's (u, v constant, sigma differentiated)."""
    cfg = _d_cfg()
    d = jmodels.build_discriminator(_jax(cfg))
    x = rng.standard_normal((2, 12, 257, 2)).astype(np.float32)
    variables = jax.tree.map(np.asarray, d.init(jax.random.PRNGKey(2), jnp.asarray(x)))

    def jloss(params):
        out, _ = d.apply({"params": params,
                          "batch_stats": variables["batch_stats"]},
                         jnp.asarray(x), train=False, mutable=["batch_stats"])
        return jnp.sum(out ** 2)

    jgrad = jax.grad(jloss)(variables["params"])
    td = tmodels.load_discriminator(cfg, variables, "cpu")
    (td(torch.from_numpy(x)) ** 2).sum().backward()
    np.testing.assert_allclose(td.convs[0].weight.grad.numpy(),
                               np.asarray(jgrad["Conv_0"]["kernel"]).transpose(3, 2, 0, 1),
                               atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(td.head.weight.grad.numpy(),
                               np.asarray(jgrad["Dense_0"]["kernel"]).T,
                               atol=1e-6, rtol=1e-4)


def test_discriminator_tree_names_and_roundtrip():
    cfg = _d_cfg()
    td = tmodels.build_discriminator(cfg, "cpu", seed=4)
    flat = tmodels.discriminator_variables_to_flax(td.state_dict())
    ref = jmodels.build_discriminator(_jax(cfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 257, 2)))
    shapes = lambda t: jax.tree.map(np.shape, t)      # noqa: E731
    assert shapes(flat) == shapes(jax.tree.map(np.asarray, dict(ref)))
    td2 = tmodels.load_discriminator(cfg, flat, "cpu")
    for k, v in td.state_dict().items():
        torch.testing.assert_close(td2.state_dict()[k], v, atol=0, rtol=0)


def test_full_width_stream_v5e8_parameter_counts():
    cfg = config.get_config("stream_v5e8")
    g = tmodels.build_generator(cfg, "cpu")
    d = tmodels.build_discriminator(cfg, "cpu")
    jg = jax.eval_shape(jmodels.build_generator(_jax(cfg)).init, jax.random.PRNGKey(0),
                        jnp.zeros((1, 16, 257)))["params"]
    jd = jax.eval_shape(jmodels.build_discriminator(_jax(cfg)).init,
                        jax.random.PRNGKey(0), jnp.zeros((1, 16, 257, 2)))["params"]
    count = lambda t: sum(np.prod(a.shape) for a in jax.tree.leaves(t))  # noqa: E731
    assert sum(p.numel() for p in g.parameters()) == count(jg)
    assert sum(p.numel() for p in d.parameters()) == count(jd)


def _bilstm(head="film", dtype="float32", noise_slot=False, **model):
    """3src_pit (S = 3, softmax masks, the BiLSTM G) at n_fft 64 (K = 33),
    G hidden 16, film head width 8."""
    cfg = config.get_config("3src_pit")
    model = {"g_head_mode": head, "g_hidden": 16, "g_film_channels": 8,
             "compute_dtype": dtype, **model}
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model),
        dsp=dataclasses.replace(cfg.dsp, n_fft=64, hop_length=16, win_length=64,
                                mask_noise_slot=noise_slot))


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _bilstm_both(cfg, n_frames):
    """(flax masks, port masks, port G) from the port's seeded init with
    random biases, converted to flax's tree, on features whose second half
    is three times louder than the first, so that the two time directions
    of the BiLSTM see different sequences.  The flax side is jitted (one
    compile, ~1 s, against ~5 s op by op)."""
    tg = tmodels.build_generator(cfg, "cpu", seed=n_frames)
    gen = torch.Generator().manual_seed(n_frames)
    with torch.no_grad():
        for name, p in tg.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.5, generator=gen)
    params = {"params": _nest(tmodels.generator_params_to_flax(tg.state_dict()))}
    feats = np.random.default_rng(n_frames).standard_normal(
        (2, n_frames, cfg.dsp.feature_dim)).astype(np.float32)
    feats[:, n_frames // 2:] *= 3.0
    ref = np.asarray(jax.jit(jmodels.build_generator(_jax(cfg)).apply)(
        params, jnp.asarray(feats)))
    with torch.no_grad():
        ours = tg(torch.from_numpy(feats)).numpy()
    return ref, ours, tg, feats


@pytest.mark.parametrize("n_frames", [20, 21])
@pytest.mark.parametrize("noise_slot", [False, True])
@pytest.mark.parametrize("head", ["film", "filmpack", "dense"])
def test_bilstm_generator_f32_matches_flax(head, noise_slot, n_frames):
    """Each sequence head, with and without the softmax noise slot, at an
    even and an odd frame count; then the two directions of layer 0
    swapped, which must not match."""
    cfg = _bilstm(head, noise_slot=noise_slot)
    ref, ours, tg, feats = _bilstm_both(cfg, n_frames)
    assert ours.shape == ref.shape == (2, 3, n_frames, 33)
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    np.testing.assert_allclose(ours.sum(axis=1) <= 1 + 1e-6, True)
    fwd, bwd = tg.cells[0], tg.cells[1]
    with torch.no_grad():
        for name in ("weight_ih", "weight_hh", "bias"):
            a, b = getattr(fwd, name), getattr(bwd, name)
            tmp = a.clone()
            a.copy_(b)
            b.copy_(tmp)
        swapped = tg(torch.from_numpy(feats)).numpy()
    assert np.abs(swapped - ref).max() > 1e-2


@pytest.mark.parametrize("head", ["film", "filmpack", "dense"])
def test_bilstm_generator_bf16_matches_flax(head):
    """bf16 compute: the port's LSTM keeps its hidden state in bf16 where
    flax promotes the carry to f32, and rounds the gate sums once where
    flax rounds each product; masks agree within 1e-2 (measured: up to
    2.3e-3 on these inputs)."""
    cfg = _bilstm(head, dtype="bfloat16")
    ref, ours, _, _ = _bilstm_both(cfg, 20)
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-2)


def test_position_encoding_is_built_as_jnp_builds_it():
    """The film heads' fixed encoding in bf16: 2π rounded to bf16 before
    the product, as jnp's weak-typed scalar is; exact in both dtypes."""
    from gan_sass_tf_tpu_torch.models.generator import _position_encoding
    for n in (33, 257):
        for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            k = jnp.linspace(0.0, 1.0, n, dtype=jdt)
            ref = jnp.stack([k] + [jnp.sin(2.0 * jnp.pi * k * q)
                                   for q in (1.0, 2.0, 4.0, 8.0)], axis=-1)
            ours = _position_encoding(n, dt, "cpu")
            assert ours.dtype == dt
            np.testing.assert_allclose(ours.float().numpy(),
                                       np.asarray(ref.astype(jnp.float32)), atol=1e-7)


@pytest.mark.parametrize("head", ["film", "filmpack", "dense"])
def test_bilstm_flax_tree_names_and_npz_roundtrip(tmp_path, head):
    cfg = _bilstm(head)
    g = tmodels.build_generator(cfg, "cpu", seed=3)
    flat = tmodels.generator_params_to_flax(g.state_dict())
    params = jax.eval_shape(jmodels.build_generator(_jax(cfg)).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 16, 33)))["params"]
    ref = {"/".join(k.key for k in path): v.shape for path, v in
           jax.tree_util.tree_leaves_with_path(params)}
    assert {k: v.shape for k, v in flat.items()} == ref
    path = str(tmp_path / "g.npz")
    tmodels.save_flax_npz(path, g.state_dict())
    g2 = tmodels.load_generator(cfg, tmodels.load_flax_npz(path), "cpu")
    assert g2.state_dict().keys() == g.state_dict().keys()
    for k, v in g.state_dict().items():
        torch.testing.assert_close(g2.state_dict()[k], v, atol=0, rtol=0)


def test_bilstm_seeded_init_follows_flax_defaults():
    """Recurrent kernels orthogonal one H x H gate block at a time, input
    kernels lecun-normal, biases zero; reproducible from the seed."""
    cfg = _bilstm(g_hidden=32)
    a = tmodels.build_generator(cfg, "cpu", seed=1)
    b = tmodels.build_generator(cfg, "cpu", seed=1).state_dict()
    assert all(torch.equal(v, b[k]) for k, v in a.state_dict().items())
    for cell in a.cells:
        for block in cell.weight_hh.detach().split(32):
            torch.testing.assert_close(block @ block.T, torch.eye(32), atol=1e-5,
                                       rtol=0)
        assert not cell.bias.any()
        fan_in = cell.weight_ih.shape[1]
        assert abs(float(cell.weight_ih.detach().std()) * fan_in ** 0.5 - 1.0) < 0.1


def test_full_width_3src_pit_generator():
    """The BiLSTM G with the film head, with exactly flax's parameters: the
    LSTM 1 339 200 + 2 162 400 (one bias a gate), the film head 274 051."""
    cfg = config.get_config("3src_pit")
    g = tmodels.build_generator(cfg, "cpu")
    assert isinstance(g, tmodels.BiLSTMGenerator) and g.head.mode == "film"
    count = lambda ps: sum(p.numel() for p in ps)      # noqa: E731
    assert count(g.parameters()) == 3_775_651
    assert count(g.cells[:2].parameters()) == 1_339_200
    assert count(g.cells[2:].parameters()) == 2_162_400
    assert count(g.head.parameters()) == 274_051
    jg = jax.eval_shape(jmodels.build_generator(_jax(cfg)).init,
                        jax.random.PRNGKey(0), jnp.zeros((1, 16, 257)))["params"]
    ref = {"/".join(k.key for k in path): v.shape for path, v in
           jax.tree_util.tree_leaves_with_path(jg)}
    flat = tmodels.generator_params_to_flax(dict(g.named_parameters()))
    assert {k: v.shape for k, v in flat.items()} == ref


@pytest.mark.parametrize("model,dsp,match", [
    ({"g_crop_nyquist": True}, {}, "only supported by the 'conv'"),
    ({"g_head_mode": "interp"}, {}, "must be 'dense', 'film' or 'filmpack'"),
    ({"g_head_mode": "film"}, {"feature": "logmel"}, "linear-grid"),
    ({"g_head_mode": "filmpack"}, {"feature": "logmel"}, "linear-grid"),
])
def test_bilstm_validations_raise_as_jax(model, dsp, match):
    cfg = config.get_config("3src_pit")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model),
                      dsp=dataclasses.replace(cfg.dsp, **dsp))
    with pytest.raises(ValueError, match=match):
        jmodels.build_generator(_jax(cfg))
    with pytest.raises(ValueError, match=match):
        tmodels.build_generator(cfg, "cpu")


def test_bilstm_dense_head_on_the_mel_grid_and_unknown_generator():
    cfg = config.get_config("3src_pit")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, g_head_mode="dense",
                                                g_hidden=8),
                      dsp=dataclasses.replace(cfg.dsp, feature="logmel", n_mels=20))
    g = tmodels.build_generator(cfg, "cpu")
    with torch.no_grad():
        assert g(torch.zeros(1, 5, 20)).shape == (1, 3, 5, 257)
    # Dropout runs at train time: keyed masks, kept values scaled by 1/(1-p).
    g = tmodels.build_generator(_bilstm(dropout=0.5), "cpu")
    key = DropoutKey(prng_key(0))
    x = torch.randn(2, 5, 33)
    with torch.no_grad():
        a, b = g(x, train=True, dropout=key), g(x, train=True, dropout=key)
        assert torch.equal(a, b) and not torch.equal(a, g(x))
    bad = cfg.replace(model=dataclasses.replace(cfg.model, generator="mlp"))
    with pytest.raises(KeyError, match=r"have \['bilstm', 'conv', 'toy'\]"):
        tmodels.build_generator(bad, "cpu")
