"""The port's model options against the JAX package on the CPU: every conv-G
stem, decoder and head, the toy G, PhaseConvTranspose, the patch, BN,
group-norm and folded-input Ds, dropout, g_remat, the builders' checks,
and one f32 train step with the BN D, the folded D input and the fold G
against the JAX `build_train_step`.

Sizes are small: n_fft 128 (K = 65), G (8, 16), D (8, 16), 9-12 frames.
Each side is built from the port's config handed to the JAX package as
`Config.from_json(cfg.to_json())`; the port takes flax's init, converted,
with its biases (and norm scales) moved off their init values so that
every parameter reaches the output."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu.models.phase_ct import _phase_plan as j_phase_plan
from gan_sass_tf_tpu.models.phase_ct import _same_pad_a as j_same_pad_a
from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch.data import prng_key
from gan_sass_tf_tpu_torch.data.threefry import fold_in
from gan_sass_tf_tpu_torch.models.dropout import DropoutKey
from gan_sass_tf_tpu_torch.models.generator import _ct_padding
from gan_sass_tf_tpu_torch.models.phase_ct import (
    _phase_plan,
    _same_pad_a,
    phase_conv_transpose,
)
from gan_sass_tf_tpu_torch.train import build_train_step, create_train_state
from test_torch_train import METRICS, _check_moves, _flat, _run_both
from test_torch_train import _cfg as train_cfg

FOLD = {"g_stem_mode": "fold", "g_stem_stride": (1, 2)}


def _cfg(preset="stream_v5e8", dsp=None, **model):
    """`preset` at n_fft 128 (mel grids: 16 mels), G (8, 16), film head
    width 8, D (8, 16), f32, no Nyquist crop unless asked for."""
    cfg = config.get_config(preset)
    d = {"n_fft": 128, "hop_length": 32, "win_length": 128, **(dsp or {})}
    if cfg.dsp.feature == "logmel":
        d["n_mels"] = 16
    m = {"g_channels": (8, 16), "d_channels": (8, 16), "compute_dtype": "float32",
         "g_crop_nyquist": False, "g_film_channels": 8, "g_hidden": 16, **model}
    return cfg.replace(model=dataclasses.replace(cfg.model, **m),
                       dsp=dataclasses.replace(cfg.dsp, **d))


def _jax(cfg):
    return j_config.Config.from_json(cfg.to_json())


def _nudge(variables, scale=0.3):
    """Biases and norm scales moved off their init (zeros, ones)."""
    def move(path, v):
        if path[-1].key not in ("bias", "scale"):
            return np.asarray(v)
        r = np.random.default_rng(len(jax.tree_util.keystr(path)))
        return np.asarray(v) + scale * r.standard_normal(v.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, variables)


def _flax_names(tree):
    return {"/".join(k.key for k in path): np.shape(v) for path, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _g_both(cfg, n_frames, seed=0):
    """(flax masks, port masks, port G) from flax's init, converted; the
    port's tree must carry exactly flax's names and shapes."""
    g = jmodels.build_generator(_jax(cfg))
    feats = np.random.default_rng(seed).standard_normal(
        (2, n_frames, cfg.dsp.feature_dim)).astype(np.float32)
    params = _nudge(g.init(jax.random.PRNGKey(seed), jnp.asarray(feats)))
    ref = np.asarray(jax.jit(g.apply)(params, jnp.asarray(feats)))
    tg = tmodels.load_generator(cfg, params, "cpu")
    flat = tmodels.generator_params_to_flax(tg.state_dict())
    assert {k: v.shape for k, v in flat.items()} == _flax_names(params["params"])
    with torch.no_grad():
        ours = tg(torch.from_numpy(feats)).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    return ref, ours, tg


G_CASES = {
    "fold_stem_fold_head": ("stream_v5e8", None, {**FOLD, "g_head_mode": "fold"}),
    "fold_stem_fold_head_crop": ("stream_v5e8", None, {
        **FOLD, "g_head_mode": "fold", "g_crop_nyquist": True}),
    "fold_stem_2x2_fold_head": ("stream_v5e8", None, {
        "g_stem_mode": "fold", "g_stem_stride": (2, 2), "g_head_mode": "fold"}),
    "fold_stem_restore_head": ("stream_v5e8", None, {**FOLD, "g_head_mode": "dense"}),
    "fold_stem_restore_head_crop": ("stream_v5e8", None, {
        **FOLD, "g_head_mode": "dense", "g_crop_nyquist": True}),
    "fold_stem_film_head": ("stream_v5e8", None, {**FOLD, "g_head_mode": "film"}),
    "fold_stem_film_head_crop": ("stream_v5e8", None, {
        **FOLD, "g_head_mode": "film", "g_crop_nyquist": True}),
    "conv_stem": ("stream_v5e8", None, {"g_stem_stride": (1, 2)}),
    "packed_film_full_grid": ("stream_v5e8", None, {"g_head_mode": "film"}),
    "mel_grid_dense_head": ("wsj0_logmel", None, {"g_head_mode": "dense"}),
    "mel_grid_conv_stem_interp": ("wsj0_logmel", None, {"g_stem_stride": (1, 2)}),
    "subpixel_dec_l0": ("stream_v5e8", None, {"g_dec_l0": "subpixel"}),
    "phase_ct": ("stream_v5e8", None, {"g_phase_ct": True}),
    "toy": ("2src_toy_cpu", None, {"generator": "toy"}),
    "toy_softmax_noise_slot": ("2src_toy_cpu", {
        "mask_activation": "softmax", "mask_noise_slot": True}, {"generator": "toy"}),
    "fold_head_softmax_noise_slot": ("stream_v5e8", {
        "mask_activation": "softmax", "mask_noise_slot": True},
        {**FOLD, "g_head_mode": "fold"}),
    "music_fold_head_complex": ("music_complex_44k", None, {
        **FOLD, "g_head_mode": "fold", "g_channels": (8, 8, 16)}),
    "dropout_at_eval": ("stream_v5e8", None, {**FOLD, "g_head_mode": "fold",
                                              "dropout": 0.3}),
}


@pytest.mark.parametrize("name", list(G_CASES))
def test_generator_option_f32_matches_flax(name):
    preset, dsp, model = G_CASES[name]
    n_frames = 9 if len(name) % 2 else 12             # odd and even T both met
    ref, ours, _ = _g_both(_cfg(preset, dsp, **model), n_frames)
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    if model.get("g_crop_nyquist"):
        np.testing.assert_array_equal(ours[..., -1], ours[..., -2])


@pytest.mark.parametrize("name", ["fold_stem_fold_head", "fold_stem_film_head",
                                  "mel_grid_dense_head", "toy", "phase_ct"])
def test_generator_option_bf16_matches_flax(name):
    preset, dsp, model = G_CASES[name]
    ref, ours, _ = _g_both(_cfg(preset, dsp, **{**model, "compute_dtype": "bfloat16"}), 12)
    np.testing.assert_allclose(ours, ref, atol=3e-2)


def test_fold_and_phase_ct_npz_roundtrip(tmp_path):
    cfg = _cfg(**FOLD, g_head_mode="fold", g_phase_ct=True, generator="conv")
    g = tmodels.build_generator(cfg, "cpu", seed=3)
    assert any(k.startswith("phase_deconvs.") for k in g.state_dict())
    path = str(tmp_path / "g.npz")
    tmodels.save_flax_npz(path, g.state_dict())
    g2 = tmodels.load_generator(cfg, tmodels.load_flax_npz(path), "cpu")
    assert g2.state_dict().keys() == g.state_dict().keys()
    for k, v in g.state_dict().items():
        torch.testing.assert_close(g2.state_dict()[k], v, atol=0, rtol=0)


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (4, 2), (5, 3), (2, 3)])
def test_phase_plan_is_the_jax_packages(k, s):
    assert _same_pad_a(k, s) == j_same_pad_a(k, s)
    assert _phase_plan(k, s) == j_phase_plan(k, s)


@pytest.mark.parametrize("strides,shape", [
    ((2, 2), (2, 9, 13, 5)),     # odd spatial dims exercise phase edges
    ((1, 2), (2, 8, 16, 4)),
    ((2, 2), (1, 6, 6, 3)),
])
def test_phase_conv_transpose_equals_conv_transpose(strides, shape):
    """Outputs and the input and kernel gradients of the phase form against
    the port's ConvTranspose path (conv_transpose2d on the flipped kernel,
    cropped to T·s) on the same parameter, and against flax's."""
    import flax.linen as nn

    rng = np.random.default_rng(1)
    x_nhwc = rng.standard_normal(shape).astype(np.float32)
    params = nn.ConvTranspose(7, (3, 3), strides=strides, padding="SAME").init(
        jax.random.PRNGKey(2), jnp.asarray(x_nhwc))
    params = _nudge(params)
    ref_flax = np.asarray(nn.ConvTranspose(7, (3, 3), strides=strides, padding="SAME")
                          .apply(params, jnp.asarray(x_nhwc))).transpose(0, 3, 1, 2)
    sd = tmodels.convert_generator_params({"ConvTranspose_0": params["params"]})
    w = sd["deconvs.0.weight"].requires_grad_()
    b = sd["deconvs.0.bias"]
    t, f = shape[1] * strides[0], shape[2] * strides[1]

    def run(phase):
        x = torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy()).requires_grad_()
        if phase:
            y = phase_conv_transpose(x, w, b, strides, torch.float32)
        else:
            pad = tuple(_ct_padding(3, s) for s in strides)
            y = F.conv_transpose2d(x, w, b, strides, pad)[:, :, :t, :f]
        gx, gw = torch.autograd.grad(y.square().sum(), (x, w))
        return y.detach(), gx, gw

    (y, gx, gw), (y_ref, gx_ref, gw_ref) = run(True), run(False)
    assert y.shape == y_ref.shape == (shape[0], 7, t, f)
    for a, r in ((y, y_ref), (gx, gx_ref), (gw, gw_ref)):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), ref_flax, atol=1e-5)


D_CASES = {
    "patch": {"discriminator": "patch", "d_norm": "batch"},
    "patch_spectral": {"discriminator": "patch", "d_norm": "spectral"},
    "batch": {"d_norm": "batch"},
    "group": {"d_norm": "group"},
    "none": {"d_norm": "none"},
    "batch_input_fold_2": {"d_norm": "batch", "d_input_fold": 2},
    "spectral_input_fold_2": {"d_norm": "spectral", "d_input_fold": 2},
    "batch_dropout_at_eval": {"d_norm": "batch", "dropout": 0.3},
}


@pytest.mark.parametrize("name,train", [
    (name, train) for name in D_CASES for train in (False, True)
    if not (train and "dropout" in name)])    # flax's train-time masks are its own
def test_discriminator_option_matches_flax(name, train):
    """Logits within 1e-4 (f32), the variables' tree names, and the
    statistics each call stores: BN's running mean and var after one
    update within 1e-6, the spectral-norm state; train=False reads the
    running statistics and stores nothing."""
    cfg = _cfg(d_channels=(8, 16, 16), **D_CASES[name])
    d = jmodels.build_discriminator(_jax(cfg))
    f = cfg.model.d_input_fold
    x = (np.random.default_rng(0).standard_normal((3, 20 // f, 65, 2 * f)) * 2
         + 0.5).astype(np.float32)
    variables = _nudge(d.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    r = np.random.default_rng(3)
    for layer, leaves in variables.get("batch_stats", {}).items():
        if layer.startswith("BatchNorm_"):     # running statistics off 0 and 1
            leaves["mean"] = leaves["mean"] + 0.3 * r.standard_normal(leaves["mean"].shape)
            leaves["var"] = leaves["var"] * np.exp(0.3 * r.standard_normal(
                leaves["var"].shape))
    ref, new = d.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"])
    td = tmodels.load_discriminator(cfg, variables, "cpu")
    before = tmodels.discriminator_variables_to_flax(td.state_dict())
    assert jax.tree.map(np.shape, before) == jax.tree.map(np.shape, dict(variables))
    with torch.no_grad():
        ours = td(torch.from_numpy(x), update_stats=train, train=train)
    assert ours.dtype == torch.float32 and ours.shape == np.shape(ref)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    after = tmodels.discriminator_variables_to_flax(td.state_dict()).get("batch_stats", {})
    want = jax.tree.map(np.asarray, new.get("batch_stats", {}))
    assert after.keys() == want.keys()
    for layer, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(after[layer][k], v, atol=1e-6, err_msg=k)


def test_discriminator_running_statistics_move_with_momentum_0_99():
    """BN's stored mean/var = 0.99·old + 0.01·batch, the batch variance
    biased (flax), not torch's unbiased one."""
    cfg = _cfg(d_norm="batch")
    td = tmodels.build_discriminator(cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 12, 65, 2)).astype(np.float32))
    acts = {}
    td.norms[0].register_forward_pre_hook(lambda m, a: acts.update(x=a[0]))
    with torch.no_grad():
        td(x, update_stats=True, train=True)
    h = acts["x"].double()
    mean, var = h.mean(dim=(0, 2, 3)), h.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(td.norms[0].mean.double(), 0.01 * mean, atol=1e-7, rtol=0)
    torch.testing.assert_close(td.norms[0].var.double(), 0.99 + 0.01 * var,
                               atol=1e-6, rtol=1e-6)


def test_input_fold_must_divide_the_stem_stride():
    cfg = _cfg(d_input_fold=3, d_norm="batch")           # stem stride (2, 4)
    d = jmodels.build_discriminator(_jax(cfg))
    with pytest.raises(ValueError, match="must divide the stem"):
        d.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 65, 6)))
    with pytest.raises(ValueError, match="must divide the stem"):
        tmodels.build_discriminator(cfg, "cpu")


def _raises(fn):
    try:
        fn()
    except (ValueError, KeyError) as exc:
        return type(exc)
    return None


def test_generator_builders_accept_and_reject_as_jax():
    """Every combination of the conv G's options: the port builds what the
    JAX builder builds and raises the same exception type where it
    refuses; the toy and BiLSTM G's checks too."""
    grid = itertools.product(("conv", "fold", "pixel"), ((1, 1), (1, 2)),
                             ("dense", "interp", "film", "fold", "filmpack"),
                             ("conv", "subpixel", "deconv"), (False, True),
                             ("stream_v5e8", "wsj0_logmel"))
    seen = set()
    for stem, stride, head, dec, crop, preset in grid:
        cfg = _cfg(preset, g_stem_mode=stem, g_stem_stride=stride, g_head_mode=head,
                   g_dec_l0=dec, g_crop_nyquist=crop)
        want = _raises(lambda: jmodels.build_generator(_jax(cfg)))
        assert _raises(lambda: tmodels.build_generator(cfg, "cpu")) == want, \
            (stem, stride, head, dec, crop, preset)
        seen.add(want)
    for gen, model in (("toy", {"g_crop_nyquist": True}), ("toy", {}),
                       ("bilstm", {"g_head_mode": "fold"}), ("mlp", {})):
        cfg = _cfg("2src_toy_cpu", generator=gen, **model)
        want = _raises(lambda: jmodels.build_generator(_jax(cfg)))
        assert _raises(lambda: tmodels.build_generator(cfg, "cpu")) == want, (gen, model)
        seen.add(want)
    assert seen == {None, ValueError, KeyError}


def test_discriminator_builders_accept_and_reject_as_jax():
    """Every D option: the port builds what flax initializes and raises
    the type flax raises (the JAX D raises its ValueErrors at init)."""
    seen = set()
    for disc, norm, fold in itertools.product(
            ("conv", "patch", "dense"), ("spectral", "batch", "group", "none", "layer"),
            (1, 2, 3)):
        cfg = _cfg(discriminator=disc, d_norm=norm, d_input_fold=fold)

        def jax_init():
            d = jmodels.build_discriminator(_jax(cfg))
            jax.eval_shape(d.init, jax.random.PRNGKey(0),
                           jnp.zeros((2, 12 // fold, 65, 2 * fold)))

        want = _raises(jax_init)
        assert _raises(lambda: tmodels.build_discriminator(cfg, "cpu")) == want, \
            (disc, norm, fold)
        seen.add(want)
    assert seen == {None, ValueError, KeyError}


def test_dropout_masks_keep_1_minus_p_scaled_and_keyed():
    """Kept share within binomial bounds of 1 - p, kept values x·(1/(1 - p))
    in float32 exactly, the same masks under the same key and other masks
    under another key, at another site or another module path; a batch's
    halves draw other masks than the whole batch (the flat index keys
    them, as flax's)."""
    p = 0.3
    x = torch.randn(4, 3, 50, 40)
    key = DropoutKey(fold_in(prng_key(5), 2))
    y = key.apply(x, p, site=1)
    kept = y != 0
    n = x.numel()
    share = float(kept.float().mean())
    assert abs(share - (1 - p)) <= 5 * (p * (1 - p) / n) ** 0.5, share
    assert torch.equal(y[kept], x[kept] * float(np.float32(1) / np.float32(1 - p)))
    assert torch.equal(key.apply(x, p, 1), y)
    assert not torch.equal(DropoutKey(fold_in(prng_key(5), 3)).apply(x, p, 1), y)
    assert not torch.equal(key.apply(x, p, 2), y)              # another site
    assert not torch.equal(DropoutKey(key.key, ("G",)).apply(x, p, 1), y)
    assert not torch.equal(key.apply(x[2:], p, 1), y[2:])


@pytest.mark.parametrize("generator", ["conv", "toy", "bilstm"])
def test_generators_drop_at_train_time_only(generator):
    preset = {"conv": "stream_v5e8", "toy": "2src_toy_cpu", "bilstm": "3src_pit"}[generator]
    model = {"g_head_mode": "film"} if generator == "bilstm" else {}
    cfg = _cfg(preset, generator=generator, dropout=0.5, **model)
    g = tmodels.build_generator(cfg, "cpu")
    feats = torch.randn(2, 10, cfg.dsp.feature_dim)
    key = DropoutKey(fold_in(prng_key(0), 1))
    with torch.no_grad():
        train = g(feats, train=True, dropout=key)
        assert torch.equal(train, g(feats, train=True, dropout=key))
        assert not torch.equal(train, g(feats))
        with pytest.raises(ValueError, match="DropoutKey"):
            g(feats, train=True)


def _g_grads(cfg, remat):
    """G's gradients of one step (the clip and Adam see them) from the seeded
    state, with dropout on."""
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, g_remat=remat))
    state = create_train_state(cfg, "cpu", seed=1)
    got = []
    inner = state.g_opt.step
    state.g_opt.step = lambda grads: (got.append([g.clone() for g in grads]), inner(grads))
    src = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 2, int(cfg.data.segment_seconds * cfg.dsp.sample_rate))).astype(np.float32))
    build_train_step(cfg)(state, src, prng_key(3))
    return got[0]


@pytest.mark.parametrize("model", [
    {"g_head_mode": "fold", "g_stem_mode": "fold", "g_stem_stride": (1, 2)},
    {"generator": "bilstm", "g_head_mode": "filmpack", "g_hidden": 8,
     "g_film_channels": 8},
])
def test_remat_gives_the_same_g_gradients(model):
    base = train_cfg("wav", d_instance_noise=0.1)
    cfg = base.replace(model=dataclasses.replace(base.model, dropout=0.2, g_crop_nyquist=False,
                                                 **model))
    plain, remat = _g_grads(cfg, False), _g_grads(cfg, True)
    for a, b in zip(plain, remat):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0)


def _options_step_cfg():
    """train_cfg("wav") (stream_v5e8 at 0.25 s, f32, no jitter, noise
    sources or instance noise) with the BN D on the frame-folded input and
    the fold G."""
    cfg = train_cfg("wav")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, d_norm="batch", d_input_fold=2, **FOLD, g_head_mode="fold"))


@pytest.fixture(scope="module")
def options_run():
    return _run_both(_options_step_cfg())


def test_train_step_bn_d_fold_g_matches_jax(options_run):
    """Two steps' metrics within 1e-4 relative; after step 1 the
    parameters (tests/test_torch_train.py's rule) and BN's running
    statistics within 1e-6.  The biases of D's convs that feed a BN have a
    zero gradient (BN removes the mean), so Adam's first step moves them
    by ±lr on float noise in both packages: they are held to that bound
    alone."""
    run = options_run
    for step, (j, t) in enumerate(zip(run["jax"], run["torch"]), 1):
        for k in METRICS:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=f"{k} {step}")
    cfg, js, j0 = run["cfg"], run["jstate1"], run["jstate0"]
    tg, td, _ = run["tstate1"]
    _check_moves(_flat(tg), dict(_flat(js.g_params)), dict(_flat(j0.g_params)),
                 cfg.train.g_lr, "G")
    pre_bn = {f"Conv_{i}/bias" for i in range(1, len(cfg.model.d_channels))}
    d_ref, d_init = dict(_flat(js.d_params)), dict(_flat(j0.d_params))
    _check_moves([kv for kv in _flat(td["params"]) if kv[0] not in pre_bn],
                 d_ref, d_init, cfg.train.d_lr, "D")
    for k in pre_bn:
        moved = dict(_flat(td["params"]))[k] - d_init[k]
        assert np.all(np.abs(moved) <= cfg.train.d_lr * (1 + 1e-4)), k
    stats = dict(_flat(js.d_batch_stats))
    got = dict(_flat(td["batch_stats"]))
    assert got.keys() == stats.keys() and stats
    for k, v in got.items():
        np.testing.assert_allclose(v, stats[k], atol=1e-6, err_msg=k)
