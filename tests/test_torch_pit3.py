"""3src_pit on the port against the JAX package: two f32 train steps of
its geometry (S = 3, softmax magnitude masks, log-magnitude L1 with PIT
over 6 permutations, the BiLSTM G with the film head), the optimizer's
view of the BiLSTM's parameters, and one-shot and streaming separation
at S = 3.

Small sizes: n_fft 64 (K = 33), G hidden 16, film head width 8, D (8, 16),
0.25 s segments at 8 kHz (F = 122), batch 2.  The sources are scaled 1,
0.12, 0.016 and the head's last bias set so the three masks start near
0.87, 0.12, 0.016: the best of the 6 permutations is then clear, and
bf16 matching picks it in both packages (and streaming chains the same
permutations)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu.config import MeshConfig
from gan_sass_tf_tpu.data.synthetic import SyntheticDataset
from gan_sass_tf_tpu.infer import streaming as j_streaming
from gan_sass_tf_tpu.parallel import make_mesh
from gan_sass_tf_tpu.train.state import create_train_state
from gan_sass_tf_tpu.train.step import build_separate_fn as j_build_separate_fn
from gan_sass_tf_tpu.train.step import build_train_step as j_build_train_step
from gan_sass_tf_tpu_torch import config, infer
from gan_sass_tf_tpu_torch.infer import streaming
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch.losses import si_sdr
from gan_sass_tf_tpu_torch.losses.pit import pairwise_losses, permutations_for, pool4
from gan_sass_tf_tpu_torch.train import build_train_step, create_train_state as t_state
from gan_sass_tf_tpu_torch.train import load_train_state
from gan_sass_tf_tpu_torch.train.state import make_optimizers
from test_torch_models import _nest
from test_torch_train import _check_run, _flat

LEVELS = np.array([1.0, 0.12, 0.016], np.float32)[None, :, None]
HEAD_BIAS = np.array([4.0, 2.0, 0.0], np.float32)    # softmax: .87, .12, .016


def _cfg(**model):
    cfg = config.get_config("3src_pit")
    return cfg.replace(
        dsp=dataclasses.replace(cfg.dsp, n_fft=64, hop_length=16, win_length=64),
        model=dataclasses.replace(cfg.model, **{
            "g_hidden": 16, "g_film_channels": 8, "d_channels": (8, 16),
            "compute_dtype": "float32", **model}),
        train=dataclasses.replace(cfg.train, batch_size=2, d_instance_noise=0.0),
        data=dataclasses.replace(cfg.data, segment_seconds=0.25,
                                 gain_jitter_db=0.0, num_noise=0,
                                 bank_utterances=4))


def _jax(cfg):
    """The same configuration as the JAX package's Config, for its side."""
    return j_config.Config.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def pit3_run():
    """Two steps of each package from one init (the head's last bias set
    as above) on the same scaled sources, as test_torch_train's _run_both."""
    cfg = _cfg()
    jcfg = _jax(cfg)
    g, d = jmodels.build_generator(jcfg), jmodels.build_discriminator(jcfg)
    jstate = create_train_state(jcfg, g, d, jax.random.PRNGKey(0))
    g_params = jax.tree.map(np.array, jstate.g_params)
    g_params["MaskHead_0"]["Conv_3"]["bias"] = HEAD_BIAS
    jstate = jstate.replace(g_params=jax.tree.map(jnp.asarray, g_params))
    jstep = jax.jit(j_build_train_step(jcfg, g, d))
    tstate = load_train_state(
        cfg, g_params,
        {"params": jax.tree.map(np.asarray, jstate.d_params),
         "batch_stats": jax.tree.map(np.asarray, jstate.d_batch_stats)}, "cpu")
    tstep = build_train_step(cfg)
    ds = SyntheticDataset(jcfg, seed=3)
    out = {"jax": [], "torch": [], "cfg": cfg, "sources": [],
           "jstate0": jax.tree.map(np.asarray, jstate)}
    for i in range(2):
        src = ds.batch() * LEVELS
        out["sources"].append(src)
        jstate, jm = jstep(jstate, jnp.asarray(src), jax.random.PRNGKey(7))
        tstate, tm = tstep(tstate, torch.from_numpy(src), 7)
        out["jax"].append({k: float(v) for k, v in jm.items()})
        out["torch"].append({k: float(v) for k, v in tm.items()})
        if i == 0:
            out["jstate1"] = jax.tree.map(np.asarray, jstate)
            out["tstate1"] = (
                tmodels.generator_params_to_flax(tstate.g.state_dict()),
                tmodels.discriminator_variables_to_flax(tstate.d.state_dict()),
                None)
            out["tg0"] = tmodels.load_generator(cfg, g_params, "cpu")
    return out


def test_train_step_3src_pit_geometry_matches_jax(pit3_run):
    cfg = pit3_run["cfg"]
    assert (cfg.data.num_sources, cfg.dsp.mask_activation, cfg.loss.recon_domain,
            cfg.loss.use_pit, cfg.model.generator, cfg.model.g_head_mode) == \
        (3, "softmax", "spec", True, "bilstm", "film")
    assert cfg.num_frames == 122
    _check_run(pit3_run)


def test_the_best_permutation_is_clear(pit3_run):
    """The premise of the step test: on the pooled log-magnitude grid the
    identity beats the other 5 permutations by a wide margin at step 1."""
    from gan_sass_tf_tpu_torch.ops import dispatch as ops
    cfg = pit3_run["cfg"]
    src = torch.from_numpy(pit3_run["sources"][0])
    feats = ops.stft_features(src.sum(1), cfg.dsp, emit=("mag", "logmag"))
    with torch.no_grad():
        masks = pit3_run["tg0"](feats["logmag"])
    est = torch.log(masks * feats["mag"][:, None] + cfg.dsp.eps)
    tgt = ops.stft_features(src, cfg.dsp, emit=("logmag",))["logmag"]
    pl = pairwise_losses(pool4(est), pool4(tgt), "l1")              # (B, S, S)
    per_perm = torch.stack([pl[:, np.arange(3), p].mean(-1)
                            for p in permutations_for(3)], dim=-1)  # (B, 6)
    best, second = per_perm.sort(dim=-1).values[:, :2].T
    assert (per_perm.argmin(-1) == 0).all()
    assert ((second - best) > 0.1 * best).all(), per_perm


def test_optimizer_clip_and_ema_see_flax_parameters(pit3_run):
    """One trainable bias a gate: the Adam, its global-norm clip and the
    EMA hold exactly the tensors that map onto flax's tree, element for
    element."""
    cfg = _cfg()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, g_ema=0.9))
    state = t_state(cfg, "cpu")
    g_opt, _ = make_optimizers(cfg, state.g, state.d)
    names = dict(zip(g_opt.names, g_opt.params))
    assert names.keys() == state.g_ema.keys() == dict(state.g.named_parameters()).keys()
    flat = tmodels.generator_params_to_flax(names)
    ref = dict(_flat(pit3_run["jstate0"].g_params))
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in ref.items()}
    assert sum(p.numel() for p in g_opt.params) == sum(v.size for v in ref.values())


def test_the_step_moves_every_lstm_gate(pit3_run):
    """Step 1 moved each gate's input and recurrent kernel and its bias in
    every LSTM cell (the step test holds the moves to the reference's)."""
    tg1, _, _ = pit3_run["tstate1"]
    j0 = dict(_flat(pit3_run["jstate0"].g_params))
    moved = [k for k in tg1 if k.startswith("OptimizedLSTMCell_")]
    assert len(moved) == 4 * 12
    for k in moved:
        assert np.abs(tg1[k] - j0[k]).max() > 0, k


def _weights(cfg, seed):
    """The port's seeded G with random biases, and its flax params."""
    tg = tmodels.build_generator(cfg, "cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in tg.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.5, generator=gen)
    return tg, jax.tree.map(jnp.asarray, _nest(tmodels.generator_params_to_flax(
        tg.state_dict())))


@pytest.mark.parametrize("t", [2000, 2100])    # on the frame grid / padded
def test_separate_three_sources_matches_jax(t):
    cfg = _cfg()
    g = jmodels.build_generator(_jax(cfg))
    tg, params = _weights(cfg, 4)
    mix = SyntheticDataset(_jax(cfg), seed=5).batch().sum(axis=1)
    mix = np.concatenate([mix, mix[:, : t - mix.shape[1]]], axis=1)[:, :t]
    hop, n_fft = cfg.dsp.hop_length, cfg.dsp.n_fft
    grid = np.pad(mix, ((0, 0), (0, (n_fft - t) % hop)))     # onto the frame grid
    ref = np.array(jax.jit(j_build_separate_fn(_jax(cfg), g))(
        params, jnp.asarray(grid)))[..., :t]
    ours = infer.separate(tg, cfg, mix, "cpu")
    assert ours.shape == ref.shape == (2, 3, t)
    np.testing.assert_allclose(ours, ref, atol=1e-3 * np.abs(ref).max())
    agree = si_sdr(torch.from_numpy(ours), torch.from_numpy(ref)).numpy()
    assert agree.min() >= 60.0, agree


def _recording(chains, inner):
    """inner, recording what it returns in `chains`."""
    def chain(*args, **kwargs):
        chains.append(inner(*args, **kwargs))
        return chains[-1]
    return chain


@pytest.mark.parametrize("mode,hysteresis", [("batch", 0.0), ("scan", 1e-3)])
def test_streaming_three_sources_matches_jax(monkeypatch, mode, hysteresis):
    """Both streaming modes at S = 3 on 1 s chunks of a 2.5 s mixture, with
    the head's last bias as in the step test so that each chunk's slots
    differ in level; batch mode chains the same permutations.  The scan
    case keeps a margin (JAX matches chunk 0 against its zero carry,
    tests/test_torch_streaming.py)."""
    cfg = _cfg()
    cfg = cfg.replace(stream=dataclasses.replace(
        cfg.stream, chunk_seconds=1.0, batch_chunks=4, perm_hysteresis=hysteresis))
    tg, params = _weights(cfg, 6)
    with torch.no_grad():
        tg.head.convs[3].bias.copy_(torch.from_numpy(HEAD_BIAS))
    params["MaskHead_0"]["Conv_3"]["bias"] = jnp.asarray(HEAD_BIAS)
    wav = SyntheticDataset(_jax(cfg), seed=7).batch()[0] * LEVELS[0]
    wav = np.tile(wav.sum(axis=0), 10)[:20_000]
    if mode == "batch":
        chains = []
        for module in (streaming, j_streaming):
            monkeypatch.setattr(module, "_chain_permutations",
                                _recording(chains, module._chain_permutations))
        ours = infer.separate_streaming(tg, cfg, wav, "cpu")
        ref = np.asarray(j_streaming.separate_streaming(
            params, _jax(cfg), wav, mesh=make_mesh(MeshConfig(data_axis_size=1))))
        assert len(chains) == 2
        np.testing.assert_array_equal(chains[0], chains[1])
    else:
        ours = infer.separate_streaming_scan(tg, cfg, wav, "cpu")
        ref = np.asarray(j_streaming.separate_streaming_scan(params, _jax(cfg), wav))
    assert ours.shape == ref.shape == (3, wav.shape[0])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3 * np.abs(ref).max())

