"""The port's train step against the JAX package's `build_train_step`, from
the same converted init on the same injected sources, plus the optimizer,
the Experiment and CLI entry points.

The configs are small `stream_v5e8` variants, and the `wsj0_logmel` and
`music_complex_44k` presets at narrow widths, in f32 with no gain jitter, no
noise sources and no instance noise, so the JAX step draws no random number
that matters and nothing random has to match across the two frameworks.
Each JAX step is compiled once per module (module-scoped fixtures)."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu.data.synthetic import SyntheticDataset
from gan_sass_tf_tpu.train.state import _lr_schedule as j_lr_schedule
from gan_sass_tf_tpu.train.state import create_train_state
from gan_sass_tf_tpu.train.step import build_train_step as j_build_train_step
from gan_sass_tf_tpu_torch import cli, config
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch.train import (
    ClippedAdam,
    Experiment,
    build_train_step,
    load_train_state,
)
from gan_sass_tf_tpu_torch.train.state import clip_by_global_norm, lr_schedule
from gan_sass_tf_tpu_torch.data import prng_key
from gan_sass_tf_tpu_torch.data.threefry import fold_in
from gan_sass_tf_tpu_torch.train.step import instance_noise

METRICS = ("d_loss", "g_loss", "g_adv", "g_recon", "d_real_logit",
           "d_fake_logit")


_LOSS = {
    "wav": {"recon_domain": "wav"},
    "mag": {"recon_domain": "mag", "recon_loss": "l1", "recon_weight": 100.0},
    # music_complex_44k's form: complex masks, (re, im) L1, no PIT.
    "cspec": {"recon_domain": "cspec", "recon_loss": "l1", "use_pit": False},
}


def _cfg(domain="wav", **train):
    cfg = config.get_config("stream_v5e8")
    mask = "complex" if domain == "cspec" else "magnitude"
    return cfg.replace(
        dsp=dataclasses.replace(cfg.dsp, mask_type=mask),
        model=dataclasses.replace(cfg.model, g_channels=(8, 16),
                                  d_channels=(8, 16), compute_dtype="float32",
                                  dropout=0.0),
        loss=dataclasses.replace(cfg.loss, **_LOSS[domain]),
        train=dataclasses.replace(cfg.train, **{
            "batch_size": 2, "d_instance_noise": 0.0, **train}),
        data=dataclasses.replace(cfg.data, segment_seconds=0.25,
                                 gain_jitter_db=0.0, num_noise=0,
                                 bank_utterances=4))


def _jax(cfg):
    """The same configuration as the JAX package's Config, for its side."""
    return j_config.Config.from_json(cfg.to_json())


def _run_both(cfg, n_steps=2, key=None):
    """`n_steps` steps of each package from one init on the same sources
    under PRNGKey(7) (the port's `key`, by default made from the int): the
    per-step metrics of both, the states after step 1 and after the last
    step."""
    jcfg = _jax(cfg)
    g, d = jmodels.build_generator(jcfg), jmodels.build_discriminator(jcfg)
    jstate = create_train_state(jcfg, g, d, jax.random.PRNGKey(0))
    jstep = jax.jit(j_build_train_step(jcfg, g, d))
    tstate = load_train_state(
        cfg, jax.tree.map(np.asarray, jstate.g_params),
        {"params": jax.tree.map(np.asarray, jstate.d_params),
         "batch_stats": jax.tree.map(np.asarray, jstate.d_batch_stats)}, "cpu")
    tstep, tkey = build_train_step(cfg), prng_key(7) if key is None else key
    ds = SyntheticDataset(jcfg, seed=3)
    out = {"jax": [], "torch": [], "cfg": cfg,
           "jstate0": jax.tree.map(np.asarray, jstate)}
    for i in range(n_steps):
        src = ds.batch()
        jstate, jm = jstep(jstate, jnp.asarray(src), jax.random.PRNGKey(7))
        tstate, tm = tstep(tstate, torch.from_numpy(src), tkey)
        out["jax"].append({k: float(v) for k, v in jm.items()})
        out["torch"].append({k: float(v) for k, v in tm.items()})
        if i == 0:
            out["jstate1"] = jax.tree.map(np.asarray, jstate)
            out["tstate1"] = (
                tmodels.generator_params_to_flax(tstate.g.state_dict()),
                tmodels.discriminator_variables_to_flax(tstate.d.state_dict()),
                None if tstate.g_ema is None else
                tmodels.generator_params_to_flax(tstate.g_ema))
    out["jstate_last"] = jax.tree.map(np.asarray, jstate)
    out["tstate_last"] = (tmodels.generator_params_to_flax(tstate.g.state_dict()),
                          tmodels.discriminator_variables_to_flax(tstate.d.state_dict()))
    out["tstep_last"] = int(tstate.step)
    return out


@pytest.fixture(scope="module")
def wav_run():
    return _run_both(_cfg("wav"))


@pytest.fixture(scope="module")
def mag_run():
    return _run_both(_cfg("mag"))


@pytest.fixture(scope="module")
def cspec_run():
    return _run_both(_cfg("cspec"))


def _narrow_preset(name, channels):
    """A preset itself at narrow widths: its G and D levels `channels` wide,
    f32, batch 2, 0.25 s, no dropout, gain jitter, noise sources or
    instance noise."""
    cfg = config.get_config(name)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, g_channels=channels,
                                  d_channels=channels, compute_dtype="float32",
                                  dropout=0.0),
        train=dataclasses.replace(cfg.train, batch_size=2, d_instance_noise=0.0),
        data=dataclasses.replace(cfg.data, segment_seconds=0.25,
                                 gain_jitter_db=0.0, num_noise=0,
                                 bank_utterances=4))


def _music_cfg():
    """music_complex_44k at its own DSP geometry (44.1 kHz, n_fft 2048, hop
    512, complex masks, cspec L1, no PIT) and its (4, 8) D stem, four G and
    D levels at narrow widths; 0.25 s leaves F = 18 frames."""
    return _narrow_preset("music_complex_44k", (8, 8, 16, 16))


@pytest.fixture(scope="module")
def music_run():
    return _run_both(_music_cfg())


@pytest.fixture(scope="module")
def extras_run():
    """R1, the G EMA and cosine/linear lr schedules, all on at once."""
    return _run_both(_cfg("wav", r1_gamma=1.0, g_ema=0.9,
                          g_lr_schedule="cosine", d_lr_schedule="linear",
                          lr_decay_steps=3))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _check_moves(ours, ref, init, lr, what, flat_share=0.05):
    """Parameters after one Adam step.  Where the reference moved a weight
    by about lr·sign(g) (|move| >= 0.99 lr) the port must agree within
    1e-2·lr.  Elsewhere |g| is within a few eps of 0, where the first
    Adam step g/(|g| + eps) turns on float noise: there the port's move
    must only keep Adam's bound |move| <= lr, and such weights must be
    rare (at most `flat_share` of a tensor)."""
    for k, v in ours:
        a, a0 = ref[k], init[k]
        sharp = np.abs(a - a0) >= 0.99 * lr
        np.testing.assert_allclose(v[sharp], a[sharp], atol=1e-2 * lr, rtol=0,
                                   err_msg=f"{what} {k}")
        assert np.all(np.abs(v - a0)[~sharp] <= lr * (1 + 1e-4)), (what, k)
        assert (~sharp).mean() <= flat_share, (what, k, (~sharp).mean())


def _check_run(run, flat_share=0.05):
    for step, (j, t) in enumerate(zip(run["jax"], run["torch"]), 1):
        for k in METRICS:
            assert np.isfinite(t[k]), (step, k)
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                       err_msg=f"{k} after step {step}")
    cfg, js, j0 = run["cfg"], run["jstate1"], run["jstate0"]
    tg, td, tema = run["tstate1"]
    g_lr, d_lr = cfg.train.g_lr, cfg.train.d_lr
    _check_moves(_flat(tg), dict(_flat(js.g_params)), dict(_flat(j0.g_params)),
                 g_lr, "G", flat_share)
    _check_moves(_flat(td["params"]), dict(_flat(js.d_params)),
                 dict(_flat(j0.d_params)), d_lr, "D")
    stats = dict(_flat(js.d_batch_stats))       # power iteration: no Adam
    for k, v in _flat(td["batch_stats"]):
        np.testing.assert_allclose(v, stats[k], atol=1e-2 * d_lr, rtol=0, err_msg=k)
    if tema is not None:
        # EMA = decay·init + (1 - decay)·params: the same rule, scaled.
        t = 1.0
        decay = min(cfg.train.g_ema, (1.0 + t) / (10.0 + t))
        _check_moves(_flat(tema), dict(_flat(js.g_ema_params)),
                     dict(_flat(j0.g_params)), (1 - decay) * g_lr, "EMA")


def test_train_step_wav_domain_matches_jax(wav_run):
    """stream_v5e8's form: −SI-SDR through the differentiable iSTFT."""
    _check_run(wav_run)


def test_train_step_mag_domain_matches_jax(mag_run):
    """wsj0_logmel's form: linear-magnitude L1, no iSTFT."""
    _check_run(mag_run)


def test_train_step_cspec_complex_masks_match_jax(cspec_run):
    """The complex-mask branch: apply_mask then |·|, (re, im) L1."""
    _check_run(cspec_run)


def test_train_step_music_complex_44k_geometry_matches_jax(music_run):
    cfg = music_run["cfg"]
    assert (cfg.dsp.n_fft, cfg.dsp.hop_length, cfg.num_frames) == (2048, 512, 18)
    assert tuple(cfg.model.d_stem_stride) == (4, 8) and not cfg.loss.use_pit
    # G's deeper levels (F = 18 frames down to 2) get gradients of about
    # 1e-8, where Adam's first step turns on float noise for most weights
    # (the reference moves them by a median 0.8·lr): there only Adam's
    # bound is held, and the second step's metrics show the updates agree.
    _check_run(music_run, flat_share=1.0)


def test_train_step_r1_ema_and_lr_schedules_match_jax(extras_run):
    _check_run(extras_run)
    assert extras_run["tstate1"][2] is not None


TRAJECTORY_STEPS = 12


def _wsj0_cfg():
    """The main path's preset, wsj0_logmel: log-mel features, the `interp`
    head, n_fft 512 at 8 kHz, linear-magnitude L1, PIT and the
    spectral-norm D with its own stem, G and D channels (8, 16)."""
    return _narrow_preset("wsj0_logmel", (8, 16))


_TRAJECTORY_CFGS = {"stream_v5e8": lambda: _cfg("wav"), "wsj0_logmel": _wsj0_cfg}


@pytest.fixture(scope="module", params=sorted(_TRAJECTORY_CFGS))
def trajectory_run(request):
    """TRAJECTORY_STEPS steps of stream_v5e8's step (−SI-SDR through the
    iSTFT, PIT, spectral-norm D) and of wsj0_logmel's (log-mel G input, the
    interp head, linear-magnitude L1, PIT, spectral-norm D), the port's key
    made from a 0-d seed tensor and its step a 0-d tensor, as the captured
    step reads them."""
    return _run_both(_TRAJECTORY_CFGS[request.param](), n_steps=TRAJECTORY_STEPS,
                     key=prng_key(torch.tensor(7, dtype=torch.int64)))


def test_train_trajectory_matches_jax_over_12_steps(trajectory_run):
    """The G, D and recon losses agree within 1e-4 relative at every one of
    12 steps, and after step 12 every G and D parameter within 1e-2·lr of
    the reference's.  Each Adam step moves a weight by about lr·sign(m̂),
    so two trajectories that round float32 sums differently stay within a
    small fraction of lr; a weight caught by the Adam-at-eps trap (|g|
    within a few eps of 0 at step 1, where g/(|g| + eps) turns on float
    noise) would move by up to lr the other way and break this bound."""
    run = trajectory_run
    assert run["tstep_last"] == TRAJECTORY_STEPS
    cfg = run["cfg"]
    if cfg.name == "wsj0_logmel":
        assert (cfg.dsp.sample_rate, cfg.dsp.n_fft, cfg.dsp.feature,
                cfg.model.g_head_mode, cfg.loss.recon_domain, cfg.loss.use_pit,
                cfg.model.d_norm) == (8000, 512, "logmel", "interp", "mag",
                                      True, "spectral")
    for step, (j, t) in enumerate(zip(run["jax"], run["torch"]), 1):
        for k in ("g_loss", "d_loss", "g_recon"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                       err_msg=f"{k} after step {step}")
    js = run["jstate_last"]
    tg, td = run["tstate_last"]
    for ours, ref, lr, what in ((tg, js.g_params, cfg.train.g_lr, "G"),
                                (td["params"], js.d_params, cfg.train.d_lr, "D")):
        ref = dict(_flat(ref))
        for k, v in _flat(ours):
            np.testing.assert_allclose(v, ref[k], atol=1e-2 * lr, rtol=0,
                                       err_msg=f"{what} {k} after step 12")


def test_r1_changes_the_d_update(wav_run, extras_run):
    # Same init and data: the R1 term enters d_loss from the first step.
    assert extras_run["torch"][0]["d_loss"] > wav_run["torch"][0]["d_loss"]


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear"])
def test_lr_schedules_match_optax(kind):
    cfg = _cfg(g_lr_schedule=kind, lr_decay_steps=7, lr_end_factor=0.2)
    ours = lr_schedule(cfg, cfg.train.g_lr, kind)
    ref = j_lr_schedule(_jax(cfg), cfg.train.g_lr, kind)
    for count in range(10):
        want = ref if isinstance(ref, float) else float(ref(count))
        np.testing.assert_allclose(ours(count), want, rtol=1e-6)


@pytest.mark.parametrize("scale", [0.1, 100.0])     # below / above the clip
def test_clipped_adam_matches_optax(rng, scale):
    shapes = [(3, 4), (5,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[scale * rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(2e-4, b1=0.5, b2=0.999))
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = ClippedAdam(tp, lambda c: 2e-4, 5.0, 0.5, 0.999)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(x) for x in g])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("norm", [4.0, 5.0, 6.0])  # below, at, above c = 5
def test_clip_by_global_norm_is_optax_rule(rng, norm):
    g = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    total = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g))
    g = [(x * norm / total).astype(np.float32) for x in g]
    ref, _ = optax.clip_by_global_norm(5.0).update([jnp.asarray(x) for x in g],
                                                   None)
    ours = clip_by_global_norm([torch.from_numpy(x) for x in g], 5.0)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    if norm < 5.0:               # untouched, where torch's rule would scale
        assert all(np.array_equal(a.numpy(), x) for a, x in zip(ours, g))


def test_instance_noise_std_and_determinism():
    x = torch.zeros(64, 10, 9, 2)
    a = instance_noise(x, 0.5, fold_in(prng_key(3), 2))
    b = instance_noise(x, 0.5, fold_in(prng_key(3), 2))
    c = instance_noise(x, 0.5, fold_in(prng_key(3), 3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.std()) - 0.5) < 0.02 and abs(float(a.mean())) < 0.02
    assert instance_noise(x, 0.0, fold_in(prng_key(3), 2)) is x


def _tiny(**train):
    cfg = _cfg("wav", **train)
    return cfg.replace(train=dataclasses.replace(cfg.train, log_every=1))


def test_experiment_trains_both_nets_and_evaluates():
    exp = Experiment(_tiny(), device="cpu")
    g0 = {k: v.clone() for k, v in exp.state.g.state_dict().items()}
    d0 = {k: v.clone() for k, v in exp.state.d.state_dict().items()}
    logged = []
    m = exp.train(num_steps=2, log_fn=lambda s, m: logged.append(s))
    assert logged == [1, 2] and exp.state.step == 2
    assert all(np.isfinite(v) for v in m.values()) and m["mixture_sec_per_sec"] > 0
    assert any(not torch.equal(g0[k], v) for k, v in exp.state.g.state_dict().items())
    assert any(not torch.equal(d0[k], v) for k, v in exp.state.d.state_dict().items())
    ev = exp.evaluate(num_batches=1)
    assert set(ev) == {"si_sdr", "si_sdr_mix", "si_sdr_improvement"}
    assert all(np.isfinite(v) for v in ev.values())


def test_experiment_noise_ema_and_reseed():
    exp = Experiment(_tiny(d_instance_noise=0.1, g_ema=0.5), device="cpu")
    exp.train(num_steps=1)
    ema = exp.eval_g_params
    live = dict(exp.state.g.named_parameters())
    assert set(ema) == set(live)
    assert any(not torch.equal(ema[k], live[k]) for k in live)
    assert np.isfinite(exp.evaluate(num_batches=1)["si_sdr"])
    g1 = exp.state.g.state_dict()["convs.0.weight"].clone()
    exp.reseed(5)
    assert exp.state.step == 0
    assert not torch.equal(exp.state.g.state_dict()["convs.0.weight"], g1)


def test_experiment_refuses_workdir_and_host_batches(tmp_path):
    """What stays refused: a workdir of the JAX package's orbax checkpoints
    (its G loads through --params) and host batches from a corpus root that
    is not there.  A workdir of the port and host batches both train
    (tests/test_torch_checkpoint.py, tests/test_torch_corpus.py)."""
    (tmp_path / "jax" / "checkpoints" / "100").mkdir(parents=True)
    with pytest.raises(ValueError, match="--params"):
        Experiment(_tiny(), workdir=str(tmp_path / "jax"), device="cpu")
    exp = Experiment(_tiny(), workdir=str(tmp_path / "port"), device="cpu")
    exp.train(num_steps=1)
    assert (tmp_path / "port" / "checkpoints" / "1.pt").exists()
    cfg = _tiny()
    host = cfg.replace(data=dataclasses.replace(cfg.data, device_bank=False))
    assert Experiment(host, device="cpu").train(num_steps=1)["g_loss"] != 0.0
    missing = host.replace(data=dataclasses.replace(
        host.data, dataset="wav_dir", data_dir=str(tmp_path / "nowhere")))
    with pytest.raises(FileNotFoundError, match="wav_dir dataset root"):
        Experiment(missing, device="cpu")


_CLI_SET = ["--device", "cpu", "--set", "model.g_channels=8,16",
            "--set", "model.d_channels=8,16", "--set", "train.batch_size=2",
            "--set", "data.segment_seconds=0.25",
            "--set", "data.bank_utterances=4"]


def test_cli_train_and_eval(capsys, tmp_path):
    assert cli.main(["train", "--config", "stream_v5e8", "--steps", "2",
                     *_CLI_SET]) == 0
    out = capsys.readouterr().out
    assert "step 2:" in out and "mix-s/s" in out
    assert cli.main(["eval", "--config", "stream_v5e8", "--batches", "1",
                     *_CLI_SET]) == 0
    assert "si_sdr_improvement" in capsys.readouterr().out
    wd = str(tmp_path / "run")
    assert cli.main(["train", "--config", "stream_v5e8", "--steps", "1",
                     "--workdir", wd, *_CLI_SET]) == 0
    assert (tmp_path / "run" / "checkpoints" / "1.pt").exists()
    assert cli.main(["eval", "--config", "stream_v5e8", "--batches", "1",
                     "--workdir", wd, "--device", "cpu"]) == 0
    assert "si_sdr_improvement" in capsys.readouterr().out
    # --profile-steps (refused before the profiler hooks were ported) now
    # writes a trace of the steps it names.
    prof = tmp_path / "prof"
    assert cli.main(["train", "--config", "stream_v5e8", "--steps", "2",
                     "--workdir", str(prof), "--profile-steps", "1:2",
                     *_CLI_SET]) == 0
    assert list((prof / "profile").glob("*.pt.trace.json"))
