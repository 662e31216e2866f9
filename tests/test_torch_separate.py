"""The whole one-shot separation slice of the port against the JAX
package's build_separate_fn, plus the scores, the wav/CLI entry points and
the rule that the port imports nothing of JAX."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu.losses.metrics import pit_si_sdr as j_pit_si_sdr
from gan_sass_tf_tpu.train.step import build_separate_fn as j_build_separate_fn
from gan_sass_tf_tpu_torch import cli, config, infer
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch.losses import pit_si_sdr, si_sdr
from gan_sass_tf_tpu_torch.utils.wav_io import read_wav, write_wav

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "gan_sass_tf_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gan_sass_tf_tpu",
             "tensorflow", "tensorboard")


def _cfg(**model):
    cfg = config.get_config("wsj0_logmel")
    model = {"g_channels": (8, 16), "compute_dtype": "float32", **model}
    return cfg.replace(model=dataclasses.replace(cfg.model, **model),
                       dsp=dataclasses.replace(cfg.dsp, n_mels=32))


def _jax(cfg):
    """The same configuration as the JAX package's Config, for its side."""
    return j_config.Config.from_json(cfg.to_json())


def _mixtures(rng, b, t, sr=8000):
    n = np.arange(t) / sr
    tones = [np.sin(2 * np.pi * f * n) for f in (220.0, 1330.0)]
    mix = [0.4 * tones[0] + 0.3 * tones[1] + 0.05 * rng.standard_normal(t)
           for _ in range(b)]
    return np.stack(mix).astype(np.float32)


@pytest.mark.parametrize("t", [4608, 5000])     # on the frame grid / padded
def test_separate_matches_jax_build_separate_fn(rng, t):
    cfg = _cfg()
    g = jmodels.build_generator(_jax(cfg))
    mix = _mixtures(rng, 2, t)
    params = g.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 32)))["params"]
    grid = np.pad(mix, ((0, 0), (0, (512 - t) % 128)))  # onto the frame grid
    ref = np.array(jax.jit(j_build_separate_fn(_jax(cfg), g))(
        params, jnp.asarray(grid)))[..., :t]
    tg = tmodels.load_generator(cfg, jax.tree.map(np.asarray, params), "cpu")
    ours = infer.separate(tg, cfg, mix, "cpu")
    assert ours.shape == ref.shape == (2, 2, t)
    np.testing.assert_allclose(ours, ref, atol=1e-3 * np.abs(ref).max())
    agree = si_sdr(torch.from_numpy(ours), torch.from_numpy(ref)).numpy()
    assert agree.min() >= 60.0, agree


def test_pit_si_sdr_matches_jax(rng):
    est = rng.standard_normal((3, 2, 4000)).astype(np.float32)
    tgt = (est[:, ::-1] + 0.3 * rng.standard_normal((3, 2, 4000))).astype(np.float32)
    ours = pit_si_sdr(torch.from_numpy(est), torch.from_numpy(tgt)).numpy()
    ref = np.asarray(j_pit_si_sdr(jnp.asarray(est), jnp.asarray(tgt)))
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    est3 = rng.standard_normal((2, 3, 1000)).astype(np.float32)
    tgt3 = rng.standard_normal((2, 3, 1000)).astype(np.float32)
    np.testing.assert_allclose(
        pit_si_sdr(torch.from_numpy(est3), torch.from_numpy(tgt3)).numpy(),
        np.asarray(j_pit_si_sdr(jnp.asarray(est3), jnp.asarray(tgt3))),
        atol=1e-4)


def test_separate_single_mixture_squeezes(rng):
    cfg = _cfg()
    g = tmodels.build_generator(cfg, "cpu")
    out = infer.separate(g, cfg, _mixtures(rng, 1, 3000)[0], "cpu")
    assert out.shape == (2, 3000) and np.isfinite(out).all()


def test_separate_file_and_cli_roundtrip(rng, tmp_path):
    cfg = _cfg()
    g = tmodels.build_generator(cfg, "cpu", seed=5)
    params = str(tmp_path / "g.npz")
    tmodels.save_flax_npz(params, g.state_dict())
    wav = str(tmp_path / "mix.wav")
    write_wav(wav, 8000, _mixtures(rng, 1, 6000)[0])
    paths = infer.separate_file(g, cfg, wav, str(tmp_path / "a"), "cpu")
    assert [pathlib.Path(p).name for p in paths] == ["mix_src0.wav", "mix_src1.wav"]
    rc = cli.main(["separate", "--config", "wsj0_logmel", "--params", params,
                   "--input", wav, "--output-dir", str(tmp_path / "b"),
                   "--device", "cpu", "--set", "model.g_channels=8,16",
                   "--set", "model.compute_dtype=float32",
                   "--set", "dsp.n_mels=32"])
    assert rc == 0
    for p in paths:
        sr, a = read_wav(p)
        _, b = read_wav(str(tmp_path / "b" / pathlib.Path(p).name))
        assert sr == 8000 and a.shape == (6000,)
        np.testing.assert_array_equal(a, b)
    write_wav(wav, 16000, np.zeros(4000, np.float32))
    with pytest.raises(ValueError, match="sample rate"):
        infer.separate_file(g, cfg, wav, str(tmp_path / "c"), "cpu")


def test_cli_configs_and_cuda_guard(tmp_path, capsys):
    assert cli.main(["configs"]) == 0
    assert "wsj0_logmel" in capsys.readouterr().out.split()
    if not torch.cuda.is_available():
        rc = cli.main(["separate", "--config", "wsj0_logmel", "--params",
                       str(tmp_path / "none.npz"), "--input", "x.wav",
                       "--output-dir", str(tmp_path)])
        assert rc == 1
        assert "--device cpu" in capsys.readouterr().err


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, not chip_smoke.py and not the ranks' code of
    tests/test_torch_parallel.py imports JAX, its libraries, any module
    of the JAX package (the config included), TensorFlow or tensorboard
    (the card's machine has neither; the port writes its TensorBoard
    event files itself)."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tests" / "_torch_dist_workers.py"]
    assert len(files) > 15
    names = {str(p.relative_to(PORT)) for p in files if PORT in p.parents}
    assert {"infer/streaming.py", "data/corpus.py", "data/fixtures.py",
            "utils/metrics_writer.py", "train/experiment.py",
            "parallel/bootstrap.py", "parallel/mesh.py", "entry.py",
            "utils/profiler.py", "utils/tb_events.py", "scripts/profile_step.py",
            "scripts/stream_quality.py", "scripts/bench_presets.py",
            "scripts/bench_streaming_compute.py", "scripts/train_wavdir_fixture.py",
            "scripts/run_queue.py", "examples/quickstart.py"} <= names
    bad = [f"{path.relative_to(ROOT)}: {mod}" for path in files
           for mod in _imports(path) if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_install_worker_imports_no_jax():
    """What chip_smoke.py's install worker loads (chip_smoke itself and, with
    it, every subpackage of the port, `utils` with profile_trace among them)
    pulls in no forbidden module by any path, and starts no CUDA."""
    code = ("import sys, torch, chip_smoke, gan_sass_tf_tpu_torch.utils; "
            "print(torch.cuda.is_initialized()); "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    cuda, loaded = res.stdout.splitlines()[-2:]
    assert cuda == "False"
    loaded = set(loaded.split())
    assert {"chip_smoke", "gan_sass_tf_tpu_torch"} <= loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
