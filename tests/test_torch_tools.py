"""The port's CLI and tools against the JAX package's: the profiler hooks
and --profile-steps, the TensorBoard mirror, entry(), stream_quality, the
row tools (bench_presets, bench_streaming_compute, profile_step), the
queue runner, train_wavdir_fixture and the quickstart, each at a tiny
size on the CPU."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses
import importlib.util
import json
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu import models as jmodels
from gan_sass_tf_tpu.config import MeshConfig
from gan_sass_tf_tpu.infer import streaming as j_streaming
from gan_sass_tf_tpu.losses.metrics import pit_si_sdr as j_pit_si_sdr
from gan_sass_tf_tpu.parallel import make_mesh
from gan_sass_tf_tpu.train.step import build_separate_fn as j_build_separate_fn
from gan_sass_tf_tpu.utils.metrics_writer import MetricsWriter as JMetricsWriter
from gan_sass_tf_tpu.utils.profiler import parse_profile_steps as j_parse_profile_steps
from gan_sass_tf_tpu_torch import cli, config
from gan_sass_tf_tpu_torch import models as tmodels
from gan_sass_tf_tpu_torch import train as ttrain
from gan_sass_tf_tpu_torch.entry import entry
from gan_sass_tf_tpu_torch.examples import quickstart
from gan_sass_tf_tpu_torch.scripts import (
    bench_presets,
    bench_streaming_compute,
    profile_step,
    quality_protocol,
    run_queue,
    stream_quality,
    train_wavdir_fixture,
)
from gan_sass_tf_tpu_torch.train import Experiment
from gan_sass_tf_tpu_torch.utils import profiler, tb_events
from gan_sass_tf_tpu_torch.utils.metrics_writer import MetricsWriter

STEP_RANGES = profiler.STEP_RANGES

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--set", "model.g_channels=8,16", "--set", "model.d_channels=8,16",
        "--set", "train.batch_size=2", "--set", "data.segment_seconds=0.25",
        "--set", "data.bank_utterances=4"]


def _jax(cfg):
    """The same configuration as the JAX package's Config, for its side."""
    return j_config.Config.from_json(cfg.to_json())


def _tiny_stream():
    cfg = config.get_config("stream_v5e8")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, g_channels=(8, 16), d_channels=(8, 16)),
        train=dataclasses.replace(cfg.train, batch_size=2, log_every=1),
        data=dataclasses.replace(cfg.data, segment_seconds=0.25, bank_utterances=4),
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1))


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _jax_script_keys(rows, script):
    """Every key of `rows` is a quoted key of the JAX script `script`."""
    src = (ROOT / "scripts" / script).read_text()
    return all(f'"{k}"' in src for row in rows for k in row)


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["0:1", "2:4", "10:250"])
def test_parse_profile_steps_matches_jax(spec):
    assert profiler.parse_profile_steps(spec) == j_parse_profile_steps(spec)


def test_train_profile_steps_writes_a_trace_of_those_steps(tmp_path):
    """train(4, profile_steps=(1, 3)) with a workdir: one Chrome trace
    under <workdir>/profile holding ProfilerStep#1 and #2 and the step's
    ranges inside them (tests/test_checkpoint.py's JAX case)."""
    exp = Experiment(_tiny_stream(), workdir=str(tmp_path / "run"), device="cpu")
    exp.train(num_steps=4, profile_steps=(1, 3))
    exp.close()
    traces = profiler.trace_files(str(tmp_path / "run" / "profile"))
    assert len(traces) == 1
    events = profiler.load_trace(traces[0])
    steps = profiler.annotations(events, profiler.STEP_PREFIX)
    assert sorted(e["name"] for e in steps) == ["ProfilerStep#1", "ProfilerStep#2"]
    names = {e["name"] for e in profiler.annotations(events)}
    assert set(STEP_RANGES) <= names
    buckets = profiler.attribute(events, STEP_RANGES, steps)
    assert set(STEP_RANGES) <= set(buckets)
    # Without a workdir nothing is traced, as in the JAX Experiment.
    Experiment(_tiny_stream(), device="cpu").train(num_steps=2, profile_steps=(0, 2))


def test_attribute_takes_the_innermost_range_by_launch():
    """A device event goes to the latest-starting range holding its launch
    time, whatever its own start; events outside `within` are left out."""
    def ann(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}

    def kernel(ts, corr, launch):
        return [{"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": 2.0,
                 "args": {"correlation": corr}},
                {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                 "ts": launch, "dur": 1.0, "args": {"correlation": corr}}]

    events = [ann("ProfilerStep#0", 0, 100), ann("g_bwd", 10, 50), ann("dsp", 20, 5),
              *kernel(200, 1, 22), *kernel(300, 2, 40), *kernel(400, 3, 80),
              *kernel(500, 4, 150)]
    within = profiler.annotations(events, profiler.STEP_PREFIX)
    assert profiler.attribute(events, STEP_RANGES, within) == {
        "dsp": 2.0, "g_bwd": 2.0, "other": 2.0}


def test_device_work_leaves_out_the_ranges_spans():
    """The step's ranges and NCCL's host ops also appear as device-side
    spans in key_averages(); device_work keeps the kernels alone."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def avg(key, device=DeviceType.CUDA, annotation=False):
        return SimpleNamespace(key=key, device_type=device,
                               is_user_annotation=annotation)

    events = [avg("g_bwd"), avg("ProfilerStep#3"), avg("nccl:all_reduce"),
              avg("my_range", annotation=True), avg("aten::mm", DeviceType.CPU),
              avg("void stft_features_kernel<false>"), avg("Memcpy HtoD")]
    prof = SimpleNamespace(key_averages=lambda: events)
    assert [e.key for e in profiler.device_work(prof)] == [
        "void stft_features_kernel<false>", "Memcpy HtoD"]


# ---------------------------------------------------------------------------
# The TensorBoard mirror
# ---------------------------------------------------------------------------

WRITES = [(0, {"g_loss": 1.5, "d_loss": -2.25, "n": 3}),
          (3, {"g_loss": 0.1, "eval_si_sdr": 1e-8, "note": "text"}),
          (7, {"mixture_sec_per_sec": 123456.789, "big": 3.4e38})]


def _tensorboard_triples(logdir):
    """(tag, step, f32 value) of every scalar tensorboard's own loader reads
    under `logdir`, simple_value migrated to tf.summary's tensor form."""
    from tensorboard import data_compat
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader
    from tensorboard.util import tensor_util

    out = []
    for path in sorted(pathlib.Path(logdir).glob("events.out.tfevents.*")):
        for event in EventFileLoader(str(path)).Load():
            for value in event.summary.value:
                value = data_compat.migrate_value(value)
                arr = tensor_util.make_ndarray(value.tensor)
                out.append((value.tag, event.step, np.float32(arr)))
    return out


def test_tensorboard_mirror_reads_back_as_jax_writes(tmp_path):
    """The same writes through both MetricsWriters: tensorboard's loader
    reads the same (tag, step, value) triples from the port's event file
    as from the JAX writer's tf.summary file, in f32, and the port's own
    reader reads both; JSONL stays as the JAX writer writes it."""
    for name, writer in (("jax", JMetricsWriter), ("port", MetricsWriter)):
        w = writer(str(tmp_path / name / "m.jsonl"), str(tmp_path / name / "tb"))
        for step, m in WRITES:
            w.write(step, m)
        w.close()
    port = _tensorboard_triples(tmp_path / "port" / "tb")
    assert port == _tensorboard_triples(tmp_path / "jax" / "tb")
    assert len(port) == 7                               # the string is not mirrored
    for name in ("jax", "port"):
        ours = [(tag, step, np.float32(v)) for step, tag, v in
                tb_events.read_dir(str(tmp_path / name / "tb"))]
        assert ours == port
    rows = [{k: v for k, v in json.loads(ln).items() if k != "time"}
            for name in ("jax", "port")
            for ln in (tmp_path / name / "m.jsonl").read_text().splitlines()]
    assert rows[:3] == rows[3:]


def test_event_file_framing(tmp_path):
    """The CRC32C of the TFRecord framing on the standard check value; a
    record read back; a flipped bit fails its CRC."""
    assert tb_events.crc32c(b"123456789") == 0xE3069283
    data = tb_events.encode_event(1.0, 5, {"a": 2.0})
    rec = bytearray(tb_events.record(data))
    assert rec[12:-4] == data
    path = tmp_path / "events.out.tfevents.0.host"
    path.write_bytes(bytes(rec))
    assert tb_events.read_scalars(str(path)) == [(5, "a", 2.0)]
    rec[14] ^= 1
    path.write_bytes(bytes(rec))
    with pytest.raises(ValueError, match="CRC"):
        tb_events.read_scalars(str(path))


def test_experiment_tensorboard_equals_metrics_jsonl(tmp_path):
    wd = tmp_path / "run"
    exp = Experiment(_tiny_stream(), workdir=str(wd), device="cpu", tensorboard=True)
    exp.train(num_steps=3)
    exp.close()
    scalars = {(step, tag): v for step, tag, v in tb_events.read_dir(str(wd / "tb"))}
    rows = [json.loads(ln) for ln in (wd / "metrics.jsonl").read_text().splitlines()]
    want = {(r["step"], k): v for r in rows for k, v in r.items()
            if k not in ("step", "time")}
    assert len(want) >= 3 * 7
    assert set(scalars) == set(want)
    for key, v in want.items():
        assert scalars[key] == float(np.float32(v)), key


# ---------------------------------------------------------------------------
# The CLI's train flags
# ---------------------------------------------------------------------------

def test_cli_train_flags_reach_experiment(tmp_path, monkeypatch):
    seen = []

    class Recording(Experiment):
        def __init__(self, *args, **kwargs):
            seen.append(kwargs)
            super().__init__(*args, **kwargs)

        def train(self, *args, **kwargs):
            seen.append(kwargs)
            return super().train(*args, **kwargs)

    monkeypatch.setattr(ttrain, "Experiment", Recording)
    wd = tmp_path / "run"
    assert cli.main(["train", "--config", "stream_v5e8", "--steps", "3", "--workdir",
                     str(wd), "--profile-steps", "1:2", "--tensorboard",
                     "--debug-nans", "--debug-leaks", "--device", "cpu", *TINY]) == 0
    assert {k: seen[0][k] for k in ("debug_nans", "debug_leaks", "tensorboard")} == {
        "debug_nans": True, "debug_leaks": True, "tensorboard": True}
    assert seen[1]["profile_steps"] == (1, 2)
    assert profiler.trace_files(str(wd / "profile"))
    assert tb_events.read_dir(str(wd / "tb"))
    assert cli.main(["train", "--config", "stream_v5e8", "--steps", "1", "--device",
                     "cpu", *TINY]) == 0
    assert {k: seen[2][k] for k in ("debug_nans", "debug_leaks", "tensorboard")} == {
        "debug_nans": False, "debug_leaks": False, "tensorboard": False}
    assert seen[3]["profile_steps"] is None


# ---------------------------------------------------------------------------
# entry()
# ---------------------------------------------------------------------------

def test_entry_matches_jax_entry(rng):
    """entry(device="cpu") on the JAX entry's G (stream_v5e8 at full width,
    bf16, carried across with models/convert.py) and a seeded (4, T)
    mixture: the JAX entry's output within 1e-3·max|y|."""
    import __graft_entry__

    j_fn, (j_params, j_mix) = __graft_entry__.entry()
    fn, (g, mixture) = entry(device="cpu")
    assert tuple(mixture.shape) == tuple(j_mix.shape) and not mixture.abs().max()
    out = fn(g, mixture)
    assert tuple(out.shape) == (4, 2, mixture.shape[1])
    assert bool(torch.isfinite(out).all())
    mix = (0.3 * rng.standard_normal(j_mix.shape)).astype(np.float32)
    ref = np.asarray(jax.jit(j_fn)(j_params, jnp.asarray(mix)))
    g_jax = tmodels.load_generator(config.get_config("stream_v5e8"),
                                   jax.tree.map(np.asarray, j_params), "cpu")
    ours = fn(g_jax, torch.from_numpy(mix)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3 * np.abs(ref).max())


def test_dryrun_multichip_runs_a_step_over_two_ranks(capfd):
    """entry.dryrun_multichip delegates to parallel/dryrun.py (two gloo
    ranks here; NCCL with one GPU a rank by default)."""
    from gan_sass_tf_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip(2): ok" in capfd.readouterr().out


def test_entry_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        entry()


# ---------------------------------------------------------------------------
# stream_quality
# ---------------------------------------------------------------------------

SR = 8000


def _stream_cfg(perm_hysteresis=0.0):
    cfg = config.get_config("2src_toy_cpu")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, g_channels=(8, 16)),
        stream=dataclasses.replace(cfg.stream, chunk_seconds=1.0, batch_chunks=4,
                                   perm_hysteresis=perm_hysteresis))


def _tone_parts():
    """Three segments of two tones, one a source, at other gains each."""
    parts = []
    for i, (a, b) in enumerate(((0.5, 0.3), (0.2, 0.6), (0.4, 0.4))):
        n = np.arange(int((1.5 + 0.25 * i) * SR)) / SR
        src = np.stack([a * np.sin(2 * np.pi * 300 * n),
                        b * np.sin(2 * np.pi * 1500 * n)]).astype(np.float32)
        parts.append((src.sum(0), src))
    return parts


@pytest.mark.parametrize("perm_hysteresis", [0.0, 1e-3])
def test_stream_quality_matches_jax_on_the_same_stream(perm_hysteresis):
    """The stream builder and SI-SDRi function against the JAX script's
    (inline) ones on the same numpy sources and the same converted G, for
    the one-shot and both streaming separations, with argmin chaining and
    with the hysteresis of the JAX script's older default: within 0.01 dB."""
    cfg = _stream_cfg(perm_hysteresis)
    jcfg = _jax(cfg)
    jg = jmodels.build_generator(jcfg)
    params = jg.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 16, cfg.dsp.feature_dim), jnp.float32))["params"]
    g = tmodels.load_generator(cfg, jax.tree.map(np.asarray, params), "cpu")
    parts, gap = _tone_parts(), int(stream_quality.GAP_SECONDS * SR)

    mixture, targets = stream_quality.long_stream(parts, gap)
    # The JAX script's builder, inline there.
    mix_parts, tgt_parts = [], []
    for i, (m, t) in enumerate(parts):
        mix_parts.append(m)
        tgt_parts.append(t)
        if i != len(parts) - 1:
            mix_parts.append(np.zeros(gap, np.float32))
            tgt_parts.append(np.zeros((t.shape[0], gap), np.float32))
    np.testing.assert_array_equal(mixture, np.concatenate(mix_parts, axis=-1))
    np.testing.assert_array_equal(targets, np.concatenate(tgt_parts, axis=-1))

    def j_sisdri(est):          # the JAX script's, inline there
        tgt = jnp.asarray(targets)[None]
        t = min(est.shape[-1], targets.shape[-1])
        si = float(j_pit_si_sdr(jnp.asarray(est)[None, :, :t], tgt[:, :, :t]).mean())
        mix_rep = jnp.broadcast_to(jnp.asarray(mixture)[None, None, :t],
                                   (1, targets.shape[0], t))
        return si - float(j_pit_si_sdr(mix_rep, tgt[:, :, :t]).mean())

    ours = stream_quality.separate_three_ways(g, cfg, mixture, "cpu")
    one = np.asarray(jax.jit(j_build_separate_fn(jcfg, jg))(
        params, jnp.asarray(mixture[None])))[0][..., : mixture.shape[-1]]
    ref = (one,
           np.asarray(j_streaming.separate_streaming(
               params, jcfg, mixture, mesh=make_mesh(MeshConfig(data_axis_size=1)))),
           np.asarray(j_streaming.separate_streaming_scan(params, jcfg, mixture)))
    for o, r in zip(ours, ref):
        got = stream_quality.si_sdr_improvement(o, targets, mixture)
        assert abs(got - j_sisdri(r)) <= 0.01
        assert abs(got - stream_quality.si_sdr_improvement(r, targets, mixture)) <= 0.01
        assert abs(j_sisdri(o) - j_sisdri(r)) <= 0.01


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_parts_are_the_jax_scripts_segments(seed):
    """`stream_parts` of a seeded stream-hard experiment against the JAX
    script's own loop (`scripts/stream_quality.py`: the experiment's eval
    dataset, `batch()[:1]`, mixed under PRNGKey(7000 + i)) on the eval
    dataset the JAX `Experiment.reseed(seed)` makes: mixtures and scaled
    sources within 1e-5 of the largest sample."""
    from gan_sass_tf_tpu.data import make_dataset as j_make_dataset
    from gan_sass_tf_tpu.data.mixer import mix_sources as j_mix_sources

    cfg = quality_protocol.protocol_config(
        "stream_v5e8", True, [a for a in TINY if a != "--set"])
    jcfg = _jax(cfg)
    exp = Experiment(cfg, device="cpu")
    exp.reseed(seed)
    ours = stream_quality.stream_parts(exp, n=3)
    j_eval = j_make_dataset(jcfg, seed=seed + 9999, split=jcfg.data.eval_split)
    for i, (mixture, scaled) in enumerate(ours):
        sources = jnp.asarray(j_eval.batch())[:1]
        ref_mix, ref_scaled = jax.jit(j_mix_sources, static_argnums=2)(
            sources, jax.random.PRNGKey(7_000 + i), jcfg.data)
        ref_mix, ref_scaled = np.asarray(ref_mix[0]), np.asarray(ref_scaled[0])
        assert mixture.shape == ref_mix.shape and scaled.shape == ref_scaled.shape
        tol = 1e-5 * float(np.abs(ref_scaled).max())
        np.testing.assert_allclose(mixture, ref_mix, atol=tol, rtol=0)
        np.testing.assert_allclose(scaled, ref_scaled, atol=tol, rtol=0)


def test_stream_quality_run_prints_the_jax_keys(capsys):
    assert stream_quality.main(["2", "--device", "cpu", *TINY]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert len(rows) == 1 and _jax_script_keys(rows, "stream_quality.py")
    assert len(rows[0]) == 11 and rows[0]["hard"] and rows[0]["steps"] == 2
    assert all(math.isfinite(v) for v in rows[0].values() if isinstance(v, float))


def test_stream_quality_saves_its_g_and_stream(capsys, monkeypatch, tmp_path):
    """Under STREAM_QUALITY_SAVE the run saves its trained G and its stream;
    `--load` separates that stream with that G again, untrained, and prints
    the run's line: the same SI-SDRi in every mode within 0.01 dB."""
    path = tmp_path / "g.pt"
    monkeypatch.setenv("STREAM_QUALITY_SAVE", str(path))
    assert stream_quality.main(["2", "--device", "cpu", "--seed", "1", *TINY]) == 0
    (row,) = _json_lines(capsys.readouterr().out)
    monkeypatch.delenv("STREAM_QUALITY_SAVE")
    assert stream_quality.main(["--load", str(path), "--device", "cpu"]) == 0
    (again,) = _json_lines(capsys.readouterr().out)
    assert set(again) == set(row) and (again["seed"], again["steps"]) == (1, 2)
    for k, v in row.items():
        if isinstance(v, float):
            assert abs(again[k] - v) <= 0.01, k
        else:
            assert again[k] == v, k
    # The loaded G carries the saved weights, not a fresh G's.
    saved = torch.load(path, weights_only=False)
    cfg, _, _, _, g, _, _ = stream_quality.load_run(str(path), torch.device("cpu"))
    fresh = tmodels.build_generator(cfg, torch.device("cpu"), seed=1).state_dict()
    assert cfg.model.g_channels == (8, 16)
    assert all(torch.equal(g.state_dict()[k], v) for k, v in saved["g"].items())
    assert not all(torch.equal(fresh[k], v) for k, v in saved["g"].items())


# ---------------------------------------------------------------------------
# The row tools
# ---------------------------------------------------------------------------

def test_bench_presets_rows(capsys, monkeypatch):
    monkeypatch.setattr(bench_presets, "STREAM_SECONDS", 4)    # 60 s on the card
    assert bench_presets.PRESET_STEPS == {
        "2src_toy_cpu": (5, 50), "wsj0_logmel": (5, 100), "3src_pit": (3, 30),
        "music_complex_44k": (3, 50), "stream_v5e8": (5, 100)}
    assert bench_presets.main(["stream_v5e8", "streaming", "--steps", "1:2",
                               "--device", "cpu", *TINY]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert [r["metric"] for r in rows] == [
        "train_throughput", "streaming_scan_realtime_factor",
        "streaming_batch_realtime_factor"]
    assert _jax_script_keys(rows, "bench_presets.py")
    assert set(rows[0]) == {"preset", "metric", "value", "unit", "step_ms", "batch"}
    assert rows[0]["unit"] == "mixture-sec/sec/cpu" and rows[0]["batch"] == 1
    assert all(r["value"] > 0 for r in rows)


def test_bench_streaming_compute_rows(capsys):
    assert bench_streaming_compute.main(
        ["3", "1", "--device", "cpu", "--set", "model.g_channels=8,16"]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert [r["mode"] for r in rows] == ["scan", "batch"]
    assert _jax_script_keys(rows, "bench_streaming_compute.py")
    assert all(set(r) == {"mode", "ms_per_chunk", "x_realtime", "chunks", "reps",
                          "fetch_ms_subtracted"} and r["chunks"] == 4
               and r["reps"] == 1 for r in rows)


def test_profile_step_rows(capsys, monkeypatch):
    _profile_step_rows(capsys, monkeypatch)


def test_profile_step_rows_host_batches(capsys, monkeypatch):
    """profile_step in host-batch mode (`--set data.device_bank=false`):
    the steps take the POOL host batches drawn ahead; the same line."""
    drawn, host_batch = [], Experiment.host_batch
    monkeypatch.setattr(Experiment, "host_batch",
                        lambda self: drawn.append(1) or host_batch(self))
    _profile_step_rows(capsys, monkeypatch, "--set", "data.device_bank=false")
    assert len(drawn) == profile_step.POOL


def _profile_step_rows(capsys, monkeypatch, *sets):
    monkeypatch.setattr(profile_step, "WARMUP", 1)             # 3 and 10 on the card
    monkeypatch.setattr(profile_step, "STEPS", 2)
    assert profile_step.main(["stream_v5e8", "2", "--device", "cpu", *TINY, *sets]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert len(rows) == 1 and _jax_script_keys(rows, "profile_step.py")
    row = rows[0]
    assert set(row) == {"preset", "batch", "device_ms_per_step",
                        "buckets_us_per_step", "top_ops_us_per_step"}
    buckets = row["buckets_us_per_step"]
    assert set(STEP_RANGES) <= set(buckets) <= set(STEP_RANGES) | {"other"}
    assert sum(buckets.values()) == pytest.approx(row["device_ms_per_step"] * 1e3)
    assert buckets.get("other", 0.0) <= 0.05 * sum(buckets.values())


# ---------------------------------------------------------------------------
# The queue runner
# ---------------------------------------------------------------------------

def _load_jax_runner():
    spec = importlib.util.spec_from_file_location(
        "jax_run_queue", ROOT / "scripts" / "run_queue.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_run_queue_skips_and_runs_the_tags_the_jax_runner_does(tmp_path, monkeypatch):
    queue = "\n".join([
        "# a comment", "", "done_a | echo never",
        'new_b | echo \'{"v": 1}\'', "new_c | exit 3", "no pipe on this line",
        "new_b | echo duplicate tag", "new_d | echo plain text"])
    records = {}
    for name, module in (("jax", _load_jax_runner()), ("port", run_queue)):
        results = tmp_path / name / "results"
        results.mkdir(parents=True)
        (results / "r4_results.jsonl").write_text(json.dumps({"tag": "done_a"}) + "\n")
        (results / "r9_queue.txt").write_text(queue)
        (results / "r9_queue.CLOSE").write_text("")
        monkeypatch.setattr(module, "RESULTS", str(results))
        monkeypatch.setattr(module, "REPO", str(tmp_path / name))
        monkeypatch.setattr(sys, "argv", ["run_queue.py", "r9"])
        assert module.main() == 0
        records[name] = [{k: v for k, v in json.loads(ln).items() if k != "wall_s"}
                         for ln in (results / "r9_results.jsonl").read_text().splitlines()]
        assert module.done_tags() == {"done_a", "new_b", "new_c", "new_d"}
    assert [r["tag"] for r in records["port"]] == ["new_b", "new_c", "new_d"]
    assert records["port"] == records["jax"]


# ---------------------------------------------------------------------------
# train_wavdir_fixture and the quickstart
# ---------------------------------------------------------------------------

def test_train_wavdir_fixture_run(capsys):
    out = train_wavdir_fixture.run(
        2, "cpu", ["model.g_channels=8,16", "model.d_channels=8,16",
                   "train.batch_size=2", "data.segment_seconds=0.5",
                   "train.steps_per_dispatch=1"])
    train_dist = "si_sdr_improvement_train_dist_db"
    assert set(out) == {"run", "steps", "si_sdr_improvement_before_db",
                        "si_sdr_improvement_after_db", "final_g_loss",
                        "final_d_loss", "ok", train_dist}
    assert _jax_script_keys([{k: v for k, v in out.items() if k != train_dist}],
                            "train_wavdir_fixture.py")
    assert math.isfinite(out[train_dist])
    assert out["ok"] == (out[train_dist] >= train_wavdir_fixture.TRAIN_DIST_FLOOR_DB)
    assert math.isfinite(out["final_g_loss"]) and math.isfinite(out["final_d_loss"])
    assert "step 2:" in capsys.readouterr().out


def test_quickstart_trains_and_writes_the_wavs(tmp_path, capsys, monkeypatch):
    full = config.get_config

    def tiny(name):             # stream_v5e8 with G and D (8, 16), 0.5 s segments
        cfg = full(name)
        return cfg.replace(
            model=dataclasses.replace(cfg.model, g_channels=(8, 16), d_channels=(8, 16)),
            data=dataclasses.replace(cfg.data, segment_seconds=0.5, bank_utterances=4))

    monkeypatch.setattr(config, "get_config", tiny)
    assert quickstart.main([str(tmp_path / "qs"), "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step 1:" in out and "eval:" in out
    from gan_sass_tf_tpu_torch.utils.wav_io import read_wav

    sr, mix = read_wav(str(tmp_path / "qs" / "mixture.wav"))
    srcs = [read_wav(str(tmp_path / "qs" / f"source_{i}.wav"))[1] for i in range(2)]
    assert sr == 16000 and all(s.shape == mix.shape for s in srcs)
    assert (tmp_path / "qs" / "checkpoints" / "1.pt").exists()

