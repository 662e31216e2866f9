"""The port's workdir: checkpoints with exact resume, keep_best, the config
fingerprint guard, the metrics file, and the CLI lifecycle from
`train --workdir` to `separate --workdir --streaming` (the cases of
tests/test_checkpoint.py and tests/test_infer.py:185 on the port)."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gan_sass_tf_tpu.utils.metrics_writer import MetricsWriter as JMetricsWriter
from gan_sass_tf_tpu_torch import cli, config
from gan_sass_tf_tpu_torch.train import Experiment
from gan_sass_tf_tpu_torch.utils.metrics_writer import MetricsWriter
from gan_sass_tf_tpu_torch.utils.wav_io import read_wav, write_wav


def _cfg(**train):
    """stream_v5e8 at a small size, with every piece of state a checkpoint
    must carry in play: the EMA, R1, instance noise and decaying lr
    schedules (driven by the optimizers' update counts)."""
    cfg = config.get_config("stream_v5e8")
    train = {"batch_size": 2, "log_every": 1, "ckpt_every": 1000,
             "eval_every": 1000, "eval_batches": 1, "g_ema": 0.9,
             "r1_gamma": 1.0, "d_instance_noise": 0.1,
             "g_lr_schedule": "cosine", "d_lr_schedule": "linear",
             "lr_decay_steps": 6, **train}
    return cfg.replace(
        model=dataclasses.replace(cfg.model, g_channels=(8, 16),
                                  d_channels=(8, 16), compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, **train),
        data=dataclasses.replace(cfg.data, segment_seconds=0.25,
                                 bank_utterances=4))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_same_state(a, b):
    fa, fb = dict(_flat(a.state.state_dict())), dict(_flat(b.state.state_dict()))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if torch.is_tensor(v):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def test_resume_is_bit_identical(tmp_path):
    """4 steps equal 2 steps, a save, a new Experiment on the workdir and 2
    more steps, tensor for tensor: G, D (its spectral-norm u and sigma
    included), both optimizers' mu, nu and count, and the EMA."""
    cfg = _cfg()
    full = Experiment(cfg, device="cpu")
    full.train(num_steps=4)

    wd = str(tmp_path / "run")
    first = Experiment(cfg, workdir=wd, device="cpu")
    first.train(num_steps=2)
    first.close()
    assert os.listdir(os.path.join(wd, "checkpoints")) == ["2.pt"]
    resumed = Experiment(cfg, workdir=wd, device="cpu")
    assert resumed.state.step == 2 and torch.equal(resumed._train_key, full._train_key)
    _assert_same_state(resumed, first)
    resumed.train(num_steps=2)
    assert resumed.state.step == 4
    _assert_same_state(resumed, full)
    sd = resumed.state.state_dict()
    assert {"u0", "sigma0"} <= set(sd["d"]) and sd["g_ema"] is not None
    assert sd["g_opt"]["count"] == sd["d_opt"]["count"] == 4
    assert set(sd["g_opt"]["mu"]) == set(dict(resumed.state.g.named_parameters()))
    # The payload is plain data: it loads with weights_only=True.
    payload = torch.load(os.path.join(wd, "checkpoints", "4.pt"),
                         weights_only=True)
    assert payload["train_seed"] == cfg.train.seed + 1
    resumed.close()

    fresh = Experiment(cfg, workdir=wd, device="cpu", resume=False)
    assert fresh.state.step == 0
    fresh.close()


def test_resume_is_bit_identical_with_bn_d_and_dropout(tmp_path):
    """The model options' state: a patch D with BN (its running mean and
    var in the checkpoint), the frame-folded D input, dropout in G and D
    (keyed by step, so the resumed steps draw the continuous run's masks)
    and the fold G: 1 + 1 resumed step equal 2."""
    base = _cfg()
    cfg = base.replace(model=dataclasses.replace(
        base.model, discriminator="patch", d_norm="batch", d_input_fold=2,
        dropout=0.2, g_stem_mode="fold", g_stem_stride=(1, 2), g_head_mode="fold",
        g_crop_nyquist=False))
    full = Experiment(cfg, device="cpu")
    full.train(num_steps=2)
    wd = str(tmp_path / "run")
    first = Experiment(cfg, workdir=wd, device="cpu")
    first.train(num_steps=1)
    first.close()
    resumed = Experiment(cfg, workdir=wd, device="cpu")
    _assert_same_state(resumed, first)
    resumed.train(num_steps=1)
    _assert_same_state(resumed, full)
    sd = resumed.state.state_dict()["d"]
    assert {"norms.0.mean", "norms.0.var"} <= set(sd) and not any(
        k.startswith("u") for k in sd)
    assert not torch.equal(sd["norms.0.var"], torch.ones_like(sd["norms.0.var"]))
    resumed.close()


def test_keep_best_checkpoint(tmp_path):
    """The state with the best held-out SI-SDRi is kept under best/ with
    best.json (equal to the best eval row of metrics.jsonl); restore_best
    loads it; a new Experiment resumes from the newest checkpoint and
    re-reads the best metric; checkpoints/ keeps the newest 3."""
    cfg = _cfg(eval_every=3, ckpt_every=2)
    wd = tmp_path / "run"
    exp = Experiment(cfg, workdir=str(wd), device="cpu")
    exp.train(num_steps=9)
    best = json.loads((wd / "best.json").read_text())
    assert best["step"] % 3 == 0 and 0 < best["step"] <= 9
    evals = {}
    for line in (wd / "metrics.jsonl").read_text().splitlines():
        row = json.loads(line)
        if "eval_si_sdr_improvement" in row:
            evals[row["step"]] = row["eval_si_sdr_improvement"]
    assert sorted(evals) == [3, 6, 9]
    assert best["eval_si_sdr_improvement"] == pytest.approx(max(evals.values()),
                                                            abs=1e-6)
    assert os.listdir(wd / "best") == [f"{best['step']}.pt"]
    assert sorted(os.listdir(wd / "checkpoints")) == ["6.pt", "8.pt", "9.pt"]
    assert exp.restore_best() == best["step"] == exp.state.step
    exp.close()

    again = Experiment(cfg, workdir=str(wd), device="cpu")
    assert again.state.step == 9
    assert again._best_metric == pytest.approx(best["eval_si_sdr_improvement"],
                                               abs=1e-6)
    again.close()
    with pytest.raises(FileNotFoundError, match="no best checkpoint"):
        Experiment(cfg, device="cpu").restore_best()


def test_config_fingerprint_guard(tmp_path):
    wd = str(tmp_path / "run")
    exp = Experiment(_cfg(), workdir=wd, device="cpu")
    exp.train(num_steps=1)
    exp.close()
    with pytest.raises(ValueError, match="different config"):
        Experiment(_cfg(ckpt_every=5), workdir=wd, device="cpu")


def test_fingerprint_tolerates_added_default_fields(tmp_path):
    """A workdir written before a default-valued field existed still
    resumes; a saved key the schema no longer has is a mismatch."""
    wd = str(tmp_path / "run")
    cfg = _cfg()
    exp = Experiment(cfg, workdir=wd, device="cpu")
    exp.train(num_steps=2)
    exp.close()
    cfg_path = os.path.join(wd, "config.json")
    with open(cfg_path) as f:
        saved = json.load(f)
    assert saved["model"].pop("g_remat") is False
    with open(cfg_path, "w") as f:
        json.dump(saved, f)
    assert Experiment(cfg, workdir=wd, device="cpu").state.step == 2
    saved["model"]["retired_knob"] = 1
    with open(cfg_path, "w") as f:
        json.dump(saved, f)
    with pytest.raises(ValueError, match="different config"):
        Experiment(cfg, workdir=wd, device="cpu")


def test_metrics_jsonl_written(tmp_path):
    wd = str(tmp_path / "run")
    exp = Experiment(_cfg(eval_every=2), workdir=wd, device="cpu")
    exp.train(num_steps=3)
    exp.close()
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines if "g_loss" in r] == [1, 2, 3]
    assert [r["step"] for r in lines if "eval_si_sdr" in r] == [2]
    assert all("g_loss" in r or "eval_si_sdr" in r for r in lines)
    assert all(r["mixture_sec_per_sec"] > 0 for r in lines if "g_loss" in r)


def test_metrics_writer_matches_jax(tmp_path):
    rows = [(1, {"g_loss": np.float32(0.5), "tag": "a"}),
            (2, {"eval_si_sdr": torch.tensor(3.25), "n": 4})]
    for cls, name in ((MetricsWriter, "ours"), (JMetricsWriter, "ref")):
        with cls(str(tmp_path / name / "m.jsonl")) as w:
            for step, m in rows:
                w.write(step, m)
    ours, ref = ([json.loads(line) for line in open(tmp_path / n / "m.jsonl")]
                 for n in ("ours", "ref"))
    for a, b in zip(ours, ref, strict=True):
        assert a.pop("time") > 0 and b.pop("time") > 0
        assert a == b


def test_leftover_temporary_checkpoint_is_ignored(tmp_path):
    """A save cut short leaves only `<step>.pt.tmp` (the checkpoint is
    renamed into place whole), and resume takes the newest complete one."""
    wd = tmp_path / "run"
    exp = Experiment(_cfg(ckpt_every=1), workdir=str(wd), device="cpu")
    exp.train(num_steps=2)
    exp.close()
    (wd / "checkpoints" / "3.pt.tmp").write_bytes(b"cut short")
    resumed = Experiment(_cfg(ckpt_every=1), workdir=str(wd), device="cpu")
    assert resumed.state.step == 2
    resumed.train(num_steps=1)
    assert sorted(os.listdir(wd / "checkpoints")) == ["1.pt", "2.pt", "3.pt"]


def test_jax_workdir_is_refused_with_a_pointer_to_params(tmp_path):
    wd = tmp_path / "jax_run"
    (wd / "checkpoints" / "1000" / "state").mkdir(parents=True)
    with pytest.raises(ValueError, match="--params"):
        Experiment(_cfg(), workdir=str(wd), device="cpu")
    assert sorted(p.name for p in wd.iterdir()) == ["checkpoints"]


_CLI_SET = ["--device", "cpu", "--set", "model.g_channels=8,16",
            "--set", "model.d_channels=8,16", "--set", "train.batch_size=2",
            "--set", "data.segment_seconds=0.25", "--set", "data.bank_utterances=4",
            "--set", "train.ckpt_every=2", "--set", "train.eval_every=2",
            "--set", "train.eval_batches=1"]


def test_cli_train_eval_separate_lifecycle(tmp_path, capsys):
    """train --workdir, a resumed train, eval --best, then separate from the
    workdir one-shot and streaming in both modes."""
    wd = str(tmp_path / "run")
    common = ["--config", "stream_v5e8", "--workdir", wd, *_CLI_SET]
    assert cli.main(["train", *common, "--steps", "4"]) == 0
    assert "step 4:" in capsys.readouterr().out
    for name in ("config.json", "best.json", "metrics.jsonl", "checkpoints/2.pt",
                 "checkpoints/4.pt"):
        assert os.path.exists(os.path.join(wd, name)), name
    assert cli.main(["train", *common, "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step 6:" in out
    assert cli.main(["eval", *common, "--batches", "1", "--best"]) == 0
    out = capsys.readouterr().out
    assert "using best checkpoint" in out and "si_sdr_improvement" in out
    assert "ignoring --set" in out

    mix = str(tmp_path / "mix.wav")
    n = np.arange(40_000) / 16_000
    write_wav(mix, 16_000, (0.4 * np.sin(2 * np.pi * 440 * n)
                            + 0.3 * np.sin(2 * np.pi * 1900 * n)).astype(np.float32))
    outs = {}
    for mode in ([], ["--streaming"], ["--streaming", "--streaming-mode", "scan"]):
        out_dir = str(tmp_path / ("sep" + "_".join(mode)))
        assert cli.main(["separate", *common, "--input", mix, "--output-dir",
                         out_dir, *mode]) == 0
        srcs = [read_wav(os.path.join(out_dir, f"mix_src{i}.wav")) for i in range(2)]
        assert all(sr == 16_000 and w.shape == (40_000,) for sr, w in srcs)
        outs[tuple(mode)] = np.stack([w for _, w in srcs])
    assert all(np.abs(o).max() > 1e-3 for o in outs.values())

    for argv in (["separate", "--config", "stream_v5e8", "--device", "cpu",
                  "--input", mix, "--output-dir", wd],
                 ["separate", *common, "--params", "g.npz", "--input", mix,
                  "--output-dir", wd]):
        assert cli.main(argv) == 1
        assert "exactly one of --workdir" in capsys.readouterr().err
    other = ["--config", "wsj0_logmel", "--workdir", wd, "--device", "cpu"]
    assert cli.main(["eval", *other]) == 1
    assert "trained with config 'stream_v5e8'" in capsys.readouterr().err
    empty = ["--config", "stream_v5e8", "--workdir", str(tmp_path / "empty"),
             *_CLI_SET]
    assert cli.main(["separate", *empty, "--input", mix, "--output-dir", wd]) == 1
    assert "no checkpoint" in capsys.readouterr().err
