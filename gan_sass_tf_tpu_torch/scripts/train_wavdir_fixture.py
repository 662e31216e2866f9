"""wav_dir end to end: write a fixture wav corpus, train wsj0_logmel through
the wav_dir dataset and the device bank, and check finite losses and a
positive held-out SI-SDR improvement.

    python -m gan_sass_tf_tpu_torch.scripts.train_wavdir_fixture [steps]
        [--set sec.key=val ...] [--device cuda]

Port of `scripts/train_wavdir_fixture.py`, with its configuration (6
speakers x 4 utterances of 4 s at 8 kHz, a bank of 32, batch 16, bf16,
the spectral-norm D, d_lr 1e-4; default 500 steps) and its JSON line:
  {"run", "steps", "si_sdr_improvement_before_db",
   "si_sdr_improvement_after_db", "final_g_loss", "final_d_loss", "ok"}
Exits 1 unless ok: every final metric finite and the improvement after
training positive.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import tempfile

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.cli import _apply_overrides
from gan_sass_tf_tpu_torch.data.fixtures import write_fixture_corpus
from gan_sass_tf_tpu_torch.scripts import split_args
from gan_sass_tf_tpu_torch.scripts.quality_protocol import device_or_exit


def fixture_config(root: str, overrides=()):
    """wsj0_logmel on the fixture corpus under `root`, as the JAX script
    configures it, then `sec.key=val` overrides."""
    cfg = config.get_config("wsj0_logmel")
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, dataset="wav_dir", data_dir=root,
                                 device_bank=True, bank_utterances=32),
        model=dataclasses.replace(cfg.model, compute_dtype="bfloat16",
                                  d_norm="spectral"),
        train=dataclasses.replace(cfg.train, batch_size=16, d_lr=1e-4,
                                  steps_per_dispatch=10, log_every=100,
                                  eval_every=10 ** 9),
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1))
    return _apply_overrides(cfg, list(overrides))


def run(steps: int = 500, device="cuda", overrides=(), log=print) -> dict:
    """Train `steps` steps on a fresh fixture corpus; the JSON line's dict
    (ok: finite final metrics and a positive improvement after)."""
    from gan_sass_tf_tpu_torch.train import Experiment

    with tempfile.TemporaryDirectory(prefix="wavdir_fixture_") as root:
        write_fixture_corpus(root, n_speakers=6, utts_per_speaker=4,
                             seconds=4.0, sample_rate=8000, seed=7)
        exp = Experiment(fixture_config(root, overrides), workdir=None, device=device)
        ev0 = exp.evaluate(num_batches=2)
        m = exp.train(num_steps=steps, log_fn=lambda s, mm: log(
            f"step {s}: g={mm['g_loss']:.4f} d={mm['d_loss']:.4f} "
            f"({mm.get('mixture_sec_per_sec', 0):.0f} mix-s/s)"))
        ev1 = exp.evaluate(num_batches=2)
    return {
        "run": "wav_dir_fixture_train",
        "steps": steps,
        "si_sdr_improvement_before_db": round(ev0["si_sdr_improvement"], 2),
        "si_sdr_improvement_after_db": round(ev1["si_sdr_improvement"], 2),
        "final_g_loss": round(m["g_loss"], 4),
        "final_d_loss": round(m["d_loss"], 4),
        "ok": (all(math.isfinite(v) for v in m.values())
               and ev1["si_sdr_improvement"] > 0.0),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pos, opts = split_args(argv)
    device = device_or_exit((opts["--device"] or ["cuda"])[-1])
    out = run(int(pos[0]) if pos else 500, device, opts["--set"])
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
