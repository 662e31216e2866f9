"""The wav_dir fixture trained by both packages on the CPU from one seed:
`scripts/train_wavdir_fixture.py`'s configuration (wsj0_logmel on a
6-speaker fixture corpus, the eval split its last 2 speakers) and the
port's `scripts/train_wavdir_fixture.py`, each given the same `--set`
overrides and the same corpus.  After `steps` steps it prints one JSON
line a package: SI-SDR improvement (dB) on the held-out speakers before
and after, and on the training speakers after (2 eval batches each,
seed + 4242 for the training speakers, as the port's script).

The two packages draw the same numbers from one seed, so a figure on
which they agree is the task's, not the port's.  The fixture's own
widths are too large for a CPU witness: narrow them with `--set`.

    python tests/wavdir_fixture_witness.py [steps] [--set sec.key=val ...]
"""

from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

N_EVAL = 2


def jax_fixture(root: str, overrides):
    """The JAX script's configuration on `root`, then the overrides."""
    from gan_sass_tf_tpu import config
    from gan_sass_tf_tpu.cli import _apply_overrides

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


def figures(exp, make_dataset, steps: int) -> dict:
    t0 = time.perf_counter()
    before = exp.evaluate(num_batches=N_EVAL)["si_sdr_improvement"]
    m = exp.train(num_steps=steps, log_fn=lambda s, mm: None)
    after = exp.evaluate(num_batches=N_EVAL)["si_sdr_improvement"]
    seen = make_dataset(exp.cfg, seed=exp.cfg.train.seed + 4242, split="train")
    train = exp.evaluate(num_batches=N_EVAL, dataset=seen)["si_sdr_improvement"]
    return {"held_out_before_db": round(float(before), 3),
            "held_out_after_db": round(float(after), 3),
            "train_speakers_after_db": round(float(train), 3),
            "final_g_loss": round(float(m["g_loss"]), 4),
            "final_d_loss": round(float(m["d_loss"]), 4),
            "finite": all(math.isfinite(float(v)) for v in m.values()),
            "wall_s": round(time.perf_counter() - t0, 1)}


def main(argv) -> int:
    from gan_sass_tf_tpu.data import make_dataset as jax_make_dataset
    from gan_sass_tf_tpu.data.fixtures import write_fixture_corpus
    from gan_sass_tf_tpu.train import Experiment as JaxExperiment
    from gan_sass_tf_tpu_torch.data import make_dataset as torch_make_dataset
    from gan_sass_tf_tpu_torch.scripts import split_args
    from gan_sass_tf_tpu_torch.scripts.train_wavdir_fixture import fixture_config
    from gan_sass_tf_tpu_torch.train import Experiment as TorchExperiment

    pos, opts = split_args(argv)
    steps, overrides = int(pos[0]) if pos else 500, opts["--set"]
    with tempfile.TemporaryDirectory(prefix="wavdir_witness_") as root:
        write_fixture_corpus(root, n_speakers=6, utts_per_speaker=4,
                             seconds=4.0, sample_rate=8000, seed=7)
        runs = {
            "jax": lambda: figures(JaxExperiment(jax_fixture(root, overrides),
                                                 workdir=None),
                                   jax_make_dataset, steps),
            "torch": lambda: figures(TorchExperiment(fixture_config(root, overrides),
                                                     workdir=None, device="cpu"),
                                     torch_make_dataset, steps)}
        for name, run in runs.items():
            print(json.dumps({"package": name, "steps": steps,
                              "overrides": list(overrides), **run()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
