"""A preset of the quality protocol (by default `stream_v5e8 --hard`)
trained by both packages on the CPU from one seed, in f32 at narrow widths:
do their trajectories part, and where?

Each package builds the quality protocol's configuration of the preset,
hard unless `--easy` (the port's `scripts/quality_protocol.protocol_config`,
the JAX side from its JSON), then the preset's narrow overrides below and
the `--set` ones,
and trains it from its own init and train key of the seed, logging every
step.  The two draw the same numbers and start from the same weights
(`tests/test_torch_random.py`), so their losses agree until float
rounding, amplified by the GAN, pulls them apart, or until a fault does.

A control run beside them: the port again, from its init with every G
weight moved by one unit in the last place.  Where the port parts from
JAX no sooner than from that nudge of its own, rounding is enough to
part them.

Prints one JSON line a run (its `d_loss` and `g_loss` at every step, the
held-out SI-SDR improvement after training over EVAL_BATCHES batches,
wall seconds), then one line comparing the port with JAX and with the
control: the first step at which either loss differs by more than 1e-4
relative, the first from which it does so for 10 steps running, the
largest relative gap in each tenth of the run, and the SI-SDR
improvements.

    python tests/stream_gap_witness.py [steps] [--preset NAME] [--easy]
        [--seed N] [--set sec.key=val ...]

Not a tier-1 test: a few hundred steps of both packages take minutes.
"""

from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json  # noqa: E402
import math  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "float32")

EVAL_BATCHES = 4
REL_TOL = 1e-4
LOSS_FLOOR = 1e-2        # losses are compared relative to at least this
SUSTAIN = 10
# Narrow and short enough for the CPU; f32 so that float rounding is all
# that may part the two.  The widths are each preset's: its G and D levels
# kept, each 8 or 16 channels wide (the BiLSTM G 16 hidden units).
NARROW = ("model.compute_dtype=float32", "train.batch_size=4", "data.segment_seconds=0.5",
          "train.log_every=1", "train.steps_per_dispatch=1", "train.eval_every=1000000",
          "train.ckpt_every=1000000", "mesh.data_axis_size=-1")
WIDTHS = {
    "stream_v5e8": ("model.g_channels=8,16", "model.d_channels=8,16"),
    "wsj0_logmel": ("model.g_channels=8,16", "model.d_channels=8,16"),
    "3src_pit": ("model.g_hidden=16", "model.g_film_channels=8",
                 "model.d_channels=8,16"),
    "music_complex_44k": ("model.g_channels=8,8,16,16", "model.d_channels=8,8,16,16"),
}


def run(exp, steps: int) -> dict:
    t0 = time.perf_counter()
    traj = {"d_loss": [], "g_loss": []}

    def log(step, m):
        for k in traj:
            traj[k].append(float(m[k]))

    exp.train(num_steps=steps, log_fn=log)
    ev = exp.evaluate(num_batches=EVAL_BATCHES)
    return {**traj, "si_sdr_improvement": float(ev["si_sdr_improvement"]),
            "wall_s": time.perf_counter() - t0}


def compare(a: dict, b: dict) -> dict:
    """The first step (1-based) where a loss parts by more than REL_TOL
    relative, the first from which it does so for SUSTAIN steps running,
    and the largest relative gap in each tenth of the run.  A loss is
    taken relative to max(|b|, LOSS_FLOOR), so a g_loss that crosses 0
    does not read as a blow-up."""
    gaps = [max(abs(a[k][i] - b[k][i]) / max(abs(b[k][i]), LOSS_FLOOR)
                for k in ("d_loss", "g_loss")) for i in range(len(a["d_loss"]))]
    over = [g > REL_TOL for g in gaps]
    first = next((i + 1 for i, o in enumerate(over) if o), None)
    sustained = next((i + 1 for i in range(len(over) - SUSTAIN + 1)
                      if all(over[i:i + SUSTAIN])), None)
    tenth = max(1, math.ceil(len(gaps) / 10))
    return {"first_step_over_tol": first, "first_step_over_tol_sustained": sustained,
            "rel_tol": REL_TOL, "loss_floor": LOSS_FLOOR, "sustain": SUSTAIN,
            "max_rel_gap_by_tenth": [max(gaps[i:i + tenth])
                                     for i in range(0, len(gaps), tenth)]}


def main(argv) -> int:
    from gan_sass_tf_tpu import config as j_config
    from gan_sass_tf_tpu.train import Experiment as JaxExperiment
    from gan_sass_tf_tpu_torch.scripts import split_args
    from gan_sass_tf_tpu_torch.scripts.quality_protocol import protocol_config
    from gan_sass_tf_tpu_torch.train import Experiment as TorchExperiment

    pos, opts = split_args(argv, ("--set", "--seed", "--preset"))
    hard = "--easy" not in pos
    pos = [a for a in pos if a != "--easy"]
    steps = int(pos[0]) if pos else 300
    seed = int((opts["--seed"] or ["0"])[-1])
    preset = (opts["--preset"] or ["stream_v5e8"])[-1]
    if preset not in WIDTHS:
        raise SystemExit(f"error: --preset {preset}: one of {sorted(WIDTHS)}")
    overrides = list(NARROW) + list(WIDTHS[preset]) + opts["--set"]
    cfg = protocol_config(preset, hard, overrides)
    jcfg = j_config.Config.from_json(cfg.to_json())
    out = {}
    for name in ("jax", "torch", "torch_g_ulp"):
        if name == "jax":
            exp = JaxExperiment(jcfg, workdir=None)
            exp.reseed(seed)
        else:
            exp = TorchExperiment(cfg, workdir=None, device="cpu")
            exp.reseed(seed)
            if name == "torch_g_ulp":
                with torch.no_grad():
                    for p in exp.state.g.parameters():
                        p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
        out[name] = run(exp, steps)
        print(json.dumps({"run": name, "preset": preset, "hard": hard, "steps": steps,
                          "seed": seed, "overrides": overrides, **out[name]}), flush=True)
    print(json.dumps({"compare": "torch vs jax", "preset": preset, "hard": hard,
                      "steps": steps, "seed": seed,
                      **compare(out["torch"], out["jax"])}), flush=True)
    print(json.dumps({"compare": "torch_g_ulp vs torch", "preset": preset, "hard": hard,
                      "steps": steps, "seed": seed,
                      **compare(out["torch_g_ulp"], out["torch"]),
                      "si_sdr_improvement": {k: v["si_sdr_improvement"]
                                             for k, v in out.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
