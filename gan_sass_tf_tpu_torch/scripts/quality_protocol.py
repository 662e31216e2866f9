"""Quality protocol: train a preset, then report the SI-SDR improvement on
held-out mixtures, on the train distribution, and the oracle-mask bound of
the held-out distribution, averaged over seeds.

    python -m gan_sass_tf_tpu_torch.scripts.quality_protocol PRESET [STEPS]
        [--hard] [--seeds 0,7] [--set sec.key=val ...] [--device cuda]

Port of `scripts/quality_protocol.py`, with its arguments, its progress
lines on stderr and the keys of its JSON line.  --hard is the headroom
protocol: shared-f0 synthetic speakers (slot identity by timbre and
modulation only) plus Gaussian noise at 10 dB SNR.  music_complex_44k
gets the vocal/accompaniment slot profiles.  --seeds runs the whole
train/eval once per seed (default seed 0) and reports the mean and the
half-range.  --device is a torch device (default cuda, which fails when no
GPU is visible).

Under torchrun it joins the process group (`parallel.
initialize_distributed`), as the JAX script fits every device into one
data mesh: training and the evals run data parallel over every rank
(`Experiment`), the bound's batches are dealt out to the ranks and their
values summed, and rank 0 alone prints.  One difference from the JAX
script: the bound's i-th batch is mixed with the counter RNG at seed
20 000 + i (`data.mix_sources`) where the JAX script used
jax.random.PRNGKey(20 000 + i): on the same sources the two packages draw
other gains and noise.

Prints one JSON line:
  {"preset":..., "hard":..., "steps":..., "seeds":[...],
   "si_sdr_improvement":<mean>, "si_sdr_improvement_per_seed":[...],
   "si_sdr_improvement_half_range":..., "si_sdr_improvement_train_dist":...,
   "oracle_bound":<mean>, "headroom":..., "d_loss":...,
   "d_loss_traj_per_seed":[...], "d_norm":..., "throughput":...}
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Optional

import torch
import torch.distributed as dist

from gan_sass_tf_tpu_torch import config as config_lib
from gan_sass_tf_tpu_torch.cli import _apply_overrides, _quiet
from gan_sass_tf_tpu_torch.data import make_dataset, mix_sources
from gan_sass_tf_tpu_torch.losses import oracle_bound_si_sdr
from gan_sass_tf_tpu_torch.parallel import DataParallel, run_in_group

BOUND_SEED = 20_000      # the bound's batch i is mixed at seed BOUND_SEED + i


def protocol_config(name: str, hard: bool, overrides=()):
    """The preset on synthetic data under the easy or hard protocol, with
    `sec.key=val` overrides (the JAX script's config, field for field)."""
    cfg = config_lib.get_config(name)
    data_kw = {"dataset": "synthetic"}
    if name == "music_complex_44k":
        data_kw["slot_profiles"] = ("vocal", "accomp")
    if hard:
        data_kw.update(f0_mode="shared", num_noise=1, snr_db=10.0)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, **data_kw),
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1),
    )
    return _apply_overrides(cfg, list(overrides))


def device_or_exit(name: str) -> torch.device:
    """The torch device named by --device; exits when cuda is asked for and
    no GPU is visible."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: --device cuda but no CUDA device is visible "
                         "(pass --device cpu to run on the CPU)")
    return device


@torch.inference_mode()
def mean_oracle_bound(cfg, dataset, device, num_batches: int,
                      dp: Optional[DataParallel] = None) -> float:
    """Mean oracle SI-SDR improvement over `num_batches` fresh batches of
    `dataset`, batch i mixed at seed BOUND_SEED + i.  Data parallel, every
    rank draws every batch (the dataset's stream stays in step) and scores
    those with i % world == rank; the per-batch values are summed over the
    ranks, so every rank returns what one rank would, bit for bit."""
    dp = dp or DataParallel()
    values = torch.zeros(num_batches, dtype=torch.float64, device=device)
    for i in range(num_batches):
        batch = dataset.batch()
        if i % dp.world == dp.rank:
            sources = torch.from_numpy(batch).to(device)
            mixture, scaled = mix_sources(sources, BOUND_SEED + i, 0, cfg.data)
            values[i] = float(oracle_bound_si_sdr(mixture, scaled, cfg.dsp)
                              ["si_sdr_improvement"])
    if dp.group is not None:
        dist.all_reduce(values, op=dist.ReduceOp.SUM, group=dp.group)
    acc = 0.0
    for v in values.tolist():
        acc += v / num_batches
    return acc


def oracle_bound_on_eval(exp, num_batches: int = 4) -> float:
    """Oracle-mask SI-SDRi on the distribution `exp.evaluate()` scores (the
    next batches of its eval dataset)."""
    return mean_oracle_bound(exp.cfg, exp.eval_dataset, exp.device, num_batches,
                             exp.dp)


def in_process_group(device: str, run) -> int:
    """run(device of this rank) inside torchrun's process group when there
    is one, else on `device`; exits when `device` is cuda and no GPU is
    visible."""
    device_or_exit(device)
    return run_in_group(device, run)


def main(argv) -> int:
    hard = "--hard" in argv
    overrides, seeds, device, skip = [], [0], "cuda", set()
    for i, a in enumerate(argv):
        if a == "--set" and i + 1 < len(argv):
            overrides.append(argv[i + 1])
            skip.update((i, i + 1))
        elif a == "--seeds" and i + 1 < len(argv):
            seeds = [int(s) for s in argv[i + 1].split(",")]
            skip.update((i, i + 1))
        elif a == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
            skip.update((i, i + 1))
        elif a.startswith("--"):
            skip.add(i)
    args = [a for i, a in enumerate(argv) if i not in skip]
    preset = args[0] if args else "stream_v5e8"
    steps = int(args[1]) if len(args) > 1 else 10_000

    cfg = protocol_config(preset, hard, overrides)
    return in_process_group(device, lambda dev: _protocol(cfg, preset, hard, steps,
                                                          seeds, dev))


def _protocol(cfg, preset, hard, steps, seeds, device) -> int:
    from gan_sass_tf_tpu_torch.train import Experiment

    exp = Experiment(cfg, workdir=None, device=device)
    say = print if exp.dp.is_main else _quiet

    d_traj: list = []   # (step, d_loss) at every log interval, current seed

    def log(step, m):
        d_traj.append((step, float(m["d_loss"])))
        if step % max(cfg.train.log_every * 10, 1) < cfg.train.log_every:
            say(f"step {step}: g={m['g_loss']:.3f} d={m['d_loss']:.3f} "
                f"thr={m['mixture_sec_per_sec']:.0f}", file=sys.stderr,
                flush=True)

    def traj_summary():
        """d_loss at ~25/50/75/100% of training, the last pick on the
        final entry."""
        if not d_traj:
            return []
        picks = [d_traj[round((len(d_traj) - 1) * q / 4)] for q in (1, 2, 3, 4)]
        return [round(v, 4) for _, v in picks]

    per_seed = []
    for seed in seeds:
        exp.reseed(seed)
        d_traj.clear()
        metrics = exp.train(num_steps=steps, log_fn=log)
        ev = exp.evaluate(num_batches=8)
        bound = oracle_bound_on_eval(exp, num_batches=8)
        # The train-distribution eval beside the held-out one: their gap is
        # the generalization gap.
        tr_ds = make_dataset(cfg, seed=seed + 4242, split="train")
        ev_tr = exp.evaluate(num_batches=8, dataset=tr_ds)
        per_seed.append({
            "seed": seed,
            "si_sdr_improvement": ev["si_sdr_improvement"],
            "si_sdr_improvement_train_dist": ev_tr["si_sdr_improvement"],
            "oracle_bound": bound,
            "d_loss": metrics.get("d_loss", float("nan")),
            "d_loss_traj": traj_summary(),
            "throughput": metrics.get("mixture_sec_per_sec", 0.0),
        })
        say(f"seed {seed}: held-out "
            f"{ev['si_sdr_improvement']:+.2f} dB (train-dist "
            f"{ev_tr['si_sdr_improvement']:+.2f}, bound {bound:.2f})",
            file=sys.stderr, flush=True)

    def mean(key):
        return sum(r[key] for r in per_seed) / len(per_seed)

    def half_range(key):
        vals = [r[key] for r in per_seed]
        return (max(vals) - min(vals)) / 2.0

    out = {
        "preset": preset,
        "hard": hard,
        "steps": steps,
        "seeds": seeds,
        "si_sdr_improvement": round(mean("si_sdr_improvement"), 2),
        "si_sdr_improvement_per_seed": [
            round(r["si_sdr_improvement"], 2) for r in per_seed],
        "si_sdr_improvement_half_range": round(
            half_range("si_sdr_improvement"), 2),
        "si_sdr_improvement_train_dist": round(
            mean("si_sdr_improvement_train_dist"), 2),
        "oracle_bound": round(mean("oracle_bound"), 2),
        "headroom": round(
            mean("oracle_bound") - mean("si_sdr_improvement"), 2),
        "d_loss": round(mean("d_loss"), 4),
        "d_loss_traj_per_seed": [r["d_loss_traj"] for r in per_seed],
        "d_norm": cfg.model.d_norm,
        "throughput": round(mean("throughput"), 1),
    }
    say(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
