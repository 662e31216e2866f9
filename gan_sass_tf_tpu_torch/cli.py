"""Command line for the PyTorch port.

    python -m gan_sass_tf_tpu_torch.cli configs
    python -m gan_sass_tf_tpu_torch.cli train --config stream_v5e8 --steps 20
    python -m gan_sass_tf_tpu_torch.cli eval --config stream_v5e8 --batches 4
    python -m gan_sass_tf_tpu_torch.cli separate --config wsj0_logmel \
        --params g.npz --input mix.wav --output-dir out/ [--device cuda]

`train` runs the alternating G/D loop from a seeded init; `eval` scores a
seeded-init generator on held-out mixtures (checkpoints, and with them
`--workdir`, are not ported yet).  `--params` is a flat `.npz` of flax
generator params ("/"-joined paths, see models/convert.py).  `--device`
defaults to cuda and fails when no GPU is visible; the CPU runs only when
asked for with `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from gan_sass_tf_tpu_torch import config as config_lib


def _apply_overrides(cfg, overrides):
    """`--set sec.key=val` overrides, one dataclass replace per section so
    that __post_init__ validation sees them together (a copy of the JAX
    CLI's helper)."""
    per_section: dict = {}
    for item in overrides:
        path, _, raw = item.partition("=")
        sec, _, key = path.partition(".")
        old = getattr(getattr(cfg, sec), key)   # raises AttributeError on typos
        typ = type(old)
        if typ is bool:
            val = raw.lower() in ("1", "true", "yes")
        elif typ is tuple:
            def _elem(x):
                try:
                    return int(x)
                except ValueError:
                    return float(x)
            val = tuple(_elem(x) for x in raw.split(","))
        elif old is None:
            val = raw
        else:
            val = typ(raw)
        per_section.setdefault(sec, {})[key] = val
    return cfg.replace(**{
        sec: dataclasses.replace(getattr(cfg, sec), **kw)
        for sec, kw in per_section.items()
    })


def _add_common(p):
    p.add_argument("--config", required=True, help="preset name")
    p.add_argument("--device", default="cuda", help="torch device")
    p.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL",
                   help="config override, e.g. train.batch_size=8")


def _run_experiment(args, cfg, device) -> int:
    from gan_sass_tf_tpu_torch.train import Experiment

    exp = Experiment(cfg, workdir=args.workdir, device=device)
    if args.cmd == "eval":
        for k, v in exp.evaluate(num_batches=args.batches).items():
            print(f"{k}: {v:.3f}")
        return 0

    def log(step, m):
        print(f"step {step}: g={m['g_loss']:.4f} d={m['d_loss']:.4f} "
              f"recon={m['g_recon']:.4f} "
              f"thr={m['mixture_sec_per_sec']:.1f} mix-s/s", flush=True)

    exp.train(num_steps=args.steps, log_fn=log)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gan_sass_tf_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_train = sub.add_parser("train", help="run the alternating G/D training loop")
    p_train.add_argument("--steps", type=int, default=None)
    p_train.add_argument("--profile-steps", default=None, metavar="A:B",
                         help="profile steps [A, B): not ported yet (raises)")
    p_eval = sub.add_parser("eval", help="SI-SDR evaluation on held-out mixtures")
    p_eval.add_argument("--batches", type=int, default=8)
    for p in (p_train, p_eval):
        _add_common(p)
        p.add_argument("--workdir", default=None,
                       help="run directory: not ported yet (raises)")
    p_sep = sub.add_parser("separate", help="separate a mixture wav into sources")
    _add_common(p_sep)
    p_sep.add_argument("--params", required=True,
                       help="flax generator params as a flat .npz")
    p_sep.add_argument("--input", required=True, help="mixture wav path")
    p_sep.add_argument("--output-dir", required=True)
    sub.add_parser("configs", help="list available config presets")
    args = parser.parse_args(argv)

    if args.cmd == "configs":
        for name in config_lib.list_configs():
            print(name)
        return 0

    if getattr(args, "profile_steps", None):
        raise NotImplementedError(
            "--profile-steps is not ported yet (ROADMAP.md, 'Modules to "
            "port', item 10: torch.profiler hooks)")
    import torch

    from gan_sass_tf_tpu_torch.infer import separate_file
    from gan_sass_tf_tpu_torch.models import load_flax_npz, load_generator

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is visible "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    cfg = _apply_overrides(config_lib.get_config(args.config), args.set)
    if args.cmd in ("train", "eval"):
        return _run_experiment(args, cfg, device)
    g = load_generator(cfg, load_flax_npz(args.params), device)
    for p in separate_file(g, cfg, args.input, args.output_dir, device):
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
