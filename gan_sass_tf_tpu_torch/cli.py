"""Command line for the PyTorch port.

    python -m gan_sass_tf_tpu_torch.cli configs
    python -m gan_sass_tf_tpu_torch.cli separate --config wsj0_logmel \
        --params g.npz --input mix.wav --output-dir out/ [--device cuda]

`--params` is a flat `.npz` of flax generator params ("/"-joined paths,
see models/convert.py).  `--device` defaults to cuda and fails when no GPU
is visible; the CPU runs only when asked for with `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from gan_sass_tf_tpu import config as config_lib


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gan_sass_tf_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_sep = sub.add_parser("separate", help="separate a mixture wav into sources")
    p_sep.add_argument("--config", required=True, help="preset name")
    p_sep.add_argument("--params", required=True,
                       help="flax generator params as a flat .npz")
    p_sep.add_argument("--input", required=True, help="mixture wav path")
    p_sep.add_argument("--output-dir", required=True)
    p_sep.add_argument("--device", default="cuda", help="torch device")
    p_sep.add_argument("--set", action="append", default=[],
                       metavar="SEC.KEY=VAL",
                       help="config override, e.g. model.compute_dtype=float32")
    sub.add_parser("configs", help="list available config presets")
    args = parser.parse_args(argv)

    if args.cmd == "configs":
        for name in config_lib.list_configs():
            print(name)
        return 0

    import torch

    from gan_sass_tf_tpu_torch.infer import separate_file
    from gan_sass_tf_tpu_torch.models import load_flax_npz, load_generator

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is visible "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    cfg = _apply_overrides(config_lib.get_config(args.config), args.set)
    g = load_generator(cfg, load_flax_npz(args.params), device)
    for p in separate_file(g, cfg, args.input, args.output_dir, device):
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
