"""Compute a preset's oracle-mask quality bound without training: the
held-out split, 8 batches, mixed as the quality protocol mixes its bound's
batches.

    python -m gan_sass_tf_tpu_torch.scripts.recompute_bounds PRESET [--hard]
        [--device cuda] [--set sec.key=val ...]

Port of `scripts/recompute_bounds.py`, with its arguments and JSON keys;
its `--cpu` is `--device cpu` here.  It builds no model, so it runs for
every preset.  Under torchrun it joins the process group and deals the
batches out to the ranks (`quality_protocol.mean_oracle_bound`); rank 0
alone prints.
"""

from __future__ import annotations

import json
import sys

from gan_sass_tf_tpu_torch.data import make_dataset
from gan_sass_tf_tpu_torch.parallel import data_parallel
from gan_sass_tf_tpu_torch.scripts.quality_protocol import (
    in_process_group,
    mean_oracle_bound,
    protocol_config,
)

NUM_BATCHES = 8


def oracle_bound(cfg, device, dp=None) -> float:
    """The bound of `cfg`'s held-out split, unrounded."""
    eval_ds = make_dataset(cfg, seed=cfg.train.seed + 9999,
                           split=cfg.data.eval_split)
    return mean_oracle_bound(cfg, eval_ds, device, NUM_BATCHES, dp)


def main(argv) -> int:
    hard = "--hard" in argv
    overrides, device, values = [], "cuda", set()
    for i, a in enumerate(argv):
        if a in ("--set", "--device") and i + 1 < len(argv):
            values.add(i + 1)
            if a == "--set":
                overrides.append(argv[i + 1])
            else:
                device = argv[i + 1]
    args = [a for i, a in enumerate(argv)
            if i not in values and not a.startswith("--")]
    preset = args[0] if args else "stream_v5e8"

    cfg = protocol_config(preset, hard, overrides)

    def run(dev) -> int:
        dp = data_parallel(cfg.mesh, cfg.train.batch_size)
        line = json.dumps({
            "preset": preset, "hard": hard,
            "oracle_bound": round(oracle_bound(cfg, dev, dp), 2),
            "mask_type": cfg.dsp.mask_type,
            "mask_activation": cfg.dsp.mask_activation,
        })
        if dp.is_main:
            print(line, flush=True)
        return 0

    return in_process_group(device, run)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
