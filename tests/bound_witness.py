"""The JAX package's `quality_protocol` oracle bound of a run, on the CPU,
without training it: each seed's eval stream (the eval split at seed +
9999, as `Experiment.reseed` makes it) skips the batches the run's
evaluations take first (one of `train.eval_batches` every
`train.eval_every` steps, then the final 8), and
`scripts/quality_protocol.py::oracle_bound_on_eval` mixes the next 8
under PRNGKey(20 000 + i).  The port's `quality_protocol` draws the same,
so its `oracle_bound` on the card is held against these.  Data only: no
model is built.

    python tests/bound_witness.py [PRESET] [STEPS] [--hard] [--seeds 0,7]
"""

from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import json  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

FINAL_EVAL_BATCHES = 8        # quality_protocol's evaluate() after training


def main(argv) -> int:
    import quality_protocol as qp

    from gan_sass_tf_tpu.data import make_dataset

    hard, seeds, args, i = "--hard" in argv, [0], [], 0
    while i < len(argv):
        if argv[i] == "--seeds" and i + 1 < len(argv):
            seeds, i = [int(s) for s in argv[i + 1].split(",")], i + 2
            continue
        if not argv[i].startswith("--"):
            args.append(argv[i])
        i += 1
    preset = args[0] if args else "stream_v5e8"
    steps = int(args[1]) if len(args) > 1 else 10_000
    cfg = qp.protocol_config(preset, hard)
    skip = (steps // cfg.train.eval_every * cfg.train.eval_batches
            + FINAL_EVAL_BATCHES)
    for seed in seeds:
        ds = make_dataset(cfg, seed=seed + 9999, split=cfg.data.eval_split)
        for _ in range(skip):
            ds.batch()
        bound = qp.oracle_bound_on_eval(types.SimpleNamespace(cfg=cfg, eval_dataset=ds),
                                        num_batches=8)
        print(json.dumps({"preset": preset, "hard": hard, "steps": steps, "seed": seed,
                          "eval_batches_skipped": skip,
                          "oracle_bound": round(bound, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
