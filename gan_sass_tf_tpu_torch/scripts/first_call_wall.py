"""Time one-shot separation on one CUDA card: the first call of a G.

    python -m gan_sass_tf_tpu_torch.scripts.first_call_wall [--samples N]

`cli separate` on a 3 s and on a 60 s wsj0_logmel mixture (each call loads
G anew from a seeded .npz, so its separation is that G's first call, as in
a process that serves one file), and `separate()` on the main path's 16 ×
3 s batch with a G loaded anew for each call.  Every wall is one call,
synchronized, in ms; the paths are timed in turns, N samples each, after
one untimed call of each (it loads the kernels' library and cuDNN).  It
prints one JSON line: each path's walls in order and their median, the
package it timed, and the card's name and power limit.

It uses only the port's public entry points (`cli.main`,
`infer.separate`, `models`), so it also times another checkout: run it by
path with PYTHONPATH at that checkout,

    PYTHONPATH=/path/to/other python gan_sass_tf_tpu_torch/scripts/first_call_wall.py

and in the order parent, change, change, parent for a paired comparison.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import gan_sass_tf_tpu_torch
from gan_sass_tf_tpu_torch import cli, config
from gan_sass_tf_tpu_torch.infer import separate
from gan_sass_tf_tpu_torch.models import (
    build_generator,
    load_flax_npz,
    load_generator,
    save_flax_npz,
)
from gan_sass_tf_tpu_torch.utils.wav_io import write_wav

PRESET, SEED = "wsj0_logmel", 0
BATCH, SECONDS = 16, 3


def _mixtures(rng, b: int, t: int, sr: int) -> np.ndarray:
    """Two harmonic tones per mixture plus noise."""
    n = np.arange(t) / sr
    out = []
    for _ in range(b):
        f1, f2 = rng.uniform(100, 300), rng.uniform(400, 1200)
        s1 = sum(np.sin(2 * np.pi * h * f1 * n) / h for h in (1, 2, 3))
        s2 = sum(np.sin(2 * np.pi * h * f2 * n) / h for h in (1, 2))
        out.append(0.3 * s1 + 0.2 * s2 + 0.02 * rng.standard_normal(t))
    return np.stack(out).astype(np.float32)


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("first_call_wall: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = config.get_config(PRESET)
    sr = cfg.dsp.sample_rate
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        params = tmp / "g.npz"
        save_flax_npz(str(params), build_generator(cfg, "cpu", seed=SEED).state_dict())
        wavs = {}
        for seconds in (3, 60):
            wavs[f"cli_separate_{seconds}s"] = tmp / f"mix{seconds}s.wav"
            write_wav(str(wavs[f"cli_separate_{seconds}s"]), sr,
                      _mixtures(rng, 1, seconds * sr, sr)[0])
        batch = _mixtures(rng, BATCH, SECONDS * sr, sr)

        def cli_call(wav):
            def call():
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = cli.main(["separate", "--config", PRESET, "--params", str(params),
                                   "--input", str(wav), "--output-dir", str(tmp / "out")])
                if rc:
                    raise RuntimeError(f"cli separate {wav.name} exited {rc}")
            return call

        def batch_call():
            g = load_generator(cfg, load_flax_npz(str(params)), dev)
            return _wall_ms(lambda: separate(g, cfg, batch, dev))

        paths = {name: cli_call(wav) for name, wav in wavs.items()}
        walls = {name: [] for name in (*paths, f"separate_{BATCH}x{SECONDS}s_new_g")}
        for fn in paths.values():
            fn()
        batch_call()
        for _ in range(args.samples):
            for name, fn in paths.items():
                walls[name].append(_wall_ms(fn))
            walls[f"separate_{BATCH}x{SECONDS}s_new_g"].append(batch_call())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(json.dumps({"package": gan_sass_tf_tpu_torch.__file__, "card": card[:1],
                      "walls_ms": walls,
                      "median_ms": {k: statistics.median(v) for k, v in walls.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
