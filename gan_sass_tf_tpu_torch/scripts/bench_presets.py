"""Per-preset training throughput, and the two streaming modes' real-time
factors: one JSON line a row.

    python -m gan_sass_tf_tpu_torch.scripts.bench_presets [preset ... | streaming]
        [--set sec.key=val ...] [--steps WARMUP:TIMED] [--device cuda]

Port of `scripts/bench_presets.py`, with its rows and keys (the values
unrounded, where the JAX script rounds them).  A training row
trains the preset on synthetic data from the device bank at its batch per
device (train.batch_size over mesh.data_axis_size when that is set, as the
JAX script sizes it for one chip), WARMUP steps untimed and TIMED steps
between two torch.cuda.synchronize() calls:
  {"preset", "metric": "train_throughput", "value": mixture-sec/sec,
   "unit": "mixture-sec/sec/gpu" ("/cpu" on the CPU), "step_ms", "batch"}
`streaming` separates a 60 s two-tone wav with a seeded stream_v5e8 G in
scan and batch mode, once to warm up, once timed (host array in, host
array out):
  {"preset", "metric": "streaming_<mode>_realtime_factor", "value",
   "unit": "x real time", "wall_s"}
--steps overrides PRESET_STEPS for every preset.  This is a tool, not the
port's benchmark.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.cli import _apply_overrides
from gan_sass_tf_tpu_torch.scripts import split_args
from gan_sass_tf_tpu_torch.scripts.quality_protocol import device_or_exit

PRESET_STEPS = {
    # (warmup, timed) — the BiLSTM scan compiles ~200 s, keep its run short
    "2src_toy_cpu": (5, 50),
    "wsj0_logmel": (5, 100),
    "3src_pit": (3, 30),
    "music_complex_44k": (3, 50),
    "stream_v5e8": (5, 100),
}
STREAM_SECONDS = 60


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_preset(name: str, device, set_overrides=(), steps=None) -> dict:
    from gan_sass_tf_tpu_torch.train import Experiment

    cfg = _apply_overrides(config.get_config(name), list(set_overrides))
    per_device = max(cfg.train.batch_size // max(cfg.mesh.data_axis_size, 1), 1)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, dataset="synthetic"),
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1),
        train=dataclasses.replace(cfg.train, batch_size=per_device))
    warmup, timed = steps or PRESET_STEPS[name]
    exp = Experiment(cfg, workdir=None, device=device)
    if not exp._use_bank:
        raise SystemExit(f"error: {name}: the presets bench takes device-bank mode")
    state, bank, key = exp.state, exp._bank, exp._train_key
    for _ in range(warmup):
        exp._train_step(state, bank, key)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(timed):
        exp._train_step(state, bank, key)
    _sync(device)
    dt = time.perf_counter() - t0
    mix_sec = timed * cfg.train.batch_size * cfg.segment_samples / cfg.dsp.sample_rate
    return {
        "preset": name,
        "metric": "train_throughput",
        "value": mix_sec / dt,
        "unit": f"mixture-sec/sec/{'gpu' if device.type == 'cuda' else 'cpu'}",
        "step_ms": dt / timed * 1e3,
        "batch": cfg.train.batch_size,
    }


def bench_streaming(device, set_overrides=()) -> list:
    from gan_sass_tf_tpu_torch.infer import separate_streaming, separate_streaming_scan
    from gan_sass_tf_tpu_torch.models import build_generator

    cfg = _apply_overrides(config.get_config("stream_v5e8"), list(set_overrides))
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1))
    g = build_generator(cfg, device, seed=0)
    t = STREAM_SECONDS * cfg.dsp.sample_rate
    n = np.arange(t) / cfg.dsp.sample_rate
    wav = (np.sin(2 * np.pi * 300 * n) + np.sin(2 * np.pi * 1500 * n)).astype(np.float32)
    rows = []
    for mode, fn in (("scan", separate_streaming_scan), ("batch", separate_streaming)):
        fn(g, cfg, wav, device)                       # warm-up
        t0 = time.perf_counter()
        fn(g, cfg, wav, device)                       # returns host arrays
        dt = time.perf_counter() - t0
        rows.append({
            "preset": "stream_v5e8",
            "metric": f"streaming_{mode}_realtime_factor",
            "value": STREAM_SECONDS / dt,
            "unit": "x real time",
            "wall_s": dt,
        })
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    names, opts = split_args(argv, ("--set", "--steps", "--device"))
    overrides = opts["--set"]
    steps = (tuple(int(x) for x in opts["--steps"][-1].split(":"))
             if opts["--steps"] else None)
    dev = device_or_exit((opts["--device"] or ["cuda"])[-1])
    for name in names or list(PRESET_STEPS):
        if name == "streaming":
            for row in bench_streaming(dev, overrides):
                print(json.dumps(row), flush=True)
            continue
        print(json.dumps(bench_preset(name, dev, overrides, steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
