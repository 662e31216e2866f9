"""Streaming quality under the hard protocol: train stream_v5e8 on shared-f0
plus noise material, build a long stream of held-out mixtures with
near-silent gaps between them (the adversarial case for chunk-permutation
chaining), and compare one-shot separation with both streaming modes.

    python -m gan_sass_tf_tpu_torch.scripts.stream_quality [STEPS] [--easy]
        [--seed N] [--set sec.key=val ...] [--device cuda]

Port of `scripts/stream_quality.py`, with its arguments (and --device,
default cuda, which fails when no GPU is visible) and its JSON keys.  A
mid-stream source flip destroys the stream-global PIT SI-SDR, so the
streaming-vs-one-shot delta is the chaining health check (the JAX
verdict's bar: < 0.5 dB).  Segment i is mixed with the counter RNG at
seed 7000 + i (`data.mix_sources`), where the JAX script used
jax.random.PRNGKey(7000 + i).

Prints one JSON line:
  {"preset", "hard", "steps", "seed", "stream_seconds",
   "si_sdr_improvement_oneshot", "si_sdr_improvement_stream_batch",
   "si_sdr_improvement_stream_scan", "delta_batch_vs_oneshot",
   "delta_scan_vs_oneshot", "perm_hysteresis"}
"""

from __future__ import annotations

import json
import sys
from typing import List, Tuple

import numpy as np
import torch

from gan_sass_tf_tpu_torch.data import mix_sources
from gan_sass_tf_tpu_torch.losses import pit_si_sdr
from gan_sass_tf_tpu_torch.scripts.quality_protocol import device_or_exit, protocol_config

N_SEGMENTS = 8
GAP_SECONDS = 0.25       # silent pause between utterances: no matching evidence
SEGMENT_SEED = 7_000     # segment i is mixed at seed SEGMENT_SEED + i


def long_stream(parts: List[Tuple[np.ndarray, np.ndarray]], gap: int):
    """[(mixture (T_i,), targets (S, T_i)), ...] -> the stream (T_long,) and
    its targets (S, T_long): the parts in order, `gap` zeros between
    consecutive ones."""
    s = parts[0][1].shape[0]
    mix, tgt = [], []
    for i, (m, t) in enumerate(parts):
        if i:
            mix.append(np.zeros(gap, np.float32))
            tgt.append(np.zeros((s, gap), np.float32))
        mix.append(np.asarray(m, np.float32))
        tgt.append(np.asarray(t, np.float32))
    return np.concatenate(mix, axis=-1), np.concatenate(tgt, axis=-1)


def stream_parts(exp, n: int = N_SEGMENTS):
    """n held-out segments of `exp`'s eval dataset, segment i mixed at seed
    SEGMENT_SEED + i: [(mixture (T,), scaled sources (S, T)), ...]."""
    parts = []
    for i in range(n):
        sources = torch.from_numpy(exp.eval_dataset.batch()[:1])    # (1, S, T)
        mixture, scaled = mix_sources(sources, SEGMENT_SEED + i, 0, exp.cfg.data)
        parts.append((mixture[0].numpy(), scaled[0].numpy()))
    return parts


def si_sdr_improvement(est: np.ndarray, targets: np.ndarray,
                       mixture: np.ndarray) -> float:
    """PIT SI-SDR of `est` (S, T') against `targets` (S, T) over the whole
    stream, minus the mixture's own, on the common length (dB)."""
    t = min(est.shape[-1], targets.shape[-1])
    tgt = torch.tensor(targets[None, :, :t])
    si = float(pit_si_sdr(torch.tensor(est[None, :, :t]), tgt).mean())
    mix = torch.tensor(mixture[:t]).expand(1, tgt.shape[1], t)
    return si - float(pit_si_sdr(mix, tgt).mean())


def separate_three_ways(g, cfg, mixture: np.ndarray, device):
    """(one-shot, batch-mode streaming, scan-mode streaming) separations of
    the (T,) stream, each (S, T)."""
    from gan_sass_tf_tpu_torch.infer import separate_streaming, separate_streaming_scan
    from gan_sass_tf_tpu_torch.train import build_separate_fn

    one = build_separate_fn(cfg, g)(torch.from_numpy(mixture[None]).to(device))
    one = one[0].cpu().numpy()[..., : mixture.shape[-1]]
    return (one, separate_streaming(g, cfg, mixture, device),
            separate_streaming_scan(g, cfg, mixture, device))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    overrides, skip, seed, device = [], set(), 0, "cuda"
    for i, a in enumerate(argv):
        if a == "--set" and i + 1 < len(argv):
            overrides.append(argv[i + 1])
            skip.update((i, i + 1))
        elif a == "--seed" and i + 1 < len(argv):
            seed = int(argv[i + 1])
            skip.update((i, i + 1))
        elif a == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
            skip.update((i, i + 1))
        elif a.startswith("--"):
            skip.add(i)
    args = [a for i, a in enumerate(argv) if i not in skip]
    steps = int(args[0]) if args else 10_000
    hard = "--easy" not in argv
    dev = device_or_exit(device)

    from gan_sass_tf_tpu_torch.train import Experiment

    cfg = protocol_config("stream_v5e8", hard, overrides)
    exp = Experiment(cfg, workdir=None, device=dev)
    exp.reseed(seed)
    exp.train(num_steps=steps,
              log_fn=lambda s, m: (s % 2000 == 0) and print(
                  f"step {s}: d={m['d_loss']:.3f}", file=sys.stderr, flush=True))
    g = exp.eval_generator()
    sr = cfg.dsp.sample_rate
    mixture, targets = long_stream(stream_parts(exp), int(GAP_SECONDS * sr))
    si_one, si_batch, si_scan = (si_sdr_improvement(est, targets, mixture)
                                 for est in separate_three_ways(g, cfg, mixture, dev))
    print(json.dumps({
        "preset": "stream_v5e8",
        "hard": hard,
        "steps": steps,
        "seed": seed,
        "stream_seconds": round(mixture.shape[-1] / sr, 2),
        "si_sdr_improvement_oneshot": round(si_one, 2),
        "si_sdr_improvement_stream_batch": round(si_batch, 2),
        "si_sdr_improvement_stream_scan": round(si_scan, 2),
        "delta_batch_vs_oneshot": round(si_batch - si_one, 2),
        "delta_scan_vs_oneshot": round(si_scan - si_one, 2),
        "perm_hysteresis": cfg.stream.perm_hysteresis,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
