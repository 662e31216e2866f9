"""Streaming compute: ms a chunk in scan and batch mode, with the chunks on
the device before the clock starts.

    python -m gan_sass_tf_tpu_torch.scripts.bench_streaming_compute [seconds] [reps]
        [--device cuda]

Port of `scripts/bench_streaming_compute.py`, with its JSON keys.
`stream_v5e8`'s G from a seeded init separates `seconds` (default 60) of
noise, cut into chunks and copied to the device first; one warm-up, then
`reps` (default 5) timed repetitions, each ended by a
torch.cuda.synchronize(); the median, less the host ms of a synchronize
on an idle device (measured, as the JAX script subtracts its fetch),
over the chunks.  Scan mode runs the scan of `infer.separate_streaming_scan`
(`infer.build_streaming_scan_fn`); batch mode separates the groups of
stream.batch_chunks chunks and joins them with the identity permutation
(`_finalize_stream`): the chaining's host transfer is left out, as the
JAX script leaves it out.

Prints one JSON line a mode:
  {"mode": "scan"|"batch", "ms_per_chunk", "x_realtime", "chunks", "reps",
   "fetch_ms_subtracted"}
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.cli import _apply_overrides
from gan_sass_tf_tpu_torch.infer import streaming
from gan_sass_tf_tpu_torch.models import build_generator
from gan_sass_tf_tpu_torch.scripts import split_args
from gan_sass_tf_tpu_torch.scripts.quality_protocol import device_or_exit
from gan_sass_tf_tpu_torch.train import build_separate_fn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device, reps: int) -> list:
    """Seconds of each of `reps` calls of fn() after one warm-up, each call
    ended by a synchronize."""
    fn()
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return times


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pos, opts = split_args(argv)
    overrides, device = opts["--set"], (opts["--device"] or ["cuda"])[-1]
    seconds = float(pos[0]) if pos else 60.0
    reps = int(pos[1]) if len(pos) > 1 else 5
    dev = device_or_exit(device)

    cfg = _apply_overrides(config.get_config("stream_v5e8"), overrides)
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1))
    sr = cfg.dsp.sample_rate
    chunk, stride, overlap, n_chunks, padded, ext = streaming._chunk_geometry(
        cfg, int(seconds * sr))
    wav = np.random.default_rng(0).standard_normal(padded).astype(np.float32) * 0.1
    idx = np.arange(n_chunks)[:, None] * stride + np.arange(chunk + ext)[None, :]
    chunks_dev = torch.from_numpy(wav[idx]).to(dev)
    bc = cfg.stream.batch_chunks
    n_groups = -(-n_chunks // bc)
    groups_dev = torch.nn.functional.pad(
        chunks_dev, (0, 0, 0, n_groups * bc - n_chunks)).reshape(n_groups, bc, -1)
    perm0 = torch.arange(cfg.data.num_sources, device=dev).repeat(n_chunks, 1)
    g = build_generator(cfg, dev, seed=0)
    separate = build_separate_fn(cfg, g)
    scan = streaming.build_streaming_scan_fn(cfg, g)

    # The host ms of a synchronize with nothing queued.
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        _sync(dev)
    fetch_ms = (time.perf_counter() - t0) / 5 * 1e3

    def run_scan():
        streaming.scan_chunks(scan, chunks_dev)

    def run_batch():
        est = torch.cat([separate(groups_dev[gi])[..., :chunk]
                         for gi in range(n_groups)])[:n_chunks]
        streaming._finalize_stream(est, perm0, stride, overlap)

    audio_sec = n_chunks * stride / sr
    for mode, fn in (("scan", run_scan), ("batch", run_batch)):
        med = statistics.median(timed(fn, dev, reps)) - fetch_ms / 1e3
        print(json.dumps({
            "mode": mode, "ms_per_chunk": med / n_chunks * 1e3,
            "x_realtime": audio_sec / med, "chunks": n_chunks, "reps": reps,
            "fetch_ms_subtracted": fetch_ms,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
