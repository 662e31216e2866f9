"""Profiler hooks: a torch.profiler trace around chosen train steps, written
as a Chrome trace (chrome://tracing, Perfetto, TensorBoard's profile
plugin), and the reading of such a trace by step range.

Port of `gan_sass_tf_tpu/utils/profiler.py` (jax.profiler xplane dumps).
A trace is trustworthy only early in its process: torch.profiler drops
kernel records more the longer a process has run, so profile the first
steps of a fresh process, or check the launches a trace recorded.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Dict, Iterable, List, Optional

import torch

STEP_PREFIX = "ProfilerStep#"     # the range around each profiled step
# Chrome-trace categories of device work: kernels, copies and fills.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# The train step's ranges (train/step.py): sampling, mixing, K1 and K3
# ("dsp"); G's forward, its masks and losses ("g_fwd"); the PIT match; the
# D updates ("d_step": D's forward, R1, backward); G's backward; both
# optimizers and the EMA.  A kernel belongs to the innermost range whose
# host window holds its launch.
STEP_RANGES = ("dsp", "g_fwd", "pit", "d_step", "g_bwd", "optimizer")


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """Profile the enclosed code (CPU, and CUDA when a GPU is visible) and
    write its Chrome trace to `logdir/<host>.<pid>.<ms>.pt.trace.json`.
    Yields the torch.profiler.profile object, or None when not enabled."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    name = f"{socket.gethostname()}.{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


def device_work(prof) -> list:
    """The device's own work among a finished torch.profiler profile's
    averaged events (`key_averages()`): kernels, copies and fills, not the
    device-side spans of record_function ranges (the train step's ranges,
    `ProfilerStep#`) or of NCCL's host ops."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("nccl:", STEP_PREFIX))
            and e.key not in STEP_RANGES]


def step_range(step: int):
    """The record_function range a profiled step runs in."""
    return torch.profiler.record_function(f"{STEP_PREFIX}{step}")


def parse_profile_steps(spec: str):
    """'a:b' -> (a, b) step interval for the trainer's --profile-steps flag."""
    a, b = spec.split(":")
    return int(a), int(b)


def trace_files(logdir: str) -> List[str]:
    """The Chrome traces under `logdir`, oldest first."""
    found = [os.path.join(root, f) for root, _, files in os.walk(logdir)
             for f in files if f.endswith(".pt.trace.json")]
    return sorted(found, key=os.path.getmtime)


def load_trace(path: str) -> List[dict]:
    """The complete ("ph": "X") events of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def annotations(events: Iterable[dict], prefix: str = "") -> List[dict]:
    """The host-side record_function ranges whose names start with `prefix`."""
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith(prefix)]


def device_events(events: List[dict]) -> List[dict]:
    """What the device ran, each event with "launch_ts": the host time its
    launch was issued (its correlation id's runtime call; events of a
    kernel launched on another thread, autograd's backward thread
    included, carry it too).  On a trace without device events (the
    CPU), the host's outermost operators of each thread stand in, each
    issued at its own start."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if dev:
        launch = {e["args"]["correlation"]: e["ts"] for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        return [{**e, "launch_ts": launch.get(e.get("args", {}).get("correlation"),
                                              e["ts"])} for e in dev]
    out, ends = [], {}
    for e in sorted((e for e in events if e.get("cat") == "cpu_op"),
                    key=lambda e: (e["ts"], -e["dur"])):
        key = (e["pid"], e["tid"])
        if e["ts"] >= ends.get(key, float("-inf")):
            out.append({**e, "launch_ts": e["ts"]})
            ends[key] = e["ts"] + e["dur"]
    return out


def attribute(events: List[dict], names: Iterable[str],
              within: Optional[List[dict]] = None) -> Dict[str, float]:
    """Device µs by range: each device event goes to the innermost range
    named in `names` whose host window holds its launch, "other" when
    none does.  With `within` (ranges, e.g. the profiled steps), only the
    events launched inside one of those count."""
    names = tuple(names)
    ranges = sorted((r for r in annotations(events) if r["name"] in names),
                    key=lambda r: r["ts"])
    buckets: Dict[str, float] = {}
    for e in device_events(events):
        ts = e["launch_ts"]
        if within is not None and not any(r["ts"] <= ts <= r["ts"] + r["dur"]
                                          for r in within):
            continue
        name = "other"
        for r in ranges:            # the latest-starting range that holds ts
            if r["ts"] > ts:
                break
            if ts <= r["ts"] + r["dur"]:
                name = r["name"]
        buckets[name] = buckets.get(name, 0.0) + e["dur"]
    return buckets
