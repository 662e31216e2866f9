"""Time the synthesis kernels (K2, K3 and K3's backward) on one CUDA card.

    python -m gan_sass_tf_tpu_torch.scripts.time_synthesis [--sweep]

At the main path's shapes (K3 and its backward at the stream_v5e8 step,
64 × 247 × 257; K2 at the wsj0_logmel separate() batch, 16 × 2 × 184 × 257
with magnitude masks, and at the music_complex_44k bound batch,
8 × 2 × 255 × 1025 with complex masks, n_fft 2048) it prints one JSON line
with, for each call: the wrapper's median ms (CUDA events around
back-to-back calls, kernel and plain version in turns), the device ms of
each CUDA kernel it launched and the launches recorded (torch.profiler),
for one-call wrappers the device ms again from CUDA events around a CUDA
graph of back-to-back calls (no host time between the launches), the
plain version's device ms, and the largest error against the plain
version.  It also holds the plain masked iSTFT on the card against the
same call on the CPU at the music shape (cuFFT's C2R transform reads the
imaginary parts at DC and Nyquist there unless the plain path drops
them).  It uses only the wrappers' public functions, so it also times
another checkout's kernels: run it by path with PYTHONPATH at that
checkout,

    PYTHONPATH=/path/to/other python gan_sass_tf_tpu_torch/scripts/time_synthesis.py

--sweep (this checkout only) times the kernels' device ms instead for each
block shape of a grid of ops.masked_istft.ROWS × TILE_SAMPLES, after
checking that every block shape gives the same output bit for bit (each
output sample adds its frames in the same order whatever the shape).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

import gan_sass_tf_tpu_torch
from gan_sass_tf_tpu_torch.ops import istft as k3
from gan_sass_tf_tpu_torch.ops import masked_istft as k2
from gan_sass_tf_tpu_torch.ops import stft_features as k1
from gan_sass_tf_tpu_torch.utils import profiler

SAMPLES, CALLS = 20, 10
SWEEP_ROWS = (4, 8, 16, 32)
SWEEP_TILE_SAMPLES = (2048, 4096, 8192, 16384)


def device_kernels(fn, calls=CALLS) -> dict:
    """{kernel name: (device ms, launches) per call} of the CUDA kernels
    `fn` launches, from torch.profiler over `calls` calls after one warm-up
    call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / calls / 1e3, e.count / calls)
            for e in profiler.device_work(prof)}


def device_ms(fn) -> float:
    return sum(ms for ms, _ in device_kernels(fn).values())


def graph_ms(fn, calls=2 * CALLS) -> float:
    """Median device ms a call of `fn`: CUDA events around a replay of a
    CUDA graph that holds `calls` back-to-back calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(SAMPLES):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def wrapper_ms(**fns) -> dict:
    """Median ms a call of each function: CUDA events around CALLS
    back-to-back calls make one sample; the functions take turns, forward
    then backward."""
    for _ in range(3):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    order = list(fns) + list(fns)[::-1]
    times = {name: [] for name in fns}
    for i in range(SAMPLES * len(fns)):
        name = order[i % len(order)]
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(CALLS):
            fns[name]()
        b.record()
        b.synchronize()
        times[name].append(a.elapsed_time(b) / CALLS)
    return {name: statistics.median(t) for name, t in times.items()}


def inputs(dev) -> dict:
    """Seeded spectra, masks and cotangents at the main path's shapes."""
    rng = np.random.default_rng(0)

    def spectrum(b, t, n_fft, hop):
        x = torch.from_numpy(rng.standard_normal((b, t), np.float32)).to(dev)
        return k1.stft_features_reference(x, n_fft, hop)["spec"]

    def masks(shape, lo):
        return torch.from_numpy(rng.uniform(lo, 1, shape).astype(np.float32)).to(dev)

    sep = spectrum(16, 23936, 512, 128)
    mus = spectrum(8, 132300, 2048, 512)
    st = spectrum(64, 32000, 512, 128)
    x = {"sep": sep, "sep_m": masks((16, 2) + tuple(sep.shape[-2:]), 0.0),
         "mus": mus, "mus_m": masks((8, 2) + tuple(mus.shape[-2:]) + (2,), -1.0),
         "re": st.real.contiguous().requires_grad_(),
         "im": st.imag.contiguous().requires_grad_()}
    x["y"] = k3.istft_kernel(x["re"], x["im"], 512, 128)
    x["y_ref"] = k3.istft_reference(x["re"], x["im"], 512, 128)
    x["dy"] = torch.randn_like(x["y_ref"])
    x["z"] = torch.randn_like(x["y_ref"])
    return x


def cases(x: dict) -> dict:
    """{name: (kernel call, plain call, one wrapper call)}."""
    f, dev = x["re"].shape[-2], x["re"].device
    inv, a_k = k2._inv_env(512, 128, "hann", f, dev), k3._bin_weights(512, dev)

    def no_grad(fn):
        def go():
            with torch.no_grad():
                return fn()
        return go

    return {
        "masked_istft 16x2x184x257 magnitude": (
            lambda: k2.masked_istft_kernel(x["sep"], x["sep_m"], 512, 128),
            lambda: k2.masked_istft_reference(x["sep"], x["sep_m"], 512, 128), True),
        "masked_istft 8x2x255x1025 complex n_fft 2048": (
            lambda: k2.masked_istft_kernel(x["mus"], x["mus_m"], 2048, 512,
                                           mask_type="complex"),
            lambda: k2.masked_istft_reference(x["mus"], x["mus_m"], 2048, 512,
                                              mask_type="complex"), True),
        "istft 64x247x257": (
            no_grad(lambda: k3.istft_kernel(x["re"], x["im"], 512, 128)),
            no_grad(lambda: k3.istft_reference(x["re"], x["im"], 512, 128)), True),
        "istft_bwd 64x247x257 (whole autograd backward)": (
            lambda: torch.autograd.grad(x["y"], (x["re"], x["im"]), x["dy"],
                                        retain_graph=True),
            lambda: torch.autograd.grad(x["y_ref"], (x["re"], x["im"]), x["dy"],
                                        retain_graph=True), False),
        "istft_adjoint 64x32000 (one call)": (
            lambda: k3.istft_adjoint(x["z"], 512, 128, "hann", f),
            lambda: torch.view_as_real(k1.stft_features_reference(
                x["z"] * inv, 512, 128)["spec"]) * a_k, True),
        "stft_features spec 64x32000 (K1, the same frames)": (
            lambda: k1.stft_features_kernel(x["z"], 512, 128),
            lambda: k1.stft_features_reference(x["z"], 512, 128), True),
    }


def max_err(a, b) -> float:
    """Largest |a - b| over tensors, tuples of tensors or dicts of outputs."""
    if isinstance(a, dict):
        return max(max_err(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        if not isinstance(b, tuple):   # (re, im) planes against (..., 2)
            b = torch.unbind(b, -1)
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a - b).abs().max())


def run(dev) -> dict:
    x = inputs(dev)
    out = {}
    for name, (kernel, plain, one_call) in cases(x).items():
        t = wrapper_ms(plain=plain, kernel=kernel)
        dk = device_kernels(kernel)
        out[name] = {"wrapper_ms": t["kernel"], "plain_ms": t["plain"],
                     "device_ms": sum(ms for ms, _ in dk.values()),
                     "device_kernels": dk, "plain_device_ms": device_ms(plain),
                     "max_abs_err": max_err(kernel(), plain())}
        if one_call:
            out[name]["graph_device_ms"] = graph_ms(kernel)
    card = k2.masked_istft_reference(x["mus"], x["mus_m"], 2048, 512, mask_type="complex")
    cpu = k2.masked_istft_reference(x["mus"].cpu(), x["mus_m"].cpu(), 2048, 512,
                                    mask_type="complex")
    out["plain masked_istft 8x2x255x1025 complex, card vs CPU"] = {
        "max_abs_err": max_err(card.cpu(), cpu), "max_abs_y": float(cpu.abs().max())}
    return out


def sweep(dev) -> dict:
    """The synthesis kernels' device ms for each block shape of the grid
    (K2, and K3's forward: the block shape is theirs alone)."""
    calls = {n: kernel for n, (kernel, _, _) in cases(inputs(dev)).items()
             if n.startswith(("masked_istft", "istft 64x"))}
    base = {n: fn() for n, fn in calls.items()}
    out = {}
    for rows in SWEEP_ROWS:
        for tile_samples in SWEEP_TILE_SAMPLES:
            k2.ROWS, k2.TILE_SAMPLES = rows, tile_samples
            for n, fn in calls.items():
                if not torch.equal(fn(), base[n]):
                    raise SystemExit(f"{n}: rows {rows}, tile samples "
                                     f"{tile_samples} changed the output")
            out[f"rows {rows}, tile samples {tile_samples}"] = {
                n: device_ms(fn) for n, fn in calls.items()}
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_synthesis: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    result = sweep(dev) if "--sweep" in argv else run(dev)
    print(json.dumps({"device": smi, "package": gan_sass_tf_tpu_torch.__file__,
                      "samples": SAMPLES, "calls_per_sample": CALLS,
                      "sweep" if "--sweep" in argv else "timing": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
