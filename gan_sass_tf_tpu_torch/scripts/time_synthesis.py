"""Time the synthesis kernels (K2, K3 and K3's backward) on one CUDA card.

    python -m gan_sass_tf_tpu_torch.scripts.time_synthesis [--sweep | --ablate]

At the main path's shapes (K2 at the wsj0_logmel separate() batch, 16 × 2
× 184 × 257 with magnitude masks, at the music_complex_44k bound batch, 8 ×
2 × 255 × 1025 with complex masks at n_fft 2048, at a stream_v5e8
streaming group and one chunk, 8 and 1 × 2 × 122 × 257, and at the
3src_pit separation, 16 × 3 × 184 × 257; K3 at the stream_v5e8 step, 64 ×
247 × 257, its kernel alone, through ops.dispatch.istft as the step calls
it, and the whole autograd backward) it prints one JSON line with, for
each call: the kernel's device ms (CUDA events around a replayed CUDA
graph of back-to-back calls), the wrapper's ms (CUDA events around
back-to-back calls: host time included), the plain version's device ms
(torch.profiler), torch.istft's device ms on the same (masked) spectrum
(center=True: it drops n_fft/2 samples at each end and has no edge clamp;
center=False raises, the periodic Hann envelope being 0 at sample 0) and,
for K2, of the mask product and torch.istft together (torch.profiler's sum
of their kernels: torch.istft reads its envelope check back to the host,
so no CUDA graph can hold it), the bound (bytes at
3.35 TB/s against FFT flops at 67 TFLOP/s f32) and its share, the largest
error against the plain version and against float64 irfft + overlap-add
(the plain version's beside it), and a sha256 of the output.  It uses only
the wrappers' public functions and `ops/cost.py`, so it also times another
checkout's kernels (one that has `ops/cost.py`): run it by path with
PYTHONPATH at that checkout,

    PYTHONPATH=/path/to/other python gan_sass_tf_tpu_torch/scripts/time_synthesis.py

and in the order parent, change, change, parent for a paired comparison.

--sweep (this checkout only) times the kernels' device ms for each block
shape of a grid of threads (ops.masked_istft.THREADS), frames a tile
(TILE_FRAMES), blocks an SM (BLOCKS_PER_SM) and segment length (the
wrapper's pick scaled by SEGMENT_SCALES), after checking that each gives
the default's output bit for bit.

--ablate (this checkout only) builds edited copies of csrc/masked_istft.cu
that each leave one part of the work out (ABLATIONS: the copies into
shared memory, the bin loads, the FFT passes, the overlap-add, the
stores) and times each beside the unedited kernel, in
turns, for what each part costs; their outputs are wrong by design and are
not compared.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import gan_sass_tf_tpu_torch
from gan_sass_tf_tpu_torch.dsp.stft import overlap_add
from gan_sass_tf_tpu_torch.dsp.windows import get_window
from gan_sass_tf_tpu_torch.ops import cost, dispatch
from gan_sass_tf_tpu_torch.ops import istft as k3
from gan_sass_tf_tpu_torch.ops import masked_istft as k2
from gan_sass_tf_tpu_torch.ops import stft_features as k1
from gan_sass_tf_tpu_torch.utils import profiler

SAMPLES, CALLS = 20, 10
SWEEP_THREADS = (0, 128, 256, 512)    # THREADS; 0: synthesis_threads' pick
SWEEP_TILES = (0, 1, 2, 4)            # TILE_FRAMES; 0: a round's worth
SWEEP_BLOCKS_PER_SM = (1, 2, 3, 4)
SEGMENT_SCALES = (0.5, 1, 2)
# (name, mixtures, sources, samples, n_fft, hop, mask type).
K2_SHAPES = (
    ("masked_istft separate() 16x2x184x257 magnitude", 16, 2, 23936, 512, 128,
     "magnitude"),
    ("masked_istft music bound 8x2x255x1025 complex", 8, 2, 132300, 2048, 512,
     "complex"),
    ("masked_istft streaming group 8x2x122x257", 8, 2, 16000, 512, 128,
     "magnitude"),
    ("masked_istft one chunk 1x2x122x257", 1, 2, 16000, 512, 128, "magnitude"),
    ("masked_istft 3src_pit 16x3x184x257", 16, 3, 23936, 512, 128, "magnitude"),
)
K3_SHAPE = (64, 32000, 512, 128)   # the stream_v5e8 step: 64 × 247 × 257
# Edits of csrc/masked_istft.cu, each leaving one part of the work out.
ABLATIONS = {
    "no copies (spectrum and masks not staged)": [
        ("prefetch(R, spec_src(w, f0), 2 * nf * K, nt);",
         "if (nf < 0) prefetch(R, spec_src(w, f0), 2 * nf * K, nt);"),
        ("prefetch(R + lay.spec + sl * lay.mask, mask_src(w, sl, f0), MW * nf * K, nt);",
         "if (nf < 0) prefetch(R + lay.spec + sl * lay.mask, mask_src(w, sl, f0), "
         "MW * nf * K, nt);")],
    "no bin loads (split on constants)": [
        ("float2 a = X[k], c = X[H - k];",
         "float2 a = make_float2(__int2float_rn(k), 1.f), c = make_float2(1.f, 2.f);"),
        ("const float ma = M[k], mc = M[H - k];", "const float ma = 0.5f, mc = 0.25f;"),
        ("a = cmul_rn(M2[k], a);\n          c = cmul_rn(M2[H - k], c);",
         "a = cmul_rn(a, a);\n          c = cmul_rn(c, c);")],
    "no FFT passes": [("fft_passes<L>(v, z, t, group, ptw, roots);", "")],
    "no overlap-add": [("rows_of(w, f0, f1, &qa, &qb);\n",
                        "rows_of(w, f0, f1, &qa, &qb);\n    qb = qa;\n")],
    "no stores": [("vstore<V>(out + ((size_t)q << log2hop) + o, acc);",
                   "if (acc[0] == 1234.5f) vstore<V>(out + ((size_t)q << log2hop) + o, acc);")],
}


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


def digest(out) -> str:
    """sha256 of a tensor's or a tuple's bytes, in order."""
    h = hashlib.sha256()
    for a in out if isinstance(out, tuple) else (out,):
        h.update(a.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def max_err(a, b) -> float:
    """Largest |a - b| over tensors, or tuples of tensors against (..., 2)."""
    if isinstance(a, tuple):
        if not isinstance(b, tuple):   # (re, im) planes against (..., 2)
            b = torch.unbind(b, -1)
        return max(max_err(x, y) for x, y in zip(a, b))
    if not isinstance(b, torch.Tensor):
        b = torch.stack(b, -1)
    return float((a - b).abs().max())


def planes(d):
    """K3's backward as (dre, dim), from its interleaved (..., 2) gradient
    or from an older checkout's two planes."""
    return d if isinstance(d, tuple) else tuple(d.unbind(-1))


def f64_synthesis(est: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """float64 irfft (imaginary parts at DC and Nyquist dropped), window,
    overlap-add and inverse envelope of a (..., F, K) complex spectrum."""
    x = est.to(torch.complex128)
    x = torch.complex(x.real, x.imag * (torch.arange(x.shape[-1], device=x.device)
                                        % (x.shape[-1] - 1) != 0))
    w = torch.from_numpy(get_window("hann", n_fft, np.float64)).to(x.device)
    y = overlap_add(torch.fft.irfft(x, n=n_fft) * w, hop)
    return y * k2._inv_env(n_fft, hop, "hann", x.shape[-2], x.device).double()


def k2_inputs(dev) -> dict:
    """{name: (spectrum, masks, n_fft, hop, mask type)}, seeded."""
    rng = np.random.default_rng(0)
    out = {}
    for name, b, s, t, n_fft, hop, mask_type in K2_SHAPES:
        x = torch.from_numpy(rng.standard_normal((b, t), np.float32)).to(dev)
        spec = k1.stft_features_reference(x, n_fft, hop)["spec"]
        shape = (b, s) + tuple(spec.shape[-2:]) + ((2,) if mask_type == "complex" else ())
        lo = -1.0 if mask_type == "complex" else 0.0
        masks = torch.from_numpy(rng.uniform(lo, 1, shape).astype(np.float32)).to(dev)
        out[name] = (spec, masks, n_fft, hop, mask_type)
    return out


def masked(spec, masks, mask_type):
    """The masked spectra (B, S, F, K), as torch.istft's input needs them."""
    m = torch.view_as_complex(masks) if mask_type == "complex" else masks
    return spec[:, None] * m


def k3_inputs(dev) -> dict:
    rng = np.random.default_rng(1)
    b, t, n_fft, hop = K3_SHAPE
    x = torch.from_numpy(rng.standard_normal((b, t), np.float32)).to(dev)
    spec = k1.stft_features_reference(x, n_fft, hop)["spec"].contiguous()
    return {"spec": spec, "re": spec.real.contiguous(), "im": spec.imag.contiguous(),
            "dy": torch.from_numpy(rng.standard_normal((b, t), np.float32)).to(dev)}


def k3_kernel(x: dict, n_fft: int, hop: int):
    """K3's kernel alone: on the interleaved spectrum where the checkout has
    that route, else on the two planes."""
    if hasattr(k3, "istft_ri_kernel"):
        ri = torch.view_as_real(x["spec"])
        return lambda: k3.istft_ri_kernel(ri, n_fft, hop)
    return lambda: k3.istft_kernel(x["re"], x["im"], n_fft, hop)


def torch_istft(n_fft, hop, dev):
    """(..., F, K) spectrum -> torch.istft of it, center=True: the one
    PyTorch call that computes the same overlap-added, envelope-normalised
    inverse (its layout is (K, F)), timed beside the kernels and used
    nowhere in the port."""
    w = torch.from_numpy(get_window("hann", n_fft)).to(dev)
    return lambda est: torch.istft(est.reshape(-1, *est.shape[-2:]).transpose(-1, -2),
                                   n_fft, hop, window=w, center=True)


def k2_row(spec, masks, n_fft, hop, mask_type) -> dict:
    b, s, f = masks.shape[0], masks.shape[1], spec.shape[-2]
    kernel = lambda: k2.masked_istft_kernel(spec, masks, n_fft, hop, mask_type=mask_type)
    plain = lambda: k2.masked_istft_reference(spec, masks, n_fft, hop, mask_type=mask_type)
    est = masked(spec, masks, mask_type)
    library = torch_istft(n_fft, hop, spec.device)
    ms_bound, by = cost.masked_istft(b, s, f, n_fft, hop, mask_type).bound()
    y, ref, exact = kernel(), plain(), f64_synthesis(est, n_fft, hop)
    ms = graph_ms(kernel)
    return {"device_ms": ms, "wrapper_ms": wrapper_ms(kernel=kernel)["kernel"],
            "plain_device_ms": device_ms(plain),
            "torch_istft_ms": device_ms(lambda: library(est)),
            "torch_istft_with_mask_ms": device_ms(
                lambda: library(masked(spec, masks, mask_type))),
            "bound_ms": ms_bound, "bound_by": by, "share": ms_bound / ms,
            "max_abs_err": max_err(y, ref),
            "f64_err": float((y.double() - exact).abs().max()),
            "plain_f64_err": float((ref.double() - exact).abs().max()),
            "max_abs_y": float(exact.abs().max()), "digest": digest(y)}


def k3_rows(x: dict) -> dict:
    _, _, n_fft, hop = K3_SHAPE
    b, f = x["spec"].shape[:2]
    kernel = k3_kernel(x, n_fft, hop)
    plain = lambda: k3.istft_reference(x["re"], x["im"], n_fft, hop)
    ms_bound, by = cost.istft(b, f, n_fft, hop).bound()
    library = torch_istft(n_fft, hop, x["spec"].device)
    with torch.no_grad():
        y, ref = kernel(), plain()
        exact = f64_synthesis(x["spec"], n_fft, hop)
        ms = graph_ms(kernel)
        fwd = {"device_ms": ms, "wrapper_ms": wrapper_ms(kernel=kernel)["kernel"],
               "plain_device_ms": device_ms(plain),
               "torch_istft_ms": device_ms(lambda: library(x["spec"])),
               "bound_ms": ms_bound, "bound_by": by, "share": ms_bound / ms,
               "max_abs_err": max_err(y, ref),
               "f64_err": float((y.double() - exact).abs().max()),
               "plain_f64_err": float((ref.double() - exact).abs().max()),
               "max_abs_y": float(exact.abs().max()), "digest": digest(y)}
        step = lambda: dispatch.istft(x["spec"], n_fft, hop)
        dispatched = {"device_ms": graph_ms(step), "wrapper_ms": wrapper_ms(step=step)["step"],
                      "kernels": device_kernels(step)}
    spec = x["spec"].clone().requires_grad_()
    y = dispatch.istft(spec, n_fft, hop)
    backward = lambda: torch.autograd.grad(y, spec, x["dy"], retain_graph=True)
    bwd = {"wrapper_ms": wrapper_ms(backward=backward)["backward"],
           "device_ms": device_ms(backward), "kernels": device_kernels(backward),
           "digest": digest(planes(torch.view_as_real(backward()[0])))}
    inv = k2._inv_env(n_fft, hop, "hann", f, x["dy"].device)
    adjoint = lambda: planes(k3.istft_adjoint(x["dy"], n_fft, hop, "hann", f))
    adj = {"device_ms": graph_ms(adjoint), "digest": digest(adjoint()),
           "max_abs_err": max_err(adjoint(), torch.view_as_real(k1.stft_features_reference(
               x["dy"] * inv, n_fft, hop)["spec"]) * k3._bin_weights(n_fft, inv.device))}
    return {"istft 64x247x257 (kernel alone)": fwd,
            "istft 64x247x257 via ops.dispatch.istft (as the step calls it)": dispatched,
            "istft_bwd 64x247x257 (whole autograd backward, dispatch path)": bwd,
            "istft_adjoint 64x32000 (one call)": adj}


def run(dev) -> dict:
    out = {name: k2_row(*args) for name, args in k2_inputs(dev).items()}
    out.update(k3_rows(k3_inputs(dev)))
    return out


def kernel_calls(dev) -> dict:
    """{name: (kernel call, the arguments of its plan)} of every K2 shape
    and K3's kernel alone."""
    calls = {}
    for name, (spec, masks, n_fft, hop, mask_type) in k2_inputs(dev).items():
        spec_input = k2.COMPLEX_MASK if mask_type == "complex" else k2.MAGNITUDE_MASK
        calls[name] = (
            lambda a=(spec, masks, n_fft, hop, mask_type): k2.masked_istft_kernel(
                *a[:4], mask_type=a[4]),
            (spec_input, masks.shape[0], masks.shape[1], spec.shape[-2], n_fft, hop))
    x = k3_inputs(dev)
    b, _, n_fft, hop = K3_SHAPE
    calls["istft 64x247x257"] = (k3_kernel(x, n_fft, hop),
                                 (k2.SPEC_ONLY, b, 1, x["spec"].shape[-2], n_fft, hop))
    return calls


def sweep(dev) -> dict:
    """Device ms of each call for each block shape of the grid, after
    checking its output against the default's bit for bit."""
    calls = kernel_calls(dev)
    base = {name: digest(fn()) for name, (fn, _) in calls.items()}
    out = {}
    try:
        for threads in SWEEP_THREADS:
            for tile in SWEEP_TILES:
                for per_sm in SWEEP_BLOCKS_PER_SM:
                    k2.THREADS, k2.TILE_FRAMES, k2.BLOCKS_PER_SM = threads, tile, per_sm
                    for scale in SEGMENT_SCALES:
                        times = {}
                        for name, (fn, plan_args) in calls.items():
                            k2.SEGMENT_ROWS = 0
                            try:
                                plan = k2.plan_for(*plan_args, "hann", "full", dev)[0]
                            except RuntimeError as e:   # more frames than a round holds
                                times[name] = str(e)
                                continue
                            k2.SEGMENT_ROWS = max(1, round(plan.seg_rows * scale))
                            if digest(fn()) != base[name]:
                                raise SystemExit(
                                    f"{name}: threads {threads}, tile {tile}, blocks/SM "
                                    f"{per_sm}, segment {k2.SEGMENT_ROWS} changed the output")
                            times[name] = graph_ms(fn)
                        key = (f"threads {threads or 'auto'}, tile {tile}, blocks/SM "
                               f"{per_sm}, segment x{scale}")
                        out[key] = {"total_ms": sum(v for v in times.values()
                                                    if isinstance(v, float)), **times}
    finally:
        k2.THREADS, k2.TILE_FRAMES, k2.BLOCKS_PER_SM, k2.SEGMENT_ROWS = 0, 0, 2, 0
    return out


def ablate(dev) -> dict:
    """Device ms of each call for the unedited kernel and each edited copy,
    the libraries taking turns (unedited first and last)."""
    from gan_sass_tf_tpu_torch.ops import build

    calls = {name: fn for name, (fn, _) in kernel_calls(dev).items()}
    src = (build.CSRC / "masked_istft.cu").read_text()
    with tempfile.TemporaryDirectory(dir=build.build_dir()) as tmp:
        dirs = {}
        for what, edits in ABLATIONS.items():
            d = Path(tmp) / str(len(dirs))
            shutil.copytree(build.CSRC, d)
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"ablation {what!r}: {old!r} is not in the source")
                text = text.replace(old, new)
            (d / "masked_istft.cu").write_text(text)
            dirs[what] = d
        with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
            libs = dict(zip(dirs, pool.map(lambda d: build.load_variant(csrc=d),
                                           dirs.values())))
    default = build.load_library()
    order = [("unedited", default), *libs.items(), ("unedited again", default)]
    out = {}
    try:
        for what, lib in order:
            build._lib = lib
            k2.synthesis_plan.cache_clear()   # a plan is prepared by its library
            out[what] = {name: graph_ms(fn) for name, fn in calls.items()}
    finally:
        build._lib = default
        k2.synthesis_plan.cache_clear()
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_synthesis: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    mode = next((a[2:] for a in argv if a in ("--sweep", "--ablate")), "timing")
    result = {"sweep": sweep, "ablate": ablate, "timing": run}[mode](dev)
    print(json.dumps({"device": smi, "package": gan_sass_tf_tpu_torch.__file__,
                      "samples": SAMPLES, "calls_per_sample": CALLS, mode: result}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
