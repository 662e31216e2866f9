"""Time the analysis kernels (K1, K4 and K3's backward) on one CUDA card.

    python -m gan_sass_tf_tpu_torch.scripts.time_analysis [--sweep | --ablate]

At the main path's shapes (K1 at the `wsj0_logmel` bench step, 128 ×
23 936 mixtures with mag, log|X| and log-mel and their 256 target rows
with mag and log|X|, and at its separate() batch; K1 at the
`stream_v5e8` and `music_complex_44k` steps, a streaming group and one
chunk, and the `3src_pit` step and separation; K4 at the stream and
music bound shapes; the adjoint at the stream step) it prints one JSON line
with, for each call: the kernel's device ms (CUDA events around a
replayed CUDA graph of back-to-back calls), the wrapper's ms (CUDA events
around back-to-back calls: host time included), `torch.stft`'s on the same
frames and window, the plain version's (torch.profiler), the bound
(bytes at 3.35 TB/s against FFT flops at 67 TFLOP/s f32) and its share,
and a sha256 of the kernel's outputs (time_synthesis.py prints those of
the synthesis kernels, K2 and K3).  It uses
only the wrappers' public functions and `ops/cost.py`, so it also times
another checkout's kernels (one that has `ops/cost.py`): run it by path
with PYTHONPATH at that checkout,

    PYTHONPATH=/path/to/other python gan_sass_tf_tpu_torch/scripts/time_analysis.py

and equal digests say that two checkouts' kernels give the same bits.

--sweep (this checkout only) times the kernels' device ms for each block
shape of a grid of threads (the kernel's compile-time STFT_THREADS, one
library built for each), ops.stft_features.TILE_ROUNDS and BLOCKS_PER_SM,
after checking that every shape gives the same outputs bit for bit (each
frame's arithmetic does not depend on the block shape).

--ablate (this checkout only) builds edited copies of csrc/stft_features.cu
that each leave one part of the work out (ABLATIONS: the FFT passes, sqrt
and log, the log-mel band sums, the epilogue's outputs) and times each
beside the unedited kernel, in turns, for what each part costs; their
outputs are wrong by design and are not compared.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import gan_sass_tf_tpu_torch
from gan_sass_tf_tpu_torch.dsp.features import mel_filterbank
from gan_sass_tf_tpu_torch.dsp.windows import get_window
from gan_sass_tf_tpu_torch.ops import build, cost
from gan_sass_tf_tpu_torch.ops import istft as k3
from gan_sass_tf_tpu_torch.ops import stft as k4
from gan_sass_tf_tpu_torch.ops import stft_features as k1
from gan_sass_tf_tpu_torch.scripts import time_synthesis as synth

SWEEP_THREADS = (128, 256, 512)
SWEEP_ROUNDS = (1, 2, 4)
SWEEP_BLOCKS_PER_SM = (1, 2, 3, 4)
# (name, rows, samples, n_fft, hop, sample rate, K1 emits or "stft" (K4)
# or "adjoint").
SHAPES = (
    ("stft_features wsj0_logmel step mixtures", 128, 23936, 512, 128, 8000,
     ("mag", "logmag", "logmel")),
    ("stft_features wsj0_logmel step targets", 256, 23936, 512, 128, 8000,
     ("mag", "logmag")),
    ("stft_features wsj0_logmel separate()", 16, 23936, 512, 128, 8000,
     ("spec", "logmel")),
    ("stft_features stream_v5e8 step", 64, 32000, 512, 128, 16000, ("spec",)),
    ("stft_features music_complex_44k step mixtures", 8, 132300, 2048, 512,
     44100, ("spec", "mag", "logmag")),
    ("stft_features music_complex_44k step targets", 16, 132300, 2048, 512,
     44100, ("logmag", "spec")),
    ("stft stream_v5e8 sources", 64, 32000, 512, 128, 16000, "stft"),
    ("stft music_complex_44k sources", 16, 132300, 2048, 512, 44100, "stft"),
    ("istft_adjoint stream_v5e8 step", 64, 32000, 512, 128, 16000, "adjoint"),
    ("stft_features stream_v5e8 streaming group", 8, 16000, 512, 128, 16000,
     ("spec", "logmag")),
    ("stft_features stream_v5e8 one chunk", 1, 16000, 512, 128, 16000,
     ("spec", "logmag")),
    ("stft_features 3src_pit step mixtures", 16, 23936, 512, 128, 8000,
     ("mag", "logmag")),
    ("stft_features 3src_pit step targets", 48, 23936, 512, 128, 8000, ("logmag",)),
    ("stft_features 3src_pit separation", 16, 23936, 512, 128, 8000,
     ("spec", "logmag")),
)
N_MELS = 80
# Edits of csrc/stft_features.cu, each leaving one part of the work out.
ABLATIONS = {
    "no FFT passes": [(
        "fft_frame<L>(v, zbuf + group * G::ZS, t, group, ptw, w);",
        "for (int s2 = 0; s2 < kPoints; ++s2) "
        "zbuf[group * G::ZS + zout(t + TF * s2)] = v[s2];")],
    "no sqrt or log": [
        ("m[e] = sqrtf(__fmaf_rn(re[e], re[e], __fmul_rn(im[e], im[e])));",
         "m[e] = __fmaf_rn(re[e], re[e], __fmul_rn(im[e], im[e]));"),
        ("lm[e] = logf(m[e] + p.eps);", "lm[e] = m[e] + p.eps;"),
        ("return logf(acc + p.eps);", "return acc + p.eps;")],
    "no log-mel band sums": [(
        "const int k0 = lo[mb], k1 = hi[mb];", "const int k0 = lo[mb], k1 = k0 - 1;")],
    "no epilogue outputs": [(
        "const size_t gb = g0 - a + kW * (size_t)u;   // a multiple of kW",
        "const size_t gb = g0 - a + kW * (size_t)u;\n        "
        "if (re[0] != 1234.5f) continue;")],
}


def digest(out) -> str:
    """sha256 of a tensor's, a tuple's or a dict's bytes, in order."""
    h = hashlib.sha256()
    parts = (out[k] for k in sorted(out)) if isinstance(out, dict) else (
        out if isinstance(out, tuple) else (out,))
    for a in parts:
        h.update(a.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def planes(d):
    """The adjoint's (dre, dim) planes, from its interleaved (..., 2) output
    (or from an older checkout's pair of planes), so that digests compare
    the same bytes in the same order."""
    return d if isinstance(d, tuple) else tuple(d.unbind(-1))


def cases(dev) -> dict:
    """{name: (kernel call, plain call, torch.stft call, bound)} on seeded
    inputs."""
    rng = np.random.default_rng(0)
    out = {}
    for name, b, t, n_fft, hop, sr, what in SHAPES:
        x = torch.from_numpy(rng.standard_normal((b, t), np.float32)).to(dev)
        w = torch.from_numpy(get_window("hann", n_fft)).to(dev)
        library = (lambda x=x, n=n_fft, h=hop, w=w: torch.stft(
            x, n, h, window=w, center=False, return_complex=True))
        if what == "stft":
            out[name] = (lambda x=x, n=n_fft, h=hop: k4.stft_kernel(x, n, h),
                         lambda x=x, n=n_fft, h=hop: k4.stft_reference(x, n, h),
                         library, cost.stft(b, t, n_fft, hop).bound())
        elif what == "adjoint":
            f = 1 + (t - n_fft) // hop
            inv = synth.k2._inv_env(n_fft, hop, "hann", f, dev)
            a_k = k3._bin_weights(n_fft, dev)
            out[name] = (
                lambda x=x, n=n_fft, h=hop, f=f: planes(k3.istft_adjoint(x, n, h, "hann", f)),
                lambda x=x, n=n_fft, h=hop, i=inv, a=a_k: torch.view_as_real(
                    k1.stft_features_reference(x * i, n, h)["spec"]) * a,
                library, cost.stft(b, t, n_fft, hop).bound())
        else:
            mel = (torch.from_numpy(mel_filterbank(N_MELS, n_fft // 2 + 1, sr)).to(dev)
                   if "logmel" in what else None)
            out[name] = (
                lambda x=x, n=n_fft, h=hop, e=what, m=mel: k1.stft_features_kernel(
                    x, n, h, emit=e, mel_matrix=m),
                lambda x=x, n=n_fft, h=hop, e=what, m=mel: k1.stft_features_reference(
                    x, n, h, emit=e, mel_matrix=m),
                library, cost.stft_features(b, t, n_fft, hop, what,
                                             N_MELS if mel is not None else 0).bound())
    return out


def run(dev) -> dict:
    out = {}
    for name, (kernel, plain, library, (bound, by)) in cases(dev).items():
        first, again = kernel(), kernel()
        ms = synth.graph_ms(kernel)
        out[name] = {"device_ms": ms, "wrapper_ms": synth.wrapper_ms(kernel=kernel)["kernel"],
                     "torch_stft_ms": synth.graph_ms(library),
                     "plain_device_ms": synth.device_ms(plain),
                     "bound_ms": bound, "bound_by": by, "share": bound / ms,
                     "repeat_bit_equal": digest(first) == digest(again),
                     "digest": digest(first)}
    return out


def sweep(dev) -> dict:
    """Device ms of each case for each block shape of the grid, after
    checking its outputs against the default shape's bit for bit."""
    calls = {name: kernel for name, (kernel, *_) in cases(dev).items()}
    base = {name: fn() for name, fn in calls.items()}
    with concurrent.futures.ThreadPoolExecutor(len(SWEEP_THREADS)) as pool:
        libs = dict(zip(SWEEP_THREADS, pool.map(
            lambda n: build.load_variant((f"-DSTFT_THREADS={n}",)), SWEEP_THREADS)))
    default = build.load_library()
    out = {}
    try:
        for threads, lib in libs.items():
            build._lib = lib
            for rounds in SWEEP_ROUNDS:
                for per_sm in SWEEP_BLOCKS_PER_SM:
                    k1.TILE_ROUNDS, k1.BLOCKS_PER_SM = rounds, per_sm
                    for name, fn in calls.items():
                        got = fn()
                        if digest(got) != digest(base[name]):
                            raise SystemExit(
                                f"{name}: threads {threads}, rounds {rounds}, blocks/SM "
                                f"{per_sm} changed the output by up to "
                                f"{synth.max_err(got, base[name])}")
                    times = {name: synth.graph_ms(fn) for name, fn in calls.items()}
                    out[f"threads {threads}, rounds {rounds}, blocks/SM {per_sm}"] = {
                        "total_ms": sum(times.values()), **times}
    finally:
        build._lib = default
    return out


def ablate(dev) -> dict:
    """Device ms of each case for the unedited kernel and each edited copy,
    the libraries taking turns (unedited first and last)."""
    calls = {name: kernel for name, (kernel, *_) in cases(dev).items()}
    src = (build.CSRC / "stft_features.cu").read_text()
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
            (d / "stft_features.cu").write_text(text)
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
            out[what] = {name: synth.graph_ms(fn) for name, fn in calls.items()}
    finally:
        build._lib = default
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_analysis: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    mode = next((a[2:] for a in argv if a in ("--sweep", "--ablate")), "timing")
    result = {"sweep": sweep, "ablate": ablate, "timing": run}[mode](dev)
    print(json.dumps({"device": smi, "package": gan_sass_tf_tpu_torch.__file__,
                      "samples": synth.SAMPLES, "calls_per_sample": synth.CALLS,
                      mode: result}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
