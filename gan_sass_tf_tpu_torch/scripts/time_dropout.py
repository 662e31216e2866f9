"""Time a train step's threefry draws: the device ms a step of its dropout,
noise, sampler and batch launches, the step's device ms graphed and eager, and
the eager step's peak memory; or the noise and the sampler alone at the
steps' shapes; or the dropout forward and the noise against edited copies
of their kernels.

    python -m gan_sass_tf_tpu_torch.scripts.time_dropout [PRESET|bench] [BATCH]
        [--set sec.key=val ...]
    python -m gan_sass_tf_tpu_torch.scripts.time_dropout --kernels
    python -m gan_sass_tf_tpu_torch.scripts.time_dropout --ablate

Default: `stream_v5e8` at batch 32 with every model option on
(`EVERY_OPTION`, chip_smoke.py's options-phase step: dropout 0.1 at G's
and D's sites, instance noise, g_remat, the patch BN D, ...), synthetic
data and the device bank; `--set` replaces the options.  `bench` is the
bench's workload (`bench.bench_config`, batch 128 unless given; no
options).  Runs `WARMUP` eager steps, captures the step
(`train/graphed.py`), then traces `STEPS` eager steps and `STEPS` replays
with torch.profiler (`utils/profiler.py`) and prints one JSON line, the
values unrounded:
  {"nvidia_smi", "preset", "batch", "sets",
   "device_ms": {"graphed", "eager"},    kernels, copies and fills a step
   "<g>_ms": {"graphed", "eager"},       for each of `GROUPS` (dropout,
                                         noise, sample, batch): the device ms a
                                         step of the kernels whose name
                                         holds one of its substrings
   "<g>_kernels": {"graphed", "eager"}: {kernel: [ms, launches] a step}
   "peak_mib", "allocated_mib"}          the eager step's peak memory
                                         (max_memory_allocated after a
                                         reset) and what was held before it
`--kernels` times the noise kernel at the every-option step's largest D
input (`NOISE_SITE`) in bf16 and float32, and the sampler at the
stream_v5e8 step's noise (`SAMPLE_NORMALS`) and the bench step's draws
(`SAMPLE_DRAWS`, each kind), beside the PyTorch calls that draw as many
numbers with Philox bits (`torch.normal`, `torch.randn`, `torch.randint`,
`torch.rand`; used nowhere in the port); device ms from a replayed CUDA
graph (scripts/time_synthesis.py).
`--ablate` builds copies of `csrc/threefry.cu` edited by `ABLATIONS` and
times `threefry_dropout_kernel` at the every-option step's largest site
(`SITE`, bf16) or `threefry_noise_kernel` at `NOISE_SITE` (bf16 and
float32), the libraries taking turns (unedited first and last), with each
copy's SASS counts (scripts/kernel_sass.py): some copies change only how
the same arithmetic is issued (nvcc picks the cipher's adds' pipe; the
noise's terms computed an element instead of looked up; scalar loads and
stores), and their outputs are held to the unedited kernel's; the others
leave a part of the dropout's work out (the cipher, the walk), so their
outputs are wrong by design and are not compared.
The file runs on an older checkout of the package too (`PYTHONPATH=that
tree python path/to/time_dropout.py`), so two versions are timed in one
call, in turns.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import shutil
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.cli import _apply_overrides
from gan_sass_tf_tpu_torch.scripts import split_args
from gan_sass_tf_tpu_torch.scripts.profile_step import nvidia_smi
from gan_sass_tf_tpu_torch.utils import profiler

STEPS, WARMUP = 10, 3
EVERY_OPTION = ("model.discriminator=patch", "model.d_norm=batch",
                "model.d_input_fold=2", "model.dropout=0.1",
                "train.d_instance_noise=0.1", "model.g_stem_mode=conv",
                "model.g_stem_stride=1,2", "model.g_head_mode=film",
                "model.g_dec_l0=subpixel", "model.g_phase_ct=true",
                "model.g_remat=true")
SITE = ((128, 32, 123, 65), (0, 2, 3, 1), 0.1)   # shape, flax dims, p
NOISE_SITE = ((128, 123, 257, 4), 0.1)          # the D update's input, std
SAMPLE_NORMALS = (32, 32000)                    # stream_v5e8 b32's noise, R x n
SAMPLE_DRAWS = (128, 2)                         # the bench step's picks and shifts
# {group: substrings of a kernel's lower-cased name}
GROUPS = {"dropout": ("dropout",), "noise": ("threefry_noise",),
          "sample": ("threefry_sample",), "batch": ("threefry_batch",)}
_KEEP = "const bool keep = bits(site, j, imad) <= keep_max;"
_VEC = "const bool noise_vec = aligned16(x) && aligned16(y);"
_BRANCH = """  float p;
  if (w < 5.0f)
    p = horner(kSmall, __fsub_rn(w, 2.5f));
  else
    p = horner(kLarge, __fsub_rn(__fsqrt_rn(w), 3.0f));
"""
_SELECT = """  const bool small = w < 5.0f;
  const float v = small ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = small ? kSmall[0] : kLarge[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, v, small ? kSmall[i] : kLarge[i]);
"""
# {name: (kernels timed, edits of csrc/threefry.cu, whether the output stays exact)}
ABLATIONS = {
    "adds as nvcc picks": (
        ("dropout",), [(_KEEP, "const bool keep = bits(site, j) <= keep_max;")], True),
    "no cipher": (("dropout",), [(_KEEP, "const bool keep = (j ^ site.x) <= keep_max;")],
                  False),
    "no walk": (("dropout",), [("  if (__builtin_expect(--left == 0, 0)) {",
                                "  if (false) {")], False),
    "noise: no table": (("noise",), [("table[(b & 0xFFu) >> 1]",
                                      "bf16_noise((b & 0xFFu) >> 1, coef)")], True),
    "noise: adds as nvcc picks": (("noise",), [("bits(k, j, imad)", "bits(k, j)")], True),
    "noise: scalar accesses": (("noise",), [(_VEC, "const bool noise_vec = false;")], True),
    "erf_inv selects (PR 15's)": (("noise", "sample"), [(_BRANCH, _SELECT)], True),
}
# The mangled names' marks of the functions whose SASS each kernel's copies report.
SASS_OF = {"dropout": ("threefry_dropout_kernelI13",),
           "noise": ("threefry_noise_kernelI13", "threefry_noise_kernelIf"),
           "sample": ("threefry_sample_kernelILi3ELj4E",)}


def traced(fn, calls: int = STEPS) -> tuple:
    """(device ms a call, {group: {kernel: [ms, launches] a call}}) over
    `calls` traced calls of `fn` (one untimed call first)."""
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiler.profile_trace(tmp):
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = profiler.device_events(profiler.load_trace(profiler.trace_files(tmp)[-1]))
    groups = {g: defaultdict(lambda: [0.0, 0.0]) for g in GROUPS}
    for e in events:
        for g, marks in GROUPS.items():
            if any(m in e["name"].lower() for m in marks):
                groups[g][e["name"]][0] += e["dur"] / calls / 1e3
                groups[g][e["name"]][1] += 1 / calls
    return sum(e["dur"] for e in events) / calls / 1e3, {g: dict(k) for g, k in groups.items()}


def kernels_alone() -> dict:
    """{case: {"ms", "library_ms"}}: the noise at NOISE_SITE in bf16 and
    float32, the sampler's normals at SAMPLE_NORMALS and each kind at
    SAMPLE_DRAWS, each beside the PyTorch call that draws as many numbers."""
    from gan_sass_tf_tpu_torch.data.threefry import prng_key
    from gan_sass_tf_tpu_torch.ops import threefry as rng_ops
    from gan_sass_tf_tpu_torch.scripts.time_synthesis import graph_ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    key = prng_key(0, dev)
    shape, std = NOISE_SITE
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(shape, device=dev, generator=gen).to(dt)
        out[f"noise {shape} {dt}"] = {
            "ms": graph_ms(lambda: rng_ops.noise_kernel(x, key, std)),
            "library_ms": graph_ms(lambda: torch.normal(x, std)),
            "library": "torch.normal(x, std)"}
    draws = [(SAMPLE_NORMALS, "normal", 0.0, 1.0, lambda r, n: torch.randn(r, n, device=dev))]
    draws += [(SAMPLE_DRAWS, kind, lo, hi, lib) for kind, lo, hi, lib in (
        ("bits", 0, 1, None),
        ("uniform", -3.0, 3.0, lambda r, n: torch.rand(r, n, device=dev)),
        ("randint", 0, 9, lambda r, n: torch.randint(0, 9, (r, n), device=dev)),
        ("normal", 0.0, 1.0, lambda r, n: torch.randn(r, n, device=dev)))]
    for (r, n), kind, lo, hi, lib in draws:
        keys = rng_ops.example_keys_reference(key, 0, r)[0][0]
        out[f"sample {r} x {n} {kind}"] = {
            "ms": graph_ms(lambda: rng_ops.sample_kernel(keys, n, kind, lo, hi)),
            "library_ms": graph_ms(lambda: lib(r, n)) if lib else None,
            "library": None if lib is None else
            {"normal": "torch.randn", "uniform": "torch.rand",
             "randint": "torch.randint(0, 9)"}[kind]}
    return out


def ablate() -> dict:
    """The device ms of the dropout forward at SITE, the noise at NOISE_SITE
    and the sampler's normals at SAMPLE_NORMALS in the unedited library,
    and of the kernels each ABLATIONS copy edits in that copy, in turns;
    each copy's SASS counts, and whether an exact copy's outputs equal the
    unedited kernel's (the dropout's, the plain version's)."""
    from gan_sass_tf_tpu_torch.data.threefry import prng_key
    from gan_sass_tf_tpu_torch.ops import build
    from gan_sass_tf_tpu_torch.ops import threefry as rng_ops
    from gan_sass_tf_tpu_torch.scripts import kernel_sass
    from gan_sass_tf_tpu_torch.scripts.time_synthesis import graph_ms

    shape, dims, p = SITE
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
    n_shape, std = NOISE_SITE
    xn = {"bf16": torch.randn(n_shape, device=dev, generator=gen).to(torch.bfloat16),
          "f32": torch.randn(n_shape, device=dev, generator=gen)}
    key = prng_key(0, dev)
    keys = rng_ops.example_keys_reference(key, 0, SAMPLE_NORMALS[0])[0][0]
    timed = {"dropout": {"": lambda: rng_ops.dropout_kernel(x, key, 1, p, dims)},
             "noise": {f" {dt}": (lambda v=v: rng_ops.noise_kernel(v, key, std))
                       for dt, v in xn.items()},
             "sample": {" normal": lambda: rng_ops.sample_kernel(
                 keys, SAMPLE_NORMALS[1], "normal")}}
    src = (build.CSRC / "threefry.cu").read_text()
    with tempfile.TemporaryDirectory(dir=build.build_dir()) as tmp:
        dirs = {}
        for what, (_, edits, _) in ABLATIONS.items():
            d = Path(tmp) / str(len(dirs))
            shutil.copytree(build.CSRC, d)
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"ablation {what!r}: {old!r} is not in the source")
                text = text.replace(old, new)
            (d / "threefry.cu").write_text(text)
            dirs[what] = d
        with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
            libs = dict(zip(dirs, pool.map(lambda d: build.load_variant(csrc=d),
                                           dirs.values())))
        sass = {}
        for what, d in dirs.items():
            for f, ops in kernel_sass.functions(kernel_sass.disassemble(
                    build.library_path(csrc=d))).items():
                if any(m in f for g in ABLATIONS[what][0] for m in SASS_OF[g]):
                    sass.setdefault(what, {})[kernel_sass.short(f)] = {
                        k: v for k, v in kernel_sass.tally(ops).items() if k != "by_opcode"}
    default = build.load_library()
    want = {g: {c: fn() for c, fn in fns.items()} for g, fns in timed.items()}
    want["dropout"][""] = rng_ops.dropout_reference(x, key, 1, p, dims)
    out = {}
    try:
        for what, lib in [("unedited", default), *libs.items(), ("unedited again", default)]:
            build._lib = lib
            row = {}
            for g in (ABLATIONS[what][0] if what in ABLATIONS else list(timed)):
                for c, fn in timed[g].items():
                    row[f"{g}{c} ms"] = graph_ms(fn)
                    if ABLATIONS.get(what, (g, (), True))[2]:
                        got, ref = fn(), want[g][c]
                        same = (all(torch.equal(a, b) for a, b in zip(got, ref))
                                if isinstance(got, tuple) else torch.equal(got, ref))
                        row[f"{g}{c} exact"] = same
            out[what] = {**row, **({"sass": sass[what]} if what in sass else {})}
    finally:
        build._lib = default
    return out


def main(argv=None) -> int:
    from gan_sass_tf_tpu_torch.train.experiment import Experiment
    from gan_sass_tf_tpu_torch.train.graphed import WARMUP_STEPS

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("error: time_dropout times the card; no CUDA device is visible")
    if argv == ["--ablate"]:
        print(json.dumps({"nvidia_smi": nvidia_smi(), "site": SITE,
                          "noise_site": NOISE_SITE, "ablate": ablate()}), flush=True)
        return 0
    if argv == ["--kernels"]:
        print(json.dumps({"nvidia_smi": nvidia_smi(), "kernels": kernels_alone()}), flush=True)
        return 0
    pos, opts = split_args(argv)
    preset = pos[0] if pos else "stream_v5e8"
    if preset == "bench":
        from gan_sass_tf_tpu_torch.bench import bench_config

        batch = int(pos[1]) if len(pos) > 1 else 128
        sets = opts["--set"]
        cfg = _apply_overrides(bench_config(batch, 1), sets)
    else:
        batch = int(pos[1]) if len(pos) > 1 else 32
        sets = opts["--set"] or list(EVERY_OPTION)
        cfg = _apply_overrides(config.get_config(preset), sets)
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset="synthetic"),
                          train=dataclasses.replace(cfg.train, batch_size=batch))
    exp = Experiment(cfg, workdir=None, device=torch.device("cuda", 0))
    for _ in range(WARMUP):
        exp._step(exp._step_data(None))
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    exp._step(exp._step_data(None))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    exp.run_steps(WARMUP_STEPS + 1)           # the eager warm-up, the capture
    steps = {"graphed": lambda: exp.run_steps(1),
             "eager": lambda: exp._step(exp._step_data(None))}
    device, launched = {}, {}
    for mode, fn in steps.items():
        device[mode], launched[mode] = traced(fn)
    groups = {}
    for g in GROUPS:
        by_mode = {m: k[g] for m, k in launched.items()}
        groups[f"{g}_ms"] = {m: sum(ms for ms, _ in k.values()) for m, k in by_mode.items()}
        groups[f"{g}_kernels"] = by_mode
    print(json.dumps({
        "nvidia_smi": nvidia_smi(), "preset": preset, "batch": batch, "sets": sets,
        "device_ms": device, **groups,
        "peak_mib": peak / 2 ** 20, "allocated_mib": allocated / 2 ** 20}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
