"""Time a train step's dropout: its launches' device ms a step, the step's
device ms graphed and eager, and the eager step's peak memory; or the
forward kernel against edited copies of it.

    python -m gan_sass_tf_tpu_torch.scripts.time_dropout [PRESET] [BATCH]
        [--set sec.key=val ...]
    python -m gan_sass_tf_tpu_torch.scripts.time_dropout --ablate

Default: `stream_v5e8` at batch 32 with every model option on
(`EVERY_OPTION`, chip_smoke.py's options-phase step: dropout 0.1 at G's
and D's sites, instance noise, g_remat, the patch BN D, ...), synthetic
data and the device bank; `--set` replaces the options.  Runs `WARMUP`
eager steps, captures the step (`train/graphed.py`), then traces `STEPS`
eager steps and `STEPS` replays with torch.profiler (`utils/profiler.py`)
and prints one JSON line, the values unrounded:
  {"nvidia_smi", "preset", "batch", "sets",
   "device_ms": {"graphed", "eager"},    kernels, copies and fills a step
   "dropout_ms": {"graphed", "eager"},   the device ms a step of kernels
                                         whose name holds "dropout"
   "dropout_kernels": {"graphed", "eager"}: {kernel: [ms, launches] a step}
   "peak_mib", "allocated_mib"}          the eager step's peak memory
                                         (max_memory_allocated after a
                                         reset) and what was held before it
`--ablate` builds copies of `csrc/threefry.cu` edited by `ABLATIONS` and
times `threefry_dropout_kernel` at the every-option step's largest site
(`SITE`, bf16) in each, the libraries taking turns (unedited first and
last; device ms from a replayed CUDA graph, scripts/time_synthesis.py),
with each copy's SASS counts (scripts/kernel_sass.py): one copy lets
nvcc pick the cipher's adds' pipe (the kernel forces IMADs on the FMA
pipe; its output is held to the plain version's), the others leave a part
of the work out (the cipher, the walk), so their outputs are wrong by
design and are not compared.
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
_KEEP = "const bool keep = bits(site, j, imad) <= keep_max;"
# {name: (edits of csrc/threefry.cu, whether the output stays exact)}
ABLATIONS = {
    "adds as nvcc picks": ([(_KEEP, "const bool keep = bits(site, j) <= keep_max;")], True),
    "no cipher": ([(_KEEP, "const bool keep = (j ^ site.x) <= keep_max;")], False),
    "no walk": ([("  if (__builtin_expect(--left == 0, 0)) {", "  if (false) {")], False),
}


def traced(fn, calls: int = STEPS) -> tuple:
    """(device ms a call, {dropout kernel: [ms, launches] a call}) over
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
    drop = defaultdict(lambda: [0.0, 0.0])
    for e in events:
        if "dropout" in e["name"].lower():
            drop[e["name"]][0] += e["dur"] / calls / 1e3
            drop[e["name"]][1] += 1 / calls
    return sum(e["dur"] for e in events) / calls / 1e3, dict(drop)


def ablate() -> dict:
    """The forward's device ms at SITE in the unedited library and in each
    ABLATIONS copy, in turns; each copy's SASS counts, and whether an exact
    copy's y and words equal the plain version's."""
    from gan_sass_tf_tpu_torch.data.threefry import prng_key
    from gan_sass_tf_tpu_torch.ops import build
    from gan_sass_tf_tpu_torch.ops import threefry as rng_ops
    from gan_sass_tf_tpu_torch.scripts import kernel_sass
    from gan_sass_tf_tpu_torch.scripts.time_synthesis import graph_ms

    shape, dims, p = SITE
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
    key = prng_key(0, dev)
    ref = rng_ops.dropout_reference(x, key, 1, p, dims)
    src = (build.CSRC / "threefry.cu").read_text()
    with tempfile.TemporaryDirectory(dir=build.build_dir()) as tmp:
        dirs = {}
        for what, (edits, _) in ABLATIONS.items():
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
        sass = {what: {k: v for k, v in kernel_sass.tally(ops).items() if k != "by_opcode"}
                for what, d in dirs.items()
                for f, ops in kernel_sass.functions(kernel_sass.disassemble(
                    build.library_path(csrc=d))).items()
                if "threefry_dropout_kernelI13" in f}
    default = build.load_library()
    out = {}
    try:
        for what, lib in [("unedited", default), *libs.items(), ("unedited again", default)]:
            build._lib = lib
            row = {"ms": graph_ms(lambda: rng_ops.dropout_kernel(x, key, 1, p, dims))}
            if ABLATIONS.get(what, ((), True))[1]:
                got = rng_ops.dropout_kernel(x, key, 1, p, dims)
                row["exact"] = all(torch.equal(a, b) for a, b in zip(got, ref))
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
                          "ablate": ablate()}), flush=True)
        return 0
    pos, opts = split_args(argv)
    preset = pos[0] if pos else "stream_v5e8"
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
    device, kernels = {}, {}
    for mode, fn in steps.items():
        device[mode], kernels[mode] = traced(fn)
    print(json.dumps({
        "nvidia_smi": nvidia_smi(), "preset": preset, "batch": batch, "sets": sets,
        "device_ms": device,
        "dropout_ms": {m: sum(ms for ms, _ in k.values()) for m, k in kernels.items()},
        "dropout_kernels": kernels,
        "peak_mib": peak / 2 ** 20, "allocated_mib": allocated / 2 ** 20}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
