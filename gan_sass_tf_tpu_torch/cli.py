"""Command line for the PyTorch port.

    python -m gan_sass_tf_tpu_torch.cli configs
    python -m gan_sass_tf_tpu_torch.cli train --config stream_v5e8 --workdir runs/a \
        [--steps 20] [--no-resume] [--profile-steps 2:4] [--tensorboard] \
        [--debug-nans] [--debug-leaks]
    python -m gan_sass_tf_tpu_torch.cli eval --config stream_v5e8 --workdir runs/a [--best]
    python -m gan_sass_tf_tpu_torch.cli separate --config stream_v5e8 --workdir runs/a \
        [--best] --input mix.wav --output-dir out/ [--streaming [--streaming-mode scan]]
    python -m gan_sass_tf_tpu_torch.cli separate --config wsj0_logmel \
        --params g.npz --input mix.wav --output-dir out/

`train` runs the alternating G/D loop; with `--workdir` it checkpoints
there and resumes from the newest checkpoint (unless `--no-resume`),
writes a torch.profiler Chrome trace of steps [A, B) under
`<workdir>/profile` with `--profile-steps A:B`, and mirrors its metrics to
TensorBoard event files under `<workdir>/tb` with `--tensorboard`.
`--debug-nans` raises FloatingPointError at the first non-finite value in
a step (autograd's anomaly mode, the metrics and the train state);
`--debug-leaks` raises when a tensor of the train state or a metric
carries an autograd graph out of a step.
`eval` scores the generator on held-out mixtures; `separate` writes
<stem>_src<i>.wav per source, one-shot or `--streaming` in overlapping
chunks (`batch`: groups of stream.batch_chunks chunks; `scan`: one chunk
at a time).  For `eval` and `separate` a workdir's config.json is
authoritative and `--best` loads its best checkpoint by held-out SI-SDRi;
without a workdir, `eval` scores a seeded init and `separate` takes
`--params`, a flat `.npz` of flax generator params ("/"-joined paths, see
models/convert.py), e.g. a generator the JAX package trained.  `--device`
defaults to cuda and fails when no GPU is visible; the CPU runs only when
asked for with `--device cpu`.

Data parallel: under torchrun, `train`, `eval` and `separate` join the
process group first (NCCL, one rank a GPU, `--device cuda` meaning
cuda:LOCAL_RANK; gloo with `--device cpu`):

    torchrun --nproc_per_node 4 -m gan_sass_tf_tpu_torch.cli train \
        --config stream_v5e8 --set mesh.data_axis_size=-1 --workdir runs/a

`train` and `eval` split each global batch over the ranks, `separate
--streaming` in batch mode each chunk group; one-shot and scan-mode
separation run on rank 0.  Only rank 0 prints, writes the workdir and
writes wavs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from gan_sass_tf_tpu_torch import config as config_lib


def _apply_overrides(cfg, overrides):
    """`--set sec.key=val` overrides, one dataclass replace per section so
    that __post_init__ validation sees them together (a copy of the JAX
    CLI's helper)."""
    per_section: dict = {}
    for item in overrides:
        path, _, raw = item.partition("=")
        sec, _, key = path.partition(".")
        old = getattr(getattr(cfg, sec), key)   # raises AttributeError on typos
        typ = type(old)
        if typ is bool:
            val = raw.lower() in ("1", "true", "yes")
        elif typ is tuple:
            def _elem(x):
                try:
                    return int(x)
                except ValueError:
                    return float(x)
            val = tuple(_elem(x) for x in raw.split(","))
        elif old is None:
            val = raw
        else:
            val = typ(raw)
        per_section.setdefault(sec, {})[key] = val
    return cfg.replace(**{
        sec: dataclasses.replace(getattr(cfg, sec), **kw)
        for sec, kw in per_section.items()
    })


def _add_common(p):
    p.add_argument("--config", required=True, help="preset name")
    p.add_argument("--device", default="cuda", help="torch device")
    p.add_argument("--workdir", default=None,
                   help="run directory (checkpoints, best/, metrics.jsonl)")
    p.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL",
                   help="config override, e.g. train.batch_size=8")


def _workdir_config(args, cfg, say):
    """For eval and separate against a workdir: its stored config (`cfg`
    where it has none yet), or None after printing why not."""
    cfg_path = os.path.join(args.workdir, "config.json")
    if not os.path.exists(cfg_path):
        return cfg
    with open(cfg_path) as f:
        stored = config_lib.Config.from_json(f.read())
    if stored.name != cfg.name:
        print(f"error: workdir was trained with config {stored.name!r}, not "
              f"{cfg.name!r}", file=sys.stderr)
        return None
    if args.set:
        say("note: ignoring --set overrides; using the workdir's stored config")
    return stored


def _quiet(*args, **kwargs) -> None:
    """print() for the ranks after rank 0."""


def _write_sources(srcs, sr: int, in_path: str, out_dir: str) -> None:
    from gan_sass_tf_tpu_torch.utils.wav_io import write_wav

    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(in_path))[0]
    for i, w in enumerate(srcs):
        path = os.path.join(out_dir, f"{stem}_src{i}.wav")
        write_wav(path, sr, w)
        print(path)


def _separate(args, cfg, g, device, main: bool) -> int:
    """One-shot and scan-mode separation on rank 0 (`main`); batch-mode
    streaming on every rank, rank 0 writing."""
    from gan_sass_tf_tpu_torch import infer
    from gan_sass_tf_tpu_torch.utils.wav_io import read_wav

    batched = args.streaming and args.streaming_mode == "batch"
    if not (main or batched):
        return 0
    if not args.streaming:
        for p in infer.separate_file(g, cfg, args.input, args.output_dir, device):
            print(p)
        return 0
    sr, wav = read_wav(args.input)
    if sr != cfg.dsp.sample_rate:
        print(f"error: wav sample rate {sr} != config {cfg.dsp.sample_rate}",
              file=sys.stderr)
        return 1
    fn = infer.separate_streaming if batched else infer.separate_streaming_scan
    srcs = fn(g, cfg, wav, device)
    if main:
        _write_sources(srcs, sr, args.input, args.output_dir)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gan_sass_tf_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_train = sub.add_parser("train", help="run the alternating G/D training loop")
    _add_common(p_train)
    p_train.add_argument("--steps", type=int, default=None)
    p_train.add_argument("--no-resume", action="store_true",
                         help="start from a seeded init even if the workdir "
                              "holds checkpoints")
    p_train.add_argument("--profile-steps", default=None, metavar="A:B",
                         help="capture a torch.profiler trace for steps [A, B) "
                              "under <workdir>/profile")
    p_train.add_argument("--debug-nans", action="store_true",
                         help="trip on the first non-finite value in the step")
    p_train.add_argument("--debug-leaks", action="store_true",
                         help="trip on a tensor that carries an autograd graph "
                              "out of the step")
    p_train.add_argument("--tensorboard", action="store_true",
                         help="mirror metrics to <workdir>/tb as TensorBoard "
                              "event files")
    p_eval = sub.add_parser("eval", help="SI-SDR evaluation on held-out mixtures")
    _add_common(p_eval)
    p_eval.add_argument("--batches", type=int, default=8)
    p_sep = sub.add_parser("separate", help="separate a mixture wav into sources")
    _add_common(p_sep)
    p_sep.add_argument("--params", default=None,
                       help="flax generator params as a flat .npz (instead of "
                            "--workdir)")
    p_sep.add_argument("--input", required=True, help="mixture wav path")
    p_sep.add_argument("--output-dir", required=True)
    p_sep.add_argument("--streaming", action="store_true",
                       help="separate in overlapping chunks")
    p_sep.add_argument("--streaming-mode", choices=["batch", "scan"],
                       default="batch",
                       help="batch: groups of stream.batch_chunks chunks "
                            "(throughput); scan: one chunk at a time, carrying "
                            "the overlap (latency)")
    for p in (p_eval, p_sep):
        p.add_argument("--best", action="store_true",
                       help="use the workdir's best checkpoint by held-out "
                            "SI-SDRi instead of the newest")
    sub.add_parser("configs", help="list available config presets")
    args = parser.parse_args(argv)

    if args.cmd == "configs":
        for name in config_lib.list_configs():
            print(name)
        return 0

    if args.cmd == "separate" and (args.params is None) == (args.workdir is None):
        print("error: separate takes exactly one of --workdir (a run of this "
              "port) and --params (a flat .npz of flax generator params)",
              file=sys.stderr)
        return 1
    if getattr(args, "best", False) and not args.workdir:
        print("error: --best needs --workdir", file=sys.stderr)
        return 1
    import torch

    from gan_sass_tf_tpu_torch.parallel import run_in_group

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is visible "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    return run_in_group(args.device, lambda device: _run(args, device))


def _run(args, device) -> int:
    """train, eval or separate on `device`, in the process group if one
    was joined."""
    import torch.distributed as dist

    main = not dist.is_initialized() or dist.get_rank() == 0
    say = print if main else _quiet
    cfg = _apply_overrides(config_lib.get_config(args.config), args.set)
    if args.cmd == "separate" and args.params:
        from gan_sass_tf_tpu_torch.models import load_flax_npz, load_generator

        return _separate(args, cfg, load_generator(cfg, load_flax_npz(args.params),
                                                   device), device, main)
    if args.cmd != "train" and args.workdir:
        cfg = _workdir_config(args, cfg, say)
        if cfg is None:
            return 1

    from gan_sass_tf_tpu_torch.train import Experiment

    if args.cmd == "train":
        from gan_sass_tf_tpu_torch.utils.profiler import parse_profile_steps

        exp = Experiment(cfg, workdir=args.workdir, device=device,
                         resume=not args.no_resume, debug_nans=args.debug_nans,
                         debug_leaks=args.debug_leaks, tensorboard=args.tensorboard)
        if exp.state.step:
            say(f"resumed from step {exp.state.step}", flush=True)

        def log(step, m):
            say(f"step {step}: g={m['g_loss']:.4f} d={m['d_loss']:.4f} "
                f"recon={m['g_recon']:.4f} "
                f"thr={m['mixture_sec_per_sec']:.1f} mix-s/s", flush=True)

        exp.train(num_steps=args.steps, log_fn=log, profile_steps=(
            parse_profile_steps(args.profile_steps) if args.profile_steps else None))
        exp.close()
        return 0

    exp = Experiment(cfg, workdir=args.workdir, device=device)
    try:
        if args.best:
            say(f"using best checkpoint (step {exp.restore_best()})")
        if args.cmd == "eval":
            for k, v in exp.evaluate(num_batches=args.batches).items():
                say(f"{k}: {v:.3f}")
            return 0
        if exp.state.step == 0:
            print(f"error: no checkpoint under {args.workdir!r} to separate "
                  "with", file=sys.stderr)
            return 1
        return _separate(args, cfg, exp.eval_generator(), device, main)
    finally:
        exp.close()


if __name__ == "__main__":
    sys.exit(main())
