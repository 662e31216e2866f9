"""Quickstart: train a 2-source separator on synthetic mixtures, then
separate a mixture into per-source wavs.

    python -m gan_sass_tf_tpu_torch.examples.quickstart [workdir] [steps] [--device cuda]

Port of `examples/quickstart.py`: `stream_v5e8` at batch 16 from the
device-resident bank (default 2000 steps into runs/quickstart, resuming
from its newest checkpoint), the held-out eval, then one fresh held-out
mixture separated and written with its sources as
<workdir>/mixture.wav and <workdir>/source_<i>.wav.  --device defaults to
cuda and fails when no GPU is visible.
"""

import dataclasses
import os
import sys

import numpy as np

from gan_sass_tf_tpu_torch import config
from gan_sass_tf_tpu_torch.infer import separate
from gan_sass_tf_tpu_torch.scripts import split_args
from gan_sass_tf_tpu_torch.scripts.quality_protocol import device_or_exit
from gan_sass_tf_tpu_torch.train import Experiment
from gan_sass_tf_tpu_torch.utils.wav_io import write_wav


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pos, opts = split_args(argv, ("--device",))
    workdir = pos[0] if pos else "runs/quickstart"
    steps = int(pos[1]) if len(pos) > 1 else 2000
    device = device_or_exit((opts["--device"] or ["cuda"])[-1])

    cfg = config.get_config("stream_v5e8")
    cfg = cfg.replace(
        mesh=dataclasses.replace(cfg.mesh, data_axis_size=-1),
        train=dataclasses.replace(cfg.train, batch_size=16, log_every=200))

    exp = Experiment(cfg, workdir=workdir, device=device)
    exp.train(num_steps=steps, log_fn=lambda s, m: print(
        f"step {s}: g={m['g_loss']:.3f} d={m['d_loss']:.4f} "
        f"recon={m['g_recon']:.4f} ({m['mixture_sec_per_sec']:.0f} mix-s/s)",
        flush=True))
    print("eval:", {k: round(v, 2) for k, v in exp.evaluate().items()})

    # Separate a fresh held-out mixture and write the results.
    sr = cfg.dsp.sample_rate
    mixture = exp.eval_dataset.batch(1).sum(axis=1)[0]       # (T,)
    wavs = separate(exp.state.g, cfg, mixture, device)
    write_wav(os.path.join(workdir, "mixture.wav"), sr, mixture)
    for i, w in enumerate(np.asarray(wavs)):
        path = os.path.join(workdir, f"source_{i}.wav")
        write_wav(path, sr, w)
        print(f"wrote {path}")
    exp.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
