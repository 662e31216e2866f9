"""gan_sass_tf_tpu_torch — PyTorch/CUDA port of gan_sass_tf_tpu for NVIDIA Hopper.

The port trains and runs the GAN source separator of the JAX package on
H100s: the alternating G/D step with PIT and the waveform loss, the
workdir (checkpoints, best, resume), one-shot and streaming separation,
data parallelism over a torch.distributed process group, the quality
protocol and the oracle bounds.  On the GPU the train step is captured
once as a CUDA graph and replayed (`train/graphed.py`).  Four hand-written CUDA kernels (sm_90a,
`ops/csrc/`) run the DSP hot ops -- the fused STFT features, the masked
and the differentiable iSTFT, the complex STFT -- beside their plain
PyTorch versions (`ops.dispatch`: a CUDA tensor takes the kernel, a CPU
tensor the plain version).  nvcc builds them at the first CUDA call, in
`ops/_build/` or, for a read-only install, under
`${XDG_CACHE_HOME:-~/.cache}/gan_sass_tf_tpu_torch/` (`ops.build`).

Entry points:
    gan-sass-torch train|eval|separate|configs ...    # console script of
    python -m gan_sass_tf_tpu_torch.cli ...           # `pip install .[torch]`
    from gan_sass_tf_tpu_torch.entry import entry     # (fn, args) of the
                                                      # separation graph
    from gan_sass_tf_tpu_torch import config, infer, train
    cfg = config.get_config("stream_v5e8")
    exp = train.Experiment(cfg, workdir="runs/a")
    exp.train(num_steps=100)
    wavs = infer.separate(exp.eval_generator(), cfg, mixture, device="cuda")
    python -m gan_sass_tf_tpu_torch.scripts.<tool> ... # quality_protocol,
                                                      # recompute_bounds, ...
    python -m gan_sass_tf_tpu_torch.bench              # one JSON line

Models are built by name through the registry (`models.build_generator`,
`models.build_discriminator`); `models.register_generator(name)` and
`models.register_discriminator(name)` add builders `fn(cfg) -> nn.Module`.
Entry points run on the GPU unless `--device cpu` / `device="cpu"` is
asked for.

The port keeps its own copy of the JAX package's presets (`config`,
equal preset for preset) and imports nothing of the JAX package or of
JAX; flax weights come in through `models.convert`.
"""

__version__ = "0.1.0"

from gan_sass_tf_tpu_torch import config  # noqa: F401
