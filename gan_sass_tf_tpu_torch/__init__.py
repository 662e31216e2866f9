"""gan_sass_tf_tpu_torch — PyTorch/CUDA port of gan_sass_tf_tpu for NVIDIA Hopper.

The port runs one-shot separation (fused STFT features -> conv U-Net G ->
fused masked iSTFT) with hand-written CUDA kernels for the two DSP hot ops
and plain PyTorch everywhere else.  It keeps its own copy of the JAX
package's presets (`config`, equal preset for preset) and imports nothing
of that package.

Public surface:
    from gan_sass_tf_tpu_torch import config, models, infer
    cfg = config.get_config("wsj0_logmel")
    g = models.load_generator(cfg, models.load_flax_npz("g.npz"), "cuda")
    wavs = infer.separate(g, cfg, mixture, device="cuda")
"""

__version__ = "0.1.0"

from gan_sass_tf_tpu_torch import config  # noqa: F401
