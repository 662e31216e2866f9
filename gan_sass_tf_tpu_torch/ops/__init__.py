"""Hand-written CUDA kernels for the DSP hot ops (sm_90a), each beside its
plain PyTorch version, and the dispatch between them.

    K1 stft_features  (csrc/stft_features.cu)  <- ops/pallas_stft.py
    K2 masked_istft   (csrc/masked_istft.cu)   <- ops/pallas_istft.py
    K3 istft          (csrc/masked_istft.cu)   <- ops/pallas_istft.py
    K4 stft           (csrc/stft_features.cu)  <- ops/pallas_stft.py

Importing these modules needs neither nvcc nor a GPU: the library is built
(`ops.build`) at the first launch on a CUDA tensor.
"""

from gan_sass_tf_tpu_torch.ops import dispatch  # noqa: F401
