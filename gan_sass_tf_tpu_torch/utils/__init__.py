"""Host-side utilities: wav I/O (scipy), the JSONL metrics sink, profiler
hooks, and TensorBoard event files (`utils.tb_events`)."""

from gan_sass_tf_tpu_torch.utils.metrics_writer import MetricsWriter
from gan_sass_tf_tpu_torch.utils.profiler import profile_trace
from gan_sass_tf_tpu_torch.utils.wav_io import read_wav, write_wav

__all__ = ["read_wav", "write_wav", "MetricsWriter", "profile_trace"]
