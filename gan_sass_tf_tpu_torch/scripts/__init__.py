"""Command-line tools of the port, run as modules:

    python -m gan_sass_tf_tpu_torch.scripts.quality_protocol PRESET [STEPS] ...
    python -m gan_sass_tf_tpu_torch.scripts.recompute_bounds PRESET ...
    python -m gan_sass_tf_tpu_torch.scripts.stream_quality [STEPS] ...
    python -m gan_sass_tf_tpu_torch.scripts.profile_step [PRESET] [BATCH] ...
    python -m gan_sass_tf_tpu_torch.scripts.bench_presets [PRESET ...] ...
    python -m gan_sass_tf_tpu_torch.scripts.bench_spd [PRESET] [BATCH] [STEPS]
    python -m gan_sass_tf_tpu_torch.scripts.bench_streaming_compute [SECONDS] [REPS]
    python -m gan_sass_tf_tpu_torch.scripts.train_wavdir_fixture [STEPS]
    python -m gan_sass_tf_tpu_torch.scripts.run_queue [ROUND]
    python -m gan_sass_tf_tpu_torch.scripts.bytes_ledger [PRESET ...] ...
    python -m gan_sass_tf_tpu_torch.scripts.roofline [PRESET ...] ...
    python -m gan_sass_tf_tpu_torch.scripts.time_dropout [PRESET] [BATCH] ...
    python -m gan_sass_tf_tpu_torch.scripts.kernel_sass [KERNEL ...]
"""

from typing import Dict, List, Sequence, Tuple


def split_args(argv: Sequence[str], options: Sequence[str] = ("--set", "--device")
               ) -> Tuple[List[str], Dict[str, List[str]]]:
    """(the positional arguments, {option: [its values in order]}) of a
    tool's argv, where each of `options` takes the one argument after it."""
    pos: List[str] = []
    values: Dict[str, List[str]] = {o: [] for o in options}
    i = 0
    while i < len(argv):
        if argv[i] in values and i + 1 < len(argv):
            values[argv[i]].append(argv[i + 1])
            i += 2
        else:
            pos.append(argv[i])
            i += 1
    return pos, values
