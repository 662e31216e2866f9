"""One-shot separation: mixture wav in, separated source wavs out.

Port of `gan_sass_tf_tpu/infer/separate.py`.  The host pads the waveform
onto the STFT frame grid, moves it to `device`, runs the separation graph
(two DSP kernels around G; on CUDA a captured CUDA graph, replayed,
`separate_fn_for`) and crops the result.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from gan_sass_tf_tpu_torch.train.graphed import GeneratorMemo, GraphedFn
from gan_sass_tf_tpu_torch.train.step import build_separate_fn
from gan_sass_tf_tpu_torch.utils.wav_io import read_wav, write_wav


@GeneratorMemo
def separate_fn_for(cfg, g: torch.nn.Module) -> GraphedFn:
    """The separation graph of (cfg, G), memoised as the JAX package's
    `separate_fn_for` memoises its jitted graph (but G held weakly): a
    callable from a (B, T) mixture on a device to (B, S, T) waveforms
    there.  On CUDA it runs `build_separate_fn(cfg, g)` eagerly for the
    first WARMUP_CALLS calls of a (B, T, dtype), then captures it and
    replays it (`train/graphed.py`); on the CPU it calls it.  The graph
    reads G's weights in place: weights loaded into G later are used, a
    parameter replaced by another tensor is not."""
    return GraphedFn(build_separate_fn(cfg, g))


def _pad_to_grid(wav: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    t = wav.shape[-1]
    if t < n_fft:
        return np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(0, n_fft - t)])
    rem = (t - n_fft) % hop
    if rem:
        wav = np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(0, hop - rem)])
    return wav


def separate(g: torch.nn.Module, cfg, mixture: np.ndarray, device) -> np.ndarray:
    """mixture (T,) or (B, T) float32 -> (S, T) or (B, S, T) separated
    source wavs, computed on `device` by `separate_fn_for(cfg, g)`: on CUDA
    a replay of the graph captured for this (B, T), on the CPU eagerly.
    The eager path on any device is `build_separate_fn(cfg, g)`."""
    squeeze = mixture.ndim == 1
    mix = np.atleast_2d(np.asarray(mixture, np.float32))
    t_in = mix.shape[-1]
    mix = _pad_to_grid(mix, cfg.dsp.n_fft, cfg.dsp.hop_length)
    wavs = separate_fn_for(cfg, g)(torch.from_numpy(mix).to(device))
    wavs = wavs.cpu().numpy()
    wavs = wavs[..., :t_in]
    return wavs[0] if squeeze else wavs


def separate_file(g: torch.nn.Module, cfg, in_path: str, out_dir: str,
                  device) -> List[str]:
    """Wav file -> per-source wav files <stem>_src<i>.wav in out_dir."""
    sr, wav = read_wav(in_path)
    if sr != cfg.dsp.sample_rate:
        raise ValueError(
            f"{in_path}: sample rate {sr} != config {cfg.dsp.sample_rate}"
        )
    wavs = separate(g, cfg, wav, device)
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(in_path))[0]
    paths = []
    for i, w in enumerate(wavs):
        p = os.path.join(out_dir, f"{stem}_src{i}.wav")
        write_wav(p, cfg.dsp.sample_rate, w)
        paths.append(p)
    return paths
