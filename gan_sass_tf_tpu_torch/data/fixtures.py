"""Synthetic fixture corpora: a LibriSpeech-style speaker tree of
harmonic-voice wav files written to disk, so the `wav_dir` path
(corpus.WavDirDataset, the device bank, host batches) runs end to end with
no corpus to download.

A copy of `gan_sass_tf_tpu/data/fixtures.py` (the same files for the same
arguments, tests/test_torch_corpus.py).  Each speaker gets a distinct
fundamental (geometric spacing), each utterance random harmonic amplitudes
and phases.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from gan_sass_tf_tpu_torch.utils.wav_io import write_wav


def write_fixture_corpus(
    root: str,
    n_speakers: int = 4,
    utts_per_speaker: int = 4,
    seconds: float = 3.0,
    sample_rate: int = 8000,
    seed: int = 0,
) -> List[str]:
    """Writes root/spk<ii>/utt<jj>.wav; returns the file paths."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    paths: List[str] = []
    for s in range(n_speakers):
        f0 = 110.0 * (1.5 ** s) * (1.0 + 0.05 * rng.standard_normal())
        spk_dir = os.path.join(root, f"spk{s:02d}")
        os.makedirs(spk_dir, exist_ok=True)
        for u in range(utts_per_speaker):
            wav = np.zeros_like(t, dtype=np.float32)
            for h in range(1, 5):
                amp = float(rng.uniform(0.1, 0.5)) / h
                ph = float(rng.uniform(0.0, 2.0 * np.pi))
                wav += amp * np.sin(2.0 * np.pi * f0 * h * t + ph)
            wav *= 0.5 / max(float(np.abs(wav).max()), 1e-6)
            p = os.path.join(spk_dir, f"utt{u:02d}.wav")
            write_wav(p, sample_rate, wav.astype(np.float32))
            paths.append(p)
    return paths
