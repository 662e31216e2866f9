"""Wav-corpus reader for LibriSpeech/WSJ0-style trees.

A copy of `gan_sass_tf_tpu/data/corpus.py`, held equal to it batch for
batch by tests/test_torch_corpus.py.  Layout: root/<speaker_id>/**/*.wav,
each direct subdirectory of the root one speaker.  Utterances are drawn
from distinct speakers, converted to float32 mono, resampled with
`resample_poly` where the rate differs, and randomly cropped or zero-padded
to the segment length on the host; gains and mixing happen on the device.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
from scipy.io import wavfile


def load_wav_mono(path: str, target_sr: int) -> np.ndarray:
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if sr != target_sr:
        # Polyphase resampling: an anti-aliasing filter, where linear
        # interpolation would alias everything above the target Nyquist.
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(target_sr, sr)
        data = resample_poly(
            data.astype(np.float64), target_sr // g, sr // g
        ).astype(np.float32)
    return data


class WavDirDataset:
    def __init__(self, cfg, seed: int = 0, split: str = "train"):
        self.cfg = cfg
        self.batch_size = cfg.train.batch_size
        self.num_sources = cfg.data.num_sources
        self.segment = cfg.segment_samples
        self.sample_rate = cfg.dsp.sample_rate
        self._rng = np.random.default_rng(seed)
        root = cfg.data.data_dir
        if not root or not os.path.isdir(root):
            raise FileNotFoundError(
                f"wav_dir dataset root not found: {root!r} — set "
                "data.data_dir (CLI: --set data.data_dir=/path/to/speakers) "
                "or use data.dataset=synthetic")
        self.speakers: List[List[str]] = []
        for spk in sorted(os.listdir(root)):
            spk_dir = os.path.join(root, spk)
            if not os.path.isdir(spk_dir):
                continue
            wavs = [
                os.path.join(dirpath, f)
                for dirpath, _, files in os.walk(spk_dir)
                for f in sorted(files)
                if f.lower().endswith(".wav")
            ]
            if wavs:
                self.speakers.append(wavs)
        # Held-out speaker split: the LAST max(num_sources, ~1/5 of
        # speakers) speakers are reserved for eval whenever both splits can
        # still field num_sources distinct speakers; otherwise the corpus is
        # too small to split and both splits see all speakers.
        n_eval = max(self.num_sources, len(self.speakers) // 5)
        if split in ("train", "eval") and \
                len(self.speakers) - n_eval >= self.num_sources:
            self.speakers = (self.speakers[-n_eval:] if split == "eval"
                             else self.speakers[:-n_eval])
        if len(self.speakers) < self.num_sources:
            raise ValueError(
                f"need ≥ {self.num_sources} speakers under {root!r}, "
                f"found {len(self.speakers)}"
            )

    def _sample_utterance(self, wavs: List[str]) -> np.ndarray:
        rng = self._rng
        wav = load_wav_mono(wavs[rng.integers(len(wavs))], self.sample_rate)
        t = self.segment
        if len(wav) >= t:
            start = rng.integers(len(wav) - t + 1)
            return wav[start : start + t]
        out = np.zeros(t, np.float32)
        start = rng.integers(t - len(wav) + 1)
        out[start : start + len(wav)] = wav
        return out

    def batch(self, batch_size: int | None = None) -> np.ndarray:
        b = batch_size or self.batch_size
        s, t = self.num_sources, self.segment
        out = np.zeros((b, s, t), np.float32)
        for bi in range(b):
            spk_ids = self._rng.choice(len(self.speakers), size=s, replace=False)
            for si, spk in enumerate(spk_ids):
                out[bi, si] = self._sample_utterance(self.speakers[spk])
        return out

    def __iter__(self):
        while True:
            yield self.batch()
