"""Device-resident utterance bank and on-device batch sampling.

Port of `gan_sass_tf_tpu/data/device_bank.py`: the (S, N_bank, T) bank is
built on the host once, uploaded to the card once, and every train step
samples its (B, S, T) sources there (an utterance per source slot and a
circular shift), so no batch crosses from the host.  Picks and shifts come
from `counter_rng` per global example index.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_sass_tf_tpu_torch.data.counter_rng import counter_bits

STREAM_PICK, STREAM_SHIFT = 11, 12


def build_bank(cfg, seed: int = 0) -> np.ndarray:
    """(S, N_bank, T) float32 source bank on the host, as the JAX package
    builds it: synthetic -> the dataset's harmonic bank; wav_dir ->
    data.bank_utterances decoded random segments per source slot."""
    from gan_sass_tf_tpu_torch.data import make_dataset

    ds = make_dataset(cfg, seed=seed)
    s, t = cfg.data.num_sources, cfg.segment_samples
    nb = cfg.data.bank_utterances
    if hasattr(ds, "_build_bank"):
        ds.BANK_PER_SLOT = nb
        return ds._build_bank()
    bank = np.zeros((s, nb, t), np.float32)
    for i in range(nb):      # corpus: decode nb random utterances per slot
        bank[:, i] = ds.batch(1)[0]
    return bank


def take_rows(bank: torch.Tensor, picks: torch.Tensor,
              shifts: torch.Tensor) -> torch.Tensor:
    """(S, N, T) bank, (B, S) picks and shifts -> (B, S, T) sources with
    out[b, s] = roll(bank[s, picks[b, s]], -shifts[b, s])."""
    s, _, t = bank.shape
    rows = bank[torch.arange(s, device=bank.device), picks]          # (B, S, T)
    idx = (torch.arange(t, device=bank.device) + shifts[..., None]) % t
    return torch.gather(rows, -1, idx)


def sample_bank(bank: torch.Tensor, seed: int, step: int, local_batch: int,
                example_offset: int = 0) -> torch.Tensor:
    """(S, N_bank, T) bank -> (B_local, S, T) sources, drawn on the bank's
    device for global examples example_offset + [0, B_local)."""
    s, nb, t = bank.shape
    ids = example_offset + torch.arange(local_batch, device=bank.device)
    picks = counter_bits(seed, step, ids, STREAM_PICK, s) % nb
    shifts = counter_bits(seed, step, ids, STREAM_SHIFT, s) % t
    return take_rows(bank, picks, shifts)
