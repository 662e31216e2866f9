"""Time-frequency mask application.

Layouts:
  spec:  (..., F, K) complex       — mixture STFT
  masks: (..., S, F, K)            for magnitude
         (..., S, F, K, 2)         for complex (last axis = re, im)
  out:   (..., S, F, K) complex    — per-source separated STFTs
"""

from __future__ import annotations

import torch


def mask_channels(mask_type: str) -> int:
    """Output channels per (source, T-F cell) the generator must emit."""
    if mask_type == "magnitude":
        return 1
    if mask_type == "complex":
        return 2
    raise ValueError(f"unknown mask_type {mask_type!r}")


def apply_mask(spec: torch.Tensor, masks: torch.Tensor,
               mask_type: str) -> torch.Tensor:
    """Apply per-source masks to the mixture STFT (broadcast over sources)."""
    spec_b = spec.unsqueeze(-3)                              # (..., 1, F, K)
    if mask_type == "magnitude":
        return spec_b * masks.float()
    if mask_type == "complex":
        m = torch.complex(masks[..., 0].float(), masks[..., 1].float())
        return spec_b * m
    raise ValueError(f"unknown mask_type {mask_type!r}")
