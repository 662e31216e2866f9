"""Adversarial losses for the alternating G/D step, on raw logits, as
scalar batch means: "ns" (non-saturating logistic), "lsgan" (least
squares), "hinge".

Port of `gan_sass_tf_tpu/losses/gan.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gan_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor,
               kind: str) -> torch.Tensor:
    if kind == "ns":
        return F.softplus(-real_logits).mean() + F.softplus(fake_logits).mean()
    if kind == "lsgan":
        return 0.5 * (((real_logits - 1.0) ** 2).mean() + (fake_logits ** 2).mean())
    if kind == "hinge":
        return F.relu(1.0 - real_logits).mean() + F.relu(1.0 + fake_logits).mean()
    raise ValueError(f"unknown gan loss {kind!r}")


def gan_g_loss(fake_logits: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "ns":
        return F.softplus(-fake_logits).mean()
    if kind == "lsgan":
        return 0.5 * ((fake_logits - 1.0) ** 2).mean()
    if kind == "hinge":
        return -fake_logits.mean()
    raise ValueError(f"unknown gan loss {kind!r}")
