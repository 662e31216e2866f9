"""Permutation-invariant training (PIT) matching.

Port of `gan_sass_tf_tpu/losses/pit.py`: the (B, S, S) pairwise loss matrix
is computed once and contracted against the S! static permutations (S ≤ 3,
so at most 6).
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from gan_sass_tf_tpu_torch.losses.recon import elem_loss


def permutations_for(num_sources: int) -> np.ndarray:
    """(S!, S) int array of all source permutations."""
    return np.asarray(list(itertools.permutations(range(num_sources))), np.int32)


@functools.lru_cache(maxsize=16)
def _perm_indices(num_sources: int, device: torch.device):
    """(source index, one index tensor a permutation, the (S!, S) table) on
    `device`, made once: no copy from the host in the step, so a captured
    step can hold the matching.  Normal tensors even when first asked for
    under inference mode (autograd may save them)."""
    with torch.inference_mode(False):
        src = torch.arange(num_sources, device=device)
        table = torch.as_tensor(permutations_for(num_sources), device=device).long()
    return src, list(table), table


def pairwise_losses(est: torch.Tensor, tgt: torch.Tensor, kind: str) -> torch.Tensor:
    """est, tgt: (B, S, ...) -> (B, S_est, S_tgt) mean loss per pair."""
    return elem_loss(est[:, :, None], tgt[:, None, :], kind, batch_dims=3)


def pit_loss(est: torch.Tensor, tgt: torch.Tensor, kind: str = "l1",
             pair_loss: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (loss (B,), perm (B, S)): perm[b, s] is the target index matched
    to estimate s under the best permutation (the first on ties, as
    argmin)."""
    pl = pairwise_losses(est, tgt, kind) if pair_loss is None else pair_loss
    src, perms, table = _perm_indices(est.shape[1], pl.device)
    per_perm = torch.stack([pl[:, src, p].mean(dim=-1) for p in perms], dim=-1)
    loss, best = per_perm.min(dim=-1)
    return loss, table[best]


def pool4(x: torch.Tensor) -> torch.Tensor:
    """4x4 average-pool the trailing (T, K) grid of a (B, S, T, K) tensor.
    Tiny grids (T or K < 4) pass through unchanged: truncating to
    (t//4)*4 would give an empty tensor whose mean is NaN."""
    b, s, t, k = x.shape
    if t < 4 or k < 4:
        return x
    t4, k4 = (t // 4) * 4, (k // 4) * 4
    x = x[:, :, :t4, :k4].reshape(b, s, t4 // 4, 4, k4 // 4, 4)
    return x.mean(dim=(3, 5))


def pooled_match_perm(est: torch.Tensor, tgt: torch.Tensor,
                      kind: str = "l1") -> torch.Tensor:
    """The train step's PIT matching: the best permutation on a bf16,
    4x4-average-pooled (T, K) grid.  Pooling runs in the inputs' dtype and
    the matching in bf16, as the JAX package does."""
    _, perm = pit_loss(pool4(est).to(torch.bfloat16),
                       pool4(tgt).to(torch.bfloat16), kind)
    return perm


def align_to_perm(tgt: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Reorder targets (B, S, ...) so aligned[b, s] = tgt[b, perm[b, s]]."""
    idx = perm.reshape(perm.shape + (1,) * (tgt.dim() - 2)).expand(
        perm.shape + tgt.shape[2:])
    return torch.gather(tgt, 1, idx)
