"""Train-time dropout with keep-masks drawn from the counter RNG.

`flax.linen.Dropout` keeps each element with probability 1 - p and scales
the kept ones by 1 / (1 - p); so does `DropoutKey.apply`.  Its masks come
from `data.counter_rng.counter_uniform`, keyed by (seed, step, the call
site's stream, the GLOBAL row of each batch element), so R ranks of B/R
rows drop exactly what one rank of B rows drops, and a recomputed forward
(`g_remat`) draws the masks it drew the first time.  The reference folds
the shard index into its dropout keys instead, so its bits cannot be
matched (ROADMAP.md §3).
"""

from __future__ import annotations

import dataclasses

import torch

from gan_sass_tf_tpu_torch.data.counter_rng import counter_uniform


@dataclasses.dataclass(frozen=True)
class DropoutKey:
    """Where one module call draws its masks: dropout site `site` of the
    call draws stream `stream + site`; row i of the batch is keyed by
    `rows[i]`, its global index."""

    seed: int
    step: int
    stream: int
    rows: torch.Tensor

    def apply(self, x: torch.Tensor, p: float, site: int) -> torch.Tensor:
        keep = 1.0 - p
        u = counter_uniform(self.seed, self.step, self.rows.to(x.device),
                            self.stream + site, x[0].numel())
        return torch.where((u < keep).reshape(x.shape), x / keep, torch.zeros_like(x))


def dropout_fn(p: float, train: bool, key: DropoutKey | None):
    """(x, site) -> x with dropout at rate p when training, else x as is.
    Training with p > 0 needs a key: there is no unkeyed draw."""
    if not (train and p > 0.0):
        return lambda x, site: x
    if key is None:
        raise ValueError("dropout at train time needs a DropoutKey (the train "
                         "step passes one)")
    return lambda x, site: key.apply(x, p, site)
