"""Train-time dropout as flax draws it.

`flax.linen.Dropout(p)` at train time keeps an element where a float32
uniform under its `make_rng('dropout')` key is below 1 - p, and scales the
kept ones by 1 / (1 - p) in the input's dtype
(`ops.dispatch.dropout`).  `Scope.make_rng` keys a site by folding
its module path and its call counter into the `dropout` rng that `apply`
was given (`flax/core/scope.py`: `LazyRng.as_jax_rng`, the SHA-1 of the
names and the counter): a module's i-th `nn.Dropout`, called once, draws
under fold_in_static(rng, (*path, f"Dropout_{i}", 1)).  The port's modules
call the same sites in the same order, so a site draws the reference's
bits; the fold is a host constant, and the key a device tensor, so a
captured step draws what its step's key says.  A recomputed forward
(`g_remat`) draws the masks it drew the first time.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from gan_sass_tf_tpu_torch.data.threefry import static_hash
from gan_sass_tf_tpu_torch.ops import dispatch

NCHW = (0, 2, 3, 1)      # flax's (B, T, F, C) from the port's (B, C, T, F)


@dataclasses.dataclass(frozen=True)
class DropoutKey:
    """A module call's `dropout` rng: `key`, a (2,) int64 threefry key on
    the device, and `path`, the names of the module's scope below the
    module `apply` was called on (() for a G or a D applied directly)."""

    key: torch.Tensor
    path: Tuple[str, ...] = ()

    def fold(self, site: int) -> int:
        """What `make_rng` folds in at the module's `Dropout_{site}`."""
        return static_hash((*self.path, f"Dropout_{site}", 1))

    def apply(self, x: torch.Tensor, p: float, site: int,
              dims: Sequence[int] = None) -> torch.Tensor:
        """Dropout site `site` on x, whose dims in the flax tensor's order
        are `dims` (x's own order by default)."""
        dims = tuple(range(x.dim())) if dims is None else dims
        return dispatch.dropout(x, self.key, self.fold(site), p, dims)


def dropout_fn(p: float, train: bool, key: DropoutKey | None):
    """(x, site[, dims]) -> x with dropout at rate p when training, else x
    as is.  Training with p > 0 needs a key: there is no unkeyed draw."""
    if not (train and p > 0.0):
        return lambda x, site, dims=None: x
    if key is None:
        raise ValueError("dropout at train time needs a DropoutKey (the train "
                         "step passes one)")
    return lambda x, site, dims=None: key.apply(x, p, site, dims)
