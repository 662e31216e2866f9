"""Permutation enumeration for permutation-invariant scoring."""

from __future__ import annotations

import itertools

import numpy as np


def permutations_for(num_sources: int) -> np.ndarray:
    """(S!, S) int array of all source permutations."""
    return np.asarray(list(itertools.permutations(range(num_sources))), np.int32)
