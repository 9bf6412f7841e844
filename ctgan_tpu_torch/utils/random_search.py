"""Hyperparameter random search (own copy of
``ctgan_tpu/utils/random_search.py``, the reference's
``LSUN_bedrooms/tflib/random_search.py:4-14``): the shuffled cartesian
product of a grid's options, split n ways for parallel sweeps."""

from __future__ import annotations

import itertools
import random as _random

__all__ = ["random_search"]


def random_search(grid: dict, n_splits: int = 1, split: int = 0, seed: int = 0) -> list[dict]:
    """``grid`` maps a name to its options.  Returns this split's configs:
    every combination (names in sorted order), shuffled by
    ``random.Random(seed)``, then every ``n_splits``-th from ``split``."""
    names = sorted(grid)
    combos = list(itertools.product(*[grid[n] for n in names]))
    _random.Random(seed).shuffle(combos)
    configs = [dict(zip(names, c)) for c in combos]
    return configs[split::n_splits]
