"""Rank functions for ``tests/test_torch_entry.py``'s launcher cases: the
spawned ranks import this module by name, so it imports nothing heavy."""

from __future__ import annotations

import time


def raise_on_rank(rank: int, world: int, bad: int) -> int:
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def hang_on_rank(rank: int, world: int, bad: int) -> int:
    if rank == bad:
        time.sleep(3600)
    return rank
