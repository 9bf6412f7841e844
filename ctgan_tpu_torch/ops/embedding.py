"""Embedding lookup (counterpart of ``ctgan_tpu/ops/embedding.py``)."""

from __future__ import annotations

import torch

__all__ = ["embedding"]


def embedding(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Rows ``indices`` of the ``[n_symbols, dim]`` ``.EmbeddingMatrix``."""
    return table[indices]
