"""Codebook lookup (``mas_tpu/models/codebook.py::lookup``).

Only the decode side is ported: quantization, the k-means bootstrap and
the reservoir belong to VQ training (ROADMAP A7/A8, kernel B5).
"""

from __future__ import annotations

import torch
from torch import nn


def lookup(indices: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """indices [...] -> codebook vectors [..., D]."""
    return nn.functional.embedding(indices.long(), embedding)


class Codebook(nn.Module):
    """Holds the [K, D] codebook under the reference key
    ``quantize.embedding.weight``."""

    def __init__(self, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(codebook_size, codebook_dim)
