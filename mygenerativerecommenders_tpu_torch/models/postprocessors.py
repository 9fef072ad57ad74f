"""Output postprocessors. Port of mygenerativerecommenders_tpu/models/postprocessors.py:14-40."""

from __future__ import annotations

import torch
from torch import nn


def l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / max(||x||_2, eps) along the last axis (the max inside the sqrt)."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


class L2NormPostprocessor(nn.Module):
    def __init__(self, embedding_dim: int, eps: float = 1e-6):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.eps = eps

    def forward(self, output_embeddings: torch.Tensor) -> torch.Tensor:
        return l2_normalize(output_embeddings[..., : self.embedding_dim], self.eps)
