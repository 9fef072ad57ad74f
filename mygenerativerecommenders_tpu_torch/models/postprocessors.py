"""Output postprocessors. Port of mygenerativerecommenders_tpu/models/postprocessors.py:14-49:
truncate to `embedding_dim`, then normalise by the L2 norm or by a LayerNorm
without scale or bias."""

from __future__ import annotations

import torch
import torch.nn.functional as F
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


class LayerNormPostprocessor(nn.Module):
    def __init__(self, embedding_dim: int, eps: float = 1e-6):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.eps = eps

    def forward(self, output_embeddings: torch.Tensor) -> torch.Tensor:
        x = output_embeddings[..., : self.embedding_dim]
        return F.layer_norm(x, (x.shape[-1],), eps=self.eps)
