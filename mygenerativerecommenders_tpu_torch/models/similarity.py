"""Similarity modules. Port of `DotProductSimilarity`
(mygenerativerecommenders_tpu/models/similarity.py:23-38):
scores(queries [..., D], items [..., X, D]) -> [..., X]."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class DotProductSimilarity(nn.Module):
    def forward(
        self,
        input_embeddings: torch.Tensor,
        item_embeddings: torch.Tensor,
        item_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        del item_ids
        scores = torch.einsum("...d,...xd->...x", input_embeddings.float(), item_embeddings.float())
        return scores.to(input_embeddings.dtype)
