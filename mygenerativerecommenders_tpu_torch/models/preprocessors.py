"""Input-feature preprocessors.

Port of `LearnablePositionalEmbeddingPreprocessor`
(mygenerativerecommenders_tpu/models/preprocessors.py:62-101):
emb * sqrt(D) + pos_emb, zeroed at invalid positions. Serving runs with
dropout off, and this forward has none; the other variants raise in
models/model.py.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from mygenerativerecommenders_tpu_torch import not_ported
from mygenerativerecommenders_tpu_torch.models.embeddings import trunc_normal_

PreprocessorOutput = Tuple[
    torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor], Dict[str, torch.Tensor]
]


class LearnablePositionalEmbeddingPreprocessor(nn.Module):
    def __init__(
        self,
        max_sequence_len: int,
        embedding_dim: int,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.embedding_dim = embedding_dim
        self._pos_emb = nn.Embedding(max_sequence_len, embedding_dim)
        trunc_normal_(self._pos_emb.weight, math.sqrt(1.0 / embedding_dim), generator)

    def forward(
        self,
        past_lengths: torch.Tensor,
        past_ids: torch.Tensor,
        past_embeddings: torch.Tensor,
        past_payloads: Dict[str, torch.Tensor],
    ) -> PreprocessorOutput:
        """-> (lengths, user_embeddings [B,N,D], valid_mask [B,N,1], aux_mask None, payloads)."""
        if past_payloads.get("positions") is not None:
            raise not_ported("packed rows (positions payload)", "Packing")
        n = past_ids.shape[1]
        user_embeddings = (
            past_embeddings * (self.embedding_dim**0.5) + self._pos_emb.weight[None, :n]
        )
        valid_mask = (past_ids != 0)[:, :, None].to(user_embeddings.dtype)
        return past_lengths, user_embeddings * valid_mask, valid_mask, None, past_payloads
