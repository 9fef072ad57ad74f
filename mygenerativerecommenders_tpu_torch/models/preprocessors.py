"""Input-feature preprocessors.

Port of `LearnablePositionalEmbeddingPreprocessor`
(mygenerativerecommenders_tpu/models/preprocessors.py:62-101):
emb * sqrt(D) + pos_emb, dropout (`nn.Dropout`: active under
`model.train()`, drawn from the device's generator), zeroed at invalid
positions. In a packed row the positional table is gathered at the
`positions` payload (each token's offset inside its segment) instead of
sliced along the row. The other variants raise in models/model.py.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

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
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.max_sequence_len = max_sequence_len
        self._dropout = nn.Dropout(dropout_rate)
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
        positions = past_payloads.get("positions")
        if positions is not None:
            # packed rows: the same table, gathered at the within-segment positions
            pos = self._pos_emb(positions.long().clamp(0, self.max_sequence_len - 1))
        else:
            pos = self._pos_emb.weight[None, : past_ids.shape[1]]
        user_embeddings = self._dropout(past_embeddings * (self.embedding_dim**0.5) + pos)
        valid_mask = (past_ids != 0)[:, :, None].to(user_embeddings.dtype)
        return past_lengths, user_embeddings * valid_mask, valid_mask, None, past_payloads
