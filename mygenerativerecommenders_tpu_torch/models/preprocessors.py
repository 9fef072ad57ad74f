"""Input-feature preprocessors.

Port of mygenerativerecommenders_tpu/models/preprocessors.py:62-337. Each
returns (lengths, user_embeddings [B, N', D'], valid_mask
[B, N', 1], aux_mask [B, N'] or None, payloads):

- `LearnablePositionalEmbeddingPreprocessor`: emb * sqrt(D) + pos_emb;
- `LearnablePositionalEmbeddingRatedPreprocessor`: [emb, rating emb] *
  sqrt(D + rating_embedding_dim) + pos_emb, so D grows (the postprocessor
  truncates it back);
- `CombinedItemAndRatingPreprocessor`: item and rating tokens interleaved,
  [i0, r0, i1, r1, ...] * sqrt(D) + pos_emb over 2N positions, timestamps and
  segment ids repeated, lengths doubled, and an aux_mask that keeps the item
  tokens (the model compacts the encoder's output by it);
- `LearnablePositionalEmbeddingAuxPreprocessor`: a token of the user's
  features (each column one-hot, looked up in its own table, or passed as a
  number; concatenated, projected to D and L2-normalized) at position 0, the
  items shifted right by one (the last position dropped) and scaled by
  sqrt(D), + pos_emb; lengths + 1, and an aux_mask that drops the token.

Each then takes dropout (`nn.Dropout`: active under `model.train()`, drawn
from the device's generator) and zeroes the invalid positions. In a packed
row the positional table is gathered at the `positions` payload (each
token's offset inside its segment) instead of sliced along the row; the
combined variant gathers it at the doubled offsets (2p, 2p + 1) and hands
them on as the new `positions`. The aux variant takes padded rows only (as
in the JAX package, packing requires the plain preprocessor); its codes are
held to the table sizes on the host before any step
(data/dataset.py:check_aux_codes), since a code past a table would stop the
card at a device assert.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from mygenerativerecommenders_tpu_torch.models.dense import Dense
from mygenerativerecommenders_tpu_torch.models.embeddings import trunc_normal_
from mygenerativerecommenders_tpu_torch.models.postprocessors import l2_normalize

PreprocessorOutput = Tuple[
    torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor], Dict[str, torch.Tensor]
]


def _gather_positions(table: nn.Embedding, positions: torch.Tensor) -> torch.Tensor:
    return table(positions.long().clamp(0, table.num_embeddings - 1))


def _twice(x: torch.Tensor) -> torch.Tensor:
    """[B, N] -> [B, 2N], each column twice in a row (a view and one copy)."""
    return x.unsqueeze(2).expand(-1, -1, 2).reshape(x.shape[0], 2 * x.shape[1])


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
            pos = _gather_positions(self._pos_emb, positions)
        else:
            pos = self._pos_emb.weight[None, : past_ids.shape[1]]
        user_embeddings = self._dropout(past_embeddings * (self.embedding_dim**0.5) + pos)
        valid_mask = (past_ids != 0)[:, :, None].to(user_embeddings.dtype)
        return past_lengths, user_embeddings * valid_mask, valid_mask, None, past_payloads


class LearnablePositionalEmbeddingRatedPreprocessor(nn.Module):
    def __init__(
        self,
        max_sequence_len: int,
        item_embedding_dim: int,
        rating_embedding_dim: int,
        num_ratings: int,
        generator: Optional[torch.Generator] = None,
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        self.num_ratings = num_ratings
        self.embedding_dim = item_embedding_dim + rating_embedding_dim
        std = math.sqrt(1.0 / self.embedding_dim)
        self._dropout = nn.Dropout(dropout_rate)
        self._rating_emb = nn.Embedding(num_ratings, rating_embedding_dim)
        self._pos_emb = nn.Embedding(max_sequence_len, self.embedding_dim)
        trunc_normal_(self._rating_emb.weight, std, generator)
        trunc_normal_(self._pos_emb.weight, std, generator)

    def forward(
        self,
        past_lengths: torch.Tensor,
        past_ids: torch.Tensor,
        past_embeddings: torch.Tensor,
        past_payloads: Dict[str, torch.Tensor],
    ) -> PreprocessorOutput:
        """-> (lengths, user_embeddings [B,N,D+Dr], valid_mask [B,N,1], None, payloads)."""
        ratings = past_payloads["ratings"].long().clamp(0, self.num_ratings - 1)
        combined = torch.cat([past_embeddings, self._rating_emb(ratings)], dim=-1)
        positions = past_payloads.get("positions")
        if positions is not None:
            pos = _gather_positions(self._pos_emb, positions)
        else:
            pos = self._pos_emb.weight[None, : past_ids.shape[1]]
        user_embeddings = self._dropout(combined * (self.embedding_dim**0.5) + pos)
        valid_mask = (past_ids != 0)[:, :, None].to(user_embeddings.dtype)
        return past_lengths, user_embeddings * valid_mask, valid_mask, None, past_payloads


class CombinedItemAndRatingPreprocessor(nn.Module):
    """Item and rating tokens interleaved: [i0, r0, i1, r1, ...]."""

    def __init__(
        self,
        max_sequence_len: int,  # in input positions; the output has twice as many
        embedding_dim: int,
        num_ratings: int,
        generator: Optional[torch.Generator] = None,
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.num_ratings = num_ratings
        std = math.sqrt(1.0 / embedding_dim)
        self._dropout = nn.Dropout(dropout_rate)
        self._rating_emb = nn.Embedding(num_ratings, embedding_dim)
        self._pos_emb = nn.Embedding(2 * max_sequence_len, embedding_dim)
        trunc_normal_(self._rating_emb.weight, std, generator)
        trunc_normal_(self._pos_emb.weight, std, generator)

    def ratings_emb(self) -> torch.Tensor:
        """The rating table [R, D], which the ranking head scores against."""
        return self._rating_emb.weight

    def forward(
        self,
        past_lengths: torch.Tensor,
        past_ids: torch.Tensor,
        past_embeddings: torch.Tensor,
        past_payloads: Dict[str, torch.Tensor],
    ) -> PreprocessorOutput:
        """-> (2 * lengths, user_embeddings [B,2N,D], valid_mask [B,2N,1],
        aux_mask [B,2N] (the item tokens below 2 * lengths), payloads)."""
        b, n = past_ids.shape
        ratings = past_payloads["ratings"].long().clamp(0, self.num_ratings - 1)
        interleaved = torch.stack([past_embeddings, self._rating_emb(ratings)], dim=2)
        interleaved = interleaved.reshape(b, 2 * n, -1) * (self.embedding_dim**0.5)
        payloads = dict(past_payloads)
        positions = past_payloads.get("positions")
        if positions is not None:
            # token j of a segment becomes slots (2j, 2j + 1): segments stay
            # contiguous, so the block-diagonal mask and the gather stay exact
            p2 = 2 * positions.long()
            doubled = torch.stack([p2, p2 + 1], dim=2).reshape(b, 2 * n)
            pos = _gather_positions(self._pos_emb, doubled)
            payloads["positions"] = doubled.to(positions.dtype)
        else:
            pos = self._pos_emb.weight[None, : 2 * n]
        user_embeddings = self._dropout(interleaved + pos)
        payloads["timestamps"] = _twice(payloads["timestamps"])
        if "seg_ids" in payloads:
            payloads["seg_ids"] = _twice(payloads["seg_ids"])
        valid_mask = _twice(past_ids != 0)[:, :, None].to(user_embeddings.dtype)
        new_lengths = past_lengths * 2
        slot = torch.arange(2 * n, device=past_ids.device)
        aux_mask = (slot[None, :] < new_lengths[:, None]) & (slot[None, :] % 2 == 0)
        return new_lengths, user_embeddings * valid_mask, valid_mask, aux_mask, payloads


class LearnablePositionalEmbeddingAuxPreprocessor(nn.Module):
    """A projected user-feature token prepended to the items (JAX :157-251).

    Parameters, under the JAX package's leaf names: `_pos_emb.weight`
    [max_sequence_len, D], `aux_emb_<col>` [cat_dim, cat_emb_dim] for each
    `embed` column (truncated normal, std sqrt(1 / cat_emb_dim)) and
    `aux_projection.kernel` [F, D] (Xavier-uniform) / `.bias` [D] (zeros), F
    the width of the concatenated encodings."""

    def __init__(
        self,
        max_sequence_len: int,
        embedding_dim: int,
        auxiliary_columns: Sequence[str],
        encoding_types: Sequence[str],
        categorical_dims: Sequence[int],
        categorical_embedding_dims: Sequence[int],
        generator: Optional[torch.Generator] = None,
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.columns = list(zip(auxiliary_columns, encoding_types, categorical_dims,
                                categorical_embedding_dims))
        width = 0
        for col, enc, cat_dim, cat_emb_dim in self.columns:
            if enc == "onehot":
                width += cat_dim
            elif enc == "embed":
                table = nn.Parameter(torch.empty(cat_dim, cat_emb_dim))
                trunc_normal_(table, math.sqrt(1.0 / cat_emb_dim), generator)
                self.register_parameter(f"aux_emb_{col}", table)
                width += cat_emb_dim
            elif enc == "numeric":
                width += 1
            else:
                raise ValueError(f"Invalid encoding type {enc}")
        # flax draws the parameters in the order they are first used: the
        # projection's, then the positional table's
        self.aux_projection = Dense((width,), (embedding_dim,), generator, "xavier_uniform")
        self._dropout = nn.Dropout(dropout_rate)
        self._pos_emb = nn.Embedding(max_sequence_len, embedding_dim)
        trunc_normal_(self._pos_emb.weight, math.sqrt(1.0 / embedding_dim), generator)

    def encode(self, payloads: Dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        """The users' columns [B] each -> the token [B, D], L2-normalized."""
        encoded: List[torch.Tensor] = []
        for col, enc, cat_dim, _ in self.columns:
            feat = payloads[col]
            if enc == "onehot":
                # jax.nn.one_hot's comparison: a fixed width, no host sync
                classes = torch.arange(cat_dim, device=feat.device)
                encoded.append((feat.long()[..., None] == classes).to(dtype))
            elif enc == "embed":
                encoded.append(getattr(self, f"aux_emb_{col}")[feat.long()])
            else:
                encoded.append(feat[..., None].to(dtype))
        return l2_normalize(self.aux_projection(torch.cat(encoded, dim=-1)))

    def forward(
        self,
        past_lengths: torch.Tensor,
        past_ids: torch.Tensor,
        past_embeddings: torch.Tensor,
        past_payloads: Dict[str, torch.Tensor],
    ) -> PreprocessorOutput:
        """-> (lengths + 1, user_embeddings [B,N,D], valid_mask [B,N,1],
        aux_mask [B,N] (the item positions below lengths + 1), payloads with
        ratings and timestamps shifted right by one)."""
        n = past_ids.shape[1]
        valid = (past_ids != 0)[:, :, None].to(past_embeddings.dtype)
        aux = self.encode(past_payloads, past_embeddings.dtype)
        shifted = torch.cat(
            [aux[:, None, :], past_embeddings[:, : n - 1] * (self.embedding_dim**0.5)], dim=1
        )
        valid_mask = torch.cat([torch.ones_like(valid[:, :1]), valid[:, : n - 1]], dim=1)
        payloads = dict(past_payloads)
        ratings, timestamps = payloads["ratings"], payloads["timestamps"]
        payloads["ratings"] = torch.cat([-torch.ones_like(ratings[:, :1]), ratings[:, : n - 1]], 1)
        payloads["timestamps"] = torch.cat(
            [torch.zeros_like(timestamps[:, :1]), timestamps[:, : n - 1]], 1
        )
        user_embeddings = self._dropout(shifted + self._pos_emb.weight[None, :n])
        new_lengths = past_lengths + 1
        pos = torch.arange(n, device=past_ids.device)
        aux_mask = (pos[None, :] < new_lengths[:, None]) & (pos[None, :] > 0)
        return new_lengths, user_embeddings * valid_mask, valid_mask, aux_mask, payloads
