"""Item-embedding modules. Port of mygenerativerecommenders_tpu/models/embeddings.py:47-100.

`LocalEmbedding` is the plain full-dimension table. `ItemYearEmbedding` is
the fork's split: half an item table, half a table indexed by each item's
release year. Row 0 of each table is the padding row and starts at zero.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

# flax's truncated_normal(stddev) draws from N(0, 1) cut at +-2 and scales by
# stddev / 0.8796..., the std of that cut distribution
_TRUNC_STD = 0.87962566103423978

# the year table's rows past 0: year values up to 2200 (JAX `num_years`)
NUM_YEARS = 2200


def trunc_normal_(w: torch.Tensor, std: float, generator: Optional[torch.Generator]) -> None:
    s = std / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=s, a=-2 * s, b=2 * s, generator=generator)


def _padded_table(rows: int, dim: int, std: float,
                  generator: Optional[torch.Generator]) -> nn.Embedding:
    table = nn.Embedding(rows, dim)
    trunc_normal_(table.weight, std, generator)
    with torch.no_grad():
        table.weight[0].zero_()
    return table


class LocalEmbedding(nn.Module):
    def __init__(
        self,
        num_items: int,  # max item id; the table has num_items + 1 rows
        item_embedding_dim: int,
        init_std: float = 0.02,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.item_embedding_dim = item_embedding_dim
        self._item_emb = _padded_table(num_items + 1, item_embedding_dim, init_std, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self._item_emb(ids.long())


class ItemYearEmbedding(nn.Module):
    """[item_emb[id] ++ year_emb[year_of_item[id]]], each D/2 wide: the
    fork's `LocalEmbeddingModule`. `_item_emb` [num_items + 1, D/2],
    `_year_emb` [NUM_YEARS + 1, D/2] (both truncated normal, row 0 zero);
    the item -> year map is a buffer that `state_dict()` leaves out, so the
    weights are exactly the reference checkpoint's two tables. Ids past the
    map read its last entry, as JAX clips them."""

    def __init__(
        self,
        num_items: int,
        item_embedding_dim: int,
        year_of_item: Sequence[int],  # [num_items + 1] item id -> year (0 unknown)
        init_std: float = 0.02,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if item_embedding_dim % 2:
            # JAX concatenates two D // 2 halves: one column short of D
            raise ValueError(
                f"embedding.kind=item_year splits item_embedding_dim into two halves; "
                f"{item_embedding_dim} is odd"
            )
        half = item_embedding_dim // 2
        self.item_embedding_dim = item_embedding_dim
        self._item_emb = _padded_table(num_items + 1, half, init_std, generator)
        self._year_emb = _padded_table(NUM_YEARS + 1, half, init_std, generator)
        years = torch.as_tensor(np.asarray(year_of_item, dtype=np.int64))
        self.register_buffer("year_of_item", years, persistent=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        years = self.year_of_item[ids.clamp(0, self.year_of_item.shape[0] - 1)]
        return torch.cat([self._item_emb(ids), self._year_emb(years)], dim=-1)
