"""Item-embedding modules. Port of mygenerativerecommenders_tpu/models/embeddings.py:47-63.

Only `LocalEmbedding`, the plain full-dimension table, is ported. Row 0 is
the padding row and starts at zero.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# flax's truncated_normal(stddev) draws from N(0, 1) cut at +-2 and scales by
# stddev / 0.8796..., the std of that cut distribution
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(w: torch.Tensor, std: float, generator: Optional[torch.Generator]) -> None:
    s = std / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=s, a=-2 * s, b=2 * s, generator=generator)


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
        self._item_emb = nn.Embedding(num_items + 1, item_embedding_dim)
        trunc_normal_(self._item_emb.weight, init_std, generator)
        with torch.no_grad():
            self._item_emb.weight[0].zero_()

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self._item_emb(ids.long())
