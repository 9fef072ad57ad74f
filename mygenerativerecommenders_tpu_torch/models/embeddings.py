"""Item-embedding modules. Port of mygenerativerecommenders_tpu/models/embeddings.py:47-423.

`LocalEmbedding` is the plain full-dimension table. `ItemYearEmbedding` is
the fork's split: half an item table, half a table indexed by each item's
release year. Row 0 of each table is the padding row and starts at zero.

The sharded kinds (`embedding.kind=sharded_*`) hold one `nn.Parameter`
under the same key, `_item_emb.weight`, and look up through the shard bodies
of parallel/embedding_sharding.py over a shard group. On one device the
group is `OneDeviceShards`, the parameter has JAX's full table shape and
each shard's table is a view of it (rows: `weight.view(R, V/R, D)`, columns:
a column slice), so fused AdamW, the step's CUDA graph and the checkpoints
see one tensor. Over a process group (`place`, from
parallel/tensor_parallel.py:place_model) the parameter is the rank's own
block of the table, its rows (columns, or row x column block), and the
group a `ProcessGroupShards` of the model (and col) axis:

- `ShardedLocalEmbedding`: row shards, the psum lookup;
- `ShardedA2AEmbedding`: row shards, the owner-routed exchange of each
  shard's own slice of the ids, then one all_gather of the rows;
- `ColumnShardedLocalEmbedding`: column shards, local gathers and one
  all_gather of the columns;
- `Sharded2DEmbedding`: rows over "model" x columns over "col": the
  owner-routed exchange of the column slices, then the two all_gathers.

The row kinds pad the vocabulary to a multiple of `num_shards` (pad rows are
never looked up); every kind's lookup equals `weight[ids]` to the bit, as
JAX's do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mygenerativerecommenders_tpu_torch.parallel.embedding_sharding import (
    OneDeviceShards,
    a2a_capacity,
    column_lookup,
    owner_routed_lookup_sliced,
    round_up,
)

# flax's truncated_normal(stddev) draws from N(0, 1) cut at +-2 and scales by
# stddev / 0.8796..., the std of that cut distribution
_TRUNC_STD = 0.87962566103423978

# the year table's rows past 0: year values up to 2200 (JAX `num_years`)
NUM_YEARS = 2200


def trunc_normal_(w: torch.Tensor, std: float, generator: Optional[torch.Generator]) -> None:
    s = std / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=s, a=-2 * s, b=2 * s, generator=generator)


def _padded_table(rows: int, dim: int, std: float, generator: Optional[torch.Generator],
                  drawn: Optional[int] = None) -> nn.Embedding:
    """A [rows, dim] table: its first `drawn` rows (all by default) truncated
    normal, the rest and row 0 zero."""
    # an uninitialised weight: nn.Embedding's own normal_ init would be
    # overwritten below (seconds of CPU time at 10M rows)
    table = nn.Embedding(rows, dim, _weight=torch.empty(rows, dim))
    drawn = rows if drawn is None else drawn
    with torch.no_grad():
        table.weight[drawn:].zero_()
    trunc_normal_(table.weight[:drawn], std, generator)
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


class ShardedLocalEmbedding(nn.Module):
    """Row-sharded table [V, D], V = num_items + 1 padded to a multiple of
    num_shards: each shard gathers the rows it owns, one psum adds them."""

    def __init__(self, num_items: int, item_embedding_dim: int, num_shards: int,
                 init_std: float = 0.02, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.item_embedding_dim = item_embedding_dim
        self.shards = OneDeviceShards(num_shards)
        vocab = round_up(num_items + 1, num_shards)
        # the local table's draw, then zero pad rows: one seed gives one model
        # whatever the table's layout (JAX draws the pad rows too; no id
        # reaches them)
        self._item_emb = _padded_table(vocab, item_embedding_dim, init_std, generator,
                                       drawn=num_items + 1)

    def place(self, shards, cols=None) -> None:
        """Run over `shards` (and `cols`), the parameter already the rank's block."""
        self.shards = shards

    def tables(self) -> torch.Tensor:
        """[local, V/R, D]: the held shards' rows."""
        return self._item_emb.weight.view(self.shards.local, -1, self.item_embedding_dim)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = self.shards.gather_psum(self.tables(), ids.reshape(-1))
        return out.reshape(*ids.shape, self.item_embedding_dim)


class ShardedA2AEmbedding(ShardedLocalEmbedding):
    """Row-sharded table with the owner-routed lookup: the flat ids, padded
    with 0 to a multiple of R, split into R slices; shard r routes slice r
    (buckets of `a2a_capacity(chunk, R, capacity_factor)` ids), and one
    tiled all_gather of the shards' rows gives the whole list's."""

    def __init__(self, num_items: int, item_embedding_dim: int, num_shards: int,
                 capacity_factor: float = 2.0, init_std: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_items, item_embedding_dim, num_shards, init_std, generator)
        self.capacity_factor = capacity_factor

    def _route(self, tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        r = self.shards.size
        flat = ids.reshape(-1).long()
        n = flat.shape[0]
        flat = torch.nn.functional.pad(flat, (0, -n % r))
        chunk = flat.shape[0] // r
        cap = a2a_capacity(chunk, r, self.capacity_factor)
        mine = self.shards.own(flat.view(r, chunk))  # the held shards' slices
        rows = owner_routed_lookup_sliced(self.shards, tables, mine, cap=cap)
        return self.shards.all_gather(rows, dim=0)[:n]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self._route(self.tables(), ids).reshape(*ids.shape, self.item_embedding_dim)


class ColumnShardedLocalEmbedding(nn.Module):
    """Column-sharded table [num_items + 1, D]: shard s owns D/R columns;
    local gathers, then one all_gather of the columns."""

    def __init__(self, num_items: int, item_embedding_dim: int, num_shards: int,
                 init_std: float = 0.02, generator: Optional[torch.Generator] = None):
        super().__init__()
        if item_embedding_dim % num_shards:
            raise ValueError(
                f"item_embedding_dim {item_embedding_dim} not divisible "
                f"by {num_shards} column shards"
            )
        self.item_embedding_dim = item_embedding_dim
        self.shards = OneDeviceShards(num_shards)
        self._item_emb = _padded_table(num_items + 1, item_embedding_dim, init_std, generator)

    def place(self, shards, cols=None) -> None:
        self.shards = shards

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = column_lookup(self.shards, self._item_emb.weight, ids.reshape(-1))
        return out.reshape(*ids.shape, self.item_embedding_dim)


class Sharded2DEmbedding(ShardedA2AEmbedding):
    """Rows over "model" (num_shards) x columns over "col" (col_shards):
    shard (r, c) holds the rows of r and the D/C columns of c. The C column
    shards route the same ids, so their exchanges run as one on the rows'
    columns stacked [R, V/R, C, D/C]; the model all_gather gives [n, C,
    D/C], and the tiled all_gather over "col" the [n, D] rows."""

    def __init__(self, num_items: int, item_embedding_dim: int, num_shards: int,
                 col_shards: int, capacity_factor: float = 2.0, init_std: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        if item_embedding_dim % col_shards:
            raise ValueError(
                f"item_embedding_dim {item_embedding_dim} not divisible "
                f"by {col_shards} column shards"
            )
        super().__init__(num_items, item_embedding_dim, num_shards, capacity_factor,
                         init_std, generator)
        self.cols = OneDeviceShards(col_shards)

    def place(self, shards, cols=None) -> None:
        self.shards, self.cols = shards, cols

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        weight = self._item_emb.weight
        c = self.cols.local
        tables = weight.view(self.shards.local, -1, c, weight.shape[1] // c)
        rows = self._route(tables, ids)  # [n, C, D/C]
        out = self.cols.all_gather(rows, dim=1, stack_dim=1)
        return out.reshape(*ids.shape, self.item_embedding_dim)
