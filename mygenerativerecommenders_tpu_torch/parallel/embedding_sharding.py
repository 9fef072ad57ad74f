"""Sharded item tables over a shard group: their R shards run in turn on one
device, or one a rank over a process group.

Port of mygenerativerecommenders_tpu/parallel/embedding_sharding.py: the
owner-routed all-to-all exchange (`owner_routed_lookup_body`,
`owner_routed_lookup_sliced`, `a2a_capacity`, :54-248) and the standalone
`ShardedEmbedding` (row shards: the psum lookup and the owner-routed one) and
`ColumnShardedEmbedding` (column shards: local gathers and one all_gather).

The bodies compute for every shard what the JAX bodies compute inside
`shard_map` on one device of the "model" (or "col") axis, and reach the other
shards only through a shard group, whose methods stand for JAX's
collectives. A group holds `local` shards' operands on a leading axis,
`[local, ...]`, and names them (`shard_ids`):

- `OneDeviceShards` holds all R, shard r's operand at index r, so each
  collective is a transpose or a concatenation of that axis, and the psum
  of the shards' masked gathers is one gather from the owner: a lookup is a
  fixed handful of launches whatever R is, and it runs inside a CUDA graph
  of the step.
- `ProcessGroupShards` holds its rank's one, `[1, ...]`, and its methods are
  collectives over a `torch.distributed` group (the model, col or sp group
  of parallel/process_group.py). Each is an autograd Function whose backward
  is the transpose that JAX's `shard_map` gives under a loss that every
  rank of the group computes whole (a replicated loss): the all_to_all's
  is the reverse all_to_all; an all_gather or a psum that yields a
  replicated value takes back the rank's own slice of the cotangent, or
  the cotangent itself; a rank's own slice of a replicated value gives
  back the all_gather of the slices' cotangents; and `enter` (a replicated
  value fed to rank-varying work, as TP's column-parallel matmul is) sums
  the ranks' partial cotangents. Where each rank goes on with a part of its
  own of a gathered or summed value (TP's heads beside the ring), the
  `_partial` methods' backward sums the ranks' cotangents first.
  `torch.distributed.nn`'s functions assume
  a loss summed over the ranks instead and would count a replicated
  loss's gradient R times.

The lookups are exact, as in JAX: a row is either gathered by its owner and
shipped back, or (an id past its bucket's static capacity) taken by the
residual, where exactly one shard contributes a non-zero row. JAX gates the
residual with a `lax.cond` on "any overflow"; here it is computed every time
and is all zero when nothing overflowed, so the values are JAX's and no step
reads a flag back to the host. Every table here is a view of one [V, D]
tensor: the gradient of a lookup is the scatter-add of its cotangent rows
into the rows (or columns) each shard owns, as the transposes of JAX's
gathers and collectives give it.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

# collectives made over a process group's shards (`ProcessGroupShards`),
# counted where they are made, as the kernel wrappers count their launches;
# a CUDA graph replay adds those its capture recorded (train/graphs.py)
collectives = 0


def round_up(x: int, m: int) -> int:
    """x rounded up to a multiple of m: a row-sharded table's vocabulary
    (num_items + 1) or the sharded index's catalog length."""
    return -(-x // m) * m


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`mask` with trailing unit dims up to `like`'s rank."""
    return mask.view(*mask.shape, *([1] * (like.dim() - mask.dim())))


def _rows(stacked: torch.Tensor, shard: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """stacked[shard, index] (stacked [R, M, ...]; shard and index broadcast)
    through `F.embedding` on the [R * M, ...] rows: its backward sums a row's
    duplicate cotangents in parallel, where the backward of advanced indexing
    (`index_put_` with accumulate) sums each run of duplicates serially on the
    card, and the masked slots of a lookup all read one row."""
    r, m = stacked.shape[:2]
    rest = stacked.shape[2:]
    flat = torch.nn.functional.embedding(shard * m + index, stacked.reshape(r * m, -1))
    return flat.reshape(*flat.shape[:-1], *rest)


class OneDeviceShards:
    """The R shards of one mesh axis on one device. A stacked operand is
    [R, ...]; a replicated one (the same on every shard) is held once."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a shard group needs at least one shard, got {size}")
        self.size = int(size)
        self.local = self.size  # the shards held here

    def shard_ids(self, device: Any) -> torch.Tensor:
        """[local]: the shards whose operands this group holds, in order."""
        return torch.arange(self.size, device=device)

    def own(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The held shards' blocks of a replicated x, split into R blocks
        along `dim`: all of x."""
        return x

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """`lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)`: shard
        s's block d goes to shard d as its block s. x [R (src), R (dst), ...]
        -> [R (dst), R (src), ...]."""
        return x.transpose(0, 1)

    def all_gather(self, x: torch.Tensor, dim: int, stack_dim: int = 0) -> torch.Tensor:
        """`lax.all_gather(axis=dim, tiled=True)`: every shard's operand
        (along `stack_dim` of x) concatenated in shard order along the
        operand's `dim`; the replicated result, held once."""
        return x.movedim(stack_dim, dim).flatten(dim, dim + 1)

    def gather_psum(self, tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The psum lookup: each shard gathers the rows of `ids` it owns
        (tables [R, rows_per_shard, ...], shard s owning ids [s * rps, (s +
        1) * rps)), zeros for the others, and one psum adds the shards. ids
        [n] -> [n, ...] replicated; ids outside [0, R * rps), -1 included,
        give zero rows. At most one shard owns an id, so the sum is its row
        plus zeros, which is the row to the bit: held once on one device, it
        is one gather from the owner, without the [R, n, ...] of masked rows."""
        rps = tables.shape[1]
        ids = ids.long()
        owner = torch.div(ids, rps, rounding_mode="floor")
        valid = (ids >= 0) & (owner < self.size)
        owner = owner.clamp(0, self.size - 1)
        local = (ids - owner * rps).clamp(0, rps - 1)
        rows = _rows(tables, owner, local)
        return torch.where(_bcast(valid, rows), rows, torch.zeros((), dtype=rows.dtype,
                                                                  device=rows.device))


def _count() -> None:
    global collectives
    collectives += 1


def _gather_list(x: torch.Tensor, group: Any, size: int) -> List[torch.Tensor]:
    _count()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _Stack(torch.autograd.Function):
    """Every rank's x stacked along `dim` (a size-1 axis of x) -> size R;
    backward: the rank's own slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.dim, ctx.rank = dim, rank
        return torch.cat(_gather_list(x, group, size), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank, 1).contiguous(), None, None, None, None


class _Own(torch.autograd.Function):
    """The rank's block of a replicated x along `dim`; backward: every
    rank's block's cotangent, concatenated (a replicated cotangent)."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        block = x.shape[dim] // size
        return x.narrow(dim, rank * block, block).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(_gather_list(grad, ctx.group, ctx.size), dim=ctx.dim), None, None, \
            None, None


class _StackPartial(torch.autograd.Function):
    """`_Stack` whose result each rank uses in a part of its own; backward:
    the sum of the ranks' cotangents, the rank's slice of it."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.dim, ctx.group, ctx.rank = dim, group, rank
        return torch.cat(_gather_list(x, group, size), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        _count()
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out.narrow(ctx.dim, ctx.rank, 1).contiguous(), None, None, None, None


class _Psum(torch.autograd.Function):
    """The sum over the ranks, a replicated value; backward: the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        _count()
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _PsumPartial(torch.autograd.Function):
    """The sum over the ranks, which each rank uses in its own way;
    backward: the sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        _count()
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        _count()
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _Enter(torch.autograd.Function):
    """A replicated value fed to rank-varying work; backward: the sum of
    the ranks' partial cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        _count()
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def _all_to_all(x: torch.Tensor, group: Any) -> torch.Tensor:
    _count()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """`all_to_all_single` over dim 0 (block d of rank s goes to rank d as
    its block s); backward: the same exchange of the cotangent's blocks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


class ProcessGroupShards:
    """The R shards of one mesh axis, one a rank of a `torch.distributed`
    group (`rank` its index there): a stacked operand is the rank's own,
    `[1, ...]`. The methods are `OneDeviceShards`' on that operand, each a
    collective over the group, with the backward of a replicated loss;
    `enter` and `psum` serve TP's blocks (models/hstu.py), which run on one
    device without a group, and beside the ring `all_gather_partial` and
    `psum_partial`, whose results each rank uses for its own heads; `own`
    and `all_gather` are the stack's boundary over an sp group and
    `rotate` the ring's step (parallel/ring_attention.py)."""

    local = 1

    def __init__(self, group: Any, rank: int, size: int):
        self.group, self.rank, self.size = group, int(rank), int(size)

    def shard_ids(self, device: Any) -> torch.Tensor:
        return torch.tensor([self.rank], device=device)

    def own(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The rank's block of a replicated x, split into R blocks along `dim`."""
        return _Own.apply(x, dim, self.group, self.rank, self.size)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated x fed to rank-varying work (TP's column-parallel
        matmul): x, whose gradient is summed over the group."""
        return _Enter.apply(x, self.group)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [1 (src), R (dst), ...] -> [1 (dst), R (src), ...]."""
        return _AllToAll.apply(x[0], self.group)[None]

    def rotate(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """x sent `shift` ranks forward around the group; -> the x of the rank
        `shift` behind (the ring's step, JAX's ppermute; no autograd). One
        `all_to_all_single` whose splits along dim 0 name one peer each way,
        which gloo and NCCL both take (gloo on CUDA tensors too)."""
        _count()
        n = x.shape[0]
        to, frm = (self.rank + shift) % self.size, (self.rank - shift) % self.size
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(),
                               [n if r == frm else 0 for r in range(self.size)],
                               [n if r == to else 0 for r in range(self.size)], group=self.group)
        return out

    def all_gather(self, x: torch.Tensor, dim: int, stack_dim: int = 0) -> torch.Tensor:
        stacked = _Stack.apply(x, stack_dim, self.group, self.rank, self.size)
        return stacked.movedim(stack_dim, dim).flatten(dim, dim + 1)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of x [1, ...]: replicated (TP's row-parallel
        output projection)."""
        return _Psum.apply(x[0], self.group)

    def all_gather_partial(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """`all_gather` of x [1, ...] where each rank goes on with a part of
        its own (TP's projection beside the ring, whose rank keeps its
        heads): the backward sums the ranks' cotangents before it takes the
        rank's block."""
        stacked = _StackPartial.apply(x, 0, self.group, self.rank, self.size)
        return stacked.movedim(0, dim).flatten(dim, dim + 1)

    def psum_partial(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of x [1, ...] where each rank goes on in
        its own way (the attention-output LayerNorm's row statistics over a
        rank's heads): the backward sums the ranks' cotangents."""
        return _PsumPartial.apply(x[0], self.group)

    def gather_psum(self, tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """`OneDeviceShards.gather_psum` on the rank's rows tables [1, rps,
        ...]: its masked gather of the ids it owns, psummed over the group."""
        rps = tables.shape[1]
        ids = ids.long()
        local = ids - self.rank * rps
        mine = (ids >= 0) & (local >= 0) & (local < rps)
        rows = torch.nn.functional.embedding(local.clamp(0, rps - 1),
                                             tables[0].reshape(rps, -1))
        rows = rows.reshape(*rows.shape[:-1], *tables.shape[2:])
        rows = torch.where(_bcast(mine, rows), rows, torch.zeros((), dtype=rows.dtype,
                                                                 device=rows.device))
        return _Psum.apply(rows, self.group)


def a2a_capacity(n: int, num_shards: int, capacity_factor: float) -> int:
    """Static per-owner bucket capacity of the owner-routed exchange."""
    cap = int(np.ceil(n / num_shards * capacity_factor))
    return max(1, min(cap, n))


def _exchange(
    group: OneDeviceShards, tables: torch.Tensor, my_ids: torch.Tensor, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The owner-routed exchange of every held shard's request list my_ids
    [local, c] (bucket by owner: a stable sort, as `jnp.argsort` is stable;
    ship each bucket of `cap` ids (empty slots -1) to its owner, gather
    there, ship the rows back and un-bucket). tables [local, rps, ...] ->
    (routed [local, c, ...], zero where an id overflowed its bucket; fits
    [local, c])."""
    r, held = group.size, my_ids.shape[0]
    rps = tables.shape[1]
    dev = my_ids.device
    c = my_ids.shape[1]
    my_ids = my_ids.long()
    owner = torch.div(my_ids, rps, rounding_mode="floor").clamp(0, r - 1)
    # rank of each id within its owner group
    sorted_owner, order = torch.sort(owner, dim=1, stable=True)
    owners = torch.arange(r, device=dev)
    group_start = torch.searchsorted(sorted_owner, owners.expand(held, r).contiguous(),
                                     side="left")
    rank_sorted = torch.arange(c, device=dev) - torch.gather(group_start, 1, sorted_owner)
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    fits = rank < cap

    # [local, R, C] send buckets of ids; the slot past the end takes the overflow
    slot = torch.where(fits, owner * cap + rank, r * cap)
    send = torch.full((held, r * cap + 1), -1, dtype=torch.long, device=dev)
    send = send.scatter(1, slot, my_ids)[:, :-1].reshape(held, r, cap)
    recv = group.all_to_all(send)  # [local (owner), R (source), C]
    local = recv - (group.shard_ids(dev) * rps)[:, None, None]
    ok = (local >= 0) & (local < rps)
    safe = local.clamp(0, rps - 1).reshape(held, r * cap)
    index = torch.arange(held, device=dev)[:, None]
    rows = _rows(tables, index, safe)  # [local (owner), R * C, ...]
    zero = torch.zeros((), dtype=rows.dtype, device=dev)
    rows = torch.where(_bcast(ok.reshape(held, r * cap), rows), rows, zero)
    back = group.all_to_all(rows.reshape(held, r, cap, *rows.shape[2:]))  # [local (source), R, C, ...]
    back = back.reshape(held, r * cap, *rows.shape[2:])
    safe_slot = torch.where(fits, slot, 0)
    routed = _rows(back, index, safe_slot)  # [local, c, ...]
    return torch.where(_bcast(fits, routed), routed, zero), fits


def owner_routed_lookup_body(
    group: OneDeviceShards, tables: torch.Tensor, flat_ids: torch.Tensor, *, cap: int,
) -> torch.Tensor:
    """The exchange with the request list `flat_ids` [n] replicated over the
    shards (JAX :54-151): every shard buckets and ships the whole list.
    tables [local, rows_per_shard, ...]. -> [n, ...] replicated. Ids past
    their bucket take the residual: each shard's rows of them, psummed.
    (Every shard routes the same rows, so over a process group the values
    are right but the table's gradient would come R times: the kinds route
    each shard's own slice, `owner_routed_lookup_sliced`.)"""
    n = flat_ids.shape[0]
    routed, fits = _exchange(group, tables, flat_ids.long().expand(group.local, n), cap)
    # every shard routed the same list, so its routed rows are the first's
    over = torch.where(fits[0], -1, flat_ids.long())
    return routed[0] + group.gather_psum(tables, over)


def owner_routed_lookup_sliced(
    group: OneDeviceShards, tables: torch.Tensor, my_ids: torch.Tensor, *, cap: int,
) -> torch.Tensor:
    """The exchange where shard r routes its own slice my_ids[r] of the
    request list (JAX :160-248), [local, chunk] -> [local, chunk, ...] rows.
    The residual: the overflowed ids all-gathered to every shard, each
    shard's rows of them psummed, each shard taking back its own chunk."""
    r, chunk = group.size, my_ids.shape[1]
    routed, fits = _exchange(group, tables, my_ids, cap)
    over = group.all_gather(torch.where(fits, -1, my_ids.long()), dim=0)  # [R * chunk]
    allrows = group.gather_psum(tables, over)  # [R * chunk, ...]
    return routed + group.own(allrows.reshape(r, chunk, *allrows.shape[1:]))


class ShardedEmbedding:
    """Row-sharded [V, D] table over a shard group: shard s owns rows [s *
    V/R, (s + 1) * V/R), V = num_items + 1 padded to a multiple of R. The
    table is one [V, D] tensor; shard s's rows are a view of it."""

    def __init__(self, group: OneDeviceShards, num_items: int, embedding_dim: int):
        self.group = group
        self.num_shards = group.size
        self.vocab = round_up(num_items + 1, self.num_shards)
        self.rows_per_shard = self.vocab // self.num_shards
        self.embedding_dim = embedding_dim

    def _tables(self, table: torch.Tensor) -> torch.Tensor:
        return table.view(self.num_shards, self.rows_per_shard, self.embedding_dim)

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The psum lookup: ids [...] -> [..., D]."""
        out = self.group.gather_psum(self._tables(table), ids.reshape(-1))
        return out.reshape(*ids.shape, self.embedding_dim)

    def lookup_all_to_all(self, table: torch.Tensor, ids: torch.Tensor,
                          capacity_factor: float = 2.0) -> torch.Tensor:
        """The owner-routed lookup of a replicated request list: ids [...]
        -> [..., D], equal to `lookup` to the bit under any overflow."""
        flat = ids.reshape(-1)
        cap = a2a_capacity(flat.shape[0], self.num_shards, capacity_factor)
        out = owner_routed_lookup_body(self.group, self._tables(table), flat, cap=cap)
        return out.reshape(*ids.shape, self.embedding_dim)

    def full_table(self, table: torch.Tensor) -> torch.Tensor:
        """Every shard's rows in order (JAX's all-gather of the table): on
        one device, the table itself."""
        return table


class ColumnShardedEmbedding:
    """Column-sharded [V, D] table: shard s owns columns [s * D/R, (s + 1) *
    D/R) of all V = num_items + 1 rows; a lookup is a local gather on every
    shard and one tiled all_gather of the columns."""

    def __init__(self, group: OneDeviceShards, num_items: int, embedding_dim: int):
        self.group = group
        self.num_shards = group.size
        if embedding_dim % self.num_shards:
            raise ValueError(
                f"embedding_dim {embedding_dim} not divisible by "
                f"{self.num_shards} column shards"
            )
        self.vocab = num_items + 1
        self.embedding_dim = embedding_dim

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        out = column_lookup(self.group, table, ids.reshape(-1))
        return out.reshape(*ids.shape, self.embedding_dim)

    def full_table(self, table: torch.Tensor) -> torch.Tensor:
        return table


def column_lookup(group: OneDeviceShards, table: torch.Tensor, flat_ids: torch.Tensor
                  ) -> torch.Tensor:
    """Shard s gathers its [n, D/R] columns of the rows at flat_ids; one
    tiled all_gather on the feature axis gives [n, D]. `table` holds the
    group's held columns, [V, local * D/R]; every shard gathers the same
    rows, so the held shards' gathers are the column blocks of one
    `F.embedding` of it (its backward sums duplicate ids in parallel)."""
    n, (v, d) = flat_ids.shape[0], table.shape
    rows = torch.nn.functional.embedding(flat_ids.long(), table)
    cols = rows.view(n, group.local, d // group.local).transpose(0, 1)  # [local, n, D/R]
    return group.all_gather(cols, dim=1)
