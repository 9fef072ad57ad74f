"""The mesh over processes: one process a card, launched by torchrun.

Port of the JAX trainer's mesh (`make_mesh`,
mygenerativerecommenders_tpu/train/driver.py:48-93, sized at :124-153) and of
`jax.distributed.initialize` (tests/distributed_worker.py:80-86). The world's
ranks are laid out on a (data, model, col, sp) grid, world = data x model x
col x sp: "model" = max(`embedding.num_shards` of a sharded kind,
`encoder.tp_shards`), "col" = `embedding.col_shards` of sharded_2d, "sp" =
`encoder.sp_shards` (the ring's sequence shards), "data" the rest. The rank
order is JAX's device order: [data, model, col, sp] with sp innermost, or
with `trainer.mesh_data_innermost` the data index innermost, so a model or
sp group spans ranks that are `data` apart.

- `init_data_parallel(trainer_cfg, backend, model=1, col=1, sp=1)` reads
  torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
  `MASTER_ADDR`, `MASTER_PORT`) and starts the default group: NCCL for a
  cuda device, gloo for the CPU, or the backend its caller names (two
  processes sharing one card run gloo). A failed NCCL start raises; nothing
  falls back to gloo. Beside the default group it makes the data group of
  each (model, col, sp) coordinate and the model, col and sp group of each
  coordinate of the other axes (`dist.new_group`, every rank making every
  group in one order), and a gloo twin of the data group and of the world
  for host arrays (eval rows, checksums), as JAX's `process_allgather`
  does. The model, col and sp groups are `ProcessGroupShards`
  (parallel/embedding_sharding.py): the shard groups of the sharded tables,
  the sharded index and tensor parallelism (parallel/tensor_parallel.py),
  and the ring's sequence shards (parallel/ring_attention.py:
  `ProcessGroupRing`).
- The ranks of one model, col or sp group hold the same rows of the global
  batch: the loaders stride over the data coordinate, the losses divide by
  the global weight sum (`global_sum`, an all-reduce over the data group
  inside the step: models/losses.py), the in-batch pool and the lazy table
  update take the data group's rows (`gather_rows_of`), and a rank's own
  draws (negatives, dropout) are keyed by its data coordinate
  (`rank_seed`), so the ranks of such a group draw alike for what is one
  replicated computation.
- The step sums the gradients in flat buffers (`GradBuffer`,
  train/task_retrieval.py:train_step_from_loss), one a kind of leaf: a leaf
  sharded over the model (and col) axis is summed over the ranks that hold
  the same shard and divided by their copies of one data index (the sp
  ranks, and the col ranks of a leaf sharded over model alone); a
  replicated leaf is summed over the world and divided by its replica
  count (model x col x sp), the mean over those ranks of the data group's
  sum, which keeps the replicas bit-equal (the attention backward's
  bias-table gradients come from float atomics, so two ranks' "same"
  gradient differs in its last bits). No leaf is sharded over sp, but the
  HSTU blocks' leaves are partial over it (each sp rank runs the blocks on
  its own rows, parallel/tensor_parallel.py:partial_axes): their kind is
  summed over the same ranks and not divided by the ranks of an axis it is
  partial over. Without a model or sp axis this is one flat all-reduce
  over the world. On cuda under NCCL the step's collectives are captured
  in its CUDA graph.

No module of the port opens a group unless `trainer.distributed` asks for
it; without one none of these functions does anything but return its input.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mygenerativerecommenders_tpu_torch.parallel.embedding_sharding import ProcessGroupShards

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# the step's collectives over the data group and the world, counted where
# they are made, as the kernel wrappers count their launches (a CUDA graph
# replay adds those its capture recorded, train/graphs.py); callers that
# count reset them. The model and col groups' are counted by
# parallel/embedding_sharding.py
all_reduces = 0
all_gathers = 0


AXES = ("data", "model", "col", "sp")


def mesh_ranks(data: int, model: int, col: int, sp: int, data_innermost: bool) -> np.ndarray:
    """[data, model, col, sp] world ranks in JAX's device order
    (`make_mesh`): sp innermost, or with `data_innermost` the data index
    innermost."""
    n = data * model * col * sp
    if data_innermost:
        return np.moveaxis(np.arange(n).reshape(model, col, sp, data), -1, 0)
    return np.arange(n).reshape(data, model, col, sp)


@dataclasses.dataclass
class DataGroup:
    """This process's coordinates on the mesh and its groups: `rank` and
    `size` on the data axis, the data group (`data_pg`; the default group
    where the world is the data axis) for the step's sums, `host` (gloo) for
    host arrays over the data group and `world_host` over the world, and
    the shard groups `model`, `col` and `sp` (None where that axis is 1)."""

    rank: int  # the data index
    size: int  # the data size
    device: torch.device
    backend: str
    host: Any  # the gloo group of host arrays over the data group
    world_rank: int = 0
    world_size: int = 1
    data_pg: Any = None  # the data group (None: the default group)
    world_host: Any = None  # the gloo group over the world (None: `host`)
    model: Optional[ProcessGroupShards] = None
    col: Optional[ProcessGroupShards] = None
    sp: Optional[ProcessGroupShards] = None
    # the group a leaf sharded over these axes is summed over, and the axes
    # beside "data" that it spans
    replica_groups: Dict[FrozenSet[str], Tuple[Any, Tuple[str, ...]]] = dataclasses.field(
        default_factory=dict)
    grid: Optional[np.ndarray] = None  # [data, model, col, sp] world ranks (`mesh_ranks`)
    # the group of the ranks that share this data index and their count,
    # None where there is one (`replica_mean_`)
    replica_pg: Optional[Tuple[Any, int]] = None

    @property
    def model_size(self) -> int:
        return self.model.size if self.model is not None else 1

    @property
    def col_size(self) -> int:
        return self.col.size if self.col is not None else 1

    @property
    def sp_size(self) -> int:
        return self.sp.size if self.sp is not None else 1

    def all_reduce_(self, t: torch.Tensor, group: Any = None) -> torch.Tensor:
        """The sum over the data group (or `group`), in place."""
        global all_reduces
        all_reduces += 1
        dist.all_reduce(t, group=group if group is not None else self.data_pg)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's `t`, concatenated along dim 0 in data order."""
        global all_gathers
        all_gathers += 1
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.data_pg)
        return torch.cat(parts)

    def gather_rows(self, arr: np.ndarray) -> np.ndarray:
        """Every data rank's host rows, concatenated in data order (JAX
        `_gather_rows`, driver.py:562-586): the row counts first, each rank's
        rows padded to the largest count for the fixed-shape gather, the
        padding dropped after it. The ranks of a model, col or sp group hold
        the same rows, so the data group's are the global batch's."""
        counts = [torch.zeros(1, dtype=torch.int64) for _ in range(self.size)]
        dist.all_gather(counts, torch.tensor([arr.shape[0]], dtype=torch.int64), group=self.host)
        counts = [int(c) for c in counts]
        padded = np.zeros((max(counts),) + arr.shape[1:], dtype=arr.dtype)
        padded[: arr.shape[0]] = arr
        parts = [torch.empty(padded.shape, dtype=torch.from_numpy(padded).dtype)
                 for _ in range(self.size)]
        dist.all_gather(parts, torch.from_numpy(padded), group=self.host)
        return np.concatenate([p.numpy()[:n] for p, n in zip(parts, counts)], axis=0)

    def barrier(self) -> None:
        dist.barrier(group=self.world_host or self.host)

    def check_replicas(self, named: Iterable[Tuple[str, torch.Tensor]]) -> None:
        """Raise unless every rank holds the same tensors, bit for bit, where
        it should: a replicated tensor on every rank, a shard (`shard_axes`,
        parallel/tensor_parallel.py) on the ranks of its coordinate. A
        checksum of each tensor's bits (exact, in int64, whatever the order
        of the sum) gathered over the world's host group."""
        from mygenerativerecommenders_tpu_torch.parallel.tensor_parallel import shard_axes

        names, sums, axes = [], [], []
        for name, t in named:
            names.append(name)
            sums.append(_bit_checksum(t))
            axes.append(shard_axes(t))
        local = torch.stack(sums).cpu()
        every = [torch.empty_like(local) for _ in range(self.world_size)]
        dist.all_gather(every, local, group=self.world_host or self.host)
        coords = self.coords()
        for rank, theirs in enumerate(every):
            theirs_at = self.coords(rank)
            for i in (theirs != local).any(dim=1).nonzero()[:, 0].tolist():
                if all(coords[a] == theirs_at[a] for a in axes[i]):
                    raise RuntimeError(
                        f"rank {rank}'s {names[i]} differs from rank {self.world_rank}'s: "
                        "every rank must build its weights from the same trainer.seed"
                    )

    def coords(self, world_rank: Optional[int] = None) -> Dict[str, int]:
        """{"data", "model", "col", "sp"} of a world rank (default this one)."""
        r = self.world_rank if world_rank is None else world_rank
        return {axis: int(x[0]) for axis, x in zip(AXES, np.nonzero(self.grid == r))}

    def sum_grads_(self, flat: torch.Tensor, axes: FrozenSet[str],
                   partial: FrozenSet[str] = frozenset()) -> None:
        """A flat buffer of leaves sharded over `axes` (empty: replicated)
        and partial over `partial`, summed over the ranks that hold their
        shard and divided by the copies of one data index among them (the
        ranks of the axes they are partial over hold parts, not copies):
        the mean over those copies of the data group's sum. One all-reduce,
        also over a group of one rank (an identity, which a graph of the
        step captures all the same)."""
        group, spans = self.replica_groups[frozenset(axes)]
        sizes = {"model": self.model_size, "col": self.col_size, "sp": self.sp_size}
        replicas = int(np.prod([sizes[a] for a in spans if a not in partial]))
        self.all_reduce_(flat, group)
        if replicas > 1:
            flat.div_(replicas)


_GROUP: Optional[DataGroup] = None  # the process's group, once started


def started() -> Optional[DataGroup]:
    """The process's mesh, None before `init_data_parallel`: the one place
    the steps, losses and shard groups learn whether they run over ranks."""
    return _GROUP


def model_shards() -> Optional[ProcessGroupShards]:
    """The started mesh's model group where its model axis spans ranks."""
    return None if _GROUP is None else _GROUP.model


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the data group of the started mesh (a detached copy,
    all-reduced in the step); x itself without one. A loss's weight sum: the
    weights are masks, so no gradient flows through it."""
    if _GROUP is None:
        return x
    return _GROUP.all_reduce_(x.detach().clone())


def gather_rows_of(t: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of `t` in data order under the started mesh
    (the global batch's); `t` itself without one."""
    return t if _GROUP is None else _GROUP.all_gather(t)


def replica_mean_(t: torch.Tensor) -> torch.Tensor:
    """t (a replicated leaf's gradient rows) averaged over the ranks of the
    started mesh that share its data index (its model, col and sp groups),
    in place: the replicas update alike."""
    if _GROUP is not None and _GROUP.replica_pg is not None:
        group, copies = _GROUP.replica_pg
        _GROUP.all_reduce_(t, group)
        t.div_(copies)
    return t


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a data index's own draws (negatives, dropout): `seed`
    itself at data index 0, so one process draws as a run without the group
    does. Keyed by the data coordinate, not the rank: the ranks of a model
    group draw alike."""
    return seed + (rank << 32)


def _bit_checksum(t: torch.Tensor) -> torch.Tensor:
    """[2] int64: the sum of the tensor's 32-bit words, and their sum
    weighted by position modulo 8191; equal tensors give equal sums."""
    flat = t.detach().contiguous().reshape(-1)
    words = flat.view(torch.int32) if flat.element_size() == 4 else flat.view(torch.int16)
    total = torch.zeros(2, dtype=torch.int64, device=flat.device)
    step = 1 << 24
    for start in range(0, words.numel(), step):
        chunk = words[start : start + step].long()
        weight = (torch.arange(start, start + chunk.numel(), device=flat.device) % 8191) + 1
        total[0] += chunk.sum()
        total[1] += (chunk * weight).sum()
    return total


class GradBuffer:
    """Flat buffers that hold every parameter's gradient as a view, one a
    kind of leaf (the axes it is sharded over, `shard_axes`, and those it
    is partial over, `partial_axes`), and one slot more for the step's loss
    in the replicated leaves' buffer: one all-reduce a buffer sums them
    (`DataGroup.sum_grads_`). `prepare()` zeroes them and points each
    `.grad` at its view (autograd then adds into it in place); nothing is
    allocated a step, so a CUDA graph replays against the same memory."""

    def __init__(self, params: Sequence[torch.Tensor]):
        from mygenerativerecommenders_tpu_torch.parallel.tensor_parallel import (
            partial_axes,
            shard_axes,
        )

        self.params = [p for p in params if p.requires_grad]
        Kind = Tuple[FrozenSet[str], FrozenSet[str]]
        replicated = (frozenset(), frozenset())
        kinds: Dict[Kind, List[torch.Tensor]] = {replicated: []}
        for p in self.params:
            kinds.setdefault((frozenset(shard_axes(p)), frozenset(partial_axes(p))), []).append(p)
        first = self.params[0]
        self.flats: List[Tuple[Kind, torch.Tensor]] = []
        self.views: Dict[torch.Tensor, torch.Tensor] = {}
        for kind, params in kinds.items():
            extra = 1 if kind == replicated else 0  # the loss slot
            flat = torch.zeros(sum(p.numel() for p in params) + extra, dtype=first.dtype,
                               device=first.device)
            start = 0
            for p in params:
                self.views[p] = flat[start : start + p.numel()].view_as(p)
                start += p.numel()
            if kind == replicated:
                self.loss = flat[start]
            self.flats.append((kind, flat))

    def prepare(self) -> None:
        for _, flat in self.flats:
            flat.zero_()
        for p in self.params:
            p.grad = self.views[p]

    def all_reduce(self, group: DataGroup, loss: torch.Tensor) -> torch.Tensor:
        """Sum the gradients and `loss` over the ranks; -> the summed loss."""
        for p in self.params:
            if p.grad is not self.views[p]:
                raise RuntimeError("a gradient left its view of the flat buffer")
        self.loss.copy_(loss.detach())
        for (axes, partial), flat in self.flats:
            if flat.numel():
                group.sum_grads_(flat, axes, partial)
        return self.loss.clone()


def _env() -> Tuple[int, int, int, str, str]:
    missing = [name for name in ENV if name not in os.environ]
    if missing:
        raise ValueError(
            f"trainer.distributed=true needs torchrun's environment ({', '.join(ENV)}); "
            f"{', '.join(missing)} unset: launch with `torchrun --nproc_per_node=N -m "
            "mygenerativerecommenders_tpu_torch.cli.train trainer.distributed=true ...`"
        )
    env = os.environ
    return (int(env["RANK"]), int(env["WORLD_SIZE"]), int(env["LOCAL_RANK"]),
            env["MASTER_ADDR"], env["MASTER_PORT"])


def _device(name: str, local_rank: int) -> torch.device:
    """`trainer.device` where it names an index (or the CPU), else
    cuda:LOCAL_RANK."""
    device = torch.device(name)
    if device.type == "cpu" or device.index is not None:
        return device
    if device.type != "cuda":
        raise ValueError(f"trainer.device must be cuda or cpu, got {name!r}")
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise ValueError(
            f"LOCAL_RANK={local_rank} but this machine has {count} CUDA device(s): "
            "torchrun's --nproc_per_node must not exceed the cards"
        )
    return torch.device("cuda", local_rank)


def check_num_devices(num_devices: int, distributed: bool, world_size: int) -> None:
    """trainer.num_devices: 0 is the world size; any other value must equal
    it, and more than one device needs trainer.distributed (one card a process)."""
    if num_devices > 1 and not distributed:
        raise ValueError(
            f"trainer.num_devices={num_devices} needs trainer.distributed=true: the port runs "
            "one card a process, launched by `torchrun --nproc_per_node=N`"
        )
    if distributed and num_devices not in (0, world_size):
        raise ValueError(
            f"trainer.num_devices={num_devices} but the world size is {world_size}: set "
            "trainer.num_devices=0 or the number of processes"
        )


def _new_groups(grid: np.ndarray, axes: Tuple[int, ...], backend: Optional[str],
                world_rank: int) -> Any:
    """One group for each coordinate of the grid's other axes, over the ranks
    along `axes` (every rank makes every group, in one order); -> this
    rank's. A group of the whole world is the default group."""
    if grid.size == int(np.prod([grid.shape[a] for a in axes])) and backend is None:
        return dist.group.WORLD
    keep = [a for a in range(grid.ndim) if a not in axes]
    moved = np.moveaxis(grid, keep, list(range(len(keep))))
    lines = moved.reshape(int(np.prod(moved.shape[: len(keep)])), -1)
    mine = None
    for ranks in lines:
        pg = dist.new_group(ranks=[int(r) for r in ranks], backend=backend)
        if world_rank in ranks:
            mine = pg
    return mine


def _axis_group(grid: np.ndarray, axes: Tuple[int, ...], data_pg: Any, rank: int,
                made: Dict[Tuple[int, ...], Any]) -> Tuple[Any, Tuple[str, ...]]:
    """(the group over the ranks along `axes` of the grid, 0 among them; the
    names of the axes beside "data" it spans): `data_pg` where the other
    axes are all of size 1, else a group made once for each set of axes
    (`made`), the default group where they span the world."""
    axes = tuple(a for a in axes if grid.shape[a] > 1 or a == 0)
    spans = tuple(AXES[a] for a in axes if a != 0)
    if axes == (0,):
        return data_pg, spans
    if axes not in made:
        made[axes] = _new_groups(grid, axes, None, rank)
    return made[axes], spans


def init_data_parallel(trainer_cfg: Any, backend: Optional[str] = None, model: int = 1,
                       col: int = 1, sp: int = 1) -> DataGroup:
    """This process's `DataGroup`: the default group started from torchrun's
    environment (or the one already started in this process), its device,
    and the groups of a (data, model, col, sp) mesh with `model` x `col` x
    `sp` dividing the world. `backend`: None picks NCCL for a cuda device
    and gloo for the CPU."""
    global _GROUP
    rank, size, local_rank, addr, port = _env()
    check_num_devices(int(trainer_cfg.num_devices), True, size)
    cut = model * col * sp
    if size % cut:
        raise ValueError(
            f"the world size {size} does not divide by the model axis {model} x the col axis "
            f"{col} x the sp axis {sp} (embedding.num_shards / encoder.tp_shards, "
            f"embedding.col_shards, encoder.sp_shards): launch a multiple of {cut} processes"
        )
    device = _device(trainer_cfg.device, local_rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    innermost = bool(getattr(trainer_cfg, "mesh_data_innermost", False))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"trainer.device={trainer_cfg.device} but no CUDA device is available")
        torch.cuda.set_device(device)
    grid = mesh_ranks(size // cut, model, col, sp, innermost)
    if _GROUP is not None:
        same = (_GROUP.world_rank, _GROUP.world_size, _GROUP.device, _GROUP.backend,
                _GROUP.model_size, _GROUP.col_size, _GROUP.sp_size) == (
                    rank, size, device, backend, model, col, sp)
        if not same or (cut > 1 and not np.array_equal(_GROUP.grid, grid)):
            raise ValueError(
                f"the process group is already started as rank {_GROUP.world_rank} of "
                f"{_GROUP.world_size} on {_GROUP.device} over {_GROUP.backend} with a model "
                f"axis of {_GROUP.model_size}, a col axis of {_GROUP.col_size} and an sp axis "
                f"of {_GROUP.sp_size}")
        return _GROUP
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=size, **kwargs)
    world_host = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    data_pg = _new_groups(grid, (0,), None, rank)
    host = world_host if data_pg is dist.group.WORLD else (
        data_pg if backend == "gloo" else _new_groups(grid, (0,), "gloo", rank))
    coords = dict(zip(AXES, (int(x[0]) for x in np.nonzero(grid == rank))))
    shards = {}
    for axis, (name, n) in enumerate((("model", model), ("col", col), ("sp", sp)), start=1):
        if n > 1:
            shards[name] = ProcessGroupShards(_new_groups(grid, (axis,), None, rank),
                                              coords[name], n)
    # the leaves by the axes they are sharded over: replicated (summed over
    # the world), the 2-D table's blocks, and TP's blocks and the other
    # kinds' (sharded over "model" alone: copied over "col"); every kind
    # spans "sp", whose ranks hold copies of a leaf, or parts of the HSTU
    # blocks' (`sum_grads_`)
    replicas, made = {frozenset(): (dist.group.WORLD, tuple(
        AXES[a] for a in (1, 2, 3) if grid.shape[a] > 1))}, {}
    if model > 1:
        for axes, over in ((frozenset({"model", "col"}), (0, 3)),
                           (frozenset({"model"}), (0, 2, 3))):
            replicas[axes] = _axis_group(grid, over, data_pg, rank, made)
    # the ranks that share a data index (`replica_mean_`): one shard group
    # where one axis is above 1
    copied = tuple(a for a in (1, 2, 3) if grid.shape[a] > 1)
    replica_pg = None
    if len(copied) == 1:
        replica_pg = (shards[AXES[copied[0]]].group, cut)
    elif copied:
        replica_pg = (_new_groups(grid, copied, None, rank), cut)
    _GROUP = DataGroup(coords["data"], size // cut, device, backend, host, rank, size,
                       data_pg, world_host, shards.get("model"), shards.get("col"),
                       shards.get("sp"), replicas, grid, replica_pg)
    return _GROUP


def shutdown() -> None:
    """Close the process's groups (the end of a run, or a test's)."""
    global _GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP = None
