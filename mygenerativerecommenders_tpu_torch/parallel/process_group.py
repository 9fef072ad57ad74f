"""Data parallel over processes: one process a card, launched by torchrun.

Port of the data axis of the JAX trainer's mesh (`make_mesh`,
mygenerativerecommenders_tpu/train/driver.py:48-93, built at :149-152) and of
`jax.distributed.initialize` (tests/distributed_worker.py:80-86). Each
process holds one replica of the weights and trains on its rows of the
global batch: its data index is its rank and the data size the world size.

- `init_data_parallel(trainer_cfg)` reads torchrun's environment (`RANK`,
  `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and starts the
  default group: NCCL for a cuda device, gloo for the CPU, or the backend
  its caller names (two processes sharing one card run gloo). A failed NCCL
  start raises; nothing falls back to gloo. Beside it a gloo group carries
  the host arrays (eval rows, checksums), as JAX's `process_allgather` does.
- Once the process has started its group (`started()`), the losses divide
  by the global weight sum (`global_sum`, an all-reduce inside the step:
  models/losses.py), the in-batch sampler draws from the global batch's
  pool (`gather_rows_of`), the lazy table update takes every rank's touched
  rows, and the step sums the gradients over the ranks in one flat buffer
  (`GradBuffer`, train/task_retrieval.py:train_step_from_loss): what XLA's
  sums over the "data" axis give the JAX step. On cuda under NCCL the
  step's all-reduces are captured in its CUDA graph.

No module of the port opens a group unless `trainer.distributed` asks for
it; without one none of these functions does anything but return its input.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# the step's collectives, counted where they are issued as the kernel wrappers
# count their launches (a CUDA graph replay adds those its capture recorded,
# train/graphs.py); callers that count reset them
all_reduces = 0
all_gathers = 0


@dataclasses.dataclass
class DataGroup:
    """This process's coordinates on the data axis and its groups: the
    default one (NCCL on the card, gloo on the CPU) for the step's
    collectives, `host` (gloo) for host arrays."""

    rank: int  # the data index
    size: int  # the data size
    device: torch.device
    backend: str
    host: Any  # the gloo group of host arrays

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks, in place."""
        global all_reduces
        all_reduces += 1
        dist.all_reduce(t)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t`, concatenated along dim 0 in rank order."""
        global all_gathers
        all_gathers += 1
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def gather_rows(self, arr: np.ndarray) -> np.ndarray:
        """Every rank's host rows, concatenated in rank order (JAX
        `_gather_rows`, driver.py:562-586): the row counts first, each rank's
        rows padded to the largest count for the fixed-shape gather, the
        padding dropped after it."""
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
        dist.barrier(group=self.host)

    def check_replicas(self, named: Iterable[Tuple[str, torch.Tensor]]) -> None:
        """Raise unless every rank holds the same tensors, bit for bit: a
        checksum of each tensor's bits (exact, in int64, whatever the order
        of the sum) gathered over the host group."""
        names, sums = [], []
        for name, t in named:
            names.append(name)
            sums.append(_bit_checksum(t))
        local = torch.stack(sums).cpu()
        every = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(every, local, group=self.host)
        for rank, theirs in enumerate(every):
            differs = (theirs != local).any(dim=1).nonzero()
            if len(differs):
                raise RuntimeError(
                    f"rank {rank}'s {names[int(differs[0])]} differs from rank {self.rank}'s: "
                    "every rank must build its weights from the same trainer.seed"
                )


_GROUP: Optional[DataGroup] = None  # the process's group, once started


def started() -> Optional[DataGroup]:
    """The process's data-parallel group, None before `init_data_parallel`:
    the one place the steps and losses learn whether they run over ranks."""
    return _GROUP


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks of the started group (a detached copy,
    all-reduced in the step); x itself without one. A loss's weight sum: the
    weights are masks, so no gradient flows through it."""
    if _GROUP is None:
        return x
    return _GROUP.all_reduce_(x.detach().clone())


def gather_rows_of(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `t` in rank order under the started group (the
    global batch's); `t` itself without one."""
    return t if _GROUP is None else _GROUP.all_gather(t)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's own draws (negatives, dropout): `seed` itself at
    rank 0, so one process draws as a run without the group does."""
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
    """One flat buffer that holds every parameter's gradient as a view, and
    one slot more for the step's loss: a single all-reduce sums both over
    the ranks. `prepare()` zeroes it and points each `.grad` at its view
    (autograd then adds into it in place); nothing is allocated a step, so
    a CUDA graph replays against the same memory."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self.params = [p for p in params if p.requires_grad]
        sizes = [p.numel() for p in self.params]
        first = self.params[0]
        self.flat = torch.zeros(sum(sizes) + 1, dtype=first.dtype, device=first.device)
        self.views: List[torch.Tensor] = []
        start = 0
        for p, n in zip(self.params, sizes):
            self.views.append(self.flat[start : start + n].view_as(p))
            start += n
        self.loss = self.flat[start]

    def prepare(self) -> None:
        self.flat.zero_()
        for p, view in zip(self.params, self.views):
            p.grad = view

    def all_reduce(self, group: DataGroup, loss: torch.Tensor) -> torch.Tensor:
        """Sum the gradients and `loss` over the ranks; -> the summed loss."""
        for p, view in zip(self.params, self.views):
            if p.grad is not view:
                raise RuntimeError("a gradient left its view of the flat buffer")
        self.loss.copy_(loss.detach())
        group.all_reduce_(self.flat)
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


def init_data_parallel(trainer_cfg: Any, backend: Optional[str] = None) -> DataGroup:
    """This process's `DataGroup`: the default group started from torchrun's
    environment (or the one already started in this process), its device and
    its gloo group for host arrays. `backend`: None picks NCCL for a cuda
    device and gloo for the CPU."""
    global _GROUP
    rank, size, local_rank, addr, port = _env()
    check_num_devices(int(trainer_cfg.num_devices), True, size)
    device = _device(trainer_cfg.device, local_rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"trainer.device={trainer_cfg.device} but no CUDA device is available")
        torch.cuda.set_device(device)
    if _GROUP is not None:
        if (_GROUP.rank, _GROUP.size, _GROUP.device, _GROUP.backend) != (rank, size, device,
                                                                          backend):
            raise ValueError(
                f"the process group is already started as rank {_GROUP.rank} of "
                f"{_GROUP.size} on {_GROUP.device} over {_GROUP.backend}")
        return _GROUP
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=size, **kwargs)
    host = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    _GROUP = DataGroup(rank, size, device, backend, host)
    return _GROUP


def shutdown() -> None:
    """Close the process's groups (the end of a run, or a test's)."""
    global _GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP = None
