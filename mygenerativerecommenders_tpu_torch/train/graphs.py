"""CUDA graphs of whole steps: captured once per batch shape, then replayed.

A port-only module: the JAX package gets one device dispatch for k steps from
`jax.jit` over a `lax.scan` (train/task_retrieval.py:326-379) or a `lax.map`
(:504-625, :627-730). On one card the counterpart is a CUDA graph of the
whole step, replayed once a step: the forward, the count, the lse forward and
backward, the attention backwards and the fused optimizer update leave the
host as one launch.

`StepGraphs(body)` holds one captured graph per key (the shapes and dtypes of
the step's inputs, and a tag such as the model's mode). Each graph has

- static input buffers. The caller's tensors are copied into them before a
  replay (`inputs`), or the caller writes into a buffer of `buffer()` itself
  and hands it over as `bound` (the negatives' offsets, drawn there outside
  the graph; the eval candidates);
- its own memory pool (`torch.cuda.graph`'s default): graphs replayed in any
  order may not share one;
- warm-up runs on a side stream before capture, as `torch.cuda.graph`
  requires; they also build and load the kernels outside the capture. A
  warm-up of a training step is a real step, so `keep` snapshots what it
  changes (parameters, optimizer state, both optimizers' under
  `optimizer2.enabled`, the lazy table update's moments and count) and the
  default CUDA generator
  (dropout) is put back too: the run's stream stays the eager step's.

A capture that fails raises; nothing falls back to the eager step.

A remat model (`encoder.remat`, models/hstu.py) is captured the same way: each
block's recompute runs inside the backward, so it is part of the graph, and a
replay launches each block's attention forward twice (the capture's counts
record both). Checkpoint's stash of the default generator's state under
capture gives the recompute the masks its replay's forward drew.

The kernel wrappers count their launches in Python (`launches += 1`), and
parallel/process_group.py its collectives, which a replay does not run. The
counts taken while capturing are given back (a capture launches nothing) and
added again at every replay. `counts` keeps the
captures, warm-up runs and replays of every `StepGraphs` by name, as the
wrappers keep their launches: callers that count (chip_smoke.py) reset it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from mygenerativerecommenders_tpu_torch.ops.kernels import (
    count_offsets,
    dense_neg_lse,
    hstu_attention,
    hstu_chunk,
)
from mygenerativerecommenders_tpu_torch.parallel import embedding_sharding, process_group

# every kernel wrapper's launch counter, as (module, attribute)
_COUNTERS = (
    (hstu_attention, "launches"), (hstu_attention, "bwd_launches"),
    (count_offsets, "launches"),
    (dense_neg_lse, "launches"), (dense_neg_lse, "bwd_launches"),
    (dense_neg_lse, "fused_launches"), (dense_neg_lse, "fused_bwd_launches"),
    (hstu_chunk, "launches"), (hstu_chunk, "bwd_launches"),
)
# and the step's collectives over the mesh (the data group's, the model and
# col groups'), which a capture records like kernels
_TALLIES = _COUNTERS + ((process_group, "all_reduces"), (process_group, "all_gathers"),
                        (embedding_sharding, "collectives"))
WARMUP_RUNS = 2  # the second runs with the optimizer state the first made

# captures, warm-up runs and replays by StepGraphs name ("train", "eval")
counts: Dict[str, collections.Counter] = collections.defaultdict(collections.Counter)

Snapshot = Callable[[], Callable[[], None]]


def _read_counters() -> List[int]:
    return [getattr(module, name) for module, name in _TALLIES]


def _set_counters(values: Sequence[int]) -> None:
    for (module, name), value in zip(_TALLIES, values):
        setattr(module, name, value)


def training_state(params: Sequence[torch.Tensor], optimizer: torch.optim.Optimizer) -> Snapshot:
    """A `keep` for a training step: the snapshot clones the parameters, the
    optimizer's state tensors (both parts' for a split optimizer,
    train/optimizers.py) and any tensors its `state_tensors()` names (the
    lazy table update's moments and step count, train/lazy_embedding.py);
    restoring copies them back in place. State that a warm-up created (the
    optimizer builds it at its first step) goes back to zeros, the value a
    first step starts from (AdamW's moments and step count; SGD's, Muon's
    and Scion's momentum, whose first update then starts from zeros as
    theirs does)."""
    params = list(params)
    own = list(getattr(optimizer, "state_tensors", lambda: ())())

    def snapshot() -> Callable[[], None]:
        saved = [p.detach().clone() for p in params]
        saved_own = [t.clone() for t in own]
        then = optimizer.state
        state = {
            p: {k: v.clone() for k, v in then[p].items() if isinstance(v, torch.Tensor)}
            for p in params if p in then
        }

        @torch.no_grad()
        def restore() -> None:
            for p, value in zip(params + own, saved + saved_own):
                p.copy_(value)
            now = optimizer.state
            for p in params:
                before = state.get(p, {})
                for k, v in now.get(p, {}).items():
                    if isinstance(v, torch.Tensor):
                        if k in before:
                            v.copy_(before[k])
                        else:
                            v.zero_()

        return restore

    return snapshot


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    inputs: Dict[str, torch.Tensor]  # static buffers, by input name
    outputs: Tuple[torch.Tensor, ...]
    launches: List[int]  # kernel launches one replay makes, per counter


class StepGraphs:
    """body(inputs) -> tuple of tensors, captured per key and replayed."""

    def __init__(
        self, body: Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, ...]],
        name: str, keep: Optional[Snapshot] = None,
    ):
        self._body = body
        self.name = name
        self._keep = keep
        self._graphs: Dict[Hashable, _Captured] = {}
        self._buffers: Dict[Hashable, torch.Tensor] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def reset(self) -> None:
        """Drop every graph (and its memory pool): the next call captures
        anew, against the tensors that then hold the state (after a restore)."""
        self._graphs.clear()

    def buffer(self, name: str, shape: Sequence[int], dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
        """A static buffer the caller fills itself and passes as `bound`: the
        same tensor for the same (name, shape, dtype) from call to call."""
        key = (name, tuple(shape), dtype, device)
        if key not in self._buffers:
            self._buffers[key] = torch.zeros(tuple(shape), dtype=dtype, device=device)
        return self._buffers[key]

    def __call__(
        self, inputs: Dict[str, torch.Tensor],
        bound: Optional[Dict[str, torch.Tensor]] = None, tag: Hashable = None,
    ) -> Tuple[torch.Tensor, ...]:
        """Copy `inputs` into the graph's buffers and replay it (capturing it
        first for a new key). -> the graph's static outputs, which the next
        replay of the same graph overwrites."""
        bound = bound or {}
        key = (tag,) + tuple(sorted(
            (name, tuple(t.shape), t.dtype) for name, t in {**inputs, **bound}.items()
        ))
        captured = self._graphs.get(key)
        if captured is None:
            captured = self._graphs[key] = self._capture(inputs, bound)
        for name, t in bound.items():
            if captured.inputs[name] is not t:
                raise ValueError(f"{name}: a bound input must be the buffer the graph captured")
        for name, t in inputs.items():
            captured.inputs[name].copy_(t, non_blocking=True)
        captured.graph.replay()
        _set_counters([a + b for a, b in zip(_read_counters(), captured.launches)])
        counts[self.name]["replays"] += 1
        return captured.outputs

    def _capture(self, inputs: Dict[str, torch.Tensor], bound: Dict[str, torch.Tensor]) -> _Captured:
        static = {name: t.clone() for name, t in inputs.items()}
        static.update(bound)
        device = next(iter(static.values())).device
        restore = self._keep() if self._keep is not None else None
        rng = torch.cuda.get_rng_state(device)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._body(static)
        current.wait_stream(side)
        if restore is not None:
            restore()
        torch.cuda.set_rng_state(rng, device)
        counts[self.name]["warmup_runs"] += WARMUP_RUNS

        graph = torch.cuda.CUDAGraph()
        before = _read_counters()
        with torch.cuda.graph(graph):
            outputs = tuple(self._body(static))
        launches = [a - b for a, b in zip(_read_counters(), before)]
        _set_counters(before)
        counts[self.name]["captures"] += 1
        return _Captured(graph, static, outputs, launches)
