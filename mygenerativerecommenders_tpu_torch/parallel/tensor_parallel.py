"""Where the model's sharded leaves live over a process group: tensor
parallelism (`encoder.tp_shards`) and the sharded item tables.

Port of mygenerativerecommenders_tpu/parallel/tensor_parallel.py (`tp_spec`,
`place_tp_params`, :37-67) and of the JAX trainer's placement of the table
(train/driver.py:163-183, :206-210). JAX places each leaf with a
`NamedSharding` and lets GSPMD partition the matmuls; here a rank holds its
block of each sharded leaf as the parameter itself, and the model's modules
reach the other blocks through the shard groups' collectives
(parallel/embedding_sharding.py: `ProcessGroupShards`):

- every HSTU block's `_uvqk` [D, 2·h·dv + 2·h·dqk] is column-parallel: rank r
  of the model group holds the contiguous column block r (JAX's
  `P(None, "model")`, not aligned to heads);
- every block's `_o.weight` (torch's [D, h·dv], or [D, 3·h·dv] with
  concat_ua; the transpose of flax's `o/kernel`) holds row block r of the
  flax kernel, `P("model", None)`: column block r here. `_o.bias` stays
  replicated and is added after the sum;
- the item table of a sharded kind: row block r for sharded_local and
  sharded_a2a (`P("model", None)`), column block r for sharded_column
  (`P(None, "model")`), block (r, c) for sharded_2d (`P("model", "col")`).

The ring's sp group cuts no weight: the HSTU stack runs on each rank's
rows of the sequence (`HSTU.place_sp`), so every block's leaves (`_uvqk`,
`_o.weight`, `_o.bias` and the bias tables) get on each rank the part of
their gradient that its rows give, which the step sums over the sp group
(`partial_axes`: "sp"). With TP beside the ring a model rank runs the ring
on its own heads, so the bias tables' gradient is partial over "model" too.
The leaves before the stack's entry (the item table, the positional
embedding) and after its exit hold their whole gradient on every rank.

A placed parameter carries its `placement`, ((dim, axis), ...), which
`shard_axes` reads: the step sums its gradient over the ranks that hold the
same block (parallel/process_group.py: `GradBuffer`), Muon and Scion
orthogonalise the whole matrix (train/optimizers.py), and the checkpoints
gather the blocks into the one-process layout (`full_state_dict`) and slice
a full state back (`local_state_dict`). On one device there is nothing to
place: `encoder.tp_shards > 1` there is the one-process block, whose one
matmul computes the K column blocks side by side, as the one-device table
kinds hold every shard.

`place_model` builds nothing: every rank builds the whole one-process model
from `trainer.seed` (and Scion's re-init runs on the whole matrices, JAX's
order at train/driver.py:186-210), then keeps its blocks.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Tuple

import torch
from torch import nn

Placement = Tuple[Tuple[int, str], ...]  # ((dim, mesh axis), ...)

# the placement of each kind's table (`embeddings._item_emb.weight`)
TABLE_PLACEMENT: Dict[str, Placement] = {
    "sharded_local": ((0, "model"),),
    "sharded_a2a": ((0, "model"),),
    "sharded_column": ((1, "model"),),
    "sharded_2d": ((0, "model"), (1, "col")),
}
# TP's leaves, in the port's layout: column-parallel `_uvqk`, row-parallel
# `_o` (torch's [out, in] weight: the flax kernel's rows are its columns)
TP_PLACEMENT: Placement = ((1, "model"),)
TP_KEYS = ("_uvqk", "_o.weight")


def shard_axes(t: torch.Tensor) -> Tuple[str, ...]:
    """The mesh axes a placed parameter is sharded over; () where it is
    replicated."""
    return tuple(axis for _, axis in getattr(t, "placement", ()))


def partial_axes(t: torch.Tensor) -> Tuple[str, ...]:
    """The mesh axes over which each rank's gradient of the parameter is a
    part of the whole, to be summed (`place_model`); () for most."""
    return getattr(t, "partial", ())


def _groups(mesh: Any) -> Dict[str, Any]:
    return {"model": mesh.model, "col": mesh.col}


def local_block(full: torch.Tensor, placement: Placement, groups: Mapping[str, Any]
                ) -> torch.Tensor:
    """The rank's block of a whole tensor (a view)."""
    for dim, axis in placement:
        g = groups[axis]
        size = full.shape[dim] // g.size
        if size * g.size != full.shape[dim]:
            raise ValueError(f"dimension {dim} of {tuple(full.shape)} does not divide by the "
                             f"{g.size} ranks of the {axis} axis")
        full = full.narrow(dim, g.rank * size, size)
    return full


@torch.no_grad()
def full_tensor(local: torch.Tensor, placement: Placement, groups: Mapping[str, Any]
                ) -> torch.Tensor:
    """The whole tensor from every rank's block: all_gathers over the
    placement's groups (every rank of them calls it)."""
    out = local
    for dim, axis in reversed(placement):
        g = groups[axis]
        out = g.all_gather(out.unsqueeze(dim), dim=dim, stack_dim=dim)
    return out


def _place(module: nn.Module, attr: str, placement: Placement, groups: Mapping[str, Any]
           ) -> None:
    """Replace module.<attr> by a parameter holding the rank's block of it."""
    whole = getattr(module, attr)
    param = nn.Parameter(local_block(whole.detach(), placement, groups).clone(),
                         requires_grad=whole.requires_grad)
    param.placement = placement
    setattr(module, attr, param)


def place_model(model: nn.Module, mesh: Any) -> nn.Module:
    """The model with its sharded leaves cut to this rank's blocks (JAX's
    `place_tp_params` and the table's `device_put`), its sharded kinds and
    HSTU stack set to run over the mesh's groups (on the rank's rows of its
    sp group, which cuts no weight but leaves the blocks' gradients partial
    over "sp"); the model itself where the mesh has no model or sp axis.
    `model.placements` names each placed key."""
    model.placements = {}
    if mesh is None:
        return model
    enc = model.cfg.encoder
    tp = mesh.model is not None and enc.kind == "hstu" and enc.tp_shards > 1
    if mesh.model is not None:
        groups = _groups(mesh)
        kind = model.cfg.embedding.kind
        if kind in TABLE_PLACEMENT and model.cfg.embedding.num_shards > 1:
            emb = model.embeddings
            _place(emb._item_emb, "weight", TABLE_PLACEMENT[kind], groups)
            emb.place(mesh.model, mesh.col)
            model.placements["embeddings._item_emb.weight"] = TABLE_PLACEMENT[kind]
        if tp:
            hstu = model.sequence_encoder["_hstu"]
            for i, block in enumerate(hstu._attention_layers):
                block.place_tp(mesh.model)
                _place(block, "_uvqk", TP_PLACEMENT, groups)
                _place(block._o, "weight", TP_PLACEMENT, groups)
                for key in TP_KEYS:
                    model.placements[f"sequence_encoder._hstu._attention_layers.{i}.{key}"] = \
                        TP_PLACEMENT
    if mesh.sp is not None:
        hstu = model.sequence_encoder["_hstu"]
        hstu.place_sp(mesh.sp)
        for block in hstu._attention_layers:
            for p in (block._uvqk, block._o.weight, block._o.bias):
                p.partial = ("sp",)
            tables = block._rel_attn_bias
            for p in (tables._pos_w, tables._ts_w) if tables is not None else ():
                if p is not None:  # a rank's ring sees its heads alone under TP
                    p.partial = ("model", "sp") if tp else ("sp",)
    return model


def local_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A one-process state_dict cut to this rank's blocks of the placed keys
    (`place_tp_params` on a state)."""
    placements = getattr(model, "placements", {})
    if not placements:
        return dict(state)
    groups = mesh_groups()
    return {k: local_block(v, placements[k], groups) if k in placements else v
            for k, v in state.items()}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state_dict in the one-process layout: the placed keys'
    blocks gathered (every rank of the mesh calls it; its inverse is
    `local_state_dict`)."""
    state = model.state_dict()
    placements = getattr(model, "placements", {})
    if not placements:
        return state
    groups = mesh_groups()
    return {k: full_tensor(v, placements[k], groups) if k in placements else v
            for k, v in state.items()}


def mesh_groups() -> Dict[str, Any]:
    """{"model", "col"}: the shard groups of the started mesh, which a
    placed parameter's blocks are spread over."""
    from mygenerativerecommenders_tpu_torch.parallel.process_group import started

    mesh = started()
    if mesh is None or mesh.model is None:
        raise RuntimeError("a placed model needs the mesh it was placed on")
    return _groups(mesh)


def _optimizer_parts(optimizer: Any, state: Mapping[str, Any]
                     ) -> Iterable[Tuple[torch.optim.Optimizer, Dict[str, Any]]]:
    """(torch optimizer, its state_dict) for each part of the port's
    optimizers: a split optimizer's two, the lazy table optimizer's `rest`."""
    if isinstance(optimizer, torch.optim.Optimizer):
        yield optimizer, state
    elif "primary" in state:
        yield from _optimizer_parts(optimizer.primary, state["primary"])
        yield from _optimizer_parts(optimizer.matrix, state["matrix"])
    else:
        yield from _optimizer_parts(optimizer.rest, state["rest"])


def _map_optimizer_state(optimizer: Any, state: Dict[str, Any], fn) -> Dict[str, Any]:
    """`state` (an optimizer's state_dict) with fn(tensor, placement) on
    every per-parameter tensor of a placed parameter's shape. The entries
    are new dicts: a state_dict's entries are the optimizer's own."""
    for part, sd in _optimizer_parts(optimizer, state):
        params = [p for g in part.param_groups for p in g["params"]]
        for index, entry in list(sd["state"].items()):
            placement = getattr(params[index], "placement", None)
            if placement is None:
                continue
            sd["state"][index] = {
                key: fn(value, placement)
                if isinstance(value, torch.Tensor) and value.dim() == params[index].dim()
                else value
                for key, value in entry.items()
            }
    return state


def full_optimizer_state(optimizer: Any) -> Dict[str, Any]:
    """The optimizer's state_dict with the placed parameters' moments
    gathered: the one-process optimizer's (every rank calls it)."""
    state = optimizer.state_dict()
    if not _placed(optimizer):
        return state
    groups = mesh_groups()
    return _map_optimizer_state(optimizer, state,
                                lambda t, placement: full_tensor(t, placement, groups))


def local_optimizer_state(optimizer: Any, state: Dict[str, Any]) -> Dict[str, Any]:
    """A one-process optimizer state cut to this rank's blocks."""
    if not _placed(optimizer):
        return state
    groups = mesh_groups()
    return _map_optimizer_state(optimizer, state,
                                lambda t, placement: local_block(t, placement, groups).clone())


def _placed(optimizer: Any) -> bool:
    return any(hasattr(p, "placement") for g in optimizer.param_groups for p in g["params"])

