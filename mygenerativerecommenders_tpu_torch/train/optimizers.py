"""Optimizer factory. Port of `build_single` / `build_optimizer`
(mygenerativerecommenders_tpu/train/optimizers.py:189-199, 280-294) for one
optimizer over every parameter: AdamW and SGD.

`torch.optim.AdamW` computes what `optax.adamw` computes: bias-corrected
moments, eps added outside the root, and decoupled weight decay on every
parameter (lr * wd * p). `torch.optim.SGD` with momentum computes
`optax.sgd(momentum=...)`'s trace. The learning rate given here is only the
first one: the train step sets it per step from the plateau controller
(`set_lr`). Muon, Scion and the second (matrix) optimizer raise.

With `fused=True` (the trainer's choice on cuda, for eager and graphed steps
alike) both run their fused kernels, and the learning rate is a 1-element
float32 tensor on the parameters' device: a CUDA graph of the step
(train/graphs.py) reads the rate from there, so `set_lr` fills it in place
between replays. AdamW is then also `capturable`, which only lets
`torch.cuda.graph` take its `step()` (the fused update's arithmetic is the
same). Without it (the CPU) the optimizers are the plain ones with a float
learning rate.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch

from mygenerativerecommenders_tpu_torch import not_ported
from mygenerativerecommenders_tpu_torch.configs import OptimizerConfig


def build_optimizer(
    opt1: OptimizerConfig,
    opt2: Optional[OptimizerConfig],
    params: Iterable[torch.nn.Parameter],
    lr1: float,
    fused: bool = False,
) -> torch.optim.Optimizer:
    if opt2 is not None and opt2.enabled:
        raise not_ported("optimizer2.enabled (the matrix optimizer)", "Muon / Scion optimizers")
    params = list(params)
    lr: Any = lr1
    extra: Dict[str, Any] = {}
    if fused:
        lr = torch.tensor([lr1], dtype=torch.float32, device=params[0].device)
        extra = {"fused": True}
    if opt1.kind == "adamw":
        opt = torch.optim.AdamW(
            params, lr=lr, betas=tuple(opt1.betas), eps=opt1.eps,
            weight_decay=opt1.weight_decay, capturable=fused, **extra,
        )
        # the eager steps run uncaptured on purpose: capturable changes nothing
        # in the fused update, so torch's one-time warning about it is noise
        opt._warned_capturable_if_run_uncaptured = True
        return opt
    if opt1.kind == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=opt1.momentum, **extra)
    if opt1.kind in ("muon", "scion", "scion_light"):
        raise not_ported(f"optimizer1.kind={opt1.kind}", "Muon / Scion optimizers")
    raise ValueError(f"Unknown optimizer kind {opt1.kind}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate to `lr`: filled in place where it is a
    tensor (a captured step reads it there), assigned where it is a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
    """`optimizer.load_state_dict(state)`, keeping what this optimizer was
    built with: its own learning-rate tensor (holding the checkpoint's rate),
    `fused` and `capturable`, and a fused optimizer's step counts as float32
    on the parameters' device. A checkpoint written by the other kind of
    optimizer (float rate, host step counts) then loads as well."""
    kept = [
        {key: group[key] for key in ("lr", "fused", "capturable") if key in group}
        for group in optimizer.param_groups
    ]
    optimizer.load_state_dict(state)
    for group, own in zip(optimizer.param_groups, kept):
        rate = float(group["lr"])
        if isinstance(own["lr"], torch.Tensor):
            own["lr"].fill_(rate)
        else:
            own["lr"] = rate
        group.update(own)
        if not group.get("fused"):
            continue
        for p in group["params"]:
            entry = optimizer.state.get(p)
            if entry and isinstance(entry.get("step"), torch.Tensor):
                entry["step"] = entry["step"].to(device=p.device, dtype=torch.float32)
