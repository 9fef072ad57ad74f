"""Optimizer factory. Port of `build_single` / `build_optimizer`
(mygenerativerecommenders_tpu/train/optimizers.py:189-199, 280-294) for one
optimizer over every parameter: AdamW and SGD.

`torch.optim.AdamW` computes what `optax.adamw` computes: bias-corrected
moments, eps added outside the root, and decoupled weight decay on every
parameter (lr * wd * p). `torch.optim.SGD` with momentum computes
`optax.sgd(momentum=...)`'s trace. The learning rate given here is only the
first one: the train step sets it per step from the plateau controller. Muon,
Scion and the second (matrix) optimizer raise.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from mygenerativerecommenders_tpu_torch import not_ported
from mygenerativerecommenders_tpu_torch.configs import OptimizerConfig


def build_optimizer(
    opt1: OptimizerConfig,
    opt2: Optional[OptimizerConfig],
    params: Iterable[torch.nn.Parameter],
    lr1: float,
) -> torch.optim.Optimizer:
    if opt2 is not None and opt2.enabled:
        raise not_ported("optimizer2.enabled (the matrix optimizer)", "Muon / Scion optimizers")
    if opt1.kind == "adamw":
        return torch.optim.AdamW(
            params, lr=lr1, betas=tuple(opt1.betas), eps=opt1.eps,
            weight_decay=opt1.weight_decay,
        )
    if opt1.kind == "sgd":
        return torch.optim.SGD(params, lr=lr1, momentum=opt1.momentum)
    if opt1.kind in ("muon", "scion", "scion_light"):
        raise not_ported(f"optimizer1.kind={opt1.kind}", "Muon / Scion optimizers")
    raise ValueError(f"Unknown optimizer kind {opt1.kind}")
