"""The model's weights, made from the run's seed on the device in two large
draws (one normal, one uniform) and cut into the leaves by name:

- the item table: N(0, 0.02) cut at two deviations, row 0 (padding) zero;
- the positional table: N(0, 1/sqrt(D)) cut at two deviations;
- each block's `_uvqk` and bias tables: N(0, 0.02); `_o.weight`
  Xavier-uniform, `_o.bias` zero; any other leaf N(0, 0.02).

The same seed and shapes give the same weights, so the reference can make
them again rather than read them from the program. The leaves are views of
the two draws' buffers: nothing is copied.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

Shapes = Sequence[Tuple[str, Tuple[int, ...]]]


def _uniform(name: str) -> bool:
    return name.endswith("_o.weight")


def make(shapes: Shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape in shapes]
    n_uni = sum(s for (name, _), s in zip(shapes, sizes) if _uniform(name))
    normal = torch.randn(sum(sizes) - n_uni, generator=gen, device=device)
    uniform = torch.rand(n_uni, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at_n = at_u = 0
    for (name, shape), size in zip(shapes, sizes):
        if _uniform(name):
            fan_out, fan_in = shape
            a = math.sqrt(6.0 / (fan_in + fan_out))
            w = uniform[at_u: at_u + size].view(shape).mul_(2 * a).sub_(a)
            at_u += size
        else:
            w = normal[at_n: at_n + size].view(shape)
            at_n += size
            if name.endswith("_o.bias"):
                w.zero_()
            elif name.endswith("_item_emb.weight"):
                w.mul_(0.02).clamp_(-0.04, 0.04)[0].zero_()
            elif name.endswith("_pos_emb.weight"):
                std = math.sqrt(1.0 / shape[-1])
                w.mul_(std).clamp_(-2 * std, 2 * std)
            else:
                w.mul_(0.02)
        out[name] = w
    return out


def shapes_of(module: torch.nn.Module) -> Shapes:
    return [(name, tuple(p.shape)) for name, p in module.named_parameters()]


@torch.no_grad()
def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"leaves differ: {sorted(set(params) ^ set(weights))}")
    for name, p in params.items():
        p.copy_(weights[name])
