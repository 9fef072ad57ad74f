"""A dense layer in flax's parameter layout.

flax's `nn.Dense` and `nn.DenseGeneral` keep their kernel as [*in, *out]
(torch's `nn.Linear` as [out, in]). The layers that the port adds after the
HSTU block (the aux preprocessor's projection, SASRec's attention and
feed-forward) keep flax's layout, so a JAX parameter carries over as it is,
`checkpoint.transposed_from_jax` has nothing to add, and
`train/optimizers.py:param_labels` sees the shapes that JAX labels.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from mygenerativerecommenders_tpu_torch.models.embeddings import trunc_normal_


class Dense(nn.Module):
    """y = x . kernel + bias, contracting x's last len(in_shape) axes.
    `kernel` [*in_shape, *out_shape], `bias` [*out_shape] (zeros at init).
    init "lecun_normal" (flax's default: truncated normal, std sqrt(1/fan_in))
    or "xavier_uniform" (uniform in +-sqrt(6 / (fan_in + fan_out)))."""

    def __init__(
        self,
        in_shape: Sequence[int],
        out_shape: Sequence[int],
        generator: Optional[torch.Generator] = None,
        init: str = "lecun_normal",
    ):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        fan_in, fan_out = math.prod(self.in_shape), math.prod(self.out_shape)
        self.kernel = nn.Parameter(torch.empty(self.in_shape + self.out_shape))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))
        if init == "lecun_normal":
            trunc_normal_(self.kernel, math.sqrt(1.0 / fan_in), generator)
        elif init == "xavier_uniform":
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            with torch.no_grad():
                self.kernel.uniform_(-limit, limit, generator=generator)
        else:
            raise ValueError(f"Unknown init {init!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fan_in, fan_out = math.prod(self.in_shape), math.prod(self.out_shape)
        flat = x.reshape(*x.shape[: x.ndim - len(self.in_shape)], fan_in)
        y = flat @ self.kernel.reshape(fan_in, fan_out) + self.bias.reshape(fan_out)
        return y.reshape(*y.shape[:-1], *self.out_shape)
