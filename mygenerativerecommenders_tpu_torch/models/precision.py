"""`model.compute_dtype=bfloat16`: the JAX package's rounding points, no more
and no fewer.

JAX's model casts the encoder's input to bfloat16 and its output back to
float32 (mygenerativerecommenders_tpu/models/model.py:275-282). Every
parameter stays float32, and jnp promotes a bfloat16 array met by a float32
one to float32, so the encoder runs in float32 from the first product with a
weight on: no matrix product and no kernel takes a bfloat16 operand (the
attention kernels get float32 q, k and v as at float32). `jax.make_jaxpr` of
JAX's forward at `compute_dtype=bfloat16` (synthetic-smoke, `use_pallas`
false; the packed rows and the one-card ring run the same block) holds these
`convert_element_type` ops to bfloat16:

- HSTU (padded, packed, the ring in both layouts; the plain, rated, aux and
  combined preprocessors, which differ only in the input's width): three,
  the encoder's input, the 0/1 mask (`valid_mask.astype(x.dtype)`,
  models/hstu.py:343) and block 0's first LayerNorm output (flax's
  LayerNorm returns its input's dtype; its statistics run in float32). Block
  0's input x is bfloat16 (x * mask in bfloat16), its residual `out + x`
  adds the rounded input in float32, and from block 1 on everything is
  float32 (x * mask there is float32 times a 0/1 bfloat16).
- `softmax_rel_bias`: five, those three and, in block 0, the softmax
  branch's output (`.astype(x.dtype)`, models/hstu.py:200) and the
  LayerNorm of it.
- SASRec: three, the input, the mask and block 0's first LayerNorm output
  (q); flax's `MultiHeadDotProductAttention` and `Dense` promote their
  inputs to their float32 kernels, and `q + attn` is float32.

The gradient rounds at the same points. The cotangent of each float32 use
of a bfloat16 value (the transpose of the promotion) is rounded to bfloat16,
and the uses' cotangents are added in bfloat16, the last use's first: that is
the order in which JAX's backward pass meets them. `uses` makes those float32
copies with that backward, so autograd's own sum (in another order) never
sees them. `layer_norm` is flax's LayerNorm without scale or bias on a
bfloat16 input: the statistics (mean(x^2) - mean(x)^2) from one promoted
copy, the normalisation from another, the result rounded to bfloat16. At
float32 the port keeps `F.layer_norm` and none of this runs.

JAX's decode step reads no `compute_dtype` (its generation of a bfloat16
model decodes the float32 one), so the port's generation refuses a bfloat16
model (models/decode.py:check_decodable; ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """`model.compute_dtype` as a torch dtype."""
    if name not in DTYPES:
        raise ValueError(f"model.compute_dtype={name}: expected one of {sorted(DTYPES)}")
    return DTYPES[name]


class _Uses(torch.autograd.Function):
    """x -> k float32 copies; the backward rounds each copy's gradient to x's
    dtype and adds them in that dtype, the last copy's first."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.dtype = x.dtype
        return tuple(x.float() for _ in range(k))

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in reversed(grads):
            g = g.to(ctx.dtype)
            total = g if total is None else total + g
        return total, None


def uses(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, ...]:
    """k float32 copies of a low-precision x, one for each of its uses in
    the order JAX's forward makes them (see the module docstring)."""
    return _Uses.apply(x, k)


def layer_norm(stats: torch.Tensor, norm: torch.Tensor, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """flax's `LayerNorm(use_bias=False, use_scale=False)` of a low-precision
    x, given two of `uses(x, ...)`'s copies (its first two uses): the float32
    statistics of `stats`, `norm` normalised by them, the output rounded to
    `dtype`."""
    mean = stats.mean(-1, keepdim=True)
    var = torch.clamp((stats * stats).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return ((norm - mean) * torch.rsqrt(var + eps)).to(dtype)
