"""SASRec, the baseline encoder. Port of mygenerativerecommenders_tpu/models/sasrec.py.

Each block computes, over the dense [B, N, D] rows:

  q = LN(x)                          (no scale or bias, eps 1e-8)
  a = MHA(q, key=x, value=x, causal) (flax's MultiHeadDotProductAttention)
  h = LN(q + a)
  x = conv2(drop(relu(conv1(h)))) -> drop -> + h
  x = x * valid_mask

The attention is flax's, op for op: q, k and v projections with biases
(q from LN(x), k and v from x), the query scaled by 1/sqrt(head_dim), the
causal mask with masked logits set to float32's lowest value (padded keys
are not masked: the JAX encoder masks none), softmax in float32, dropout on
the weights with one [N, N] keep mask a block shared by every row and head
(flax's default `broadcast_dropout=True`), and the output projection with a
bias. The JAX package runs it as plain XLA ops, not as a Pallas kernel, and
so does the port: matmuls and a masked softmax. `scaled_dot_product_attention`
is not used: its dropout draws every element on its own.

At `model.compute_dtype=bfloat16` the input, the mask and block 0's first
LayerNorm output are rounded to bfloat16, as in JAX (models/precision.py);
the projections promote them to float32 and the rest runs in float32.

Parameters keep the JAX leaves' names and flax's layout (models/dense.py):
`mha_{i}.{query,key,value}.kernel` [D, H, D/H] with `.bias` [H, D/H],
`mha_{i}.out.kernel` [H, D/H, D] with `.bias` [D], `ffn_{i}.conv1.kernel`
[D, F], `ffn_{i}.conv2.kernel` [F, D] with their biases; every kernel drawn
lecun-normal (truncated, std sqrt(1 / fan_in)), every bias zero. Under
`model.train()` the dropouts draw from the device's default generator.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mygenerativerecommenders_tpu_torch.models import precision
from mygenerativerecommenders_tpu_torch.models.dense import Dense

_LN_EPS = 1e-8


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=_LN_EPS)


class MultiHeadAttention(nn.Module):
    """flax's `MultiHeadDotProductAttention` with a causal mask."""

    def __init__(self, embedding_dim: int, num_heads: int, dropout_rate: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embedding_dim % num_heads:
            raise ValueError(f"embedding_dim {embedding_dim} is not a multiple of num_heads "
                             f"{num_heads}")
        head_dim = embedding_dim // num_heads
        self.head_dim = head_dim
        self.dropout_rate = dropout_rate
        self.query = Dense((embedding_dim,), (num_heads, head_dim), generator)
        self.key = Dense((embedding_dim,), (num_heads, head_dim), generator)
        self.value = Dense((embedding_dim,), (num_heads, head_dim), generator)
        self.out = Dense((num_heads, head_dim), (embedding_dim,), generator)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor,
                inputs_v: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`inputs_v` (default `inputs_kv`): the value projection's own copy
        of the keys' input (models/precision.py)."""
        n = inputs_q.shape[1]
        q = self.query(inputs_q) / self.head_dim**0.5  # [B, N, H, d]
        k = self.key(inputs_kv)
        v = self.value(inputs_kv if inputs_v is None else inputs_v)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~causal, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        if self.training and self.dropout_rate > 0:
            keep = 1.0 - self.dropout_rate
            mask = torch.empty(n, n, device=q.device).bernoulli_(keep)  # shared by rows and heads
            weights = weights * (mask / keep)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v))


class SASRecFFN(nn.Module):
    """conv1 -> relu (or gelu) -> dropout -> conv2 -> dropout, + the input:
    the reference's kernel-size-1 Conv1d pair as per-position dense layers."""

    def __init__(self, embedding_dim: int, hidden_dim: int, activation: str = "relu",
                 dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.conv1 = Dense((embedding_dim,), (hidden_dim,), generator)
        self.conv2 = Dense((hidden_dim,), (embedding_dim,), generator)
        self._dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x)
        # flax's gelu is the tanh approximation
        h = F.relu(h) if self.activation == "relu" else F.gelu(h, approximate="tanh")
        h = self._dropout(self.conv2(self._dropout(h)))
        return h + x


class SASRec(nn.Module):
    def __init__(
        self,
        max_sequence_len: int,
        embedding_dim: int,
        num_blocks: int,
        num_heads: int,
        ffn_hidden_dim: int,
        activation: str = "relu",
        dropout_rate: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        del max_sequence_len  # the JAX encoder takes it and reads it nowhere
        # flax draws the parameters block by block: mha_i, then ffn_i
        for i in range(num_blocks):
            self.add_module(f"mha_{i}", MultiHeadAttention(
                embedding_dim, num_heads, dropout_rate, generator))
            self.add_module(f"ffn_{i}", SASRecFFN(
                embedding_dim, ffn_hidden_dim, activation, dropout_rate, generator))
        self.num_blocks = num_blocks

    def forward(
        self,
        past_lengths: torch.Tensor,
        user_embeddings: torch.Tensor,  # [B, N, D]
        valid_mask: torch.Tensor,  # [B, N, 1]
        past_payloads: Dict[str, torch.Tensor],
    ) -> torch.Tensor:
        """-> [B, N, D], zero at invalid rows."""
        del past_lengths, past_payloads
        x = user_embeddings
        mask = valid_mask.to(x.dtype)
        for i in range(self.num_blocks):
            mha = getattr(self, f"mha_{i}")
            if x.dtype == torch.float32:
                q = _layer_norm(x)
                h = _layer_norm(q + mha(q, x))
            else:
                # block 0 at compute_dtype=bfloat16 (models/precision.py): x's
                # uses (the LayerNorm's two, key, value) and q's (query, the
                # residual) each promoted to float32 as in JAX
                stats, norm, x_key, x_value = precision.uses(x, 4)
                q = precision.layer_norm(stats, norm, _LN_EPS, x.dtype)
                q_query, q_res = precision.uses(q, 2)
                h = _layer_norm(q_res + mha(q_query, x_key, x_value))
            x = getattr(self, f"ffn_{i}")(h) * mask
        return x
