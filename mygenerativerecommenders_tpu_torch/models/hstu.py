"""HSTU sequential encoder: the pointwise (rel_bias) and the softmax
(softmax_rel_bias) attention.

Port of mygenerativerecommenders_tpu/models/hstu.py:58-216 (HSTUBlock) and
:287-414 (HSTU). Everything stays dense [B, N, D] with the invalid rows kept
at zero: the stack re-masks between blocks, so the residual and the output
bias never drift into padded rows, and the attention sees zero keys there.
With the time bias the attention goes through the fused wrapper
(ops/kernels/hstu_attention.py: the CUDA kernel on the card, its plain
version on the CPU) with `lengths` = last valid position + 1. Only where
the kernel cannot build the bias (no `ts_w` table or no timestamps) does it
take the dense reference with a materialised [B, N, N] bias. A packed batch
(a `seg_ids` payload) hands every block its `positions` payload as the
wrapper's `seg_positions`: the attention is block-diagonal over the segments.
The JAX stack's pad of the residual stream to 128 rows serves its TPU
kernels' tiles and has no counterpart here.

With `sp_shards` > 1 the attention is the ring of
parallel/ring_attention.py (`_ring_attention`, the counterpart of the JAX
block's :218-284): the sequence is padded to a multiple of the shard count
(twice that in the zigzag layout) and its P shards run in turn on the one
device, each through the chunk kernels of ops/kernels/hstu_chunk.py. The
ring has no `lengths`: rows past a user's length are live there, and the
block's output is the same only because u is silu(0) = 0 on those zero rows.

`normalization="softmax_rel_bias"` is the JAX block's softmax branch
(:182-200), in plain torch ops as JAX runs it in jnp ops: q and k keep the
all-heads-as-one layout [B, N, H*dqk] (one logit per pair, scaled by
1/sqrt(dqk) with dqk the per-head width), the materialised position (and
time) bias is added, the softmax runs over all N keys and the non-causal
weights are zeroed after it, with no renormalisation and no 1/N; then the
weights multiply v [B, N, H*dv]. `scaled_dot_product_attention` masks
before its softmax, so it computes another function. It takes no packed
rows (as JAX) and no ring: JAX's softmax branch is dense and ignores
`sp_shards`, which raises here.

Parameter names follow the reference checkpoint
(mygenerativerecommenders_tpu/cli/convert_ckpt.py:9-15): `_uvqk`, `_o`,
`_rel_attn_bias._pos_w` / `._ts_w`. Init matches the JAX package: uvqk and
the bias tables ~ N(0, 0.02), the output projection Xavier-uniform with a
zero bias. Under `model.train()` the block drops out the output
projection's input at `linear_dropout_rate` (`nn.Dropout`, drawn from the
device's generator).

`remat=True` (JAX :383-388, `nn.remat` of each block) runs each block under
`torch.utils.checkpoint` (non-reentrant) wherever grad is enabled: the
block's activations are dropped after its forward and recomputed inside its
backward, where the attention's autograd Function (rows 1-2 or, on the ring,
9-10) runs its forward kernel a second time. Checkpoint stashes the device's
RNG state before the block and puts it back for the recompute, so the
recompute draws the first forward's dropout mask, and the stream after it is
the one without remat: the same masks, the same gradients. On torch 2.11
this holds inside a CUDA graph capture too (a captured step's recompute drew
its forward's masks in every replay, PERF.md PR 19). The fused attention
saves only q, k and v, never the [B*H, N, N] scores that JAX's remat exists
to drop: here remat drops the O(N*D) activations of each block (its
LayerNorm, the uvqk projection and its silu, the attention output, its
LayerNorm, u * LN, the dropout mask).

At `model.compute_dtype=bfloat16` the stack's input arrives in bfloat16, and
the stack rounds where JAX's does (models/precision.py): the mask, block 0's
first LayerNorm output (and, in the softmax branch, block 0's attention
output and its LayerNorm); block 0's residual adds the rounded input in
float32, and every block after it runs in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mygenerativerecommenders_tpu_torch import not_ported
from mygenerativerecommenders_tpu_torch.models import precision
from mygenerativerecommenders_tpu_torch.ops.hstu_attention import (
    hstu_attention_reference,
    relative_position_bias,
    relative_position_index,
    relative_time_index,
)
from mygenerativerecommenders_tpu_torch.ops.kernels.hstu_attention import (
    hstu_attention_fused,
)
from mygenerativerecommenders_tpu_torch.parallel.ring_attention import ring_hstu_attention

TIMESTAMPS_KEY = "timestamps"
SEGMENT_IDS_KEY = "seg_ids"


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] as an embedding lookup: the same values, and a backward
    that sums each slot's gradient by sort and segments. Indexing's backward
    serialises the duplicates of a slot, and a [B, N, N] index into a bias
    table holds ~10^5 of each (`tools/bias_lookup_backward.py` times both)."""
    return F.embedding(idx, table[:, None])[..., 0]


def _normal(shape, std: float, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


class RelativeBucketedTimeAndPositionBasedBias(nn.Module):
    """The per-block bias tables: pos_w [2L-1] and, for time_position, ts_w [nb+1]."""

    def __init__(self, max_len: int, num_buckets: int, with_time: bool, generator=None):
        super().__init__()
        self._pos_w = _normal((2 * max_len - 1,), 0.02, generator)
        self._ts_w = _normal((num_buckets + 1,), 0.02, generator) if with_time else None


class HSTUBlock(nn.Module):
    """LN -> uvqk -> silu -> split(u, v, q, k) -> pointwise attention with the
    relative bias -> u * LN(attn) -> output linear -> + residual."""

    def __init__(
        self,
        embedding_dim: int,
        linear_dim: int,
        attention_dim: int,
        num_heads: int,
        max_attn_len: int,  # static N: the 1/N normalizer and the bias-table center
        normalization: str = "rel_bias",
        linear_activation: str = "silu",
        enable_relative_attention_bias: bool = True,
        relative_bias_type: str = "time_position",
        num_time_buckets: int = 128,
        concat_ua: bool = False,
        eps: float = 1e-6,
        generator: Optional[torch.Generator] = None,
        dropout_rate: float = 0.0,
        sp_shards: int = 1,
        sp_zigzag: bool = False,
    ):
        super().__init__()
        if normalization not in ("rel_bias", "hstu_rel_bias", "softmax_rel_bias"):
            raise ValueError(f"Unknown normalization {normalization}")
        if normalization == "softmax_rel_bias" and sp_shards > 1:
            # JAX's softmax branch is dense: it ignores sp_shards without a word
            raise ValueError(
                f"encoder.sp_shards={sp_shards} with encoder.normalization=softmax_rel_bias: "
                "the reference's softmax attention has no ring and ignores sp_shards; set "
                "encoder.sp_shards=1"
            )
        self.softmax = normalization == "softmax_rel_bias"
        if linear_activation not in ("silu", "none"):
            raise ValueError(f"Unknown linear_activation {linear_activation}")
        self.num_heads, self.linear_dim, self.attention_dim = num_heads, linear_dim, attention_dim
        self.max_attn_len = max_attn_len
        self.sp_shards, self.sp_zigzag = sp_shards, sp_zigzag
        self.linear_activation = linear_activation
        self.num_time_buckets = num_time_buckets
        self.concat_ua = concat_ua
        self.eps = eps
        self._dropout = nn.Dropout(dropout_rate)
        h, dv, dqk = num_heads, linear_dim, attention_dim
        self._uvqk = _normal((embedding_dim, 2 * dv * h + 2 * dqk * h), 0.02, generator)
        self._rel_attn_bias = None
        if enable_relative_attention_bias:
            self._rel_attn_bias = RelativeBucketedTimeAndPositionBasedBias(
                max_attn_len, num_time_buckets,
                relative_bias_type == "time_position", generator,
            )
        self._o = nn.Linear(dv * h * (3 if concat_ua else 1), embedding_dim)
        with torch.no_grad():
            nn.init.xavier_uniform_(self._o.weight, generator=generator)
            self._o.bias.zero_()

    def forward(
        self,
        x: torch.Tensor,  # [B, N, D], zero at invalid rows
        timestamps: Optional[torch.Tensor],  # [B, N]
        lengths: Optional[torch.Tensor] = None,  # [B] valid row counts
        seg_pos: Optional[torch.Tensor] = None,  # [B, N] within-segment positions (packed)
        kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
    ) -> torch.Tensor:
        """-> the block's output [B, N, D]; with a `kv` list, its k [B, N, H*Dqk]
        and v [B, N, H*Dv] are appended to it (the decode cache's rows)."""
        h, dv, dqk = self.num_heads, self.linear_dim, self.attention_dim
        b, n, d = x.shape
        low = x.dtype  # bfloat16 in block 0 at compute_dtype=bfloat16
        if low == torch.float32:
            normed = F.layer_norm(x, (d,), eps=self.eps)
        else:
            # x's three uses, the LayerNorm's statistics and normalisation and
            # the residual, each promoted to float32 as in JAX
            stats, norm, x = precision.uses(x, 3)
            normed = precision.layer_norm(stats, norm, self.eps, low).float()
        proj = normed @ self._uvqk
        if self.linear_activation == "silu":
            proj = F.silu(proj)
        u, v, q, k = torch.split(proj, [dv * h, dv * h, dqk * h, dqk * h], dim=-1)
        if kv is not None:
            kv.append((k, v))
        # [B, N, H, d] views of the column slices: no copy
        qh, kh, vh = q.unflatten(-1, (h, dqk)), k.unflatten(-1, (h, dqk)), v.unflatten(-1, (h, dv))

        pos_w = ts_w = None
        if self._rel_attn_bias is not None:
            pos_w = self._rel_attn_bias._pos_w
            if timestamps is not None:
                ts_w = self._rel_attn_bias._ts_w
        if self.softmax:
            if seg_pos is not None:
                raise ValueError(
                    "packed rows (seg_ids) are not supported with "
                    "normalization='softmax_rel_bias'"
                )
            # JAX casts the branch's output to the block input's dtype
            attn_out = self._softmax_attention(q, k, v, timestamps, pos_w, ts_w).to(low)
        elif self.sp_shards > 1:
            if ts_w is None:
                raise ValueError(
                    "sp_shards > 1 requires relative_bias_type='time_position' (ring "
                    "attention generates the time bias per chunk)"
                )
            if seg_pos is not None:
                raise ValueError(
                    "packed rows are not supported with ring attention (sp_shards > 1) "
                    "— packing already removes the padding the ring would shard"
                )
            attn_out = self._ring_attention(qh, kh, vh, timestamps, pos_w, ts_w)
        elif ts_w is not None:
            attn_out = hstu_attention_fused(
                qh, kh, vh, timestamps, pos_w, ts_w,
                max_len=self.max_attn_len, num_buckets=self.num_time_buckets,
                lengths=lengths, seg_positions=seg_pos,
            )
        else:
            bias = None
            if pos_w is not None:
                bias = relative_position_bias(pos_w, n, self.max_attn_len)[None]
            # segments are contiguous, so a segment's start (row - position)
            # is an id of its own
            seg_equiv = None
            if seg_pos is not None:
                seg_equiv = torch.arange(n, device=x.device)[None, :] - seg_pos
            attn_out = hstu_attention_reference(
                qh, kh, vh, bias, max_len=self.max_attn_len, causal=True, seg_ids=seg_equiv
            )
        attn_out = attn_out.reshape(b, n, h * dv)
        if attn_out.dtype == torch.float32:
            a = F.layer_norm(attn_out, (h * dv,), eps=self.eps)
        else:
            a = precision.layer_norm(*precision.uses(attn_out, 2), self.eps, attn_out.dtype).float()
        o_input = torch.cat([u, a, u * a], dim=-1) if self.concat_ua else u * a
        return self._o(self._dropout(o_input)) + x

    def _softmax_attention(self, q, k, v, timestamps, pos_w, ts_w) -> torch.Tensor:
        """The softmax branch on q, k [B, N, H*dqk] and v [B, N, H*dv]
        (JAX :182-200): softmax((q k^T + bias) / sqrt(dqk)) over all keys,
        the non-causal weights zeroed after it, times v."""
        n = q.shape[1]
        logits = torch.einsum("bnd,bmd->bnm", q.float(), k.float())
        if pos_w is not None:
            bias = _lookup(pos_w, relative_position_index(n, self.max_attn_len, q.device))[None]
            if ts_w is not None:
                bias = bias + _lookup(ts_w, relative_time_index(timestamps,
                                                                self.num_time_buckets))
            logits = logits + bias
        probs = torch.softmax(logits / self.attention_dim**0.5, dim=-1)
        causal = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        probs = torch.where(causal[None], probs, 0.0)
        return torch.einsum("bnm,bmd->bnd", probs, v.to(probs.dtype)).to(v.dtype)

    def _ring_attention(self, qh, kh, vh, timestamps, pos_w, ts_w) -> torch.Tensor:
        """Sequence-parallel attention on one device (exact: HSTU attention is
        a plain sum over keys). N is padded up to a multiple of sp_shards (of
        2 * sp_shards in the zigzag layout); padded keys contribute nothing
        (their v rows are zero) and padded query rows are sliced off. The
        timestamps pad by repeating the last column, so the last real row's
        next-item timestamp is the dense path's."""
        n = qh.shape[1]
        chunks = 2 * self.sp_shards if self.sp_zigzag else self.sp_shards
        pad = -n % chunks
        if pad:
            qh, kh, vh = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (qh, kh, vh))
            timestamps = torch.cat(
                [timestamps, timestamps[:, -1:].expand(-1, pad)], dim=1
            )
        out = ring_hstu_attention(
            qh, kh, vh, timestamps, pos_w, ts_w,
            num_shards=self.sp_shards, zigzag=self.sp_zigzag,
            # the 1/n normaliser and the table centre use the UNPADDED n
            # (= max_attn_len in every real configuration)
            max_len=self.max_attn_len, num_buckets=self.num_time_buckets,
        )
        return out[:, :n]


class HSTU(nn.Module):
    """Stack of HSTU blocks over a dense masked batch; output zero at invalid rows."""

    def __init__(
        self,
        max_sequence_len: int,
        max_output_len: int,
        embedding_dim: int,
        num_blocks: int,
        num_heads: int,
        linear_dim: int,
        attention_dim: int,
        normalization: str = "rel_bias",
        linear_activation: str = "silu",
        enable_relative_attention_bias: bool = True,
        relative_bias_type: str = "time_position",
        num_time_buckets: int = 128,
        concat_ua: bool = False,
        sp_shards: int = 1,
        tp_shards: int = 1,
        remat: bool = False,
        sp_zigzag: bool = False,
        generator: Optional[torch.Generator] = None,
        linear_dropout_rate: float = 0.0,
    ):
        super().__init__()
        if tp_shards > 1:
            raise not_ported("encoder.tp_shards > 1", "Distributed")
        self.remat = remat
        n_total = max_sequence_len + max_output_len
        self._attention_layers = nn.ModuleList(
            HSTUBlock(
                embedding_dim=embedding_dim,
                linear_dim=linear_dim,
                attention_dim=attention_dim,
                num_heads=num_heads,
                max_attn_len=n_total,
                normalization=normalization,
                linear_activation=linear_activation,
                enable_relative_attention_bias=enable_relative_attention_bias,
                relative_bias_type=relative_bias_type,
                num_time_buckets=num_time_buckets,
                concat_ua=concat_ua,
                generator=generator,
                dropout_rate=linear_dropout_rate,
                sp_shards=sp_shards,
                sp_zigzag=sp_zigzag,
            )
            for _ in range(num_blocks)
        )

    def forward(
        self,
        past_lengths: torch.Tensor,
        user_embeddings: torch.Tensor,  # [B, N, D]
        valid_mask: torch.Tensor,  # [B, N, 1]
        past_payloads: Dict[str, torch.Tensor],
        kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
    ) -> torch.Tensor:
        """-> [B, N, D], zero at invalid rows; a `kv` list collects each
        block's (k, v) in block order (`HSTUBlock.forward`)."""
        del past_lengths
        x = user_embeddings
        timestamps = past_payloads.get(TIMESTAMPS_KEY)
        # a seg_ids payload marks packed rows: the positions then drive the
        # block-diagonal mask and the kernels' key-tile skip
        seg_pos = (
            past_payloads.get("positions")
            if past_payloads.get(SEGMENT_IDS_KEY) is not None else None
        )
        mask = valid_mask.to(x.dtype)
        # the kernel's per-row length: last valid position + 1, robust to any
        # mask pattern (preprocessors may change the row count)
        n = x.shape[1]
        pos1 = torch.arange(1, n + 1, dtype=torch.int32, device=x.device)
        kernel_lengths = (valid_mask[:, :, 0].to(torch.int32) * pos1).amax(dim=1)
        remat = self.remat and kv is None and torch.is_grad_enabled()
        for block in self._attention_layers:
            x = x * mask  # padded rows stay exactly zero
            if remat:
                # preserve_rng_state: the recompute draws the forward's mask
                x = torch.utils.checkpoint.checkpoint(
                    block, x, timestamps, kernel_lengths, seg_pos,
                    use_reentrant=False, preserve_rng_state=True,
                )
            else:
                x = block(x, timestamps, kernel_lengths, seg_pos, kv)
        return x * mask
