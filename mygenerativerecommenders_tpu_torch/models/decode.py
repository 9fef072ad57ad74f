"""Incremental decoding for HSTU: the KV-cache prefill, the one-token decode
step, and greedy, sampled and beam generation over them.

Port of mygenerativerecommenders_tpu/models/decode.py:40-359. The cache is
static-shape: per block, the k and v projections of every position of the
[B, N] row, and each decode step appends one position:

  prefill:  one forward of the model (on the card its attention is the fused
            kernel); every block's (k, v) comes out of that same forward
            (`GenerativeRecommender.forward(seq, kv=...)`), where the JAX
            prefill rebuilds them in a second, dense O(N^2) pass. Padded rows
            are exactly zero in both (x * mask, LayerNorm of 0, silu(0) = 0,
            no bias on uvqk).
  step:     for the token at position p (= the row's length): per block
            LN -> uvqk row -> u, v, q, k; the cache's row p takes (k, v); one
            attention row over the keys j <= p with the relative bias
            pos_w[j - p + N - 1] + ts_w[bucket(new_ts - ts[j])]; then
            u * LN(av) @ o + b + x; the postprocessor on the new row.
            O(N * D) a step. Torch ops, as JAX's step is jnp outside any
            Pallas kernel.

The JAX step hard-codes part of the block: silu projections, u * LN(av)
without concat_ua, the time_position bias with 128 time buckets, and the
learnable positional preprocessor (emb * sqrt(D) + pos_emb). A model with
another value of one of those knobs would decode a different model from
its forward, so `check_decodable` raises for it (ROADMAP.md, queue 3).

Generation returns what JAX's returns. It skips the decode step after the
last pick, whose output JAX computes and discards. `sample_generate` takes
its Gumbel noise as an input ([steps, B, X]): `jax.random.categorical` is
argmax(logits + gumbel), so JAX's own draws give JAX's ids, and the serving
engine draws the noise outside its CUDA graph. Temperature, top-k and top-p
may be 0-d tensors: one graph serves every value.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F

from mygenerativerecommenders_tpu_torch.configs import ModelConfig
from mygenerativerecommenders_tpu_torch.models.model import GenerativeRecommender
from mygenerativerecommenders_tpu_torch.ops.hstu_attention import bucketize_timedelta
from mygenerativerecommenders_tpu_torch.ops.sequence import (
    get_current_embeddings,
    scatter_at_lengths,
)
from mygenerativerecommenders_tpu_torch.ops.topk import masked_mips_scores, mips_top_k
from mygenerativerecommenders_tpu_torch.utils.features import SequenceBatch

NUM_TIME_BUCKETS = 128  # the JAX step's bucketize_timedelta(delta, 128)
Scalar = Union[float, int, torch.Tensor]


class DecodeCache(NamedTuple):
    k: torch.Tensor  # [num_blocks, B, N, H*Dqk]
    v: torch.Tensor  # [num_blocks, B, N, H*Dv]
    lengths: torch.Tensor  # [B] the next token's position
    timestamps: torch.Tensor  # [B, N]


def check_decodable(m: ModelConfig) -> None:
    """Raise a ValueError naming the first knob whose value the decode step
    does not compute (it would generate from another model than the forward)."""
    enc = m.encoder
    knobs = [
        ("model.encoder.kind", enc.kind, "hstu"),
        ("model.preprocessor.kind", m.preprocessor.kind, "learnable_positional"),
        ("model.encoder.concat_ua", enc.concat_ua, False),
        ("model.encoder.linear_activation", enc.linear_activation, "silu"),
        ("model.encoder.enable_relative_attention_bias", enc.enable_relative_attention_bias, True),
        ("model.encoder.relative_bias_type", enc.relative_bias_type, "time_position"),
        ("model.encoder.num_time_buckets", enc.num_time_buckets, NUM_TIME_BUCKETS),
    ]
    if enc.normalization not in ("rel_bias", "hstu_rel_bias"):
        knobs.insert(1, ("model.encoder.normalization", enc.normalization, "rel_bias"))
    for name, value, decoded in knobs:
        if value != decoded:
            raise ValueError(
                f"generation decodes {name}={decoded!r} only (as the JAX package's "
                f"models/decode.py), got {value!r}"
            )


def _blocks(model: GenerativeRecommender):
    return model.sequence_encoder["_hstu"]._attention_layers


def prefill(
    model: GenerativeRecommender, seq: SequenceBatch
) -> Tuple[torch.Tensor, DecodeCache]:
    """One forward + the cache. -> (encoded [B, N, D'], cache)."""
    check_decodable(model.cfg)
    kv = []
    encoded, _ = model(seq, kv=kv)
    cache = DecodeCache(
        k=torch.stack([k for k, _ in kv]), v=torch.stack([v for _, v in kv]),
        lengths=seq.past_lengths, timestamps=seq.past_payloads["timestamps"],
    )
    return encoded, cache


def decode_step(
    model: GenerativeRecommender,
    cache: DecodeCache,
    new_ids: torch.Tensor,  # [B] item id appended at position `lengths`
    new_timestamps: torch.Tensor,  # [B]
) -> Tuple[torch.Tensor, DecodeCache]:
    """Append one token. -> (its postprocessed embedding [B, D], cache')."""
    _, b, n, _ = cache.k.shape
    p = cache.lengths.long()
    new_timestamps = new_timestamps.to(cache.timestamps.dtype)
    ts = scatter_at_lengths(cache.timestamps, cache.lengths, new_timestamps)
    d = model.cfg.item_embedding_dim
    pos_emb = model.preprocessor._pos_emb.weight
    x = model.item_embeddings(new_ids) * (d**0.5) + pos_emb[p.clamp(0, n - 1)]

    j = torch.arange(n, device=p.device)[None, :]
    at_p = (j == p[:, None])[:, :, None]  # [B, N, 1] the cache row written
    key_mask = (j <= p[:, None])[:, None, :]  # [B, 1, N] live keys
    # the new row's "next" timestamp is its own (JAX :142-144)
    buckets = bucketize_timedelta(new_timestamps[:, None] - ts, NUM_TIME_BUCKETS).long()
    rel = (j - p[:, None] + (n - 1)).clamp(0, 2 * n - 2)  # [B, N] pos_w slots
    ks, vs = [], []
    for i, block in enumerate(_blocks(model)):
        h, dv, dqk = block.num_heads, block.linear_dim, block.attention_dim
        if block.max_attn_len != n:
            raise ValueError(f"cache width {n} != the block's max_attn_len {block.max_attn_len}")
        proj = F.silu(F.layer_norm(x, (x.shape[-1],), eps=block.eps) @ block._uvqk)
        u, v_new, q_new, k_new = torch.split(proj, [dv * h, dv * h, dqk * h, dqk * h], dim=-1)
        k_cache = torch.where(at_p, k_new[:, None, :], cache.k[i])
        v_cache = torch.where(at_p, v_new[:, None, :], cache.v[i])
        ks.append(k_cache)
        vs.append(v_cache)
        bias = block._rel_attn_bias._pos_w[rel] + block._rel_attn_bias._ts_w[buckets]
        logits = torch.einsum(
            "bhd,bnhd->bhn", q_new.reshape(b, h, dqk), k_cache.reshape(b, n, h, dqk)
        ) + bias[:, None, :]
        attn = torch.where(key_mask, F.silu(logits) / n, 0.0)
        av = torch.einsum("bhn,bnhd->bhd", attn, v_cache.reshape(b, n, h, dv)).reshape(b, h * dv)
        x = block._o(u * F.layer_norm(av, (h * dv,), eps=block.eps)) + x
    out = model.postprocessor(x)
    return out, DecodeCache(torch.stack(ks), torch.stack(vs), cache.lengths + 1, ts)


def last_timestamps(cache: DecodeCache) -> torch.Tensor:
    """[B] each row's last cached timestamp: the next token's (JAX :214-217)."""
    idx = (cache.lengths.long() - 1).clamp(min=0)[:, None]
    return torch.gather(cache.timestamps, 1, idx)[:, 0]


def greedy_generate(
    model: GenerativeRecommender,
    seq: SequenceBatch,
    candidates: torch.Tensor,  # [X, D] normalized catalog embeddings
    candidate_ids: torch.Tensor,  # [X]
    steps: int,
    max_item_id: int,
) -> torch.Tensor:
    """Autoregressive greedy next-item generation. -> [B, steps] ids."""
    encoded, cache = prefill(model, seq)
    query = get_current_embeddings(cache.lengths, encoded)
    invalid = seq.past_ids
    generated = []
    for step in range(steps):
        top_ids, _ = mips_top_k(
            query, candidates, candidate_ids, k=1, invalid_ids=invalid, max_item_id=max_item_id
        )
        next_ids = top_ids[:, 0]
        generated.append(next_ids)
        if step + 1 < steps:
            invalid = scatter_at_lengths(invalid, cache.lengths, next_ids.to(invalid.dtype))
            query, cache = decode_step(model, cache, next_ids, last_timestamps(cache))
    return torch.stack(generated, dim=1)


def truncate_logits(logits: torch.Tensor, top_k: Scalar, top_p: Scalar) -> torch.Tensor:
    """JAX's top-k then top-p truncation (decode.py:252-266), masked to -inf.

    top_k applies where 0 < top_k < X, top_p where 0 < top_p < 1, as the
    JAX branches do; as tensor conditions here, so both may be 0-d tensors.
    One descending sort serves both: the sorted row of the top-k-masked
    logits is the sorted row with the same mask."""
    x = logits.shape[-1]
    top_k = torch.as_tensor(top_k, device=logits.device)
    top_p = torch.as_tensor(top_p, dtype=logits.dtype, device=logits.device)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    kth = sorted_logits[:, (top_k.clamp(1, x) - 1).long().reshape(1)]  # [B, 1]
    apply_k = (top_k > 0) & (top_k < x)
    logits = torch.where(apply_k & (logits < kth), -math.inf, logits)
    sorted_logits = torch.where(apply_k & (sorted_logits < kth), -math.inf, sorted_logits)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # the smallest prefix with mass >= top_p stays (the shifted keep mask)
    keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool), cum[:, :-1] < top_p], dim=-1)
    cutoff = torch.where(keep, sorted_logits, math.inf).amin(dim=-1, keepdim=True)
    apply_p = (top_p > 0) & (top_p < 1)
    return torch.where(apply_p & (logits < cutoff), -math.inf, logits)


def sample_generate(
    model: GenerativeRecommender,
    seq: SequenceBatch,
    candidates: torch.Tensor,  # [X, D] normalized catalog embeddings
    candidate_ids: torch.Tensor,  # [X]
    steps: int,
    max_item_id: int,
    gumbel: torch.Tensor,  # [steps, B, X] standard Gumbel noise, one draw a step
    temperature: Scalar = 1.0,
    top_k: Scalar = 0,
    top_p: Scalar = 0.0,
) -> torch.Tensor:
    """Stochastic autoregressive generation. -> [B, steps] ids.

    The masked MIPS scores are the logits: divided by max(temperature, 1e-6),
    truncated to the top k and the nucleus top_p, then a categorical draw
    argmax(logits + gumbel[step])."""
    encoded, cache = prefill(model, seq)
    query = get_current_embeddings(cache.lengths, encoded)
    invalid = seq.past_ids
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=query.device)
    generated = []
    for step in range(steps):
        scores = masked_mips_scores(
            query, candidates, candidate_ids, invalid_ids=invalid, max_item_id=max_item_id
        )
        logits = truncate_logits(scores / temperature.clamp(min=1e-6), top_k, top_p)
        next_ids = candidate_ids[torch.argmax(logits + gumbel[step], dim=-1)]
        generated.append(next_ids)
        if step + 1 < steps:
            invalid = scatter_at_lengths(invalid, cache.lengths, next_ids.to(invalid.dtype))
            query, cache = decode_step(model, cache, next_ids, last_timestamps(cache))
    return torch.stack(generated, dim=1)


def beam_generate(
    model: GenerativeRecommender,
    seq: SequenceBatch,
    candidates: torch.Tensor,  # [X, D] normalized catalog embeddings
    candidate_ids: torch.Tensor,  # [X]
    steps: int,
    max_item_id: int,
    num_beams: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over item sequences. -> (ids [B, steps], score [B]).

    A beam's score is the sum of its picks' log-softmax over the filtered
    catalog; the best beam is index 0 (top-k sorts descending)."""
    b, w, x = seq.past_lengths.shape[0], num_beams, candidates.shape[0]
    encoded, cache = prefill(model, seq)
    query = get_current_embeddings(cache.lengths, encoded)

    # step 0: the single context expands into W beams
    scores0 = masked_mips_scores(
        query, candidates, candidate_ids, invalid_ids=seq.past_ids, max_item_id=max_item_id
    )
    beam_logp, first_idx = torch.topk(torch.log_softmax(scores0, dim=-1), w, dim=-1)  # [B, W]
    flat_next = candidate_ids[first_idx].reshape(-1)  # [B*W]
    cache = DecodeCache(*(t.repeat_interleave(w, dim=dim) for t, dim in zip(cache, (1, 1, 0, 0))))
    invalid = seq.past_ids.repeat_interleave(w, dim=0)  # [B*W, N]
    generated = flat_next[:, None]
    rows = torch.arange(b, device=query.device)[:, None] * w  # [B, 1] each row's first beam
    for step in range(1, steps):
        invalid = scatter_at_lengths(invalid, cache.lengths, flat_next.to(invalid.dtype))
        query, cache = decode_step(model, cache, flat_next, last_timestamps(cache))
        scores = masked_mips_scores(
            query, candidates, candidate_ids, invalid_ids=invalid, max_item_id=max_item_id
        )
        total = beam_logp.reshape(-1, 1) + torch.log_softmax(scores, dim=-1)  # [B*W, X]
        beam_logp, flat_idx = torch.topk(total.reshape(b, w * x), w, dim=-1)  # [B, W]
        # reorder every per-beam state by the surviving beams' parents
        sel = (rows + torch.div(flat_idx, x, rounding_mode="floor")).reshape(-1)
        cache = DecodeCache(
            cache.k[:, sel], cache.v[:, sel], cache.lengths[sel], cache.timestamps[sel]
        )
        invalid, generated = invalid[sel], generated[sel]
        flat_next = candidate_ids[flat_idx % x].reshape(-1)
        generated = torch.cat([generated, flat_next[:, None]], dim=1)
    return generated.reshape(b, w, -1)[:, 0, :], beam_logp[:, 0]
