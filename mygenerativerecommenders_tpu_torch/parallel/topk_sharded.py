"""Sharded brute-force MIPS top-k: a local top-k per candidate shard, then a
merge, over a shard group: the R shards run in turn on one device, or one a
rank of the model group.

Port of mygenerativerecommenders_tpu/parallel/topk_sharded.py
(`sharded_mips_top_k`, `sharded_mips_top_k_int8`). The candidate rows [X, D]
and their ids [X] are row-sharded over a shard group (X a multiple of R, pad
rows carrying id 0 and never winning). Each shard scores the queries against
its X/R rows and keeps its k' = k + n_invalid best (the int8 form pre-ranks
`max(k', over_fetch * k)` on its own int8 rows and re-scores them against
its own exact rows); one all_gather of the R * k' winners, a top-k of k'
over them, each row's invalid ids masked on that small merged list, and a
final top-k of k. Exact whenever k valid candidates exist.

The candidate arguments hold the group's `local` shards' rows
(parallel/embedding_sharding.py): on one device all of them, [X, D], the
shard scores one [R, B, X/R] product, every shard's selection one `topk`
along its last axis, the all_gather a reshape; over a process group the
rank's own X/R rows (JAX's `candidates_sharded`, train/task_retrieval.py
:439-470), its top-k, and one all_gather of the (score, id) pairs over the
model group. The queries are the same on every rank of the group. `approx_recall > 0` takes the exact
selection, as `ops/topk.py` does (JAX's `approx_max_k` is exact off the TPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mygenerativerecommenders_tpu_torch.ops.quantized_topk import quantize_rows
from mygenerativerecommenders_tpu_torch.ops.topk import NEG_INF
from mygenerativerecommenders_tpu_torch.parallel.embedding_sharding import OneDeviceShards


def _merge(
    group: OneDeviceShards, scores: torch.Tensor, ids: torch.Tensor, k: int, k_fetch: int,
    invalid_ids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The held shards' winners scores, ids [local, B, k'] -> (ids, scores) [B, k]:
    the all_gather, the merged top-k', the invalid-id mask, the final top-k."""
    all_s = group.all_gather(scores, dim=1)  # [B, R * k']
    all_ids = group.all_gather(ids, dim=1)
    merged_s, merged_idx = torch.topk(all_s, min(k_fetch, all_s.shape[1]), dim=1)
    merged_ids = torch.gather(all_ids, 1, merged_idx)
    is_invalid = (merged_ids[:, :, None] == invalid_ids[:, None, :].to(merged_ids.dtype)).any(-1)
    merged_s = torch.where(is_invalid, NEG_INF, merged_s)
    final_s, final_idx = torch.topk(merged_s, k, dim=1)
    return torch.gather(merged_ids, 1, final_idx), final_s


def _invalid(query: torch.Tensor, invalid_ids: Optional[torch.Tensor]) -> torch.Tensor:
    # a [B, 1] zero column filters nothing (id 0 is never a catalog id)
    if invalid_ids is None:
        return torch.zeros((query.shape[0], 1), dtype=torch.long, device=query.device)
    return invalid_ids


def sharded_mips_top_k(
    group: OneDeviceShards,
    query_embeddings: torch.Tensor,  # [B, D]
    item_embeddings: torch.Tensor,  # [X, D], R row shards of X / R
    item_ids: torch.Tensor,  # [X], sharded alike; pad rows 0
    k: int,
    invalid_ids: Optional[torch.Tensor] = None,  # [B, N0] ids to exclude (0 = none)
    approx_recall: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (top_k_ids [B, k], top_k_scores [B, k]), sorted descending."""
    if approx_recall > 1.0:
        raise ValueError(f"approx_recall={approx_recall}: a recall target is at most 1")
    held = group.local
    k_fetch = k + (int(invalid_ids.shape[1]) if invalid_ids is not None else 0)
    invalid = _invalid(query_embeddings, invalid_ids)
    x, d = item_embeddings.shape
    items = item_embeddings.float().view(held, x // held, d)
    ids = item_ids.view(held, x // held)
    scores = torch.einsum("bd,rxd->rbx", query_embeddings.float(), items)
    # padding rows (id 0) never enter the merge
    scores = torch.where(ids[:, None, :] == 0, NEG_INF, scores)
    s, idx = torch.topk(scores, min(k_fetch, x // held), dim=2)  # [local, B, k']
    top_ids = torch.gather(ids[:, None, :].expand(-1, idx.shape[1], -1), 2, idx)
    return _merge(group, s, top_ids, k, k_fetch, invalid)


def sharded_mips_top_k_int8(
    group: OneDeviceShards,
    query_embeddings: torch.Tensor,  # [B, D] float32
    catalog_q: torch.Tensor,  # [X, D] int8, R row shards
    catalog_scales: torch.Tensor,  # [X] float32, sharded alike
    catalog_exact: torch.Tensor,  # [X, D] float32 exact rows, sharded alike
    item_ids: torch.Tensor,  # [X], sharded alike
    k: int,
    invalid_ids: Optional[torch.Tensor] = None,
    over_fetch: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 pre-ranked sharded top-k: each shard pre-ranks its own int8 rows,
    re-scores its winners against its own exact rows, and the exact winners
    merge as in `sharded_mips_top_k`. -> (ids [B, k], scores [B, k])."""
    held = group.local
    n_inv = int(invalid_ids.shape[1]) if invalid_ids is not None else 0
    k_fetch = k + n_inv
    kp = max(k_fetch, over_fetch * k)
    invalid = _invalid(query_embeddings, invalid_ids)
    x, d = catalog_q.shape
    xs = x // held
    qq, qs = quantize_rows(query_embeddings)
    # the int8 product as one float32 matmul of the int8 values: exact
    # (ops/quantized_topk.py), so every shard's sums are JAX's int32 ones
    si = torch.einsum("bd,rxd->rbx", qq.float(), catalog_q.float().view(held, xs, d))
    approx = si * qs[None, :, None] * catalog_scales.view(held, 1, xs)
    ids = item_ids.view(held, xs)
    approx = torch.where(ids[:, None, :] == 0, NEG_INF, approx)
    _, idx = torch.topk(approx, min(kp, xs), dim=2)  # [R, B, kp]
    b = idx.shape[1]
    cand_ids = torch.gather(ids[:, None, :].expand(-1, b, -1), 2, idx)
    shard = torch.arange(held, device=idx.device)[:, None, None]
    cand_rows = catalog_exact.float().view(held, xs, d)[shard, idx]  # [local, B, kp, D]
    exact = torch.einsum("bd,rbkd->rbk", query_embeddings.float(), cand_rows)
    exact = torch.where(cand_ids == 0, NEG_INF, exact)
    return _merge(group, exact, cand_ids, k, k_fetch, invalid)
