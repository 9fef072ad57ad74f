"""Int8-quantized MIPS top-k with exact re-scoring (`index.quantize=int8`).

Port of mygenerativerecommenders_tpu/ops/quantized_topk.py:33-125: the
catalog is held as symmetric per-row int8 (absmax / 127 scales), every query
row is quantized the same way, the [B, X] pre-ranking scores are the int8
products times both scales, and the `rescore_over_fetch * k` best candidates
are scored again against the exact float32 rows, so the returned order and
scores are exact wherever the true top-k survives the pre-ranking.

The int8 x int8 product is one float32 matmul of the int8 values. It is
exact: every product is at most 127^2 and every partial sum an integer below
D * 127^2 = 1,032,256 at D = 64 (exact to D = 1,040), under the 2^24 where
float32 stops holding integers, in any summation order. So the CPU and the
card give the same bits, and the one code path serves both (`torch._int_mm`
would need X a multiple of 8 and more than 16 query rows). The JAX package
computes it with `lax.dot_general` outside any Pallas kernel; this is the
library product in its place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mygenerativerecommenders_tpu_torch.ops.topk import NEG_INF


class QuantizedCatalog(NamedTuple):
    q: torch.Tensor  # [X, D] int8 rows
    scales: torch.Tensor  # [X] float32 dequantization scales
    exact: Optional[torch.Tensor]  # [X, D] float32 rows for re-scoring (or None)


def quantize_rows(emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: q = round(e / s), s = absmax / 127 (1 for a
    zero row). `torch.round` rounds half to even, as `jnp.round` does."""
    absmax = emb.abs().amax(dim=-1)
    # a tensor divisor (a fill, which a CUDA graph can capture): PyTorch's
    # CUDA division by a host scalar multiplies by its reciprocal, which
    # rounds twice and parts from the CPU's (and JAX's) scales in the last bit
    scales = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                         torch.ones_like(absmax))
    q = torch.clamp(torch.round(emb / scales[..., None]), -127, 127).to(torch.int8)
    return q, scales.to(torch.float32)


def quantize_catalog(emb: torch.Tensor, keep_exact: bool = True) -> QuantizedCatalog:
    q, scales = quantize_rows(emb)
    return QuantizedCatalog(q=q, scales=scales, exact=emb if keep_exact else None)


def _invalid_mask(
    item_ids: torch.Tensor,  # [X] catalog ids (> 0)
    invalid_ids: torch.Tensor,  # [B, N0] ids to exclude (0 = none)
    max_item_id: int,
) -> torch.Tensor:
    """[B, X] bool, True where the catalog item is in the row's invalid set:
    scattered into id space, then gathered at the catalog ids (slot 0 takes
    the padding and is never read back)."""
    b = invalid_ids.shape[0]
    space = torch.zeros((b, max_item_id + 1), dtype=torch.bool, device=invalid_ids.device)
    space.scatter_(1, torch.clamp(invalid_ids.long(), 0, max_item_id), True)
    space[:, 0] = False
    return space[:, item_ids.long()]


def mips_top_k_int8(
    query_embeddings: torch.Tensor,  # [B, D] float32
    catalog: QuantizedCatalog,
    item_ids: torch.Tensor,  # [X] catalog ids, all > 0
    k: int,
    invalid_ids: Optional[torch.Tensor] = None,  # [B, N0]
    max_item_id: Optional[int] = None,
    over_fetch: int = 4,  # re-score k' = min(X, over_fetch * k) rows
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (top_k_ids [B, k], top_k_scores [B, k]), sorted descending. With
    `catalog.exact` the scores are the exact inner products of the
    re-scored candidates, without it the dequantized int8 ones."""
    x = item_ids.shape[0]
    qq, qs = quantize_rows(query_embeddings)
    si = qq.to(torch.float32) @ catalog.q.to(torch.float32).T  # exact: see the module's notes
    scores = si * qs[:, None] * catalog.scales[None, :]
    if invalid_ids is not None:
        if max_item_id is None:
            raise ValueError(
                "mips_top_k_int8 requires max_item_id when invalid_ids is passed "
                "(it sizes the invalid-id scatter mask)"
            )
        scores = torch.where(_invalid_mask(item_ids, invalid_ids, max_item_id), NEG_INF, scores)

    if catalog.exact is None:
        top_scores, top_idx = torch.topk(scores, k, dim=1)
        return item_ids[top_idx], top_scores

    kp = min(x, max(k, over_fetch * k))
    _, cand_idx = torch.topk(scores, kp, dim=1)  # [B, k']
    cand_rows = catalog.exact[cand_idx]  # [B, k', D]
    exact = torch.einsum("bd,bkd->bk", query_embeddings.float(), cand_rows.float())
    if invalid_ids is not None:
        # candidates that were NEG_INF in the quantized scan (only when k'
        # exceeds the valid count) are masked again, so that they sort last
        pre = torch.gather(scores, 1, cand_idx)
        exact = torch.where(pre <= NEG_INF / 2, NEG_INF, exact)
    top_scores, within = torch.topk(exact, k, dim=1)  # [B, k] into k'
    top_idx = torch.gather(cand_idx, 1, within)
    return item_ids[top_idx], top_scores
