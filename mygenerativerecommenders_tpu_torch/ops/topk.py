"""Brute-force MIPS top-k with per-row invalid-id filtering.

Port of mygenerativerecommenders_tpu/ops/topk.py:25-90. Each row's invalid
ids are masked to NEG_INF in the [B, X] score matrix, then one exact
`torch.topk`, the counterpart of XLA's `lax.top_k`. The two may order
near-equal scores differently; `topk_agree` compares two results with that
in mind.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch import not_ported

NEG_INF = -1e30


def masked_mips_scores(
    query_embeddings: torch.Tensor,  # [B, D]
    item_embeddings: torch.Tensor,  # [X, D]
    item_ids: torch.Tensor,  # [X] catalog ids, all > 0
    invalid_ids: Optional[torch.Tensor] = None,  # [B, N0] ids to exclude, 0 = none
    max_item_id: Optional[int] = None,
) -> torch.Tensor:
    """[B, X] inner-product scores with each row's invalid ids at NEG_INF."""
    scores = query_embeddings.float() @ item_embeddings.float().T
    if invalid_ids is None:
        return scores
    if max_item_id is None:
        max_item_id = int(item_ids.max())
    b = invalid_ids.shape[0]
    # scatter the invalid ids into id space, then gather at the catalog ids;
    # slot 0 absorbs padding and is never read back (catalog ids are > 0)
    in_id_space = torch.zeros((b, max_item_id + 1), dtype=torch.bool, device=scores.device)
    in_id_space.scatter_(1, torch.clamp(invalid_ids.long(), 0, max_item_id), True)
    in_id_space[:, 0] = False
    is_invalid = in_id_space[:, item_ids.long()]
    return torch.where(is_invalid, NEG_INF, scores)


def mips_top_k(
    query_embeddings: torch.Tensor,
    item_embeddings: torch.Tensor,
    item_ids: torch.Tensor,
    k: int,
    invalid_ids: Optional[torch.Tensor] = None,
    max_item_id: Optional[int] = None,
    approx_recall: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (top_k_ids [B, k], top_k_scores [B, k]), sorted descending."""
    if approx_recall > 0.0:
        raise not_ported("index.approx_top_k_recall > 0", "Index variants")
    scores = masked_mips_scores(
        query_embeddings, item_embeddings, item_ids, invalid_ids, max_item_id
    )
    top_scores, top_idx = torch.topk(scores, k, dim=1, largest=True, sorted=True)
    return item_ids[top_idx], top_scores


def topk_agree(
    ids_a: Sequence[Sequence[int]],
    scores_a: Sequence[Sequence[float]],
    ids_b: Sequence[Sequence[int]],
    scores_b: Sequence[Sequence[float]],
    atol: float,
) -> Optional[str]:
    """None when two top-k results agree, else what differs.

    Scores must agree rank by rank within `atol`. Ids may differ only at a
    near-tie: where the score is within 2*atol of a neighbouring rank's, or
    at the last rank (whose tie partner may lie just outside the top k).
    """
    sa, sb = np.asarray(scores_a, np.float64), np.asarray(scores_b, np.float64)
    ia, ib = np.asarray(ids_a), np.asarray(ids_b)
    if sa.shape != sb.shape or ia.shape != ib.shape:
        return f"shapes differ: {ia.shape} vs {ib.shape}"
    err = np.abs(sa - sb)
    if err.size and err.max() > atol:
        r, c = np.unravel_index(err.argmax(), err.shape)
        return f"score at row {r} rank {c}: {sa[r, c]} vs {sb[r, c]} (atol {atol})"
    for r, c in zip(*np.nonzero(ia != ib)):
        row = sa[r]
        gaps = [abs(row[c] - row[j]) for j in (c - 1, c + 1) if 0 <= j < len(row)]
        if c != len(row) - 1 and min(gaps) > 2 * atol:
            return f"id at row {r} rank {c}: {ia[r, c]} vs {ib[r, c]}, not a near-tie"
    return None
